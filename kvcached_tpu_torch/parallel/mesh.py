"""Device meshes for the engine: the dp part of
``kvcached_tpu/parallel/mesh.py``.

A mesh is a ``[dp, tp]`` grid of ``torch.device`` s with the axis names
``("dp", "tp")``.  Each dp replica is a placement: a device holding its own
copy of the KV pool, serving its share of the batch rows
(:class:`~kvcached_tpu_torch.engine.LLMEngine` with ``mesh=``).  A device
may appear more than once, so one card can host several replicas; the
semantics are those of replicas on separate cards (rows split, one pool
copy each, an equalizing write after each step), as the reference's dp
tests run every replica on one processor.

Only tp = 1 is ported: tensor parallelism and a pipeline axis raise
``NotImplementedError`` (ROADMAP A15).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device.pool import resolve_device

AXES = ("dp", "tp")


@dataclass(frozen=True)
class Mesh:
    """``devices[r][t]``: the device of dp replica ``r``, tp shard ``t``."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, ...] = AXES

    @property
    def shape(self) -> dict[str, int]:
        """Axis sizes by name, as a JAX mesh gives them."""
        return dict(zip(self.axis_names, (len(self.devices), len(self.devices[0]))))

    @property
    def replica_devices(self) -> list[torch.device]:
        """The device of each dp replica (tp = 1: one device each)."""
        return [row[0] for row in self.devices]


def _check_ported(axis_names, tp: int) -> None:
    """Only axes ``("dp", "tp")`` with tp = 1 are ported: any other axis (a
    pipeline axis) or a tp > 1 raises ``NotImplementedError``."""
    if tuple(axis_names) != AXES:
        raise NotImplementedError(
            f"mesh axes {tuple(axis_names)}: only ('dp', 'tp') is ported; pipeline axes "
            "are not yet (ROADMAP A15)")
    if tp != 1:
        raise NotImplementedError(f"tp={tp}: tensor parallelism is not ported yet (ROADMAP A15)")


def check_mesh(mesh: Mesh) -> int:
    """A mesh of the ported form (:func:`_check_ported`); returns its dp."""
    _check_ported(mesh.axis_names, len(mesh.devices[0]))
    return len(mesh.devices)


def make_mesh(tp: int = 1, dp: int = 1, devices=None, axis_names=AXES) -> Mesh:
    """A ``[dp, tp]`` mesh over ``devices``.

    ``devices=None`` takes the visible CUDA cards and raises if there are
    fewer than ``dp * tp`` (or none); an explicit list (``"cuda:0"``,
    ``torch.device("cpu")``, ...) may repeat a device, so that one card, or
    the CPU, hosts several replicas.  The first ``dp * tp`` entries are
    used, in row-major order, as the reference's ``make_mesh`` does.
    ``tp > 1`` and axes other than ``("dp", "tp")`` raise
    ``NotImplementedError``."""
    _check_ported(axis_names, tp)
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    n = dp * tp
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu', ...] to place the "
                "replicas on the CPU")
        visible = torch.cuda.device_count()
        if visible < n:
            raise RuntimeError(
                f"need {n} CUDA devices, {visible} visible; pass devices= (a device may "
                "repeat) to place several replicas on one card")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [resolve_device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"need {n} devices, got {len(devices)}")
    return Mesh(tuple(tuple(devices[r * tp:(r + 1) * tp]) for r in range(dp)))
