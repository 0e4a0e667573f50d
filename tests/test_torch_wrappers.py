"""The kernel wrappers' contract, on the CPU: options the CUDA kernels do
not implement raise instead of being ignored, and a wrapper given a CUDA
tensor launches its kernel or raises, never running the plain version.
This file imports nothing of JAX."""

import importlib

import pytest
import torch

from kvcached_tpu_torch import ops

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

L, P, KH, QH, TP, D = 2, 8, 2, 4, 16, 128


def _decode_inputs():
    q = torch.zeros(2, QH, D)
    kp = torch.zeros(L, P, KH, TP, D)
    pt = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    return q, kp, kp.clone(), pt, torch.tensor([20, 5], dtype=torch.int32)


def test_unported_modes_raise():
    q, kp, vp, pt, sl = _decode_inputs()
    with pytest.raises(NotImplementedError):  # soft-capping in the MLA modes
        ops.paged_attention_decode(q, kp[:, :, :1], None, pt, sl, 0, q[:, :1], None,
                                   sl, sl, mla_v_dim=64, logit_softcap=30.0)
    with pytest.raises(NotImplementedError):  # float16 pools are not ported
        ops.paged_attention(q, kp.half(), vp.half(), pt, sl, 0)
    with pytest.raises(NotImplementedError):
        ops.paged_attention(q, kp, vp, pt, sl, 0, mla_v_dim=64)


def test_cuda_tensor_never_takes_plain_path(monkeypatch):
    """Without a card, ``_on_cpu`` is stubbed to say "CUDA" and the kernel
    build to fail: the wrapper must raise, run no plain version, and count
    no launch."""
    from kvcached_tpu_torch.ops import _build

    pa = importlib.import_module("kvcached_tpu_torch.ops.paged_attention")

    def no_build(name):
        raise RuntimeError("build refused")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(pa, "_on_cpu", lambda *ts: False)
    calls = []
    monkeypatch.setattr(pa, "write_prefill_kv_plain", lambda *a: calls.append(a))
    kp = torch.zeros(1, 4, 2, 16, 128)
    before = pa.write_prefill_kv.launches
    with pytest.raises(RuntimeError, match="build refused"):
        pa.write_prefill_kv(kp, kp.clone(), torch.zeros(2, 16, 128),
                            torch.zeros(2, 16, 128),
                            torch.tensor([1], dtype=torch.int32), 0)
    assert not calls, "the plain version never ran"
    assert pa.write_prefill_kv.launches == before, "a launch that failed is not counted"
