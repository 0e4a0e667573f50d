"""Parameters from the JAX package's layout.

:func:`params_from_jax` turns the JAX package's Llama, MLA or hybrid
parameter tree, as numpy arrays (``jax.tree.map(np.asarray, params)``), into
the port's :class:`~kvcached_tpu_torch.models.llama.LlamaModel`,
:class:`~kvcached_tpu_torch.models.mla.MLAModel` or
:class:`~kvcached_tpu_torch.models.hybrid.HybridModel` (the Llama tree plus
the Gemma post norms and the optional q/k norms and biases).  Both packages use the
same names and layouts (stacked layers, input-major projections), so the
two compute the same function on the same numbers.  This module imports
neither JAX nor the JAX package: it takes plain numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from .device.pool import resolve_device
from .models.hybrid import HybridConfig, HybridModel
from .models.llama import LlamaConfig, LlamaModel
from .models.mla import MLAConfig, MLAModel


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: widen exactly
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)  # a copy


def params_from_jax(tree: dict, cfg: LlamaConfig | MLAConfig | HybridConfig, *,
                    device=None) -> LlamaModel:
    """``{"embed", "layers": {...}, "final_norm", "lm_head"}`` of numpy
    arrays → :class:`LlamaModel` (an :class:`MLAModel` for an
    :class:`MLAConfig`, a :class:`HybridModel` for a :class:`HybridConfig`)
    on ``device`` (default: the card) in ``cfg.dtype``."""
    dev = resolve_device(device)
    dt = cfg.tdtype
    model = {MLAConfig: MLAModel, HybridConfig: HybridModel}.get(type(cfg), LlamaModel)
    return model(
        cfg,
        embed=_tensor(tree["embed"], dt, dev),
        layers={k: _tensor(v, dt, dev) for k, v in tree["layers"].items()},
        final_norm=_tensor(tree["final_norm"], dt, dev),
        lm_head=_tensor(tree["lm_head"], dt, dev),
    )
