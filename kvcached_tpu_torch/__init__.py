"""kvcached-tpu on PyTorch and CUDA: the elastic paged KV cache and its
serving engine, on one NVIDIA H100.

The JAX package ``kvcached_tpu`` is the reference this package is held
against.  The module layout and names are the same, so each module's
counterpart is found at the same path there.  The allocator, shm control
plane and prefix cache are copies (this package imports nothing of
``kvcached_tpu``); the device pool, the model, the engine (with
speculative decoding) and the four paged-attention kernels (hand-written
CUDA for ``sm_90a``, under ``csrc/``) are ports.

Importing the package imports neither torch nor the kernels, so an operator
process (``kvctl limit``-style, through :mod:`kvcached_tpu_torch.shm`) stays
cheap.
"""

from .config import KVConfig, KVCachedConfigError
from .kv_cache_manager import KVCacheManager

__version__ = "0.1.0"

__all__ = [
    "KVConfig",
    "KVCachedConfigError",
    "KVCacheManager",
    "__version__",
]
