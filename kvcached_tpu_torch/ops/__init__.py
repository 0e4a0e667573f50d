"""The paged-KV kernels, hand-written CUDA for Hopper, with their plain
PyTorch versions.

``KERNELS`` names each kernel wrapper; :func:`launch_counts` and
:func:`reset_launch_counts` read and zero the wrappers' launch counters.
"""

from .paged_attention import (
    paged_attention,
    paged_attention_decode,
    paged_attention_decode_plain,
    paged_attention_reference,
    write_prefill_kv,
    write_prefill_kv_plain,
)
from .paged_prefill import (
    paged_prefill_attention,
    paged_prefill_attention_batch,
    paged_prefill_attention_batch_plain,
)

#: kernel id → wrapper (K1r is K1's CUDA kernel with the write off)
KERNELS = {
    "K1": paged_attention_decode,
    "K1r": paged_attention,
    "K2": write_prefill_kv,
    "K3": paged_prefill_attention_batch,
}


def launch_counts() -> dict[str, int]:
    return {k: fn.launches for k, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS",
    "launch_counts",
    "reset_launch_counts",
    "paged_attention",
    "paged_attention_decode",
    "paged_attention_decode_plain",
    "paged_attention_reference",
    "paged_prefill_attention",
    "paged_prefill_attention_batch",
    "paged_prefill_attention_batch_plain",
    "write_prefill_kv",
    "write_prefill_kv_plain",
]
