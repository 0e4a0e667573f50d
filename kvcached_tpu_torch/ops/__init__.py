"""The paged-KV kernels, hand-written CUDA for Hopper, with their plain
PyTorch versions.

``KERNELS`` names each kernel wrapper; :func:`launch_counts` and
:func:`reset_launch_counts` read and zero the wrappers' launch counters,
:func:`launch_counts_by_dtype` reads them by pool type (the int8 and fp8
modes of K1-K4 are their launches on byte pools; the soft-capped launches
of K1, K1r, K3 and K4 count under the pool type's name plus ``+softcap``,
and launches at head_dim 256 with ``+d256`` after that).
"""

from .paged_attention import (
    paged_attention,
    paged_attention_decode,
    paged_attention_decode_mla,
    paged_attention_decode_plain,
    paged_attention_reference,
    paged_attention_verify,
    paged_attention_verify_mla,
    paged_attention_verify_plain,
    quantize_kv,
    to_e4m3,
    write_prefill_kv,
    write_prefill_kv_plain,
    write_prefill_kv_single,
    write_prefill_kv_single_plain,
)
from .paged_prefill import (
    paged_prefill_attention,
    paged_prefill_attention_batch,
    paged_prefill_attention_batch_mla,
    paged_prefill_attention_batch_plain,
)

#: kernel id → wrapper (K1r is K1's CUDA kernel with the write off; K5,
#: K5v and K3m are the MLA modes of decode, verify and prefill, all three
#: launching csrc/mla_attend.cu)
KERNELS = {
    "K1": paged_attention_decode,
    "K1r": paged_attention,
    "K2": write_prefill_kv,
    "K3": paged_prefill_attention_batch,
    "K4": paged_attention_verify,
    "K5": paged_attention_decode_mla,
    "K5v": paged_attention_verify_mla,
    "K6": write_prefill_kv_single,
    "K3m": paged_prefill_attention_batch_mla,
}


def launch_counts() -> dict[str, int]:
    return {k: fn.launches for k, fn in KERNELS.items()}


def launch_counts_by_dtype() -> dict[str, dict[str, int]]:
    return {k: dict(fn.launches_by_dtype) for k, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        fn.launches_by_dtype = {}


__all__ = [
    "KERNELS",
    "launch_counts",
    "launch_counts_by_dtype",
    "reset_launch_counts",
    "paged_attention",
    "paged_attention_decode",
    "paged_attention_decode_mla",
    "paged_attention_decode_plain",
    "paged_attention_reference",
    "paged_attention_verify",
    "paged_attention_verify_mla",
    "paged_attention_verify_plain",
    "paged_prefill_attention",
    "paged_prefill_attention_batch",
    "paged_prefill_attention_batch_mla",
    "paged_prefill_attention_batch_plain",
    "quantize_kv",
    "to_e4m3",
    "write_prefill_kv",
    "write_prefill_kv_plain",
    "write_prefill_kv_single",
    "write_prefill_kv_single_plain",
]
