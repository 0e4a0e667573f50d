"""Model families served by the port (the Llama and MLA families so far)."""

from .llama import (
    LlamaConfig,
    LlamaModel,
    init_llama_params,
    llama_decode_step,
    llama_prefill_batch_step,
    llama_prefill_step,
)
from .mla import (
    MLAConfig,
    MLAModel,
    init_mla_params,
    mla_decode_step,
    mla_prefill_batch_step,
    mla_prefill_step,
    mla_verify_step,
)

__all__ = [
    "LlamaConfig",
    "LlamaModel",
    "init_llama_params",
    "llama_decode_step",
    "llama_prefill_batch_step",
    "llama_prefill_step",
    "MLAConfig",
    "MLAModel",
    "init_mla_params",
    "mla_decode_step",
    "mla_prefill_batch_step",
    "mla_prefill_step",
    "mla_verify_step",
]
