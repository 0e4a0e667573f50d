"""Model families served by the port (the Llama family so far)."""

from .llama import (
    LlamaConfig,
    LlamaModel,
    init_llama_params,
    llama_decode_step,
    llama_prefill_batch_step,
    llama_prefill_step,
)

__all__ = [
    "LlamaConfig",
    "LlamaModel",
    "init_llama_params",
    "llama_decode_step",
    "llama_prefill_batch_step",
    "llama_prefill_step",
]
