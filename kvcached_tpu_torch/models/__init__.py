"""Model families served by the port (the Llama, MLA and hybrid families so far)."""

from .hybrid import (
    HybridConfig,
    HybridModel,
    hybrid_decode_step,
    hybrid_prefill_batch_step,
    hybrid_prefill_step,
    hybrid_verify_step,
    init_hybrid_params,
)
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
    "HybridConfig",
    "HybridModel",
    "hybrid_decode_step",
    "hybrid_prefill_batch_step",
    "hybrid_prefill_step",
    "hybrid_verify_step",
    "init_hybrid_params",
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
