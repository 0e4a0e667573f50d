"""Model adapters: the engine↔model contract.

Port of ``kvcached_tpu/models/adapter.py`` for the Llama family (Llama,
Mistral, Qwen2, Qwen3).  An adapter gives the engine the KV geometry for the
pool, ``init_params``, and the step functions over the paged pool.  The
other families (MLA, hybrid layer groups, hybrid-linear) are not ported yet:
:func:`as_adapter` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Protocol


class ModelAdapter(Protocol):
    vocab_size: int
    num_layers: int
    num_kv_heads: int
    head_dim: int
    num_kv_buffers: int
    window: int | None

    def init_params(self, *, seed: int = 0, device=None): ...

    def decode_step(self, params, tokens, positions, k_pools, v_pools,
                    page_tables, slot_pages, slot_offsets, seq_lens): ...

    def prefill_step(self, params, tokens, positions, k_pools, v_pools,
                     chunk_pages, page_table, q_start, true_len): ...

    def prefill_batch_step(self, params, tokens, positions, k_pools, v_pools,
                           chunk_pages, page_tables, q_starts, true_lens): ...

    def verify_step(self, params, tokens, positions, k_pools, v_pools,
                    page_tables, slot_pages, slot_offsets, seq_lens): ...


@dataclass
class LlamaAdapter:
    cfg: Any  # LlamaConfig

    def __post_init__(self):
        c = self.cfg
        self.vocab_size = c.vocab_size
        self.num_layers = c.num_layers
        self.num_kv_heads = c.num_kv_heads
        self.head_dim = c.head_dim
        self.num_kv_buffers = 2
        self.window = c.sliding_window

    def init_params(self, *, seed: int = 0, device=None):
        from .llama import init_llama_params

        return init_llama_params(self.cfg, seed=seed, device=device)

    def decode_step(self, params, *args, **kw):
        from .llama import llama_decode_step

        return llama_decode_step(params, self.cfg, *args, **kw)

    def prefill_step(self, params, *args, **kw):
        from .llama import llama_prefill_step

        return llama_prefill_step(params, self.cfg, *args, **kw)

    def prefill_batch_step(self, params, *args, **kw):
        """Batched prefill: N chunks in one pass, identical to N serial
        prefill_step calls."""
        from .llama import llama_prefill_batch_step

        return llama_prefill_batch_step(params, self.cfg, *args, **kw)

    def verify_step(self, params, *args, **kw):
        """Speculative-decode verification: T fed tokens per row in one
        pass, logits at every position."""
        from .llama import llama_verify_step

        return llama_verify_step(params, self.cfg, *args, **kw)


def as_adapter(model) -> ModelAdapter:
    """Accept a Llama config or an adapter."""
    from .llama import LlamaConfig

    if isinstance(model, LlamaConfig):
        return LlamaAdapter(model)
    if isinstance(model, LlamaAdapter):
        return model
    raise NotImplementedError(
        f"{type(model).__name__}: only the Llama family is ported so far "
        "(MLA, hybrid and hybrid-linear models are not)"
    )
