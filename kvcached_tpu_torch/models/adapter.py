"""Model adapters: the engine↔model contract.

Port of ``kvcached_tpu/models/adapter.py`` for the Llama family (Llama,
Mistral, Qwen2, Qwen3), the MLA family and the hybrid family of equal layer
groups (Gemma2).  An adapter gives the engine the KV geometry for the pool,
``init_params``, and the step functions over the paged pool.  The
hybrid-linear family is not ported yet: :func:`as_adapter` raises
``NotImplementedError`` for it.
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


@dataclass
class MLAAdapter:
    """The MLA family: one latent kv head of ``cache_head_dim`` lanes in a
    single pool (no V pool)."""

    cfg: Any  # MLAConfig

    def __post_init__(self):
        c = self.cfg
        self.vocab_size = c.vocab_size
        self.num_layers = c.num_layers
        self.num_kv_heads = 1
        self.head_dim = c.cache_head_dim
        self.num_kv_buffers = 1
        self.window = None

    def init_params(self, *, seed: int = 0, device=None):
        from .mla import init_mla_params

        return init_mla_params(self.cfg, seed=seed, device=device)

    def decode_step(self, params, *args, **kw):
        from .mla import mla_decode_step

        return mla_decode_step(params, self.cfg, *args, **kw)

    def prefill_step(self, params, *args, **kw):
        from .mla import mla_prefill_step

        return mla_prefill_step(params, self.cfg, *args, **kw)

    def prefill_batch_step(self, params, *args, **kw):
        """Batched prefill over the single latent pool, identical to N
        serial prefill_step calls."""
        from .mla import mla_prefill_batch_step

        return mla_prefill_batch_step(params, self.cfg, *args, **kw)

    def verify_step(self, params, *args, **kw):
        """Speculative-decode verification: absorbed multi-query attention
        over the latent pool, logits at every position."""
        from .mla import mla_verify_step

        return mla_verify_step(params, self.cfg, *args, **kw)


@dataclass
class HybridAdapter:
    """Full-attention and sliding-window layer groups of equal layer count
    over one shared arena of ``layers_per_group`` layers: the engine keeps
    one ``KVCacheManager`` and one page table per group (``group_windows``)
    over the same pool."""

    cfg: Any  # HybridConfig

    def __post_init__(self):
        c = self.cfg
        if not c.equal_groups:
            raise NotImplementedError(
                f"unequal layer groups {c.group_layer_counts} (per-group arenas) are "
                "not ported yet (ROADMAP A11b)")
        self.vocab_size = c.vocab_size
        self.num_layers = c.num_layers
        self.num_kv_heads = c.num_kv_heads
        self.head_dim = c.head_dim
        self.num_kv_buffers = 2
        self.window = None  # windows are per group, not global
        self.group_windows = c.group_windows
        self.layers_per_group = c.layers_per_group

    def init_params(self, *, seed: int = 0, device=None):
        from .hybrid import init_hybrid_params

        return init_hybrid_params(self.cfg, seed=seed, device=device)

    def decode_step(self, params, *args, **kw):
        """Tables [G, B, max_pages], slots [G, B]."""
        from .hybrid import hybrid_decode_step

        return hybrid_decode_step(params, self.cfg, *args, **kw)

    def prefill_step(self, params, *args, **kw):
        """Chunk pages [G, n], table [G, max_pages]."""
        from .hybrid import hybrid_prefill_step

        return hybrid_prefill_step(params, self.cfg, *args, **kw)

    def prefill_batch_step(self, params, *args, **kw):
        """Chunk pages [N, G, n], tables [N, G, max_pages]; identical to N
        serial prefill_step calls."""
        from .hybrid import hybrid_prefill_batch_step

        return hybrid_prefill_batch_step(params, self.cfg, *args, **kw)

    def verify_step(self, params, *args, **kw):
        """Tables [G, B, max_pages], slots [G, B, T]; logits at every
        position."""
        from .hybrid import hybrid_verify_step

        return hybrid_verify_step(params, self.cfg, *args, **kw)


def as_adapter(model) -> ModelAdapter:
    """Accept a Llama, MLA or hybrid config, or an adapter."""
    from .hybrid import HybridConfig
    from .llama import LlamaConfig
    from .mla import MLAConfig

    if isinstance(model, LlamaConfig):
        return LlamaAdapter(model)
    if isinstance(model, MLAConfig):
        return MLAAdapter(model)
    if isinstance(model, HybridConfig):
        return HybridAdapter(model)
    if isinstance(model, (LlamaAdapter, MLAAdapter, HybridAdapter)):
        return model
    raise NotImplementedError(
        f"{type(model).__name__}: only the Llama, MLA and hybrid families are "
        "ported so far (hybrid-linear models are not)"
    )
