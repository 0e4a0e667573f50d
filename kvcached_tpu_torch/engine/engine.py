"""Continuous-batching LLM engine over the elastic KV pool.

Port of the single-device subset of ``kvcached_tpu/engine/engine.py``:

- **Scheduler** (host): fcfs / priority / sjf admission, per-sequence block
  allocation through :class:`KVCacheManager` (so a ``kvctl limit`` through
  the shm plane applies to serving), newest-first preemption under memory
  pressure, chunked prefill interleaved with decode, batched prefill, the
  prefix cache (off for sliding-window models), stop ids and stop strings.
- **Runner** (device): prefill steps and a **decode horizon** of K steps per
  dispatch.  Where the JAX engine scanned the K steps inside one jitted
  program, the port runs a host loop of K steps: the per-step positions,
  slots and lengths are computed on the host once per dispatch and copied
  to the card in one transfer, the sampled tokens feed the next step on the
  card, and the K x B tokens come back in one transfer at the end.
- **Speculative decoding** (``spec_decode``): a dispatch runs S verify
  iterations on the card, each drafting gamma tokens per row from a ring of
  its last tokens (prompt lookup), verifying them in one multi-query
  forward (K4) and accepting the longest agreeing prefix (rejection
  sampling for sampled rows); the S x B x (gamma+1) tokens come back in one
  transfer.
- Engine blocks are pool pages (``block_tokens == page_tokens``); page
  tables hold physical page ids for the kernels.
- **Layer groups** (the hybrid family): one :class:`KVCacheManager` per
  group over the same :class:`DevicePagePool`, whose arena holds
  ``layers_per_group`` layers, so pages are fungible across groups while
  each group has its own block lists, page table, shm segment (``_g<id>``)
  and page lifetime: a sliding-window group frees the pages that slid out
  of its window, a full-attention group keeps them.  A model with one
  group keeps 2-D tables; with G groups the decode and verify tables are
  ``[G, B, max_pages]``, a verify's slots ``[G, B, T]``, a chunk's pages
  ``[G, n]`` and a batched prefill's ``[N, G, n]``.  int8 scales on layer
  groups come per model layer (``[num_layers, KH]``).  The prefix cache is
  off for several groups.

The mesh, pipeline-parallel and stateful paths of the JAX engine, and layer
groups of unequal size (ROADMAP A11b), are not ported yet.

Sampling draws from ``torch.Generator`` s seeded from the engine step (and
the request seed for first tokens), so an identical engine history
reproduces identical outputs; the numbers differ from ``jax.random``'s.
"""

from __future__ import annotations

import bisect
import hashlib
import itertools
import time
from dataclasses import dataclass
from typing import Sequence as Seq

import numpy as np
import torch

from ..config import KVConfig
from ..device.pool import DevicePagePool, PoolSpec, hbm_free_bytes, resolve_device
from ..kv_cache_manager import KVCacheManager
from ..logging_utils import get_kvcached_logger
from ..models.adapter import as_adapter
from .prefix_cache import PrefixCache, page_keys

logger = get_kvcached_logger(__name__)


@dataclass
class SamplingParams:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy (deterministic)
    top_k: int = 0  # 0 = disabled; keep the k highest-logit tokens
    top_p: float = 1.0  # nucleus sampling; 1.0 = disabled
    seed: int = 0
    stop_token_ids: tuple[int, ...] = ()
    #: stop STRINGS: generation ends when the decoded output contains one;
    #: the returned text is truncated before it.  Needs a tokenizer.
    stop: tuple[str, ...] = ()


def _generator(device, *seeds: int) -> torch.Generator:
    """A generator on ``device`` seeded from the given integers."""
    h = hashlib.blake2b(digest_size=8)
    for s in seeds:
        h.update(int(s).to_bytes(8, "little", signed=True))
    seed = int.from_bytes(h.digest(), "little") & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(seed)


def _filtered_scaled(logits, temps, top_ks, top_ps, *, filters: bool):
    """Temperature-scaled logits with rank-based top-k / top-p filtering on
    the last axis (parameter tensors broadcast against the leading axes).
    Rank-based: a stable sort breaks ties by token index exactly like
    argmax, so top_k=1 equals greedy even when logits tie at the max."""
    scaled = logits / torch.clamp(temps, min=1e-6)[..., None]
    if filters:
        V = logits.shape[-1]
        order = torch.argsort(-scaled, dim=-1, stable=True)  # desc token ids
        ranks = torch.empty_like(order).scatter_(
            -1, order, torch.arange(V, device=logits.device).expand_as(order))
        k = torch.where(top_ks > 0, top_ks, torch.full_like(top_ks, V))
        neg = torch.full_like(scaled, float("-inf"))
        scaled = torch.where(ranks >= k[..., None], neg, scaled)
        # nucleus: keep the smallest rank-prefix whose exclusive cumulative
        # mass is < top_p (always >= 1 token)
        desc = torch.gather(scaled, -1, order)
        probs = torch.softmax(desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_n = ((cum - probs) < top_ps[..., None]).sum(dim=-1)
        scaled = torch.where(ranks >= keep_n.clamp(min=1)[..., None], neg, scaled)
    return scaled


def _categorical(scaled, generator):
    """One draw per row from the logits ``scaled`` on the last axis
    (Gumbel-max)."""
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)


def _sample_tokens(logits, temps, top_ks, top_ps, generator, *, filters: bool,
                   sampled: bool = True):
    """Per-row sampling: greedy where temp == 0, else a categorical draw
    (Gumbel-max) from the temperature / top-k / top-p filtered logits.
    ``sampled=False`` (no row has temp > 0, known on the host) skips the
    draw."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not sampled:
        return greedy
    scaled = _filtered_scaled(logits, temps, top_ks, top_ps, filters=filters)
    return torch.where(temps > 0, _categorical(scaled, generator), greedy)


def _spec_accept(logits, drafts, temps, top_ks, top_ps, generator, *,
                 filters: bool):
    """Acceptance rule for speculative decoding with deterministic
    (prompt-lookup) drafts.  ``logits`` [B, T, V]: position j < gamma = T-1
    verifies draft j; position gamma gives the bonus token.

    Greedy rows (temp == 0): accept iff the draft equals the model's own
    argmax, so they are token-exact vs plain greedy decode.

    Sampled rows: rejection sampling against the row's filtered target p.
    The draft distribution is a point mass, so draft d is accepted with
    probability p(d), and on rejection the replacement is drawn from p with
    d's mass removed: each emitted token is distributed exactly as
    sequential sampling from p.

    Returns (out [B, T] int32, a [B] accepted drafts in 0..gamma): the
    kept tokens of an iteration are out[:, :a+1]."""
    B, T = logits.shape[:2]
    gamma = T - 1
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)  # [B, T]
    scaled = _filtered_scaled(logits, temps[:, None], top_ks[:, None],
                              top_ps[:, None], filters=filters)
    p = torch.softmax(scaled, dim=-1)
    # padded batch rows (a ring of -1) draft -1; their outputs are discarded
    ids = drafts.long().clamp(min=0)
    p_draft = torch.gather(p[:, :gamma], -1, ids[..., None])[..., 0]
    u = torch.rand((B, gamma), generator=generator, device=logits.device)
    is_sampled = temps > 0
    accept = torch.where(is_sampled[:, None], u < p_draft, greedy[:, :gamma] == drafts)
    a = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    # replacement on rejection: the draft's mass removed, renormalized
    rep = _categorical(scaled[:, :gamma].scatter(-1, ids[..., None], float("-inf")), generator)
    bonus = _categorical(scaled[:, gamma], generator)
    out_draft = torch.where(accept, drafts.to(torch.int32),
                            torch.where(is_sampled[:, None], rep, greedy[:, :gamma]))
    out_bonus = torch.where(is_sampled, bonus, greedy[:, gamma])
    return torch.cat([out_draft, out_bonus[:, None]], dim=1), a


def _ngram_draft(ring, n: int, gamma: int):
    """Prompt-lookup drafts [B, gamma] from ``ring`` [B, W] (each row's last
    W tokens, newest last, short rows left-padded with -1): the tokens that
    followed the latest earlier occurrence of the trailing n-gram, clamped at
    the ring's end; the last token repeated where the n-gram never
    occurred."""
    B, W = ring.shape
    dev = ring.device
    key = ring[:, W - n:]
    idx = torch.arange(W - n, device=dev)[:, None] + torch.arange(n, device=dev)[None]
    m = (ring[:, idx] == key[:, None, :]).all(dim=-1)  # [B, W-n] windows
    found = m.any(dim=1)
    latest = (W - n - 1) - torch.argmax(m.flip(1).to(torch.int32), dim=1)
    cont_idx = (latest[:, None] + n + torch.arange(gamma, device=dev)[None]).clamp(max=W - 1)
    cont = torch.gather(ring, 1, cont_idx)
    return torch.where(found[:, None], cont, ring[:, -1:].expand_as(cont))


@dataclass
class Request:
    req_id: int
    prompt: list[int]
    sampling: SamplingParams
    #: scheduling priority under scheduling_policy="priority" (smaller =
    #: served sooner); ignored by fcfs/sjf
    priority: int = 0


@dataclass
class RequestOutput:
    req_id: int
    prompt: list[int]
    output_tokens: list[int]
    finished: bool = True
    #: decoded output truncated before the earliest stop string (only set
    #: when a stop string fired)
    output_text: str | None = None


class Sequence:
    def __init__(self, req: Request, num_groups: int = 1):
        self.req = req
        self.tokens: list[int] = list(req.prompt)
        # block ids from each layer group's KVCacheManager (one group for
        # every family but the hybrid one); None = a page that slid out of
        # the group's attention window and was reclaimed
        self.blocks_g: list[list[int | None]] = [[] for _ in range(num_groups)]
        self.num_prefilled = 0
        self.stop_hit = False  # a stop STRING fired
        self.output_text: str | None = None

    @property
    def prompt_len(self) -> int:
        return len(self.req.prompt)

    @property
    def num_generated(self) -> int:
        return len(self.tokens) - self.prompt_len

    def finished(self) -> bool:
        sp = self.req.sampling
        if self.stop_hit or self.num_generated >= sp.max_new_tokens:
            return True
        return bool(
            sp.stop_token_ids
            and self.num_generated > 0
            and self.tokens[-1] in sp.stop_token_ids
        )


@dataclass
class EngineConfig:
    max_batch: int = 8
    max_model_len: int = 2048
    page_tokens: int = 64
    decode_horizon: int = 8  # device steps per dispatch
    prefill_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    num_pages: int | None = None  # physical pool pages; None = from free memory
    hbm_utilization: float = 0.3
    #: pool type: "bfloat16", "float32", or a byte type ("int8",
    #: "float8_e4m3fn"; page_tokens a multiple of 32) for twice the tokens
    kv_dtype: str = "bfloat16"
    #: int8 KV: default per-head dequantization scale (amax/127 of expected
    #: K/V magnitude); override per (layer, head) via set_kv_scales()
    kv_scale: float = 0.04
    ipc_name: str | None = None
    enable_prefix_caching: bool = True
    max_cached_tokens: int | None = None  # None = KVCACHED_MAX_CACHED_TOKENS
    #: shrink the decode horizon near sequence caps (no wasted steps)
    adaptive_horizon: bool = True
    #: batched prefill: stack up to this many waiting prompts into one
    #: prefill pass (the weights stream once for N prompts).  Identical to
    #: serial prefill.  1 = off.
    prefill_batch: int = 1
    #: admission order for the waiting queue: "fcfs", "priority" (smaller
    #: Request.priority sooner; preemption evicts the worst-priority newest)
    #: or "sjf" (shortest remaining prompt first)
    scheduling_policy: str = "fcfs"
    #: speculative decoding: prompt-lookup (n-gram) drafts verified in one
    #: multi-query forward, up to spec_gamma+1 tokens per row per verify
    #: iteration.  Greedy rows are token-exact vs plain decode (argmax
    #: equality); temperature>0 rows are distribution-exact (rejection
    #: sampling, _spec_accept).
    spec_decode: bool = False
    spec_gamma: int = 4  # draft tokens verified per iteration
    spec_ngram: int = 2  # trailing n-gram matched for prompt lookup
    spec_horizon: int = 4  # verify iterations per dispatch
    spec_window: int = 128  # token ring the card drafts from
    #: refuse spec_decode configurations that cannot guarantee token-
    #: exactness vs plain decode: sub-float32 params or KV (the verify
    #: forward reduces in another order than decode, so a near-tie argmax
    #: can flip).  Off by default: bf16 spec decode logs a warning.
    spec_exact: bool = False
    #: acceptance-driven gamma: walk a power-of-two ladder <= spec_gamma on
    #: an EMA of accepted drafts per iteration, and cool off to plain decode
    #: when drafting is useless
    spec_adaptive: bool = False


class LLMEngine:
    """Single-model serving engine on one device."""

    _ids = itertools.count()

    def __init__(
        self,
        model_cfg,
        engine_cfg: EngineConfig | None = None,
        *,
        params=None,
        seed: int = 0,
        device=None,
        tokenizer=None,
    ):
        """``device`` defaults to the card; pass ``device="cpu"`` to run the
        kernels' plain versions on the CPU.  ``params``: a
        :class:`~kvcached_tpu_torch.models.llama.LlamaModel` on that device
        (random-initialized from ``seed`` when None)."""
        self.adapter = as_adapter(model_cfg)
        self.model_cfg = model_cfg
        self.tokenizer = tokenizer
        self.cfg = engine_cfg or EngineConfig()
        ec = self.cfg
        if ec.scheduling_policy not in ("fcfs", "priority", "sjf"):
            raise ValueError(
                f"unknown scheduling_policy {ec.scheduling_policy!r} "
                "(expected 'fcfs', 'priority', or 'sjf')"
            )
        if ec.kv_dtype not in ("bfloat16", "float32", "int8", "float8_e4m3fn"):
            raise NotImplementedError(
                f"kv_dtype={ec.kv_dtype!r} is not ported yet "
                "(bfloat16, float32, int8, float8_e4m3fn)")
        if ec.spec_decode:
            dt = str(self.adapter.cfg.dtype)
            if ec.spec_exact and (dt != "float32" or ec.kv_dtype != "float32"):
                raise ValueError(
                    f"spec_exact=True requires float32 params AND "
                    f"kv_dtype='float32' for token-exact speculative decoding "
                    f"(model dtype {dt}, kv_dtype {ec.kv_dtype}); use float32 "
                    f"or drop spec_exact")
            if dt != "float32":
                logger.warning(
                    "spec_decode with %s params is distribution-faithful but "
                    "not guaranteed token-exact vs plain decode (near-tie "
                    "argmax may flip between the verify and decode reduction "
                    "orders); use float32 for exactness-critical serving", dt)
        # layer groups (the hybrid family): group g's pages live in a shared
        # arena of layers_per_group layers; other families have one group
        self.group_windows: tuple = (getattr(self.adapter, "group_windows", None)
                                     or (self.adapter.window,))
        self.num_groups = len(self.group_windows)
        #: leading axis of the page rows the model steps take: none for one
        #: group (2-D tables), G for several
        self._groups = (self.num_groups,) if self.num_groups > 1 else ()
        self.device = resolve_device(device)
        if params is None:
            params = self.adapter.init_params(seed=seed, device=self.device)
        elif params.device != self.device:
            raise ValueError(f"params live on {params.device}, engine on {self.device}")
        self.params = params

        self.kv_cfg = KVConfig(
            num_layers=(self.adapter.layers_per_group if self.num_groups > 1
                        else self.adapter.num_layers),
            num_kv_heads=self.adapter.num_kv_heads,
            head_dim=self.adapter.head_dim,
            block_tokens=ec.page_tokens,  # block == page
            page_tokens=ec.page_tokens,
            kv_dtype=ec.kv_dtype,
            num_kv_buffers=self.adapter.num_kv_buffers,
        )
        if ec.num_pages is not None:
            spec = PoolSpec.from_config(self.kv_cfg, num_pages=ec.num_pages)
        else:
            budget = hbm_free_bytes(self.device)
            if budget is None:
                budget = 2 << 30  # CPU: 2 GB worth of pages
            spec = PoolSpec.from_config(
                self.kv_cfg, hbm_budget_bytes=int(budget * ec.hbm_utilization))
        self.pool = DevicePagePool(spec, device=self.device)
        self.k_pools, self.v_pools = self.pool.allocate_arrays()
        #: int8 pools: per-(layer, kv head) dequantization scales [L, KH]
        #: for K and V, each ``kv_scale`` until set_kv_scales(); the MLA
        #: latent pool has one kv head, and its K scales serve the values;
        #: layer groups take them per model layer, and each group's steps
        #: its layers' rows
        self.quant_scales = None
        if ec.kv_dtype == "int8":
            shape = self._scales_shape
            self.quant_scales = tuple(
                torch.full(shape, ec.kv_scale, dtype=torch.float32, device=self.device)
                for _ in range(2))
        # one manager per layer group over the same pool: pages fungible
        # across groups, accounting and limits (shm segment _g<id>) per group
        self.managers = [
            KVCacheManager(
                self.kv_cfg if g == 0 else KVConfig(**{**self.kv_cfg.__dict__, "group_id": g}),
                self.pool, ipc_name=ec.ipc_name, reserve_null_block=True)
            for g in range(self.num_groups)
        ]

        self.max_pages_per_seq = ec.max_model_len // ec.page_tokens
        # sliding-window models reclaim pages mid-sequence; cached pages
        # would dangle, so the prefix cache is forced off (hybrid models
        # always have a windowed group)
        enable_cache = (ec.enable_prefix_caching and self.num_groups == 1
                        and not self.group_windows[0])
        self.prefix_cache = PrefixCache(
            ec.page_tokens, (ec.max_cached_tokens if enable_cache else 0))
        self.cache_namespace = self._stable_namespace()
        self.waiting: list[Sequence] = []
        self.running: list[Sequence] = []
        #: sequence mid-way through an interleaved chunked prefill
        self._prefilling: Sequence | None = None
        self.finished_outputs: list[RequestOutput] = []
        self._preempt_count = 0
        self._step_count = 0
        self._pb_dispatches = 0
        self._pb_prompts = 0
        #: host wall time of the prefill and decode dispatches (each ends in
        #: a device→host pull, so it covers the device work) and the tokens
        #: they produced: prompt tokens prefilled, generated tokens kept;
        #: decode_steps counts the decode dispatches' forward passes (decode
        #: steps, or verify iterations under spec decode)
        self.stats = dict(prefill_tokens=0, prefill_seconds=0.0,
                          decode_tokens=0, decode_seconds=0.0, decode_steps=0)
        self._spec_dispatches = 0
        self._spec_tokens = 0
        self._spec_iterations = 0  # (row, verify iteration) pairs that kept tokens
        # adaptive gamma (spec_adaptive): EMA of accepted drafts per verify
        # iteration, current ladder rung, plain-decode cooldown
        self._spec_ema: float | None = None
        self._spec_gamma_cur = ec.spec_gamma
        self._spec_cooldown = 0

    def _stable_namespace(self) -> str:
        """Prefix-cache namespace: model config + kv config + a weights
        fingerprint (not ``id(self)``, which collides after GC)."""
        h = hashlib.blake2b(digest_size=8)
        h.update(repr(self.model_cfg).encode())
        h.update(repr(self.kv_cfg).encode())
        sample = self.params.embed.reshape(-1)[:64].float().cpu().numpy()
        h.update(sample.tobytes())
        return h.hexdigest()

    @property
    def _scales_shape(self) -> tuple[int, int]:
        """The int8 scales' shape: arena layers x kv heads, or for layer
        groups model layers x kv heads (the reference's form)."""
        layers = self.adapter.num_layers if self.num_groups > 1 else self.kv_cfg.num_layers
        return (layers, self.kv_cfg.num_kv_heads)

    def set_kv_scales(self, k_scales, v_scales) -> None:
        """int8 KV: install per-(layer, kv head) dequantization scales,
        [L, KH] float32 each (L: arena layers, or model layers for layer
        groups); the next step uses them.  Raises ValueError on any other
        shape."""
        want = self._scales_shape
        ks, vs = (torch.as_tensor(np.asarray(a), dtype=torch.float32).to(self.device)
                  for a in (k_scales, v_scales))
        if tuple(ks.shape) != want or tuple(vs.shape) != want:
            what = "model" if self.num_groups > 1 else "arena"
            raise ValueError(
                f"set_kv_scales: expected shape {want} ({what} layers x kv heads), "
                f"got k={tuple(ks.shape)} v={tuple(vs.shape)}")
        self.quant_scales = (ks, vs)

    @property
    def _scales_kw(self) -> dict:
        """The model steps' ``quant_scales`` keyword, when scales are set."""
        return {} if self.quant_scales is None else {"quant_scales": self.quant_scales}

    def _dev(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # ------------------------------------------------------------- requests

    def add_request(self, prompt: list[int],
                    sampling: SamplingParams | None = None,
                    *, priority: int = 0) -> int:
        req = Request(next(self._ids), list(prompt),
                      sampling or SamplingParams(), priority)
        if len(req.prompt) + req.sampling.max_new_tokens > self.cfg.max_model_len:
            raise ValueError(
                f"prompt+max_new_tokens exceeds max_model_len={self.cfg.max_model_len}"
            )
        # prompts longer than the largest bucket are served by chunked prefill
        self._enqueue(Sequence(req, self.num_groups))
        return req.req_id

    # ------------------------------------------------------ queue policies

    def _queue_key(self, seq: Sequence):
        """Admission sort key under the configured policy; req_id is the
        arrival ordinal (the fcfs key and the tiebreak everywhere else)."""
        policy = self.cfg.scheduling_policy
        if policy == "priority":
            return (seq.req.priority, seq.req.req_id)
        if policy == "sjf":
            return (seq.prompt_len - seq.num_prefilled, seq.req.req_id)
        return (seq.req.req_id,)

    def _enqueue(self, seq: Sequence) -> None:
        if self.cfg.scheduling_policy == "fcfs":
            self.waiting.append(seq)
            return
        keys = [self._queue_key(s) for s in self.waiting]
        self.waiting.insert(bisect.bisect_right(keys, self._queue_key(seq)), seq)

    def _requeue_preempted(self, seq: Sequence) -> None:
        """fcfs: back to the FRONT (it was admitted once); priority/sjf: to
        its policy slot."""
        if self.cfg.scheduling_policy == "fcfs":
            self.waiting.insert(0, seq)
        else:
            self._enqueue(seq)

    def has_unfinished(self) -> bool:
        return bool(self.waiting or self.running or self._prefilling)

    # ------------------------------------------------------------- scheduling

    def _blocks_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.cfg.page_tokens)

    def _alloc_blocks(self, need: int, g: int = 0) -> list[int] | None:
        """Allocate through group g's manager, reclaiming prefix-cache
        pages under pressure first."""
        mgr = self.managers[g]
        blocks = mgr.alloc(need)
        if blocks is None and self.prefix_cache.num_evictable:
            evicted = self.prefix_cache.evict(need + 4)
            if evicted:
                self.managers[0].free(evicted)
                blocks = mgr.alloc(need)
        return blocks

    def _ensure_blocks(self, seq: Sequence, num_tokens: int) -> bool:
        """Grow seq's blocks in every group to cover ``num_tokens`` tokens.
        All or nothing: on a group's failure, the pages just taken for
        earlier groups are returned."""
        num_tokens = min(num_tokens, self.cfg.max_model_len)
        target = self._blocks_needed(num_tokens)
        taken: list[tuple[int, list[int]]] = []
        for g in range(self.num_groups):
            need = target - len(seq.blocks_g[g])
            if need <= 0:
                continue
            blocks = self._alloc_blocks(need, g)
            if blocks is None:
                for gg, bs in taken:
                    self.managers[gg].free(bs)
                    del seq.blocks_g[gg][-len(bs):]
                return False
            seq.blocks_g[g].extend(blocks)
            taken.append((g, blocks))
        return True

    def _reclaim_slid_pages(self, seq: Sequence) -> None:
        """Sliding-window groups free the pages every token of which is
        below the window of every future position; full-attention groups
        keep theirs."""
        for g, window in enumerate(self.group_windows):
            if not window:
                continue
            win_start = len(seq.tokens) - window
            if win_start <= 0:
                continue
            last_dead_page = win_start // self.cfg.page_tokens  # exclusive
            row = seq.blocks_g[g]
            dead = [b for b in row[:last_dead_page] if b is not None]
            if dead:
                self.managers[g].free(dead)
                for j in range(min(last_dead_page, len(row))):
                    row[j] = None

    def _free_seq(self, seq: Sequence, cache_kv: bool = True) -> None:
        # groups past the first never enter the prefix cache: free directly
        for g in range(1, self.num_groups):
            live = [b for b in seq.blocks_g[g] if b is not None]
            if live:
                self.managers[g].free(live)
            seq.blocks_g[g] = []
        blocks = [b for b in seq.blocks_g[0] if b is not None]
        seq.blocks_g[0] = []
        if not blocks:
            return
        if cache_kv and self.prefix_cache.enabled:
            # register full pages (prompt AND generated) before releasing;
            # the final token's KV is never written, so only pages whose
            # every slot is below len-1 are cacheable
            n_full = min(
                (len(seq.tokens) - 1) // self.cfg.page_tokens, len(blocks))
            if n_full:
                keys = page_keys(
                    seq.tokens[: n_full * self.cfg.page_tokens],
                    self.cfg.page_tokens, self.cache_namespace)
                self.prefix_cache.insert(keys[:n_full], blocks[:n_full])
        _retained, to_free = self.prefix_cache.release(blocks)
        if to_free:
            self.managers[0].free(to_free)

    def _admit_running(self, need_fn) -> list:
        """Take the head of the running queue (up to max_batch) and ensure
        each sequence has blocks for ``need_fn(seq)`` tokens, preempting
        under pressure.  The scan restarts after every preemption (the
        victim may sit below the scan index).  Returns the admitted batch."""
        B = self.cfg.max_batch
        batch = self.running[:B]
        i = 0
        while i < len(batch):
            if self._ensure_blocks(batch[i], need_fn(batch[i])):
                i += 1
                continue
            if not self._preempt_one():
                break
            batch = self.running[:B]
            i = 0
        return [s for s in batch if s in self.running]

    def _preempt_one(self) -> bool:
        """Evict a running sequence back to waiting (recompute): the newest
        under fcfs/sjf, the worst-priority newest under priority."""
        if not self.running:
            return False
        if self.cfg.scheduling_policy == "priority":
            seq = max(self.running, key=lambda s: (s.req.priority, s.req.req_id))
            self.running.remove(seq)
        else:
            seq = self.running.pop()
        self._free_seq(seq)
        # restart from scratch (keeps greedy decoding deterministic)
        seq.tokens = list(seq.req.prompt)
        seq.num_prefilled = 0
        self._requeue_preempted(seq)
        self._preempt_count += 1
        logger.info("preempted request %d under memory pressure", seq.req.req_id)
        return True

    def _phys_row(self, seq: Sequence, g: int = 0) -> np.ndarray:
        pt = self.managers[g].page_allocator.page_table
        row = np.zeros(self.max_pages_per_seq, np.int32)
        for j, b in enumerate(seq.blocks_g[g]):
            # reclaimed (slid-out) pages point at the zero page; the kernels
            # never read below the window start
            row[j] = pt[b] if b is not None else 0
        return row

    def _phys_rows(self, seq: Sequence) -> np.ndarray:
        """The rows the model steps take: [max_pages] for one group,
        [G, max_pages] for several."""
        return np.stack([self._phys_row(seq, g) for g in range(self.num_groups)]).reshape(
            self._groups + (self.max_pages_per_seq,))

    def _bucket_len(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest prefill bucket")

    # ------------------------------------------------------------- stepping

    def _begin_prefill(self, seq: Sequence) -> bool:
        P = self.cfg.page_tokens
        plen = seq.prompt_len
        hits: list[int] = []
        if self.prefix_cache.enabled:
            keys = page_keys(seq.req.prompt, P, self.cache_namespace)
            hits = self.prefix_cache.lookup(keys)
            if hits and len(hits) * P >= plen:
                # must compute at least the last token for its logits
                dropped = hits.pop()
                _, to_free = self.prefix_cache.release([dropped])
                if to_free:
                    self.managers[0].free(to_free)
        seq.blocks_g[0] = list(hits)
        if not self._ensure_blocks(seq, plen + 1):
            _, to_free = self.prefix_cache.release(hits)
            if to_free:
                self.managers[0].free(to_free)
            seq.blocks_g[0] = []
            return False
        seq.num_prefilled = len(hits) * P  # prefill progress (tokens written)
        return True

    def _prefill_chunk(self, seq: Sequence) -> bool:
        """Run ONE bucket-sized page-aligned chunk of seq's prompt.  Returns
        True when the prompt is fully prefilled (first token sampled)."""
        t0 = time.perf_counter()
        P = self.cfg.page_tokens
        plen = seq.prompt_len
        q_start = seq.num_prefilled
        phys = self._phys_rows(seq)  # [max_pages], or [G, max_pages]
        this_len = min(plen - q_start, max(self.cfg.prefill_buckets))
        T = self._bucket_len(this_len)
        assert T % P == 0, "prefill buckets must be multiples of page_tokens"
        tokens = np.zeros(T, np.int32)
        tokens[:this_len] = seq.req.prompt[q_start : q_start + this_len]
        positions = q_start + np.arange(T, dtype=np.int32)
        start_page = q_start // P
        n_real = -(-this_len // P)
        chunk_pages = np.zeros(phys.shape[:-1] + (T // P,), np.int32)
        chunk_pages[..., :n_real] = phys[..., start_page : start_page + n_real]
        logits, _, _ = self.adapter.prefill_step(
            self.params, self._dev(tokens), self._dev(positions),
            self.k_pools, self.v_pools, self._dev(chunk_pages),
            self._dev(phys), q_start, this_len, **self._scales_kw,
        )
        seq.num_prefilled = q_start + this_len
        if seq.num_prefilled < plen:
            logits.sum().item()  # finish the device work inside the timing
            self._account("prefill", this_len, t0)
            return False
        seq.tokens.append(self._sample_first_token(seq, logits))
        self._account("prefill", this_len, t0)
        self.running.append(seq)
        self._check_stops(seq)
        if seq.finished():  # stop string in the very first token
            self._finish_seq(seq)
        return True

    def _collect_prefill_batch(self) -> tuple[list[Sequence], bool]:
        """Pop a FIFO prefix of the waiting queue whose prompts each fit one
        bucket, admitting each; stop at a long prompt, an admission failure
        or capacity.  Also returns whether the queue head failed admission."""
        ec = self.cfg
        if ec.prefill_batch < 2:
            return [], False
        cap = min(ec.prefill_batch, ec.max_batch - len(self.running))
        if cap < 2 or len(self.waiting) < 2:
            return [], False
        max_bucket = max(ec.prefill_buckets)
        batch: list[Sequence] = []
        head_blocked = False
        while self.waiting and len(batch) < cap:
            seq = self.waiting[0]
            if seq.prompt_len > max_bucket:
                break
            if not (self._can_admit(seq) and self._begin_prefill(seq)):
                head_blocked = not batch
                break
            self.waiting.pop(0)
            batch.append(seq)
        return batch, head_blocked

    def _prefill_chunk_batch(self, seqs: list[Sequence]) -> None:
        """One batched prefill pass for N begun sequences whose remaining
        prompts share a bucket.  Identical to serial _prefill_chunk (rows
        are independent in the kernels)."""
        t0 = time.perf_counter()
        P = self.cfg.page_tokens
        T = self._bucket_len(max(s.prompt_len - s.num_prefilled for s in seqs))
        N = len(seqs)
        tokens = np.zeros((N, T), np.int32)
        positions = np.tile(np.arange(T, dtype=np.int32), (N, 1))
        chunk_pages = np.zeros((N,) + self._groups + (T // P,), np.int32)
        page_tables = np.zeros((N,) + self._groups + (self.max_pages_per_seq,), np.int32)
        q_starts = np.zeros(N, np.int32)
        true_lens = np.zeros(N, np.int32)
        for i, seq in enumerate(seqs):
            q_start = seq.num_prefilled  # page-aligned (prefix-cache hits)
            this_len = seq.prompt_len - q_start
            tokens[i, :this_len] = seq.req.prompt[q_start:]
            positions[i] += q_start
            phys = self._phys_rows(seq)
            start_page = q_start // P
            n_real = -(-this_len // P)
            chunk_pages[i, ..., :n_real] = phys[..., start_page : start_page + n_real]
            page_tables[i] = phys
            q_starts[i] = q_start
            true_lens[i] = this_len
        self._pb_dispatches += 1
        self._pb_prompts += N
        logits, _, _ = self.adapter.prefill_batch_step(
            self.params, *map(self._dev, (tokens, positions)),
            self.k_pools, self.v_pools,
            *map(self._dev, (chunk_pages, page_tables, q_starts, true_lens)),
            **self._scales_kw,
        )
        firsts = torch.argmax(logits, dim=-1).cpu().numpy()
        for i, seq in enumerate(seqs):
            if seq.req.sampling.temperature > 0:
                firsts[i] = self._sample_first_token(seq, logits[i], row=i)
        self._account("prefill", int(true_lens.sum()), t0)
        for i, seq in enumerate(seqs):
            seq.num_prefilled = seq.prompt_len
            seq.tokens.append(int(firsts[i]))
            self.running.append(seq)
            self._check_stops(seq)
            if seq.finished():
                self._finish_seq(seq)

    def _sample_first_token(self, seq: Sequence, logits, row: int = 0) -> int:
        """The prefill's token with the request's own sampling params,
        drawn from a generator keyed on (engine step, request seed, batch
        row): identical engine histories reproduce identical outputs."""
        sp = seq.req.sampling
        if sp.temperature <= 0:
            return int(torch.argmax(logits))
        dev = logits.device
        tok = _sample_tokens(
            logits[None],
            torch.tensor([sp.temperature], dtype=torch.float32, device=dev),
            torch.tensor([sp.top_k], dtype=torch.int64, device=dev),
            torch.tensor([sp.top_p], dtype=torch.float32, device=dev),
            _generator(dev, self._step_count, sp.seed, row),
            filters=sp.top_k > 0 or sp.top_p < 1.0,
        )
        return int(tok[0])

    def _row_cap(self, seq: Sequence) -> int:
        return min(self.cfg.max_model_len,
                   seq.prompt_len + seq.req.sampling.max_new_tokens)

    def _decode_horizon(self, K, tokens0, seq_lens0, page_tables, temps,
                        top_ks, top_ps, max_lens, filters, sampled):
        """K decode steps.  seq_lens0 counts tokens whose KV is written; step
        j consumes input token j at position seq_lens0 + j.  Steps past a
        row's cap (``max_lens``; 0 for padded rows) are routed to the zero
        page, where the kernel discards the write, and their lengths are
        clamped.  ``page_tables`` is [B, max_pages], or [G, B, max_pages]
        for layer groups (each group's slots from its own table).  Returns
        the sampled tokens [K, B] on the host."""
        P = self.cfg.page_tokens
        B = tokens0.shape[0]
        raw = seq_lens0[None] + np.arange(K, dtype=np.int32)[:, None] + 1  # [K, B]
        seq_lens = np.minimum(raw, max_lens[None])
        positions = np.maximum(seq_lens - 1, 0)
        tables3 = page_tables.reshape((-1,) + page_tables.shape[-2:])  # [G, B, max_pages]
        slot_pages = np.where(
            raw[None] > max_lens[None, None], 0,
            tables3[:, np.arange(B)[None], positions // P])  # [G, K, B]
        # rows: positions, offsets, lengths, then each group's slot pages;
        # step j's slots are plan[3:, j], one [B] row a group
        plan = self._dev(np.concatenate(
            [np.stack([positions, positions % P, seq_lens]), slot_pages]))
        tables = self._dev(page_tables)
        dev = self.device
        temps_t = torch.as_tensor(temps).to(dev)
        top_ks_t = torch.as_tensor(top_ks, dtype=torch.int64).to(dev)
        top_ps_t = torch.as_tensor(top_ps).to(dev)
        gen = _generator(dev, self._step_count) if sampled else None
        tokens = self._dev(tokens0)
        out = []
        scales = self._scales_kw
        for j in range(K):
            slots = plan[3:, j].reshape(self._groups + (B,))
            logits, _, _ = self.adapter.decode_step(
                self.params, tokens, plan[0, j], self.k_pools, self.v_pools,
                tables, slots, plan[1, j], plan[2, j], **scales,
            )
            tokens = _sample_tokens(logits, temps_t, top_ks_t, top_ps_t, gen,
                                    filters=filters, sampled=sampled)
            out.append(tokens)
        return torch.stack(out).cpu().numpy()

    def _do_decode(self) -> None:
        ec = self.cfg
        B = ec.max_batch
        batch = self.running[:B]
        # adaptive horizon: no step past the batch's nearest cap produces a
        # kept token, so shrink K (to a power of two) near the caps
        if ec.adaptive_horizon:
            needed = min(max(1, self._row_cap(s) - len(s.tokens)) for s in batch)
            K = min(ec.decode_horizon, 1 << (needed.bit_length() - 1))
        else:
            K = ec.decode_horizon
        batch = self._admit_running(lambda s: len(s.tokens) + K)
        if not batch:
            return
        tokens0 = np.zeros(B, np.int32)
        seq_lens0 = np.zeros(B, np.int32)
        page_tables = np.zeros(self._groups + (B, self.max_pages_per_seq), np.int32)
        temps = np.zeros(B, np.float32)
        top_ks = np.zeros(B, np.int64)
        top_ps = np.ones(B, np.float32)
        max_lens = np.zeros(B, np.int32)  # 0 for padded rows: writes discarded
        for i, seq in enumerate(batch):
            tokens0[i] = seq.tokens[-1]
            seq_lens0[i] = len(seq.tokens) - 1  # KV written so far
            page_tables[..., i, :] = self._phys_rows(seq)
            sp = seq.req.sampling
            temps[i] = sp.temperature
            top_ks[i] = sp.top_k
            top_ps[i] = sp.top_p
            max_lens[i] = self._row_cap(seq)
        # only pay the vocab sorts when some row actually filters
        filters = bool((top_ks > 0).any() or (top_ps < 1.0).any())
        t0 = time.perf_counter()
        toks = self._decode_horizon(
            K, tokens0, seq_lens0, page_tables, temps, top_ks, top_ps,
            max_lens, filters, bool((temps > 0).any()))
        self.stats["decode_steps"] += K
        kept = 0
        for i, seq in enumerate(batch):
            for j in range(K):
                seq.tokens.append(int(toks[j, i]))
                kept += 1
                if seq.finished():
                    break
            self._check_stops(seq)
            self._reclaim_slid_pages(seq)
            if seq.finished():
                # trim over-generated tokens beyond the stop point
                keep = min(seq.num_generated, seq.req.sampling.max_new_tokens)
                kept -= len(seq.tokens) - (seq.prompt_len + keep)
                seq.tokens = seq.tokens[: seq.prompt_len + keep]
                self._finish_seq(seq)
        self._account("decode", kept, t0)

    # ------------------------------------------------------------ spec decode

    def _decode_dispatch(self) -> None:
        """A spec horizon when spec decode is on and not cooling off, else
        a decode horizon.  (The JAX engine's ``_spec_ok`` also asks for a
        verify step and a stateless family: every ported family has both.)"""
        if self.cfg.spec_decode and not self._spec_cooling():
            self._do_spec_decode()
        else:
            self._do_decode()

    def _spec_cooling(self) -> bool:
        """During a cooldown the engine runs plain decode dispatches (the
        workload does not draft well even at the smallest gamma); when it
        expires, speculation retries with a fresh EMA."""
        if not self.cfg.spec_adaptive or self._spec_cooldown <= 0:
            return False
        self._spec_cooldown -= 1
        if self._spec_cooldown == 0:
            self._spec_ema = None  # retry unbiased
            self._spec_gamma_cur = min(2, self.cfg.spec_gamma)
        return True

    def _spec_update_gamma(self, drafts_per_iter: float) -> None:
        """Follow the observed acceptance with an EMA and walk the
        power-of-two gamma ladder: shrink when most drafts are rejected,
        grow when the current rung is mostly accepted, and cool off to
        plain decode when even gamma=2 yields almost nothing."""
        ema = (drafts_per_iter if self._spec_ema is None
               else 0.7 * self._spec_ema + 0.3 * drafts_per_iter)
        self._spec_ema = ema
        g = self._spec_gamma_cur
        if ema < 0.15 and g <= 2:
            self._spec_cooldown = 8
        elif ema < 0.8 and g > 2:
            self._spec_gamma_cur = g // 2
        elif ema > 0.6 * g and g * 2 <= self.cfg.spec_gamma:
            self._spec_gamma_cur = g * 2

    def _spec_horizon(self, T, S, ring0, seq_lens0, page_tables, max_lens,
                      temps, top_ks, top_ps, sampled, filters):
        """S chained verify iterations on the card.  Where the JAX engine
        jitted the S iterations into one program, the port runs a host loop
        of torch ops that never waits on the card: each iteration drafts
        gamma = T-1 tokens per row from the ring of its last W tokens
        (:func:`_ngram_draft`), routes the fed tokens to their slots,
        verifies them in one multi-query forward and accepts per
        :func:`_spec_accept`.  seq_lens0 counts tokens whose KV is written;
        ``page_tables`` is [B, max_pages], or [G, B, max_pages] for layer
        groups (each group's slots from its own table).
        Returns [S, B, T+1] on the host, in one transfer: each iteration's
        emitted tokens and, last, how many of them count (accepted drafts
        + 1)."""
        P, n, gamma = self.cfg.page_tokens, self.cfg.spec_ngram, T - 1
        B, W = ring0.shape
        dev = self.device
        ring = self._dev(ring0)
        seq_lens = self._dev(np.maximum(seq_lens0, 0))
        tables = self._dev(page_tables)
        tables3 = tables.reshape((-1,) + tables.shape[-2:])  # [G, B, max_pages]
        # position cap (the final token's slot) is never consumed, and plain
        # decode leaves it unwritten: writes go to the zero page from the cap
        # on, also for a row whose length is pinned at its cap
        cap = (self._dev(max_lens) - 1).clamp(min=0)
        steps = torch.arange(T, dtype=torch.int32, device=dev)[None]
        rows = torch.arange(B, device=dev)[:, None]
        cols = torch.arange(W, device=dev)[None]
        temps_t = torch.as_tensor(temps).to(dev)
        top_ks_t = torch.as_tensor(top_ks, dtype=torch.int64).to(dev)
        top_ps_t = torch.as_tensor(top_ps).to(dev)
        gen = _generator(dev, self._step_count) if sampled else None
        out = []
        for _ in range(S):
            drafts = _ngram_draft(ring, n, gamma)
            tokens = torch.cat([ring[:, -1:], drafts], dim=1)  # [B, T]
            raw_pos = seq_lens[:, None] + steps
            pos = torch.minimum(raw_pos, cap[:, None])
            overflow = raw_pos >= cap[:, None]  # incl. padded rows (max_lens 0)
            slot_pages = torch.where(
                overflow[None], 0, tables3[:, rows, (pos // P).long()],
            ).reshape(self._groups + (B, T))  # [B, T], or [G, B, T]
            # unclamped: query j sits at kv_lens - T + j, so clamping at the
            # cap would shift every query of the row; overflow queries'
            # outputs are discarded and their writes go to the zero page
            kv_lens = seq_lens + T
            logits, _, _ = self.adapter.verify_step(
                self.params, tokens, pos, self.k_pools, self.v_pools, tables,
                slot_pages, pos % P, kv_lens, **self._scales_kw)
            if sampled:
                toks, a = _spec_accept(logits, drafts, temps_t, top_ks_t,
                                       top_ps_t, gen, filters=filters)
            else:
                # all greedy: the longest draft prefix equal to the model's
                # own argmax; the argmax doubles as the correction
                toks = torch.argmax(logits, dim=-1).to(torch.int32)
                a = torch.cumprod((toks[:, :gamma] == drafts).to(torch.int32), dim=1).sum(dim=1)
            appended = (a + 1).to(torch.int32)
            # roll the kept tokens toks[:, :appended] into the ring
            ring = torch.gather(torch.cat([ring, toks], dim=1), 1,
                                cols + appended[:, None].long())
            seq_lens = torch.minimum(seq_lens + appended, cap)
            out.append(torch.cat([toks, appended[:, None]], dim=1))
        return torch.stack(out).cpu().numpy()

    def _do_spec_decode(self) -> None:
        """One speculative horizon: S verify iterations, each drafting and
        verifying gamma tokens per row and keeping the accepted prefix.
        Greedy rows are token-exact vs plain decode by construction; sampled
        rows are distribution-exact."""
        ec = self.cfg
        B = ec.max_batch
        gamma = self._spec_gamma_cur if ec.spec_adaptive else ec.spec_gamma
        T = gamma + 1
        S = ec.spec_horizon
        W = max(ec.spec_window, ec.spec_ngram + gamma + 1)
        batch = self.running[:B]
        # adaptive horizon: each iteration advances a row by >= 1 token, so
        # near the batch's nearest cap S shrinks to a power of two
        if ec.adaptive_horizon and batch:
            needed = min(max(1, self._row_cap(s) - len(s.tokens)) for s in batch)
            if needed < S:
                S = min(1 << (needed.bit_length() - 1), ec.spec_horizon)
        # a dispatch advances a row by at most S*T tokens (up to its cap)
        batch = self._admit_running(
            lambda s: min(len(s.tokens) + S * T, self._row_cap(s)))
        if not batch:
            return
        ring = np.full((B, W), -1, np.int32)  # -1 pad: matches no n-gram
        seq_lens0 = np.zeros(B, np.int32)
        page_tables = np.zeros(self._groups + (B, self.max_pages_per_seq), np.int32)
        max_lens = np.zeros(B, np.int32)  # 0 for padded rows: all discarded
        temps = np.zeros(B, np.float32)
        top_ks = np.zeros(B, np.int64)
        top_ps = np.ones(B, np.float32)
        for i, seq in enumerate(batch):
            tail = seq.tokens[-W:]
            ring[i, W - len(tail):] = tail
            seq_lens0[i] = len(seq.tokens) - 1  # KV written so far
            page_tables[..., i, :] = self._phys_rows(seq)
            max_lens[i] = self._row_cap(seq)
            sp = seq.req.sampling
            temps[i], top_ks[i], top_ps[i] = sp.temperature, sp.top_k, sp.top_p
        sampled = bool((temps > 0).any())
        filters = sampled and bool((top_ks > 0).any() or (top_ps < 1.0).any())
        t0 = time.perf_counter()
        packed = self._spec_horizon(T, S, ring, seq_lens0, page_tables, max_lens,
                                    temps, top_ks, top_ps, sampled, filters)
        outs, counts = packed[..., :-1], packed[..., -1]  # [S, B, T], [S, B]
        self._spec_dispatches += 1
        self.stats["decode_steps"] += S
        if ec.spec_adaptive:
            # counts are accepted drafts + 1; real rows only
            self._spec_update_gamma(float(counts[:, : len(batch)].mean()) - 1.0)
        kept = 0
        for i, seq in enumerate(batch):
            for it in range(S):
                if seq.finished():
                    break
                self._spec_iterations += 1
                for j in range(int(counts[it, i])):
                    seq.tokens.append(int(outs[it, i, j]))
                    kept += 1
                    if seq.finished():
                        break
            self._check_stops(seq)
            self._reclaim_slid_pages(seq)
            if seq.finished():
                self._finish_seq(seq)
        self._spec_tokens += kept
        self._account("decode", kept, t0)

    def _account(self, kind: str, tokens: int, t0: float) -> None:
        self.stats[kind + "_tokens"] += tokens
        self.stats[kind + "_seconds"] += time.perf_counter() - t0

    def _check_stops(self, seq: Sequence) -> None:
        """Stop-STRING detection: decode the generated tail and finish the
        sequence when a stop string appears, keeping the text truncated
        before its earliest occurrence.  Runs once per dispatch; truncation
        is by text position, so the result equals per-token checking."""
        sp = seq.req.sampling
        if (not sp.stop or self.tokenizer is None or seq.stop_hit
                or seq.num_generated == 0):
            return
        text = self.tokenizer.decode(seq.tokens[seq.prompt_len:])
        hits = [i for i in (text.find(s) for s in sp.stop) if i != -1]
        if hits:
            seq.stop_hit = True
            seq.output_text = text[: min(hits)]

    def _finish_seq(self, seq: Sequence) -> None:
        self.running.remove(seq)
        self._free_seq(seq)
        self.finished_outputs.append(RequestOutput(
            seq.req.req_id, seq.req.prompt, seq.tokens[seq.prompt_len:],
            output_text=seq.output_text))

    def _can_admit(self, seq: Sequence) -> bool:
        """Admission watermark: room in every group for the prompt plus one
        decode horizon plus a page of margin (prevents admit→grow→preempt
        churn)."""
        target = self._blocks_needed(seq.prompt_len + self.cfg.decode_horizon) + 1
        for g in range(self.num_groups):
            avail = self.managers[g].available_size() + (
                self.prefix_cache.num_evictable if g == 0 else 0)
            if avail < target - len(seq.blocks_g[g]):
                return False
        return True

    def step(self) -> None:
        """One scheduler iteration: one prefill chunk, or one decode
        horizon.  A long prompt's chunks interleave with decode (chunk on
        odd steps, decode on even)."""
        self._step_count += 1
        if self._prefilling is not None:
            if not self.running or self._step_count % 2:
                if self._prefill_chunk(self._prefilling):
                    self._prefilling = None
            else:
                self._decode_dispatch()
            return
        if self.waiting and len(self.running) < self.cfg.max_batch:
            # burst admission alternates with decode when rows are running
            if self.running and self._step_count % 2 == 0:
                self._decode_dispatch()
                return
            batch, head_blocked = self._collect_prefill_batch()
            if len(batch) >= 2:
                self._prefill_chunk_batch(batch)
                return
            if len(batch) == 1:
                self._prefill_chunk(batch[0])
                return
            seq = self.waiting[0]
            if not head_blocked and self._can_admit(seq) and self._begin_prefill(seq):
                self.waiting.pop(0)
                if not self._prefill_chunk(seq):
                    self._prefilling = seq
                return
            if not self.running:
                # nothing running and nothing admissible: pick up a resize
                # target via a no-op alloc and wait for operator action
                for m in self.managers:
                    m.alloc(0)
                time.sleep(0.01)
                return
        if self.running:
            self._decode_dispatch()

    # ------------------------------------------------------------- frontends

    def generate(self, prompts: Seq[Seq[int]],
                 sampling: SamplingParams | None = None) -> list[RequestOutput]:
        ids = [self.add_request(list(p), sampling) for p in prompts]
        want = set(ids)
        while self.has_unfinished() and want - {o.req_id for o in self.finished_outputs}:
            self.step()
        by_id = {o.req_id: o for o in self.finished_outputs}
        return [by_id[i] for i in ids]

    # ------------------------------------------------------------- metrics

    @property
    def ipc_name(self) -> str | None:
        """The shm control-plane segment (``kvctl limit`` target)."""
        tracker = self.managers[0]._tracker
        return tracker.ipc_name if tracker is not None else None

    def kv_metrics(self) -> dict:
        out = {
            "mapped_bytes": sum(m.get_mapped_memory_size() for m in self.managers),
            "in_use_pages": sum(m.page_allocator.num_in_use for m in self.managers),
            "reserved_pages": sum(m.page_allocator.num_reserved for m in self.managers),
            # what gates admission: the scarcest group
            "available_blocks": min(m.available_size() for m in self.managers),
            "running": len(self.running),
            "waiting": len(self.waiting),
            "prefilling": int(self._prefilling is not None),
            "preemptions": self._preempt_count,
            "prefix_cache": self.prefix_cache.get_usage(),
            "throughput": dict(self.stats),
        }
        if self.cfg.prefill_batch > 1:
            out["prefill_batch"] = {
                "dispatches": self._pb_dispatches,
                "prompts": self._pb_prompts,
                "prompts_per_dispatch": (
                    self._pb_prompts / self._pb_dispatches
                    if self._pb_dispatches else 0.0),
            }
        if self.cfg.spec_decode:
            out["spec"] = {
                "dispatches": self._spec_dispatches,
                "tokens": self._spec_tokens,
                "tokens_per_dispatch": (
                    self._spec_tokens / self._spec_dispatches
                    if self._spec_dispatches else 0.0),
                # tokens a row keeps per verify iteration: 1 + accepted drafts
                "iterations": self._spec_iterations,
                "tokens_per_iteration": (
                    self._spec_tokens / self._spec_iterations
                    if self._spec_iterations else 0.0),
            }
            if self.cfg.spec_adaptive:
                out["spec"]["gamma"] = self._spec_gamma_cur
                out["spec"]["acceptance_ema"] = self._spec_ema
                out["spec"]["cooldown"] = self._spec_cooldown
        if self.num_groups > 1:
            out["groups"] = [
                {"window": self.group_windows[g],
                 "in_use_pages": self.managers[g].page_allocator.num_in_use,
                 "mapped_bytes": self.managers[g].get_mapped_memory_size()}
                for g in range(self.num_groups)
            ]
        return out

    def shutdown(self) -> None:
        for m in self.managers:
            m.shutdown()
