#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kvcached_tpu_torch``) on one
NVIDIA H100.

Run from the repository root, on a machine with one CUDA card, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the five CUDA kernel sources are compiled from
   ``kvcached_tpu_torch/csrc`` into eight libraries (K1's, K3's and K4's
   sources once more at head_dim 256; one nvcc per library, in parallel),
   with ptxas' register counts and spill bytes;
3. kernels: K1, K1r, K2, K3 and K4 against their plain PyTorch versions on
   the card at Llama-3-8B shapes (B=8, KH=8, QH=32, D=128, 64-token pages,
   contexts 512-2048 on shuffled pages, a windowed case, a K3 batch with
   q_start > 0 and a kv_len = 0 row, K4 with T=5 fed tokens, a row
   overhanging its table and a row whose writes are all discarded), and the
   MLA kernels K5 (decode), K5v (verify, T=5), K6 and K3m at
   DeepSeek-V2-Lite's widths (one latent kv head of 640 lanes, values the
   first 512, 16 query heads, the same contexts and cases): pool writes
   bit-exact, outputs within 2e-2 at bf16 and 1e-4 at float32 (TF32 off);
   each kernel's device time (calls back to back) and its time a call from
   the host, the plain version's and SDPA's, beside the kernel's bound;
   and the soft-capped mode of K1, K1r, K3 and K4 at Gemma-2-27B's widths
   (KH=16, QH=32, sm_scale 1/12, cap 50, windows none, 4096 and 1024) on
   bf16, float32, int8 and e4m3 pools, q scaled so that the scores reach
   several times the cap: within the same tolerances, while the uncapped
   plain output must lie more than ten tolerances away (the control), and
   the bf16 rows and K4's byte rows timed beside the same kernel uncapped
   and beside flex_attention with the cap as its score_mod; and K1, K1r,
   K2, K3 and K4 at head_dim 256, Gemma-2-9B's widths (KH=8, QH=16,
   sm_scale 1/16, cap 50, windows none, 4096 and 1024) on every pool type,
   soft-capped, with the same control, the bf16 and byte rows timed beside
   the same kernel at head_dim 128 on otherwise the same shapes, uncapped,
   and beside flex_attention;
4. engine: ``LLMEngine`` serves Llama-3-8B at full width (32 layers, bf16,
   weights drawn on the card from a seed) for 8 requests: a prefix-cache
   hit, a prompt longer than the largest prefill bucket, batched prefill,
   greedy rows and a seeded sampled row, 64 new tokens each.  Every kernel
   launch counter is zeroed just before and read just after; each must be
   > 0.  The kernel path's last-position logits (prefill, decode, and a
   verify step of T fed tokens) are held against the plain path's on the
   card (norm-relative error <= 1e-2 at float32; the bf16 error is printed
   beside bf16's own distance from float32);
5. elastic: mid-run, a child process shrinks and then grows the pool through
   ``kvcached_tpu_torch.shm.update_kv_cache_limit``; ``kv_metrics`` must
   show both, and the outputs must be md5-identical to an unconstrained run;
6. real weights: the committed tinyadd (Llama) and winadd (Qwen2, windowed)
   checkpoints through the port's loader at float32, served greedily by the
   kernel path on the card and by the plain path on the CPU: identical
   tokens, with and without speculative decoding (winadd's window runs
   through K4); winadd's exact match over 32 held-out examples;
7. speculative decoding at full width: (a) Llama-3-8B at float32 serves 4
   requests x 32 tokens with ``spec_decode=True, spec_exact=True`` and
   without: identical greedy tokens; (b) at bf16, 8 requests x 64 tokens
   (half of the prompts repetitive) with and without spec decode, then
   each half alone: decode tok/s, tokens per verify iteration, and the
   device busy share of one spec dispatch.  The launch counters are zeroed
   just before the mixed spec run and read just after; K4's must be > 0.
   Phase 7 runs before phase 6, while the 8B weights are loaded;
8. MLA, after the 8B weights are freed (before phase 6): ``LLMEngine``
   serves the MLA family at DeepSeek-V2-Lite's widths (bf16, 2.61 B
   parameters drawn on the card from a seed) for phase 4's request mix,
   (a) without and (b) with spec decode, the launch counters zeroed just
   before and read just after each (K5, K6, K3m, and K5v with spec decode,
   each > 0); (c) on int8 and e4m3 latent pools: the pages one HBM budget
   holds (twice bf16's), phase 4's mix on each (K5, K6, K3m of each mode
   > 0), the float32 logits gate of phase 9 at 3e-2 and float32 spec
   tokens identical to plain decode on each (K5v of each mode > 0),
   GREW/SHRANK/CORRECT on int8 (the same function as phase 9); (d) the kernel path's last-position logits (prefill, decode,
   verify) within 1e-2 of the plain path's at float32; (e) float32 spec
   tokens identical to plain decode; (f) GREW/SHRANK/CORRECT under a live
   limit;
9. byte KV pools, after phase 7 while the 8B weights are loaded: the pages
   one HBM budget holds at bf16, int8 and e4m3 (a byte pool twice bf16's);
   phase 4's request mix on an int8 and on an e4m3 pool (launch counters
   zeroed just before and read just after, by pool type: K1, K2, K3 of each
   mode > 0), tok/s and one decode dispatch's device busy share; at float32
   on each byte pool, the kernel path's last-position logits within 1e-2 of
   the plain path's while the byte pool's own effect on the plain path
   exceeds 1e-2, the two paths' pools equal at layer 0 (an int8 pool's
   layer 1 differing only to neighbouring codes), and spec
   decode's greedy tokens identical to plain decode (K4's launches of each
   mode > 0); GREW/SHRANK/CORRECT on an int8 pool.  Phase 3 runs K1, K1r, K2, K3, K4 and the MLA kernels K5, K5v, K6
   and K3m on int8 and e4m3 pools too (bf16 q and new K/V, int8 scales per
   (layer, kv head), one a layer for the latent pool; pools bit-exact,
   outputs within 2e-2; K2 and K6 write the reference's edge values: int8
   halfway steps and clipping, e4m3 460, 464, 470, -500 and inf);
10. the hybrid family (``models/hybrid.py``: sliding and full layer groups
   on one shared arena) at Gemma-2-27B's widths, after every earlier model
   is freed: (a) a float32 model of those widths at 4 layers, last-position
   logits of a 4200-token prompt (past the 4096 window) and a decode step,
   kernel path vs plain path <= 1e-2 norm-relative, with the share of
   logits the final soft-cap moved; (b) the bf16 model at all 46 layers
   (~28.4 B parameters drawn on the card from seed 0, 712 arena pages)
   serving phase 4's request mix plus a 4200-token prompt, the launch
   counters zeroed just before and read just after (soft-capped K1 and K3
   and K2 > 0), the sliding group freeing pages of the long request while
   the full group keeps all of its own, both groups' pages from one arena,
   tok/s and one decode dispatch under torch.profiler; (c)
   GREW/SHRANK/CORRECT through a limit on the full group's segment
   (``_g1``); (d) float32 spec decode at 4 layers: greedy tokens identical
   to plain decode; (e) the bf16 model at 46 layers serving phase 4's mix
   without and with spec decode (soft-capped K4 > 0 over the spec run),
   tok/s, tokens per verify iteration, one spec dispatch under
   torch.profiler; (f) int8 and e4m3 arenas, phase 9's checks
   (``phase_byte_pools``: pages per 8 GiB budget, twice bf16's; phase 4's
   mix, soft-capped K1 and K3 and K2 of each mode > 0; the 4-layer float32
   logits gate with the byte pool's own effect above it, spec tokens equal
   to plain decode's, soft-capped K4 of each mode > 0; GREW/SHRANK/CORRECT
   on int8 through ``_g1``).  Part (a)'s logits include a verify step;
   (d) and (f)'s float32 part run after (a), on its 4-layer model.
   ``torch.cuda.memory_allocated`` is logged before each load;
11. Gemma-2-9B (head_dim 256, query width 4096 against hidden 3584), after
   phase 10's model is freed: phase 10's parts (a)-(f) through the same
   function at its widths (42 layers, 10.2 B parameters, 780 bf16 and 1560
   byte arena pages of 21 layers), log tag ``[gemma9]``; the head_dim 256
   launches (K1, K2, K3 in (b) and (f), K4 in (e) and (f)) must be > 0.

The line before last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.  ``--rehearse`` runs the control flow
on the CPU at toy sizes (plain versions only) and exits 3 without a result;
``--kernels-only`` stops after phase 3 and exits 4 without a result.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time
import uuid

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_TOL, F32_TOL, LOGITS_REL_TOL = 2e-2, 1e-4, 1e-2
#: the float32 logits gate on the MLA model's byte latent pools: the kernel
#: path read 1.15e-2 (int8) and 1.68e-2 (e4m3) from the plain path on the
#: H100, while a byte pool itself moves the plain path's logits 5.95e-2 to
#: 0.152 from a float32 pool's, which this gate must refuse; a code that
#: lands one step away at a rounding boundary moves the 27-layer model more
#: than Llama-3-8B's (1e-2, read 2.6e-3 to 4.0e-3)
MLA_BYTE_LOGITS_TOL = 3e-2
HOLD_CYCLES = 60_000_000  # ~30 ms at the H100's clocks: longer than any enqueue below

CARD = dict(
    B=8, KH=8, QH=32, D=128, TP=64, L=4, contexts=(512, 2048, 768, 1536, 1024, 1792, 640, 1280),
    window=1024, prefill_T=512, model="llama3_8b", max_new=64, shared_prefix=256,
    buckets=(256, 512), long_prompt=700, iters=20, spec_T=5, spec_new_exact=32,
    # the MLA kernels at DeepSeek-V2-Lite's widths (MLAConfig.deepseek_v2_lite:
    # 16 heads, a 512 + 64-lane latent padded to 640, sm_scale 1/sqrt(128 + 64))
    mla_model="deepseek_v2_lite", MLA_H=16, MLA_D=640, MLA_R=512, MLA_SCALE=192 ** -0.5,
    # the soft-capped K1 and K3 take their widths from the hybrid model
    # (hybrid_config); q scaled by 40 so that the scores reach ~3x the cap
    G_QSCALE=40.0,
    # phase 10: Gemma-2-27B, a 4200-token prompt (past the 4096 window), 712
    # arena pages of 23 layers (~8 GiB)
    hyb_model="gemma2_27b", hyb_long=4200, hyb_pages=712, hyb_max_len=8192,
    # phase 11 (and phase 3's head_dim 256 rows): Gemma-2-9B, 780 arena
    # pages of 21 layers at head_dim 256 (~8 GiB)
    hyb9_model="gemma2_9b", hyb9_pages=780,
)
REHEARSE = dict(
    B=3, KH=2, QH=4, D=128, TP=32, L=2, contexts=(40, 70, 23), window=24,
    prefill_T=32, model="toy", max_new=48, shared_prefix=32, buckets=(32, 64),
    long_prompt=90, iters=2, spec_T=5, spec_new_exact=8,
    mla_model="toy", MLA_H=4, MLA_D=256, MLA_R=128, MLA_SCALE=128 ** -0.5,
    G_QSCALE=40.0,
    hyb_model="toy", hyb_long=90, hyb_pages=96, hyb_max_len=256, hyb_window=32,
    hyb9_model="toy256", hyb9_pages=96,
)


def log(*a):
    print(*a, flush=True)


def require(ok, what):
    """A gate: raise (and so exit nonzero) when ``ok`` is false."""
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi prints them
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} cards {torch.cuda.device_count()}")
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build():
    from kvcached_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    secs = time.perf_counter() - t0
    log(f"[build] {len(paths)} kernel libraries in {secs:.1f} s -> {_build.build_dir()}")
    for name in paths:
        logf = os.path.join(_build.build_dir(), name + ".log")
        if os.path.exists(logf):
            for line in open(logf):
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
    return secs


# ---------------------------------------------------------------------------
# 3. kernels vs plain versions
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters, hold=True):
    """Mean time of fn over ``iters`` calls (CUDA events, after a warm-up);
    fn cycles the pool layer itself so the K/V reads are cold.  ``hold``: a
    sleep kernel holds the stream while the host enqueues the calls, so the
    events time the device's work back to back, without the host's launch
    gaps (a call that waits on the device, as the plain versions' boolean
    indexing does, keeps its gaps).  ``hold=False`` times what a caller
    that launches one call at a time pays."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def _dev_time(e):
    """A profiler event's own device time (us), across torch versions."""
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def kernel_parts(torch, fn, iters):
    """Device ms per call of each CUDA kernel that ``fn`` launches, from
    torch.profiler over ``iters`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    name = lambda key: re.sub(r"^void |\(anonymous namespace\)::", "", key).split("<")[0].split("(")[0]  # noqa: E731
    return {name(e.key): round(_dev_time(e) / 1e3 / iters, 4) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _dev_time(e) > 0}


def bound(bytes_, flops, f32_ops=0):
    """(least ms, what bounds it): the bytes over the memory rate, or the
    tensor-core operations over their peak, or ``f32_ops`` (the soft-cap's
    tanh a score, counted as one operation) over the float32 rate of the
    CUDA cores, which run beside the tensor cores: the largest."""
    t_b = bytes_ / HBM_BYTES_PER_S
    t_f = max(flops / BF16_FLOPS_PER_S, f32_ops / F32_FLOPS_PER_S)
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def is_byte(torch, dtype):
    """int8 and e4m3 pools: quantized on write, bf16 q and operands."""
    return dtype in (torch.int8, torch.float8_e4m3fn)


def _same_bytes(torch, a, b):
    """Pools equal byte for byte (an e4m3 NaN never equals itself)."""
    if a.element_size() == 1:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return bool(torch.equal(a, b))


class KernelCase:
    """Shared inputs at the main path's decode/prefill shapes.  Byte pools
    hold quantized N(0, 1) values (int8 with per-(layer, kv head) scales
    ``self.scales``), and their q and new K/V are bf16, as the bf16 model
    hands them over."""

    def __init__(self, torch, dev, S):
        self.torch, self.dev, self.S = torch, dev, S
        g = torch.Generator(device=dev).manual_seed(0)
        self.g = g
        self.scales = tuple(0.02 + 0.03 * torch.rand((S["L"], S["KH"]), generator=g,
                                                      device=dev) for _ in range(2))
        B, TP = S["B"], S["TP"]
        self.maxp = max(-(-c // TP) for c in S["contexts"])
        self.P = 1 + B * self.maxp + 4 * (S["prefill_T"] // TP + self.maxp)
        perm = (torch.randperm(self.P - 1, generator=g, device=dev) + 1).to(torch.int32)
        self.perm = perm
        pt = torch.zeros((B, self.maxp), dtype=torch.int32, device=dev)
        for b, c in enumerate(S["contexts"]):
            n = -(-c // TP)
            pt[b, :n] = perm[b * self.maxp: b * self.maxp + n]
        self.page_tables = pt
        self.seq_lens = torch.tensor(S["contexts"], dtype=torch.int32, device=dev)
        pos = (self.seq_lens - 1).long()
        self.slot_pages = pt[torch.arange(B, device=dev), pos // TP].contiguous()
        self.slot_offsets = (pos % TP).to(torch.int32)

    def randn(self, shape, dtype):
        return self.torch.randn(shape, generator=self.g, device=self.dev).to(dtype)

    def io(self, dtype):
        """The type of q and the new K/V given to the kernels of a pool."""
        return self.torch.bfloat16 if is_byte(self.torch, dtype) else dtype

    def scale_kw(self, dtype):
        """The attention kernels' int8 scale arguments (none for others)."""
        if dtype != self.torch.int8:
            return {}
        return dict(k_scales=self.scales[0], v_scales=self.scales[1])

    def pools(self, dtype):
        from kvcached_tpu_torch.ops import quantize_kv

        S = self.S
        shape = (S["L"], self.P, S["KH"], S["TP"], S["D"])
        if is_byte(self.torch, dtype):
            k, v = (quantize_kv(self.randn(shape, self.torch.float32), dtype,
                                sc[:, None, :, None, None]) for sc in self.scales)
        else:
            k, v = self.randn(shape, dtype), self.randn(shape, dtype)
        k[:, 0] = 0
        v[:, 0] = 0
        return k, v

    def gather(self, pool, layer, table, which):
        """Layer ``layer`` of ``pool`` gathered through ``table`` into a
        contiguous [N, KH, width, D] in the pool's compute type: a byte
        pool dequantized to bf16 (``which`` 0 = K, 1 = V scales), the
        library yardstick's input."""
        torch = self.torch
        N, KH, D = table.shape[0], pool.shape[2], pool.shape[4]
        x = pool[layer][table.long()].permute(0, 2, 1, 3, 4).reshape(N, KH, -1, D)
        if is_byte(torch, pool.dtype):
            x = x.float()
            if pool.dtype == torch.int8:
                x = x * self.scales[which][layer][None, :, None, None]
            x = x.to(torch.bfloat16)
        return x.contiguous()


def _err(torch, a, b):
    return (a.float() - b.float()).abs().max().item()


def soft_cap_kw(cap):
    """The attention wrappers' keywords of a soft-capped case (``cap``:
    its sm_scale, cap and query scale; None: an uncapped case)."""
    return {} if cap is None else dict(sm_scale=cap["sm_scale"], logit_softcap=cap["softcap"])


def flex_softcap(torch, q4, qpos, kv_len, width, window, cap):
    """The soft-capped rows' library yardstick: one call of PyTorch's
    flex_attention computing the same function, the cap as its score_mod
    and the causal, length and window mask as its block mask, on gathered,
    contiguous K/V ``[N, KH, width, D]`` (q4 ``[N, QH, Tq, D]``; ``qpos``
    ``[N, Tq]`` each query's position, ``kv_len`` ``[N]``).  Compiled, as
    flex_attention is meant to run (its eager form is an unfused
    fallback); only this script calls it.  Returns ``(k, v) -> out``."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    c = cap["softcap"]

    def mask_mod(b, h, qi, ki):
        p = qpos[b, qi]
        m = (ki <= p) & (ki < kv_len[b])
        return m & (ki > p - window) if window else m

    def score_mod(s, b, h, qi, ki):
        return c * torch.tanh(s * (1.0 / c))

    N, _, Tq, _ = q4.shape
    block_mask = create_block_mask(mask_mod, N, None, Tq, width, device=q4.device)
    fa = torch.compile(flex_attention, dynamic=False)
    return lambda k, v: fa(q4, k, v, score_mod=score_mod, block_mask=block_mask,
                           scale=cap["sm_scale"], enable_gqa=True)


def kernel_decode(torch, ops, F, case, dtype, window, timed, cap=None):
    """K1 (fused write + attend) and K1r (read-only) vs plain.  With ``cap``
    (the soft-capped mode) q is scaled so that the scores reach several
    times the cap, and each row also holds the uncapped plain output's
    distance from the capped one (the control).  ``timed``: False (the
    check alone), True (the row's times, bound and yardstick) or
    ``"kernel"`` (the check and the kernels' device time alone, as
    :func:`kernel_prefill_write`, :func:`kernel_prefill` and
    :func:`kernel_verify` take it too)."""
    S = case.S
    B, KH, QH, D, L = S["B"], S["KH"], S["QH"], S["D"], S["L"]
    kp, vp = case.pools(dtype)
    q = case.randn((B, QH, D), case.io(dtype))
    if cap is not None:
        q = (q.float() * cap["q_scale"]).to(q.dtype)
    kn, vn = case.randn((B, KH, D), case.io(dtype)), case.randn((B, KH, D), case.io(dtype))
    kw = dict(case.scale_kw(dtype), **soft_cap_kw(cap))
    args = (case.page_tables, case.seq_lens)
    slots = (case.slot_pages, case.slot_offsets)
    kp2, vp2 = kp.clone(), vp.clone()
    out_k, _, _ = ops.paged_attention_decode(q, kp, vp, *args, 1, kn, vn, *slots,
                                             window=window, **kw)
    out_p, _, _ = ops.paged_attention_decode_plain(q, kp2, vp2, *args, 1, kn, vn, *slots,
                                                   window=window, **kw)
    res = {"K1": dict(pools_bit_exact=_same_bytes(torch, kp, kp2) and _same_bytes(torch, vp, vp2),
                      max_abs_err=_err(torch, out_k, out_p))}
    ro_k = ops.paged_attention(q, kp, vp, *args, 2, window=window, **kw)
    ro_p = ops.paged_attention_decode_plain(q, kp, vp, *args, 2, None, None, None, None,
                                            window=window, write_kv=False, **kw)[0]
    res["K1r"] = dict(max_abs_err=_err(torch, ro_k, ro_p))
    if cap is not None:
        nocap = {k: v for k, v in kw.items() if k != "logit_softcap"}
        uncapped = ops.paged_attention_decode_plain(
            q, kp2.clone(), vp2.clone(), *args, 1, kn, vn, *slots, window=window, **nocap)[0]
        res["K1"]["uncapped_err"] = _err(torch, uncapped, out_p)
        uncapped = ops.paged_attention_decode_plain(
            q, kp, vp, *args, 2, None, None, None, None, window=window, write_kv=False,
            **nocap)[0]
        res["K1r"]["uncapped_err"] = _err(torch, uncapped, ro_p)
    torch.cuda.synchronize()
    if not timed:
        return res
    it = S["iters"]
    eff = [min(c, window) if window else c for c in S["contexts"]]
    isz, qsz = kp.element_size(), q.element_size()
    kv_bytes = sum(eff) * KH * D * isz * 2
    io_bytes = 2 * B * QH * D * qsz + B * case.maxp * 4 + B * 4
    flops = 4 * QH * D * sum(eff)
    cyc = iter(range(10 ** 9))
    lay = lambda: next(cyc) % L  # noqa: E731
    k1 = lambda: ops.paged_attention_decode(  # noqa: E731
        q, kp, vp, *args, lay(), kn, vn, *slots, window=window, **kw)
    k1r = lambda: ops.paged_attention(q, kp, vp, *args, lay(), window=window, **kw)  # noqa: E731
    if timed == "kernel":  # the kernels' device time alone
        res["K1"]["ms"], res["K1r"]["ms"] = time_ms(torch, k1, it), time_ms(torch, k1r, it)
        return res
    res["K1"].update(
        ms=time_ms(torch, k1, it), host_ms=time_ms(torch, k1, it, hold=False),
        plain_ms=time_ms(torch, lambda: ops.paged_attention_decode_plain(
            q, kp, vp, *args, lay(), kn, vn, *slots, window=window, **kw), it))
    res["K1"]["bound_ms"], res["K1"]["bound_by"] = bound(
        kv_bytes + io_bytes + 2 * B * KH * D * (qsz + isz) + 2 * B * 4, flops,
        QH * sum(eff) if cap is not None else 0)
    Sx = case.maxp * S["TP"]
    gathered = [(case.gather(kp, layer, case.page_tables, 0),
                 case.gather(vp, layer, case.page_tables, 1)) for layer in range(L)]
    q4 = q[:, :, None, :]
    res["K1r"].update(
        ms=time_ms(torch, k1r, it), host_ms=time_ms(torch, k1r, it, hold=False),
        plain_ms=time_ms(torch, lambda: ops.paged_attention_decode_plain(
            q, kp, vp, *args, lay(), None, None, None, None, window=window,
            write_kv=False, **kw), it))
    res["K1r"]["bound_ms"], res["K1r"]["bound_by"] = bound(
        kv_bytes + io_bytes, flops, QH * sum(eff) if cap is not None else 0)
    if cap is not None:
        res["K1"]["nocap_ms"] = time_ms(torch, lambda: ops.paged_attention_decode(
            q, kp, vp, *args, lay(), kn, vn, *slots, window=window, **nocap), it)
        res["K1r"]["nocap_ms"] = time_ms(torch, lambda: ops.paged_attention(
            q, kp, vp, *args, lay(), window=window, **nocap), it)
        # yardstick: flex_attention with the cap as its score_mod; layer 1
        # holds the token written above, K1r read layer 2
        lens = case.seq_lens.long()
        flex = flex_softcap(torch, q4, (lens - 1)[:, None], lens, Sx, window, cap)
        res["K1"]["library_err"] = _err(torch, flex(*gathered[1])[:, :, 0], out_p)
        # the timed K1 calls wrote layer 2's slots since: K1r's plain output anew
        ro_p = ops.paged_attention_decode_plain(q, kp, vp, *args, 2, None, None, None, None,
                                                window=window, write_kv=False, **kw)[0]
        res["K1r"]["library_err"] = _err(torch, flex(*gathered[2])[:, :, 0], ro_p)
        res["K1"]["library_ms"] = res["K1r"]["library_ms"] = time_ms(
            torch, lambda: flex(*gathered[lay()]), it)
        return res
    # yardstick: one SDPA call on the gathered, contiguous (dequantized) K/V
    # of each layer
    pos = torch.arange(Sx, device=case.dev)[None]
    valid = pos < case.seq_lens[:, None]
    if window:
        valid &= pos >= (case.seq_lens[:, None] - window).clamp(min=0)
    mask = valid[:, None, None, :]
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, *gathered[lay()], attn_mask=mask, enable_gqa=True), it)
    res["K1"]["library_ms"] = res["K1r"]["library_ms"] = lib
    return res


def kernel_prefill_write(torch, ops, case, dtype, timed):
    """K2; into byte pools also the reference's edge values: int8 steps
    exactly halfway (round half to even) and past ±127 (clipped); e4m3
    460 and 464 (448), 470, -500 and inf (NaN: no saturation)."""
    S = case.S
    KH, D, TP, T, L = S["KH"], S["D"], S["TP"], S["prefill_T"], S["L"]
    n = T // TP
    kp, vp = case.pools(dtype)
    kn, vn = case.randn((KH, T, D), case.io(dtype)), case.randn((KH, T, D), case.io(dtype))
    kw = {}
    if dtype == torch.int8:
        kw = dict(k_scale=case.scales[0][1].clone(), v_scale=case.scales[1][1])
        kw["k_scale"][0] = 0.5
        kn[0, 0, :6] = torch.tensor([0.25, 0.75, 1.25, -0.25, -0.75, 100.0])
    elif dtype == torch.float8_e4m3fn:
        kn[0, 0, :6] = torch.tensor([460.0, 464.0, 470.0, -500.0, float("inf"), 1e-9])
    pages = case.perm[-n:].clone()
    pages[1] = 0  # a discarded chunk
    kp2, vp2 = kp.clone(), vp.clone()
    ops.write_prefill_kv(kp, vp, kn, vn, pages, 1, **kw)
    ops.write_prefill_kv_plain(kp2, vp2, kn, vn, pages, 1, **kw)
    torch.cuda.synchronize()
    res = dict(pools_bit_exact=_same_bytes(torch, kp, kp2) and _same_bytes(torch, vp, vp2),
               max_abs_err=0.0 if is_byte(torch, dtype) else _err(torch, kp, kp2))
    if is_byte(torch, dtype):
        edge = kp[1, int(pages[0]), 0, 0, :6].view(torch.uint8).tolist()
        want = ([0, 2, 2, 0, 0xFE, 0x7F] if dtype == torch.int8
                else [0x7E, 0x7E, 0x7F, 0xFF, 0x7F, 0x00])
        res["edge_values_ok"] = edge == want
    if not timed:
        return res
    it = S["iters"]
    cyc = iter(range(10 ** 9))
    lay = lambda: next(cyc) % L  # noqa: E731
    k2 = lambda: ops.write_prefill_kv(kp, vp, kn, vn, pages, lay(), **kw)  # noqa: E731
    if timed == "kernel":  # the kernel's device time alone
        res["ms"] = time_ms(torch, k2, it)
        return res
    res["ms"], res["host_ms"] = time_ms(torch, k2, it), time_ms(torch, k2, it, hold=False)
    res["plain_ms"] = time_ms(
        torch, lambda: ops.write_prefill_kv_plain(kp, vp, kn, vn, pages, lay(), **kw), it)
    live = int((pages != 0).sum())
    res["bound_ms"], res["bound_by"] = bound(
        2 * live * KH * TP * D * (kn.element_size() + kp.element_size()) + n * 4, 0)
    if is_byte(torch, dtype):
        res["library_ms"] = None  # no one PyTorch call quantizes and scatters
        return res
    keep = (pages != 0).nonzero().squeeze(1)
    idx = pages[keep].long()
    kc = kn.reshape(KH, n, TP, D).transpose(0, 1)[keep].contiguous()
    vc = vn.reshape(KH, n, TP, D).transpose(0, 1)[keep].contiguous()

    def lib():
        layer = lay()
        kp[layer].index_copy_(0, idx, kc)
        vp[layer].index_copy_(0, idx, vc)

    res["library_ms"] = time_ms(torch, lib, it)
    return res


def kernel_prefill(torch, ops, F, case, dtype, window, timed, cap=None):
    """K3: a batch with a cached prefix (q_start > 0), a fresh chunk, a
    long-context row and a kv_len = 0 padding row.  ``cap`` as in
    :func:`kernel_decode`."""
    S = case.S
    KH, QH, D, TP, T, L = S["KH"], S["QH"], S["D"], S["TP"], S["prefill_T"], S["L"]
    dev = case.dev
    q_starts = torch.tensor([0, T, 2 * T, 0], dtype=torch.int32, device=dev)
    kv_lens = torch.tensor([T - 37, T + T // 2, 3 * T, 0], dtype=torch.int32, device=dev)
    N = 4
    maxp = -(-3 * T // TP)
    pt = torch.zeros((N, maxp), dtype=torch.int32, device=dev)
    base = S["B"] * case.maxp
    for r in range(N - 1):
        need = -(-int(kv_lens[r]) // TP)
        pt[r, :need] = case.perm[base + r * maxp: base + r * maxp + need]
    kp, vp = case.pools(dtype)
    q = case.randn((N, T, QH, D), case.io(dtype))
    if cap is not None:
        q = (q.float() * cap["q_scale"]).to(q.dtype)
    kw = dict(case.scale_kw(dtype), **soft_cap_kw(cap))
    out_k = ops.paged_prefill_attention_batch(q, kp, vp, pt, q_starts, kv_lens, 1,
                                              window=window, **kw)
    out_p = ops.paged_prefill_attention_batch_plain(q, kp, vp, pt, q_starts, kv_lens, 1,
                                                    window=window, **kw)
    torch.cuda.synchronize()
    live = [(r, slice(0, max(int(kv_lens[r] - q_starts[r]), 0))) for r in range(N)]
    err = max(_err(torch, out_k[r, s], out_p[r, s]) if s.stop else 0.0 for r, s in live)
    res = dict(max_abs_err=err, kv_len0_row_zero=not bool(out_k[N - 1].float().abs().max()))
    if cap is not None:
        uncapped = ops.paged_prefill_attention_batch_plain(
            q, kp, vp, pt, q_starts, kv_lens, 1, window=window, sm_scale=cap["sm_scale"],
            **case.scale_kw(dtype))
        res["uncapped_err"] = max(_err(torch, uncapped[r, s], out_p[r, s]) if s.stop else 0.0
                                  for r, s in live)
    if not timed:
        return res
    it = S["iters"]
    cyc = iter(range(10 ** 9))
    lay = lambda: next(cyc) % L  # noqa: E731
    k3 = lambda: ops.paged_prefill_attention_batch(  # noqa: E731
        q, kp, vp, pt, q_starts, kv_lens, lay(), window=window, **kw)
    if timed == "kernel":  # the kernel's device time alone
        res["ms"] = time_ms(torch, k3, it)
        return res
    res["ms"], res["host_ms"] = time_ms(torch, k3, it), time_ms(torch, k3, it, hold=False)
    res["plain_ms"] = time_ms(torch, lambda: ops.paged_prefill_attention_batch_plain(
        q, kp, vp, pt, q_starts, kv_lens, lay(), window=window, **kw), it)
    # work this data needs: visible (query, key) pairs and each K/V read once
    Sx = maxp * TP
    qpos = q_starts.long()[:, None] + torch.arange(T, device=dev)[None]
    kv = torch.arange(Sx, device=dev)[None, None]
    vis = (kv <= qpos[:, :, None]) & (kv < kv_lens.long()[:, None, None])
    if window:
        vis &= kv > qpos[:, :, None] - window
    pairs = int(vis.sum())
    keys = int(vis.any(dim=1).sum())
    isz = kp.element_size()
    res["bound_ms"], res["bound_by"] = bound(
        2 * N * T * QH * D * q.element_size() + 2 * keys * KH * D * isz,
        4 * QH * D * pairs, QH * pairs if cap is not None else 0)
    gathered = [(case.gather(kp, layer, pt, 0), case.gather(vp, layer, pt, 1))
                for layer in range(L)]
    q4 = q.transpose(1, 2).contiguous()
    if cap is not None:
        nocap = {k: v for k, v in kw.items() if k != "logit_softcap"}
        res["nocap_ms"] = time_ms(torch, lambda: ops.paged_prefill_attention_batch(
            q, kp, vp, pt, q_starts, kv_lens, lay(), window=window, **nocap), it)
        flex = flex_softcap(torch, q4, qpos, kv_lens.long(), Sx, window, cap)
        out_f = flex(*gathered[1]).transpose(1, 2)
        res["library_err"] = max(_err(torch, out_f[r, s], out_p[r, s]) if s.stop else 0.0
                                 for r, s in live)
        res["library_ms"] = time_ms(torch, lambda: flex(*gathered[lay()]), it)
        return res
    mask = vis[:, None]
    res["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, *gathered[lay()], attn_mask=mask, enable_gqa=True), it)
    return res


def kernel_verify(torch, ops, F, case, dtype, window, timed, cap=None):
    """K4: T fed tokens per row at the case's contexts (seq_len includes
    them); the longest row overhangs its table by 2 < T tokens (those two
    slots discarded, as the engine routes them) and one row's writes are
    all discarded.  Every query of this case lies inside its table.
    ``cap`` as in :func:`kernel_decode`."""
    S = case.S
    B, KH, QH, D, TP, L, T = S["B"], S["KH"], S["QH"], S["D"], S["TP"], S["L"], S["spec_T"]
    dev, width = case.dev, case.maxp * S["TP"]
    sl = case.seq_lens.clone()
    sl[int(torch.argmax(sl))] = width + 2
    pos = sl.long()[:, None] - T + torch.arange(T, device=dev)[None]  # [B, T]
    inside = pos < width
    pages = case.page_tables.gather(1, pos.clamp(max=width - 1) // TP)
    slot_pages = torch.where(inside, pages, torch.zeros_like(pages)).contiguous()
    slot_pages[2] = 0
    slot_offsets = (pos % TP).to(torch.int32)
    kp, vp = case.pools(dtype)
    io = case.io(dtype)
    q = case.randn((B, T, QH, D), io)
    if cap is not None:
        q = (q.float() * cap["q_scale"]).to(q.dtype)
    kn, vn = case.randn((B, T, KH, D), io), case.randn((B, T, KH, D), io)
    kw = dict(case.scale_kw(dtype), **soft_cap_kw(cap))
    args = (case.page_tables, sl)
    slots = (slot_pages, slot_offsets)
    kp2, vp2 = kp.clone(), vp.clone()
    out_k, _, _ = ops.paged_attention_verify(q, kp, vp, *args, 1, kn, vn, *slots,
                                             window=window, **kw)
    out_p, _, _ = ops.paged_attention_verify_plain(q, kp2, vp2, *args, 1, kn, vn, *slots,
                                                   window=window, **kw)
    torch.cuda.synchronize()
    res = dict(pools_bit_exact=_same_bytes(torch, kp, kp2) and _same_bytes(torch, vp, vp2),
               max_abs_err=_err(torch, out_k[inside], out_p[inside]))
    if cap is not None:
        nocap = {k: v for k, v in kw.items() if k != "logit_softcap"}
        uncapped = ops.paged_attention_verify_plain(q, kp2.clone(), vp2.clone(), *args, 1, kn,
                                                    vn, *slots, window=window, **nocap)[0]
        res["uncapped_err"] = _err(torch, uncapped[inside], out_p[inside])
    if not timed:
        return res
    it = S["iters"]
    cyc = iter(range(10 ** 9))
    lay = lambda: next(cyc) % L  # noqa: E731
    k4 = lambda: ops.paged_attention_verify(  # noqa: E731
        q, kp, vp, *args, lay(), kn, vn, *slots, window=window, **kw)
    if timed == "kernel":  # the kernel's device time alone
        res["ms"] = time_ms(torch, k4, it)
        return res
    res["ms"], res["host_ms"] = time_ms(torch, k4, it), time_ms(torch, k4, it, hold=False)
    res["parts"] = kernel_parts(torch, k4, it)
    res["plain_ms"] = time_ms(torch, lambda: ops.paged_attention_verify_plain(
        q, kp, vp, *args, lay(), kn, vn, *slots, window=window, **kw), it)
    # work this data needs: visible (query, key) pairs, each row's keys read
    # once, q / the fed K,V / tables read, the output and the fed tokens written
    kv = torch.arange(width, device=dev)[None, None]
    vis = (kv <= pos[:, :, None]) & (kv < sl.long()[:, None, None])
    if window:
        vis &= kv > pos[:, :, None] - window
    pairs = int(vis.sum()) * QH
    keys = int(vis.any(dim=1).sum())
    isz, qsz = kp.element_size(), q.element_size()
    written = int((slot_pages != 0).sum())
    res["bound_ms"], res["bound_by"] = bound(
        2 * keys * KH * D * isz + 2 * B * T * QH * D * qsz
        + 2 * (B * T * qsz + written * isz) * KH * D + B * case.maxp * 4 + 3 * B * T * 4,
        4 * D * pairs, pairs if cap is not None else 0)
    gathered = [(case.gather(kp, layer, case.page_tables, 0),
                 case.gather(vp, layer, case.page_tables, 1)) for layer in range(L)]
    q4 = q.transpose(1, 2).contiguous()
    if cap is not None:
        res["nocap_ms"] = time_ms(torch, lambda: ops.paged_attention_verify(
            q, kp, vp, *args, lay(), kn, vn, *slots, window=window, **nocap), it)
        # yardstick: flex_attention with the cap as its score_mod; layer 1
        # holds the tokens written above
        flex = flex_softcap(torch, q4, pos, sl.long(), width, window, cap)
        out_f = flex(*gathered[1]).transpose(1, 2)
        res["library_err"] = _err(torch, out_f[inside], out_p[inside])
        res["library_ms"] = time_ms(torch, lambda: flex(*gathered[lay()]), it)
        return res
    mask = vis[:, None]
    res["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, *gathered[lay()], attn_mask=mask, enable_gqa=True), it)
    return res


class MLACase(KernelCase):
    """The MLA kernels' inputs at DeepSeek-V2-Lite's attention widths: one
    latent kv head of MLA_D lanes (values its first MLA_R), MLA_H query
    heads, the same contexts on shuffled pages as the Llama case.  Byte
    latent pools hold quantized N(0, 1) values (int8 with one scale a
    layer, ``self.latent_scales`` [L, 1]), and their q and new entries are
    bf16, as the bf16 model hands them over."""

    def __init__(self, torch, dev, S):
        super().__init__(torch, dev, S)
        self.latent_scales = 0.02 + 0.03 * torch.rand((S["L"], 1), generator=self.g,
                                                      device=dev)

    def scale_kw(self, dtype):
        """The attention kernels' int8 scale arguments: the layer's K scale
        serves the values too."""
        if dtype != self.torch.int8:
            return {}
        return dict(k_scales=self.latent_scales, v_scales=self.latent_scales)

    def pool(self, dtype):
        from kvcached_tpu_torch.ops import quantize_kv

        S = self.S
        shape = (S["L"], self.P, 1, S["TP"], S["MLA_D"])
        if is_byte(self.torch, dtype):
            k = quantize_kv(self.randn(shape, self.torch.float32), dtype,
                            self.latent_scales[:, None, :, None, None])
        else:
            k = self.randn(shape, dtype)
        k[:, 0] = 0
        return k

    def gather(self, pool, layer, table):
        """Layer ``layer`` of the latent pool gathered through ``table`` into
        a contiguous [N, 1, width, D] (keys) and [N, 1, width, R] (values),
        a byte pool dequantized to bf16: the library yardstick's input."""
        torch, S = self.torch, self.S
        N = table.shape[0]
        k = pool[layer, :, 0][table.long()].reshape(N, 1, -1, S["MLA_D"])
        if is_byte(torch, pool.dtype):
            k = k.float()
            if pool.dtype == torch.int8:
                k = k * self.latent_scales[layer]
            k = k.to(torch.bfloat16)
        return k.contiguous(), k[..., :S["MLA_R"]].contiguous()


def mla_decode_verify(torch, ops, F, case, dtype, timed):
    """K5's decode form (T=1) and its verify form (T=spec_T, the longest
    row overhanging its table by 2, row 2's writes all discarded) vs plain."""
    S = case.S
    B, H, D, R, TP, L, T = S["B"], S["MLA_H"], S["MLA_D"], S["MLA_R"], S["TP"], S["L"], S["spec_T"]
    dev, width = case.dev, case.maxp * TP
    scale = S["MLA_SCALE"]
    res = {}
    for name, Tq in (("K5", 1), ("K5v", T)):
        sl = case.seq_lens.clone()
        if Tq > 1:
            sl[int(torch.argmax(sl))] = width + 2
        pos = sl.long()[:, None] - Tq + torch.arange(Tq, device=dev)[None]  # [B, Tq]
        inside = pos < width
        pages = case.page_tables.gather(1, pos.clamp(max=width - 1) // TP)
        slot_pages = torch.where(inside, pages, torch.zeros_like(pages)).contiguous()
        if Tq > 1:
            slot_pages[2] = 0
        slot_offsets = (pos % TP).to(torch.int32)
        kp = case.pool(dtype)
        io = case.io(dtype)
        q = case.randn((B, Tq, H, D), io)
        ent = case.randn((B, Tq, 1, D), io)
        kw = case.scale_kw(dtype)
        kp2 = kp.clone()
        lay = lambda: 1  # noqa: E731  (the checked calls use layer 1)
        if Tq == 1:
            q1, ent1 = q[:, 0], ent[:, 0]
            sp1, so1 = slot_pages[:, 0].contiguous(), slot_offsets[:, 0].contiguous()
            call = lambda pool, plain: (ops.paged_attention_decode_plain if plain  # noqa: E731
                                        else ops.paged_attention_decode)(
                q1, pool, None, case.page_tables, sl, lay(), ent1, None, sp1, so1,
                sm_scale=scale, mla_v_dim=R, **kw)[0][:, None]
        else:
            call = lambda pool, plain: (ops.paged_attention_verify_plain if plain  # noqa: E731
                                        else ops.paged_attention_verify)(
                q, pool, None, case.page_tables, sl, lay(), ent, None, slot_pages,
                slot_offsets, sm_scale=scale, mla_v_dim=R, **kw)[0]
        out_k, out_p = call(kp, False), call(kp2, True)
        torch.cuda.synchronize()
        r = res[name] = dict(pools_bit_exact=_same_bytes(torch, kp, kp2),
                             max_abs_err=_err(torch, out_k[inside], out_p[inside]))
        if not timed:
            continue
        it = S["iters"]
        cyc = iter(range(10 ** 9))
        lay = lambda: next(cyc) % L  # noqa: E731
        kern = lambda: call(kp, False)  # noqa: E731
        r.update(ms=time_ms(torch, kern, it), host_ms=time_ms(torch, kern, it, hold=False),
                 parts=kernel_parts(torch, kern, it),
                 plain_ms=time_ms(torch, lambda: call(kp, True), it))
        # work this data needs: visible (query token, key) pairs, each row's
        # entries read once, q / the fed entries / tables read, the output
        # and the fed entries written (q, the output and the fed entries in
        # their own type, the pool's entries in the pool's)
        kv = torch.arange(width, device=dev)[None, None]
        vis = (kv <= pos[:, :, None]) & (kv < sl.long()[:, None, None])
        pairs = int(vis.sum()) * H
        keys = int(vis.any(dim=1).sum())
        isz, qsz = kp.element_size(), q.element_size()
        written = int((slot_pages != 0).sum())
        r["bound_ms"], r["bound_by"] = bound(
            keys * D * isz + 2 * B * Tq * H * D * qsz + B * Tq * D * qsz + written * D * isz
            + B * case.maxp * 4 + 3 * B * Tq * 4, pairs * 2 * (D + R))
        gathered = [case.gather(kp, layer, case.page_tables) for layer in range(L)]
        q4 = q.permute(0, 2, 1, 3).contiguous()  # [B, H, Tq, D]
        mask = vis[:, None]
        r["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, *gathered[lay()], attn_mask=mask, scale=scale, enable_gqa=True), it)
    return res


def mla_prefill(torch, ops, F, case, dtype, timed):
    """K6 (a page-aligned latent chunk, one page discarded) and K3m (a batch
    with a cached prefix, a fresh chunk, a long-context row and a kv_len = 0
    row) vs plain."""
    S = case.S
    H, D, R, TP, T, L = S["MLA_H"], S["MLA_D"], S["MLA_R"], S["TP"], S["prefill_T"], S["L"]
    dev, scale = case.dev, S["MLA_SCALE"]
    n = T // TP
    kp = case.pool(dtype)
    io = case.io(dtype)
    ent = case.randn((1, T, D), io)
    kw = case.scale_kw(dtype)
    wkw = {}
    if dtype == torch.int8:  # the reference's edge values (see kernel_prefill_write)
        wkw = dict(scale=torch.full((1,), 0.5, device=dev))
        ent[0, 0, :6] = torch.tensor([0.25, 0.75, 1.25, -0.25, -0.75, 100.0])
    elif dtype == torch.float8_e4m3fn:
        ent[0, 0, :6] = torch.tensor([460.0, 464.0, 470.0, -500.0, float("inf"), 1e-9])
    pages = case.perm[-n:].clone()
    pages[1] = 0  # a discarded chunk
    kp2 = kp.clone()
    ops.write_prefill_kv_single(kp, ent, pages, 1, **wkw)
    ops.write_prefill_kv_single_plain(kp2, ent, pages, 1, **wkw)
    torch.cuda.synchronize()
    res = {"K6": dict(pools_bit_exact=_same_bytes(torch, kp, kp2),
                      max_abs_err=0.0 if is_byte(torch, dtype) else _err(torch, kp, kp2))}
    if is_byte(torch, dtype):
        edge = kp[1, int(pages[0]), 0, 0, :6].view(torch.uint8).tolist()
        want = ([0, 2, 2, 0, 0xFE, 0x7F] if dtype == torch.int8
                else [0x7E, 0x7E, 0x7F, 0xFF, 0x7F, 0x00])
        res["K6"]["edge_values_ok"] = edge == want
    q_starts = torch.tensor([0, T, 2 * T, 0], dtype=torch.int32, device=dev)
    kv_lens = torch.tensor([T - 37, T + T // 2, 3 * T, 0], dtype=torch.int32, device=dev)
    N = 4
    maxp = -(-3 * T // TP)
    pt = torch.zeros((N, maxp), dtype=torch.int32, device=dev)
    base = S["B"] * case.maxp
    for r in range(N - 1):
        need = -(-int(kv_lens[r]) // TP)
        pt[r, :need] = case.perm[base + r * maxp: base + r * maxp + need]
    q = case.randn((N, T, H, D), io)
    attend = lambda plain, layer=1: (ops.paged_prefill_attention_batch_plain if plain  # noqa: E731
                                     else ops.paged_prefill_attention_batch)(
        q, kp, None, pt, q_starts, kv_lens, layer, sm_scale=scale, mla_v_dim=R, **kw)
    out_k, out_p = attend(False), attend(True)
    torch.cuda.synchronize()
    live = [(r, slice(0, max(int(kv_lens[r] - q_starts[r]), 0))) for r in range(N)]
    res["K3m"] = dict(
        max_abs_err=max(_err(torch, out_k[r, s], out_p[r, s]) if s.stop else 0.0
                        for r, s in live),
        kv_len0_row_zero=not bool(out_k[N - 1].float().abs().max()))
    if not timed:
        return res
    it = S["iters"]
    cyc = iter(range(10 ** 9))
    lay = lambda: next(cyc) % L  # noqa: E731
    isz = kp.element_size()
    w = res["K6"]
    if dtype == torch.int8:
        wkw = dict(scale=case.latent_scales[1])
    k6 = lambda: ops.write_prefill_kv_single(kp, ent, pages, lay(), **wkw)  # noqa: E731
    w.update(ms=time_ms(torch, k6, it), host_ms=time_ms(torch, k6, it, hold=False),
             plain_ms=time_ms(torch, lambda: ops.write_prefill_kv_single_plain(
                 kp, ent, pages, lay(), **wkw), it))
    nlive = int((pages != 0).sum())
    w["bound_ms"], w["bound_by"] = bound(
        nlive * TP * D * (ent.element_size() + isz) + n * 4, 0)
    keep = (pages != 0).nonzero().squeeze(1)
    idx = pages[keep].long()
    chunks = ent.reshape(1, n, TP, D).transpose(0, 1)[keep].contiguous()
    # no one PyTorch call quantizes and scatters: byte pools have no yardstick
    w["library_ms"] = None if is_byte(torch, dtype) else time_ms(
        torch, lambda: kp[lay()].index_copy_(0, idx, chunks), it)
    a = res["K3m"]
    k3m = lambda: attend(False, lay())  # noqa: E731
    a.update(ms=time_ms(torch, k3m, it), host_ms=time_ms(torch, k3m, it, hold=False),
             plain_ms=time_ms(torch, lambda: attend(True, lay()), it))
    Sx = maxp * TP
    qpos = q_starts.long()[:, None] + torch.arange(T, device=dev)[None]
    kv = torch.arange(Sx, device=dev)[None, None]
    vis = (kv <= qpos[:, :, None]) & (kv < kv_lens.long()[:, None, None])
    pairs = int(vis.sum()) * H
    keys = int(vis.any(dim=1).sum())
    a["bound_ms"], a["bound_by"] = bound(2 * N * T * H * D * q.element_size() + keys * D * isz,
                                         pairs * 2 * (D + R))
    gathered = [case.gather(kp, layer, pt) for layer in range(L)]
    q4 = q.transpose(1, 2).contiguous()
    mask = vis[:, None]
    a["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, *gathered[lay()], attn_mask=mask, scale=scale, enable_gqa=True), it)
    return res


def phase_kernels(torch, ops, S, dev):
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    case = KernelCase(torch, dev, S)
    mcase = MLACase(torch, dev, S)
    rows = {}
    modes = ((torch.bfloat16, BF16_TOL, True), (torch.float32, F32_TOL, False),
             (torch.int8, BF16_TOL, True), (torch.float8_e4m3fn, BF16_TOL, True))
    for dtype, tol, timed in modes:
        tag = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8",
               torch.float8_e4m3fn: "fp8"}[dtype]
        # rows keyed "K1" for bf16, "K1 int8" / "K1 fp8" for the byte modes
        key = (lambda name: name) if dtype == torch.bfloat16 else (lambda name: f"{name} {tag}")
        for window in (None, S["window"]):
            d = kernel_decode(torch, ops, F, case, dtype, window, timed and window is None)
            p = kernel_prefill(torch, ops, F, case, dtype, window, timed and window is None)
            v = kernel_verify(torch, ops, F, case, dtype, window, timed and window is None)
            for name, r in (("K1", d["K1"]), ("K1r", d["K1r"]), ("K3", p), ("K4", v)):
                ok = r["max_abs_err"] <= tol and r.get("pools_bit_exact", True) \
                    and r.get("kv_len0_row_zero", True)
                log(f"[kernels] {name} {tag} window={window}: max_abs_err="
                    f"{r['max_abs_err']:.3e} (tol {tol}) "
                    + ("pools bit-exact " if "pools_bit_exact" in r else "")
                    + ("ok" if ok else "FAILED"))
                require(ok, f"{name} {tag} window={window} disagrees: {r}")
                if timed and window is None:
                    rows[key(name)] = dict(r, tolerance=tol)
        w = kernel_prefill_write(torch, ops, case, dtype, timed)
        log(f"[kernels] K2 {tag}: pools bit-exact={w['pools_bit_exact']}"
            + (f", edge values as the reference={w['edge_values_ok']}"
               if "edge_values_ok" in w else ""))
        require(w["pools_bit_exact"] and w.get("edge_values_ok", True),
                f"K2 {tag} pool bytes differ")
        if timed:
            rows[key("K2")] = dict(w, tolerance=0.0)
        # the MLA kernels at DeepSeek-V2-Lite's widths
        mla = {**mla_decode_verify(torch, ops, F, mcase, dtype, timed),
               **mla_prefill(torch, ops, F, mcase, dtype, timed)}
        for name, r in mla.items():
            tol_r = 0.0 if name == "K6" else tol
            ok = r["max_abs_err"] <= tol_r and r.get("pools_bit_exact", True) \
                and r.get("kv_len0_row_zero", True) and r.get("edge_values_ok", True)
            log(f"[kernels] {name} {tag} (MLA, D={S['MLA_D']}, values {S['MLA_R']}, "
                f"{S['MLA_H']} heads): max_abs_err={r['max_abs_err']:.3e} (tol {tol_r}) "
                + ("pools bit-exact " if r.get("pools_bit_exact") else "")
                + (f"edge values as the reference={r['edge_values_ok']} "
                   if "edge_values_ok" in r else "")
                + ("ok" if ok else "FAILED"))
            require(ok, f"{name} {tag} disagrees: {r}")
            if timed:
                rows[key(name)] = dict(r, tolerance=tol_r)
    # the soft-capped mode of K1, K1r, K3 and K4 at the hybrid model's
    # widths (Gemma-2-27B: KH 16, QH 32, sm_scale 1/12, cap 50), every pool
    # type; q scaled so that the scores reach several times the cap, or the
    # random scores would stay far below it and a kernel that ignored the
    # cap would pass: the uncapped plain output must lie far outside the
    # tolerance (the control).  Windows: none, the model's sliding window
    # (4096, past every context here) and one that cuts these contexts
    # (phase 3's).  Timed: the bf16 rows, and K4's byte modes
    hcfg = hybrid_config(S)
    require(hcfg.head_dim == S["D"], f"the hybrid model's head_dim {hcfg.head_dim} != {S['D']}")
    KH, QH = hcfg.num_kv_heads, hcfg.num_heads
    gcase = KernelCase(torch, dev, dict(S, KH=KH, QH=QH))
    cap = dict(sm_scale=hcfg.query_scale ** -0.5, softcap=hcfg.attn_softcap,
               q_scale=S["G_QSCALE"])
    sliding = next(w for w in hcfg.group_windows if w)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL),
                       (torch.int8, BF16_TOL), (torch.float8_e4m3fn, BF16_TOL)):
        tag = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8",
               torch.float8_e4m3fn: "fp8"}[dtype]
        for window in (None, sliding, S["window"]):
            t = dtype == torch.bfloat16 and window is None
            d = kernel_decode(torch, ops, F, gcase, dtype, window, t, cap=cap)
            p = kernel_prefill(torch, ops, F, gcase, dtype, window, t, cap=cap)
            t4 = dtype != torch.float32 and window is None
            v = kernel_verify(torch, ops, F, gcase, dtype, window, t4, cap=cap)
            for name, r in (("K1", d["K1"]), ("K1r", d["K1r"]), ("K3", p), ("K4", v)):
                ok = r["max_abs_err"] <= tol and r.get("pools_bit_exact", True) \
                    and r.get("kv_len0_row_zero", True)
                control = r["uncapped_err"] > 10 * tol
                log(f"[kernels] {name} softcap {tag} window={window} (KH={KH}, QH={QH}, "
                    f"cap {cap['softcap']}): max_abs_err={r['max_abs_err']:.3e} "
                    f"(tol {tol}) " + ("pools bit-exact " if "pools_bit_exact" in r else "")
                    + f"uncapped plain output off by {r['uncapped_err']:.3e} (must exceed "
                    f"{10 * tol:.0e}) " + ("ok" if ok and control else "FAILED"))
                require(ok, f"{name} softcap {tag} window={window} disagrees: {r}")
                require(control, f"{name} softcap {tag}: the cap does not change the output")
                if t or (name == "K4" and t4):
                    key = f"{name} softcap" + ("" if dtype == torch.bfloat16 else f" {tag}")
                    rows[key] = dict(r, tolerance=tol)
    del gcase
    # head_dim 256 at Gemma-2-9B's widths (KH 8, QH 16, sm_scale 1/16, cap
    # 50), every pool type, soft-capped as the model runs them, each with
    # the uncapped control; windows none, the model's sliding window and a
    # cutting one.  Timed: the bf16 and byte rows, each beside the same
    # kernel at head_dim 128 on otherwise the same shapes (d128_ms), the
    # same kernel uncapped and flex_attention
    h9 = hybrid_config(S, S["hyb9_model"])
    KH9, QH9, D9 = h9.num_kv_heads, h9.num_heads, h9.head_dim
    shape9 = dict(S, KH=KH9, QH=QH9)
    case9, case9_128 = KernelCase(torch, dev, dict(shape9, D=D9)), KernelCase(torch, dev, shape9)
    cap9 = dict(sm_scale=h9.query_scale ** -0.5, softcap=h9.attn_softcap, q_scale=S["G_QSCALE"])
    sliding9 = next(w for w in h9.group_windows if w)
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL),
                       (torch.int8, BF16_TOL), (torch.float8_e4m3fn, BF16_TOL)):
        tag = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int8: "int8",
               torch.float8_e4m3fn: "fp8"}[dtype]
        sfx = "" if dtype == torch.bfloat16 else f" {tag}"  # rows "K1 d256", "K1 d256 int8"
        for window in (None, sliding9, S["window"]):
            t = dtype != torch.float32 and window is None
            d = kernel_decode(torch, ops, F, case9, dtype, window, t, cap=cap9)
            p = kernel_prefill(torch, ops, F, case9, dtype, window, t, cap=cap9)
            v = kernel_verify(torch, ops, F, case9, dtype, window, t, cap=cap9)
            if t:  # the same kernels at head_dim 128
                d1 = kernel_decode(torch, ops, F, case9_128, dtype, window, "kernel", cap=cap9)
                d["K1"]["d128_ms"], d["K1r"]["d128_ms"] = d1["K1"]["ms"], d1["K1r"]["ms"]
                p["d128_ms"] = kernel_prefill(torch, ops, F, case9_128, dtype, window, "kernel",
                                              cap=cap9)["ms"]
                v["d128_ms"] = kernel_verify(torch, ops, F, case9_128, dtype, window, "kernel",
                                             cap=cap9)["ms"]
            for name, r in (("K1", d["K1"]), ("K1r", d["K1r"]), ("K3", p), ("K4", v)):
                ok = r["max_abs_err"] <= tol and r.get("pools_bit_exact", True) \
                    and r.get("kv_len0_row_zero", True)
                control = r["uncapped_err"] > 10 * tol
                log(f"[kernels] {name} d{D9} softcap {tag} window={window} (KH={KH9}, QH={QH9}, "
                    f"D={D9}, cap {cap9['softcap']}): max_abs_err={r['max_abs_err']:.3e} "
                    f"(tol {tol}) " + ("pools bit-exact " if "pools_bit_exact" in r else "")
                    + f"uncapped plain output off by {r['uncapped_err']:.3e} (must exceed "
                    f"{10 * tol:.0e}) " + ("ok" if ok and control else "FAILED"))
                require(ok, f"{name} d{D9} {tag} window={window} disagrees: {r}")
                require(control, f"{name} d{D9} {tag}: the cap does not change the output")
                if t:
                    rows[f"{name} d{D9}{sfx}"] = dict(r, tolerance=tol)
        w = kernel_prefill_write(torch, ops, case9, dtype, dtype != torch.float32)
        log(f"[kernels] K2 d{D9} {tag}: pools bit-exact={w['pools_bit_exact']}"
            + (f", edge values as the reference={w['edge_values_ok']}"
               if "edge_values_ok" in w else ""))
        require(w["pools_bit_exact"] and w.get("edge_values_ok", True),
                f"K2 d{D9} {tag} pool bytes differ")
        if dtype != torch.float32:
            w["d128_ms"] = kernel_prefill_write(torch, ops, case9_128, dtype, "kernel")["ms"]
            rows[f"K2 d{D9}{sfx}"] = dict(w, tolerance=0.0)
    del case9, case9_128
    from kvcached_tpu_torch.ops.paged_attention import mla_wave_blocks

    log("[kernels] MLA blocks a wave (occupancy API), by dtype and query rows a block: "
        + ", ".join(f"{dt} x {qr}: {mla_wave_blocks(dev, getattr(torch, dt), qr)}"
                    for dt in ("bfloat16", "int8", "float8_e4m3fn")
                    for qr in (16, 32, 48, 64))
        + f", float32 x 16: {mla_wave_blocks(dev, torch.float32, 16)}")
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"[kernels] {name}: {r['ms']:.4f} ms on the device, {r['host_ms']:.4f} ms a "
            f"call from the host (plain {r['plain_ms']:.4f}, library "
            f"{lib}, bound {r['bound_ms']:.4f} by {r['bound_by']})"
            + (f"; device ms per call by kernel {json.dumps(r['parts'])}"
               if "parts" in r else "")
            + (f"; the same kernel uncapped on the same inputs {r['nocap_ms']:.4f} ms"
               if "nocap_ms" in r else "")
            + (f"; the same kernel at head_dim 128 on otherwise the same shapes "
               f"{r['d128_ms']:.4f} ms" if "d128_ms" in r else "")
            + (f"; flex_attention's output off the plain version's by "
               f"{r['library_err']:.3e}" if "library_err" in r else ""))
    return rows


# ---------------------------------------------------------------------------
# 4. engine at full width
# ---------------------------------------------------------------------------


def serve(eng, requests):
    """requests: [(prompt, SamplingParams)] → output token lists, in order."""
    ids = [eng.add_request(p, sp) for p, sp in requests]
    while eng.has_unfinished():
        eng.step()
    by_id = {o.req_id: o.output_tokens for o in eng.finished_outputs}
    return [by_id[i] for i in ids]


def model_steps(cfg):
    """(prefill, decode, verify) step functions of cfg's model family."""
    from kvcached_tpu_torch.models import llama, mla

    if isinstance(cfg, mla.MLAConfig):
        return mla.mla_prefill_step, mla.mla_decode_step, mla.mla_verify_step
    return llama.llama_prefill_step, llama.llama_decode_step, llama.llama_verify_step


def last_logits(torch, cfg, params, S, dev, reference, kv_dtype=None, with_pools=False):
    """Last-position logits of a two-chunk prefill (the second chunk at
    q_start = one bucket), of one decode step after it, and of one verify
    step of spec_T fed tokens after that, through the kernels or
    (``reference``) through their plain versions, on fresh pools of the
    model's dtype or ``kv_dtype`` (one latent pool for the MLA family; an
    int8 pool with the engine's default scales).  ``with_pools``: returns
    (the logits, the pools after the steps, the values each layer of a pool
    was written).  A hybrid model takes :func:`hybrid_logits`' path."""
    from kvcached_tpu_torch.models.hybrid import HybridConfig

    TP, T, Tv = S["TP"], max(S["buckets"]), S["spec_T"]
    tail = T // 4 + 9
    T2 = next(b for b in S["buckets"] if b >= tail)
    plen = T + tail
    if isinstance(cfg, HybridConfig):
        return hybrid_logits(torch, cfg, params, S, dev, reference, plen, kv_dtype, with_pools)
    prefill_step, decode_step, verify_step = model_steps(cfg)
    pdt, kw = _logits_pool(torch, cfg, dev, kv_dtype)
    n_pages = -(-(plen + 1 + Tv) // TP)
    shape = (cfg.num_layers, n_pages + 1, cfg.num_kv_heads, TP, cfg.head_dim)
    g = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (plen,), generator=g, device=dev,
                           dtype=torch.int32)
    table = torch.arange(1, n_pages + 1, dtype=torch.int32, device=dev)
    one = lambda x: torch.tensor([x], dtype=torch.int32, device=dev)  # noqa: E731
    kp = torch.zeros(shape, dtype=pdt, device=dev)
    vp = None if getattr(cfg, "num_kv_buffers", 2) == 1 else torch.zeros_like(kp)
    for q0, n, Tb in ((0, T, T), (T, tail, T2)):
        toks = torch.zeros(Tb, dtype=torch.int32, device=dev)
        toks[:n] = prompt[q0:q0 + n]
        pos = q0 + torch.arange(Tb, dtype=torch.int32, device=dev)
        chunk = torch.zeros(Tb // TP, dtype=torch.int32, device=dev)
        nreal = -(-n // TP)
        chunk[:nreal] = table[q0 // TP: q0 // TP + nreal]
        lg_prefill, _, _ = prefill_step(
            params, cfg, toks, pos, kp, vp, chunk, table, q0, n,
            reference_attention=reference, **kw)
    lg_decode, _, _ = decode_step(
        params, cfg, prompt[:1], one(plen), kp, vp, table[None],
        one(int(table[plen // TP])), one(plen % TP), one(plen + 1),
        reference_attention=reference, **kw)
    vpos = plen + 1 + torch.arange(Tv, dtype=torch.int32, device=dev)
    lg_verify, _, _ = verify_step(
        params, cfg, prompt[None, 1:Tv + 1], vpos[None], kp, vp, table[None],
        table[vpos // TP][None].contiguous(), (vpos % TP)[None], one(plen + 1 + Tv),
        reference_attention=reference, **kw)
    logits = lg_prefill, lg_decode[0], lg_verify[0, -1]
    if with_pools:
        written = (plen + 1 + Tv) * cfg.num_kv_heads * cfg.head_dim
        return logits, [p for p in (kp, vp) if p is not None], written
    return logits


def _logits_pool(torch, cfg, dev, kv_dtype):
    """(pool type, the steps' int8 scale keyword) of :func:`last_logits`:
    an int8 pool takes the engine's default scales, one a model layer and
    kv head."""
    from kvcached_tpu_torch.device.pool import torch_dtype
    from kvcached_tpu_torch.engine import EngineConfig

    pdt = torch_dtype(kv_dtype or cfg.dtype)
    if pdt != torch.int8:
        return pdt, {}
    sc = torch.full((cfg.num_layers, cfg.num_kv_heads), EngineConfig.kv_scale,
                    dtype=torch.float32, device=dev)
    return pdt, dict(quant_scales=(sc, sc))


def float32_copy(cfg, params):
    """The same model widened to float32 (config and parameters)."""
    import dataclasses

    c = dataclasses.replace(cfg, dtype="float32")
    return c, type(params)(c, params.embed.float(),
                           {k: v.float() for k, v in params.layers.items()},
                           params.final_norm.float(), params.lm_head.float())


def logits_check(torch, cfg, params, S, dev):
    """Kernel path vs plain path on the card, norm-relative error of the
    last-position logits.  Gated at float32 (the same weights widened,
    float32 pools, TF32 off), where the two differ only by summation
    order; at bf16 the error is printed beside bf16's own distance from
    float32 (the plain path at both), since bf16 rounding differences
    compound over the layers of a random-weight model."""
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    out = {}
    logits = {}
    for tag, c, p in (("bf16", cfg, params), ("f32", None, None)):
        if tag == "f32":
            c, p = float32_copy(cfg, params)
        kern = last_logits(torch, c, p, S, dev, False)
        plain = last_logits(torch, c, p, S, dev, True)
        logits[tag] = plain
        for what, a, b in zip(("prefill", "decode", "verify"), kern, plain):
            out[f"{tag}_{what}"] = rel(a, b)
        del p
    for i, what in enumerate(("prefill", "decode", "verify")):
        out[f"bf16_vs_f32_{what}"] = rel(logits["bf16"][i], logits["f32"][i])
    return out


def profile_decode(torch, eng, rand, sp, spec=False):
    """Device busy share of one decode dispatch (a full batch, the decode
    horizon of steps, or with ``spec`` the spec horizon of verify
    iterations): the sum of torch.profiler's CUDA kernel times over the
    host wall time (the profiler's own host cost included).  Launches here
    come after the main path's counts were read."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(eng.cfg.max_batch):
        eng.add_request(rand(200), sp)
    while eng.waiting or eng._prefilling is not None:
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        (eng._do_spec_decode if spec else eng._do_decode)()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    # kernel events only: an operator's own row repeats its kernels' time
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and _dev_time(e) > 0]
    ev.sort(key=_dev_time, reverse=True)
    while eng.has_unfinished():
        eng.step()
    return dict(
        rows=eng.cfg.max_batch, wall_ms=wall * 1e3,
        steps=eng.cfg.spec_horizon if spec else eng.cfg.decode_horizon,
        device_ms=sum(_dev_time(e) for e in ev) / 1e3,
        top=[(e.key[:60], round(_dev_time(e) / 1e3, 3)) for e in ev[:6]])


def request_mix(S, V, new):
    """Phase 4's requests: one prompt, then 7: a prefix-cache hit, a prompt
    longer than the largest bucket (chunked), four short prompts (batched
    prefill) and a seeded sampled row.  Returns (rand, greedy, wave1,
    wave2)."""
    import numpy as np

    from kvcached_tpu_torch.engine import SamplingParams

    rng = np.random.default_rng(1)
    rand = lambda n: [int(t) for t in rng.integers(0, V, n)]  # noqa: E731
    prefix = rand(S["shared_prefix"])
    greedy = SamplingParams(max_new_tokens=new)
    sampled = SamplingParams(max_new_tokens=new, temperature=0.8, top_k=50, seed=1)
    B0 = max(S["buckets"])
    wave1 = [(prefix + rand(40), greedy)]
    wave2 = [(prefix + rand(70), greedy), (rand(S["long_prompt"]), greedy)]
    wave2 += [(rand(int(n)), greedy) for n in np.linspace(B0 // 5, B0 - 8, 4)]
    wave2 += [(rand(B0 // 3), sampled)]
    return rand, greedy, wave1, wave2


def serve_mix(ops, eng, wave1, wave2):
    """Serve the two waves with every launch counter zeroed just before and
    read just after; the engine's throughput stats cover wave 2.  Returns
    (counts, wave 1's outputs, wave 2's, wave 2's wall seconds)."""
    ops.reset_launch_counts()  # --- the main path starts here
    out1 = serve(eng, wave1)
    eng.stats.update(prefill_tokens=0, prefill_seconds=0.0, decode_tokens=0,
                     decode_seconds=0.0, decode_steps=0)
    t0 = time.perf_counter()
    out2 = serve(eng, wave2)
    wall = time.perf_counter() - t0
    return ops.launch_counts(), out1, out2, wall  # --- and ends here


def phase_engine(torch, ops, S, dev, rehearse):
    from kvcached_tpu_torch.engine import EngineConfig, LLMEngine
    from kvcached_tpu_torch.models.llama import LlamaConfig, init_llama_params

    cfg = LlamaConfig.llama3_8b() if S["model"] == "llama3_8b" else LlamaConfig.toy()
    t0 = time.perf_counter()
    params = init_llama_params(cfg, seed=0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[engine] {S['model']}: L={cfg.num_layers} E={cfg.hidden_size} "
        f"H={cfg.num_heads} KH={cfg.num_kv_heads} F={cfg.intermediate_size} "
        f"V={cfg.vocab_size} {cfg.dtype}: {n_params / 1e9:.2f} B params drawn on "
        f"{dev} in {time.perf_counter() - t0:.1f} s")
    TP, V, new = S["TP"], cfg.vocab_size, S["max_new"]
    ec = EngineConfig(
        max_batch=8, max_model_len=2048 if not rehearse else 256, page_tokens=TP,
        decode_horizon=8, prefill_buckets=S["buckets"], num_pages=320 if not rehearse else 96,
        kv_dtype=cfg.dtype, prefill_batch=4)
    eng = LLMEngine(cfg, ec, params=params, device=dev)
    rand, greedy, wave1, wave2 = request_mix(S, V, new)
    counts, out1, out2, wall = serve_mix(ops, eng, wave1, wave2)
    m = eng.kv_metrics()
    prof = None if rehearse else profile_decode(torch, eng, rand, greedy)
    eng.shutdown()
    outs = out1 + out2
    th = m["throughput"]
    log(f"[engine] {len(outs)} requests, {sum(map(len, outs))} tokens; wave 2 "
        f"({len(wave2)} requests) in {wall:.2f} s: prefill "
        f"{th['prefill_tokens'] / max(th['prefill_seconds'], 1e-9):.1f} tok/s "
        f"({th['prefill_tokens']} tokens), decode "
        f"{th['decode_tokens'] / max(th['decode_seconds'], 1e-9):.1f} tok/s "
        f"({th['decode_tokens']} tokens)")
    log(f"[engine] prefix cache {m['prefix_cache']}, prefill batch {m['prefill_batch']}, "
        f"preemptions {m['preemptions']}")
    log(f"[engine] kernel launches on the main path: {json.dumps(counts)}")
    if prof:
        log(f"[engine] one decode dispatch ({prof['rows']} rows x "
            f"{prof['steps']} steps) under torch.profiler: wall "
            f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms "
            f"({100 * prof['device_ms'] / prof['wall_ms']:.1f}%), top kernels "
            f"{json.dumps(prof['top'])}")
    require(all(len(o) == new for o in outs), "every request yields max_new tokens")
    require(all(0 <= t < V for o in outs for t in o), "tokens inside the vocabulary")
    require(m["prefix_cache"]["hits"] > 0, "the shared prefix was a cache hit")
    require(m["prefill_batch"]["dispatches"] > 0, "batched prefill ran")
    for k in ("K1", "K2", "K3"):
        if not rehearse:
            require(counts[k] > 0, f"{k} was never launched on the main path")
    rels = logits_check(torch, cfg, params, S, dev)
    log(f"[engine] last-position logits, kernel path vs plain path on {dev}, "
        f"norm-relative error: float32 prefill {rels['f32_prefill']:.3e} decode "
        f"{rels['f32_decode']:.3e} verify {rels['f32_verify']:.3e} (tol "
        f"{LOGITS_REL_TOL}); bf16 prefill {rels['bf16_prefill']:.3e} decode "
        f"{rels['bf16_decode']:.3e} verify {rels['bf16_verify']:.3e} (bf16 plain "
        f"path vs float32 plain path: prefill {rels['bf16_vs_f32_prefill']:.3e} "
        f"decode {rels['bf16_vs_f32_decode']:.3e} verify "
        f"{rels['bf16_vs_f32_verify']:.3e})")
    require(max(rels["f32_prefill"], rels["f32_decode"], rels["f32_verify"])
            <= LOGITS_REL_TOL, f"logits disagree: {rels}")
    tok_s = dict(prefill=th["prefill_tokens"] / max(th["prefill_seconds"], 1e-9),
                 decode=th["decode_tokens"] / max(th["decode_seconds"], 1e-9))
    return cfg, params, counts, tok_s


# ---------------------------------------------------------------------------
# 5. elastic limit through the shm plane
# ---------------------------------------------------------------------------


def _set_limit(name, nbytes):
    """What ``kvctl limit`` does, from another process."""
    code = ("import sys; from kvcached_tpu_torch import shm; "
            "shm.update_kv_cache_limit(sys.argv[1], int(sys.argv[2]))")
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", code, name, str(nbytes)], check=True,
                   cwd=HERE, env=env, timeout=120)


def phase_elastic(torch, cfg, params, S, dev, rehearse, tag="elastic", kv_dtype=None,
                  group=0):
    """GREW/SHRANK/CORRECT: a limit written from another process on layer
    group ``group``'s segment (``<ipc>_g<group>`` past group 0) cuts that
    group's capacity mid-run and raises it again; the other groups keep
    their limits, and the outputs stay md5-identical to an unconstrained
    run."""
    import numpy as np

    from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams

    TP = S["TP"]
    B0 = max(S["buckets"])

    def make(ipc_name=None):
        # serial prefill and no prefix cache: a preempted sequence recomputes
        # with the same shapes as its first pass
        return LLMEngine(cfg, EngineConfig(
            max_batch=8, max_model_len=4 * B0, page_tokens=TP, decode_horizon=8,
            prefill_buckets=(B0,), num_pages=160 if not rehearse else 96,
            kv_dtype=kv_dtype or cfg.dtype, enable_prefix_caching=False, prefill_batch=1,
            ipc_name=ipc_name), params=params, device=dev)

    rng = np.random.default_rng(2)
    sp = SamplingParams(max_new_tokens=S["max_new"])
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, int(n))]
               for n in rng.integers(B0 // 2, B0, 8)]
    ref = make()
    want = serve(ref, [(p, sp) for p in prompts])
    ref.shutdown()
    del ref

    name = f"kvcached_tpu_smoke_{uuid.uuid4().hex[:8]}"
    eng = make(name)
    page_bytes = eng.kv_cfg.page_bytes
    full = eng.pool.capacity
    mgr = eng.managers[group]
    segment = eng.ipc_name + (f"_g{group}" if group else "")
    others = {g: m.page_allocator.limit_pages for g, m in enumerate(eng.managers) if g != group}

    def metrics():
        """kv_metrics, with the group's capacity (pages in use + obtainable)."""
        return dict(eng.kv_metrics(), cap=mgr.page_allocator.num_in_use + mgr.available_size())

    cap = lambda m: m["cap"]  # noqa: E731

    def await_limit(pages):
        """Wait until the allocator has taken up the new limit: its watcher
        polls the segment every 100 ms, and the next alloc applies it."""
        deadline = time.time() + 30
        while mgr.page_allocator.limit_pages != pages:
            require(time.time() < deadline, f"limit {pages} never taken up")
            time.sleep(0.02)
            mgr.alloc(0)

    try:
        ids = [eng.add_request(p, sp) for p in prompts]
        while len(eng.running) < 8 and eng.has_unfinished():
            eng.step()
        m_load = metrics()
        small = max(mgr.page_allocator.num_in_use // 2, 4)
        _set_limit(segment, small * page_bytes)
        await_limit(small)
        for _ in range(2):  # serve under the cut: growth now preempts
            if eng.has_unfinished():
                eng.step()
        m_cut = metrics()
        require(eng.has_unfinished(), "the cut landed mid-run")
        require(all(eng.managers[g].page_allocator.limit_pages == lim
                    for g, lim in others.items()), "the other groups keep their limits")
        _set_limit(segment, full * page_bytes)
        await_limit(full)
        m_grow = metrics()
        while eng.has_unfinished():
            eng.step()
        by_id = {o.req_id: o.output_tokens for o in eng.finished_outputs}
        got = [by_id[i] for i in ids]
        m_end = eng.kv_metrics()
    finally:
        eng.shutdown()
    log(f"[{tag}] segment {segment}: under load: capacity {cap(m_load)} pages, mapped "
        f"{m_load['mapped_bytes']} B; limit cut to {small} pages -> capacity "
        f"{cap(m_cut)}, mapped {m_cut['mapped_bytes']} B, preemptions "
        f"{m_cut['preemptions']}; limit raised -> capacity {cap(m_grow)}; "
        f"finished with {m_end['preemptions']} preemptions")
    md5 = lambda x: hashlib.md5(str(x).encode()).hexdigest()  # noqa: E731
    log(f"[{tag}] md5 constrained {md5(got)} unconstrained {md5(want)}")
    require(small < cap(m_load) and cap(m_cut) < cap(m_load), "SHRANK")
    require(cap(m_grow) > cap(m_cut), "GREW")
    require(md5(got) == md5(want), "CORRECT")
    log(f"[{tag}] GREW/SHRANK/CORRECT ok")


# ---------------------------------------------------------------------------
# 7. speculative decoding at full width
# ---------------------------------------------------------------------------


def phase_spec(torch, ops, cfg, params, S, dev, rehearse):
    """(a) token exactness at float32, (b) speed at bf16, with K4's launches
    counted over the mixed spec run.  Returns that run's launch counts and
    every run's decode tok/s."""
    import numpy as np

    from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams

    rng = np.random.default_rng(4)
    V, TP, B0 = cfg.vocab_size, S["TP"], max(S["buckets"])
    rand = lambda n: [int(t) for t in rng.integers(0, V, n)]  # noqa: E731
    # a repetitive prompt: a random phrase of `period` tokens, repeated
    rep = lambda n, period: (rand(period) * (n // period + 1))[:n]  # noqa: E731

    def make(c, p, spec, num_pages):
        return LLMEngine(c, EngineConfig(
            max_batch=8, max_model_len=2048 if not rehearse else 256, page_tokens=TP,
            decode_horizon=8, prefill_buckets=S["buckets"], num_pages=num_pages,
            kv_dtype=c.dtype, prefill_batch=4, spec_decode=spec,
            spec_exact=spec and c.dtype == "float32"), params=p, device=dev)

    # (a) float32: the verify forward and the decode forward give the same
    # greedy tokens
    c32, p32 = float32_copy(cfg, params)
    prompts = [rep(B0 // 4, 12), rand(B0 // 3), rep(B0 // 8, 7), rand(B0 // 5)]
    sp = SamplingParams(max_new_tokens=S["spec_new_exact"])
    outs = {}
    for spec in (False, True):
        eng = make(c32, p32, spec, 64)
        outs[spec] = serve(eng, [(p, sp) for p in prompts])
        m = eng.kv_metrics().get("spec")
        eng.shutdown()
        del eng
    del p32
    same = outs[True] == outs[False]
    log(f"[spec] (a) {S['model']} float32, {len(prompts)} requests x "
        f"{S['spec_new_exact']} tokens: spec decode (spec_exact) vs plain decode "
        f"greedy tokens identical: {same}; spec {json.dumps(m)}")
    require(same, "float32 spec decode changed greedy tokens")
    require(m["dispatches"] > 0, "the float32 spec run dispatched no verify")

    # (b) bf16 speed: the mixed batch (the main path), then its repetitive
    # and its random half alone: prompt lookup drafts well only where the
    # text repeats, and a closed batch ends with its slowest rows
    halves = dict(
        repetitive=[rep(n, per) for n, per in ((B0 // 2, 16), (B0 // 3, 9), (B0 // 4, 24),
                                               (B0 // 5, 5))],
        random=[rand(n) for n in (B0 // 2, B0 // 3, B0 // 4, B0 // 5)])
    sets = dict(mixed=halves["repetitive"] + halves["random"], **halves)
    sp = SamplingParams(max_new_tokens=S["max_new"])
    res = {}
    for name, prompts in sets.items():
        for spec in (False, True):
            main = name == "mixed" and spec
            eng = make(cfg, params, spec, 320 if not rehearse else 96)
            if main:
                ops.reset_launch_counts()  # --- the spec path starts here
            outs = serve(eng, [(p, sp) for p in prompts])
            if main:
                counts = ops.launch_counts()  # --- and ends here
            m = eng.kv_metrics()
            th = m["throughput"]
            r = res[name, spec] = dict(
                outs=outs, spec=m.get("spec"), prof=None,
                decode=th["decode_tokens"] / max(th["decode_seconds"], 1e-9),
                step_ms=1e3 * th["decode_seconds"] / max(th["decode_steps"], 1))
            if name == "mixed" and not rehearse:
                r["prof"] = profile_decode(torch, eng, rand, sp, spec=spec)
            eng.shutdown()
            del eng
        plain, spec_r = res[name, False], res[name, True]
        ms = spec_r["spec"]
        agree = sum(a == b for a, b in zip(spec_r["outs"], plain["outs"]))
        log(f"[spec] (b) {S['model']} {cfg.dtype}, {name} prompts, {len(prompts)} "
            f"requests x {S['max_new']} tokens: decode {plain['decode']:.1f} tok/s "
            f"plain, {spec_r['decode']:.1f} tok/s spec; host wall {plain['step_ms']:.2f} "
            f"ms a decode step, {spec_r['step_ms']:.2f} ms a verify iteration; "
            f"{ms['dispatches']} spec "
            f"dispatches, {ms['tokens_per_dispatch']:.2f} tokens per dispatch, "
            f"{ms['tokens_per_iteration']:.3f} tokens per row per verify iteration; "
            f"{agree}/{len(prompts)} requests token-identical to plain decode (bf16 "
            f"is not exact)")
    log(f"[spec] kernel launches on the spec path (mixed prompts): {json.dumps(counts)}")
    for spec, what in ((False, "decode dispatch"), (True, "spec dispatch")):
        prof = res["mixed", spec]["prof"]
        if prof:
            log(f"[spec] one {what} ({prof['rows']} rows x {prof['steps']} "
                f"{'verify iterations' if spec else 'steps'}) under torch.profiler: "
                f"wall {prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms "
                f"({100 * prof['device_ms'] / prof['wall_ms']:.1f}%), "
                f"{prof['device_ms'] / prof['steps']:.2f} ms device per "
                f"{'iteration' if spec else 'step'}, top kernels {json.dumps(prof['top'])}")
    require(all(len(o) == S["max_new"] for r in res.values() for o in r["outs"]),
            "every request yields max_new tokens")
    require(all(0 <= t < V for r in res.values() for o in r["outs"] for t in o),
            "tokens inside the vocabulary")
    require(all(r["spec"]["dispatches"] > 0 for (_, spec), r in res.items() if spec),
            "a spec run dispatched no verify")
    if not rehearse:
        require(counts["K4"] > 0, "K4 was never launched on the spec path")
    return counts, {f"{name} {'spec' if spec else 'plain'}": r["decode"]
                    for (name, spec), r in res.items()}


# ---------------------------------------------------------------------------
# 9. byte KV pools (int8, e4m3) at full width
# ---------------------------------------------------------------------------


def byte_code_diffs(torch, a, b, mode, written):
    """Two byte pools [L, pages, KH, TP, D] of ``mode``, code by code, per
    layer: (the share of a layer's ``written`` values whose codes differ,
    the most representable values between two codes: 1 for neighbours).
    An e4m3 code counts by its place among the format's values in order
    (its magnitude's code, negated below zero; +0 and -0 are one place)."""
    def place(t):
        if mode == "int8":
            return t.int()
        u = t.view(torch.uint8).int()
        return torch.where(u >= 0x80, -(u & 0x7F), u)
    bad = a.view(torch.uint8) != b.view(torch.uint8)
    share = [n / written for n in bad.flatten(1).sum(1).tolist()]
    return share, (place(a) - place(b)).abs().flatten(1).amax(1).tolist()


def near_ties(torch, cfg, params, S, dev, kv_dtype, prompts, outs, logits_tol):
    """Where spec decode's greedy tokens (``outs[True]``) part from plain
    decode's (``outs[False]``) on a byte pool: each request's first
    differing token, checked against a third path, the prefill of the
    request's common prefix through the kernels on a fresh pool of
    ``kv_dtype``.  A near-tie passes: the two tokens are that path's top
    two logits, within ``logits_tol`` of the top logit's magnitude (the
    byte pool's bf16 operands and the verify and decode forwards' GEMM
    shapes can turn such a tie either way).  Returns [(request, token
    index, top two logits, their ids, gap)]; raises on any other split.
    A hybrid model only (:func:`hybrid_logits`)."""
    ties = []
    for r, (a, b) in enumerate(zip(outs[False], outs[True])):
        if a == b:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        prefix = prompts[r] + a[:j]
        lg = hybrid_logits(torch, cfg, params, S, dev, False, len(prefix), kv_dtype,
                           prompt=prefix)[0]
        top = torch.topk(lg.float(), 2)
        vals, ids = [round(v, 6) for v in top.values.tolist()], top.indices.tolist()
        gap = vals[0] - vals[1]
        require(sorted(ids) == sorted((a[j], b[j])) and gap <= logits_tol * abs(vals[0]),
                f"request {r}: spec token {b[j]} and plain token {a[j]} at {j} are not the "
                f"prefill path's near-tied top two (top two {vals}, ids {ids})")
        ties.append((r, j, vals, ids, gap))
    return ties


def phase_byte_pools(torch, ops, cfg, params, S, dev, rehearse, *, tag, mix_kernels,
                     spec_kernel, logits_tol, bf16_pages=None, f32_model=None,
                     elastic_group=0, parts="1234", spec_ties=False):
    """One model family over int8 and e4m3 pools: Llama-3-8B in phase 9,
    the MLA family's latent pool in phase 8 (c), Gemma-2-27B's arena in
    phase 10 (f); ``tag`` prefixes the log lines of parts 1-4.  (1) the
    pages one HBM budget (``bf16_pages`` bf16 pages, phase 4's 320 by
    default) holds per pool type; (2) phase 4's request mix on each byte
    pool (bf16 model), launch counters zeroed just before and read just
    after (``mix_kernels`` of each pool type > 0; a name ``"K1+softcap"``
    counts the soft-capped mode), tok/s and one decode dispatch's device
    busy share; (3) on each byte pool, at float32 (``f32_model()``: the
    model and parameters, by default the same weights widened), the logits
    gate below, and spec decode's greedy tokens identical to plain decode's
    (``spec_kernel`` of each pool type > 0, counted over the spec run); (4)
    GREW/SHRANK/CORRECT on an int8 pool through layer group
    ``elastic_group``'s segment.  ``parts`` names the parts to run (1 and
    2 go together).  ``spec_ties``: in (3), spec tokens may part from plain
    decode's at a near-tie (:func:`near_ties`).  Returns (launches by
    kernel and mode, tok/s by mode).

    The logits gate: the kernel path's last-position logits within
    ``logits_tol`` (norm-relative) of the plain path's, and the byte pool's
    own effect on the plain path (byte pool vs float32 pool) above
    ``logits_tol``, so that the gate tells a quantized pool from one that
    kept float32 entries.  The pools after the steps back the cause of the
    remaining difference: both paths write layer 0 from identical inputs,
    so its codes must be equal; layer 1's inputs differ only by layer 0's
    attention, whose bf16 softmax weights the kernel rounds against the
    running maxima of its key tiles and the plain version against the
    row's (phase 3's tolerance), so its entries move by less than an int8
    step and a differing int8 code must be a neighbour.  e4m3's values
    crowd towards zero (2^-9 apart below 2^-6), where the same movement
    crosses several codes.  The deeper layers compound; the shares of
    differing codes and their distances are printed for every layer (model
    layers: a hybrid arena's layer holds one model layer of each group)."""
    from kvcached_tpu_torch.config import KVConfig
    from kvcached_tpu_torch.device.pool import PoolSpec
    from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams

    TP, V, new = S["TP"], cfg.vocab_size, S["max_new"]
    modes = {"int8": "int8", "float8_e4m3fn": "fp8"}
    part = lambda n: f"[{tag}{n}]"  # noqa: E731
    buffers = getattr(cfg, "num_kv_buffers", 2)
    groups = len(getattr(cfg, "group_windows", (None,)))
    arena_layers = cfg.layers_per_group if groups > 1 else cfg.num_layers
    kv = lambda dt: KVConfig(  # noqa: E731
        num_layers=arena_layers, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        block_tokens=TP, page_tokens=TP, kv_dtype=dt, num_kv_buffers=buffers)
    if bf16_pages is None:
        bf16_pages = 320 if not rehearse else 96  # phase 4's and phase 8's pools
    budget = bf16_pages * kv("bfloat16").page_bytes
    pages = {dt: PoolSpec.from_config(kv(dt), hbm_budget_bytes=budget).num_pages
             for dt in ("bfloat16", *modes)}
    counts, tok_s = {}, {}
    if "2" in parts:
        log(f"{part(1)} one HBM budget of {budget / 2**30:.3f} GiB holds "
            + ", ".join(f"{dt} {n} pages ({n * TP} tokens)" for dt, n in pages.items()))
        require(all(pages[dt] == 2 * pages["bfloat16"] for dt in modes),
                "a byte pool holds twice bf16's pages")
        for mode, mt in modes.items():
            eng = LLMEngine(cfg, EngineConfig(
                max_batch=8, max_model_len=2048 if not rehearse else 256, page_tokens=TP,
                decode_horizon=8, prefill_buckets=S["buckets"], num_pages=pages[mode],
                kv_dtype=mode, prefill_batch=4), params=params, device=dev)
            require(eng.k_pools.element_size() == 1 and (eng.v_pools is None) == (buffers == 1),
                    "a byte pool holds one byte a value, in the family's buffers")
            rand, greedy, wave1, wave2 = request_mix(S, V, new)
            _, out1, out2, wall = serve_mix(ops, eng, wave1, wave2)
            by_dtype = ops.launch_counts_by_dtype()  # the main path's, by pool type
            m = eng.kv_metrics()
            prof = None if rehearse else profile_decode(torch, eng, rand, greedy)
            eng.shutdown()
            del eng
            th = m["throughput"]
            tok_s[f"{mt} prefill"] = th["prefill_tokens"] / max(th["prefill_seconds"], 1e-9)
            tok_s[f"{mt} decode"] = th["decode_tokens"] / max(th["decode_seconds"], 1e-9)
            for k in mix_kernels:
                name, _, mod = k.partition("+")
                counts[f"{k} {mt}"] = by_dtype[name].get(mode + (f"+{mod}" if mod else ""), 0)
            outs = out1 + out2
            log(f"{part(2)} {mode} pool, {pages[mode]} pages: {len(outs)} requests; wave 2 in "
                f"{wall:.2f} s: prefill {tok_s[mt + ' prefill']:.1f} tok/s, decode "
                f"{tok_s[mt + ' decode']:.1f} tok/s; prefix cache {m['prefix_cache']}; "
                f"launches by pool type {json.dumps(by_dtype)}")
            if prof:
                log(f"{part(2)} {mode}: one decode dispatch ({prof['rows']} rows x "
                    f"{prof['steps']} steps) under torch.profiler: wall {prof['wall_ms']:.2f} "
                    f"ms, device busy {prof['device_ms']:.2f} ms "
                    f"({100 * prof['device_ms'] / prof['wall_ms']:.1f}%), top kernels "
                    f"{json.dumps(prof['top'])}")
            require(all(len(o) == new for o in outs), "every request yields max_new tokens")
            require(all(0 <= t < V for o in outs for t in o), "tokens inside the vocabulary")
            require((m["prefix_cache"]["hits"] > 0) == (groups == 1)
                    and m["prefill_batch"]["dispatches"] > 0,
                    "the prefix hit (no cache for layer groups) and batched prefill ran")
            for k in mix_kernels:
                if not rehearse:
                    require(counts[f"{k} {mt}"] > 0, f"{k} {mt} was never launched")
    if "3" in parts:
        # (3) at float32: the same weights widened, or the caller's model
        if dev.type == "cuda":
            torch.cuda.empty_cache()  # the byte engines' arenas, before the float32 weights
        c32, p32 = f32_model() if f32_model else float32_copy(cfg, params)
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
        rand = request_mix(S, V, new)[0]
        B0 = max(S["buckets"])
        prompts = [(rand(12) * B0)[:B0 // 4], rand(B0 // 3), (rand(7) * B0)[:B0 // 8], rand(B0 // 5)]
        sp = SamplingParams(max_new_tokens=S["spec_new_exact"])
        where = ("prefill", "decode", "verify")
        ref32 = last_logits(torch, c32, p32, S, dev, True)  # plain path, float32 pool
        for mode, mt in modes.items():
            kern, kpools, written = last_logits(torch, c32, p32, S, dev, False, kv_dtype=mode,
                                                with_pools=True)
            plain, ppools, _ = last_logits(torch, c32, p32, S, dev, True, kv_dtype=mode,
                                           with_pools=True)
            rels = {w: rel(a, b) for w, a, b in zip(where, kern, plain)}
            quant = {w: rel(b, r) for w, b, r in zip(where, plain, ref32)}
            codes = {name: byte_code_diffs(torch, a, b, mode, written)
                     for name, a, b in zip("KV", kpools, ppools)}
            del kpools, ppools
            log(f"{part(3)} {mode} pool, float32 model: last-position logits kernel path vs "
                f"plain path, norm-relative {json.dumps(rels)} (tol {logits_tol}); the byte "
                f"pool's own effect (plain path, {mode} pool vs float32 pool) "
                f"{json.dumps(quant)} (must exceed the tol); share of written codes that "
                f"differ between the paths' pools, by layer "
                + json.dumps({n: [float(f"{s:.3e}") for s in sh] for n, (sh, _) in codes.items()})
                + "; the most values between two codes, by layer "
                + json.dumps({n: dist for n, (_, dist) in codes.items()}))
            require(max(rels.values()) <= logits_tol, f"{mode} logits disagree: {rels}")
            if not rehearse:  # the toy models of a rehearsal move less
                require(min(quant.values()) > logits_tol,
                        f"the logits gate cannot tell a {mode} pool from a float32 pool: {quant}")
            require(all(sh[0] == 0 for sh, _ in codes.values()),
                    f"{mode} layer 0 codes differ, written from identical inputs")
            require(mode != "int8" or all(dist[1] <= 1 for _, dist in codes.values()),
                    f"{mode} layer 1 codes differ by more than one step")
            outs, ms = {}, None
            for spec in (False, True):
                eng = LLMEngine(c32, EngineConfig(
                    max_batch=8, max_model_len=2048 if not rehearse else 256, page_tokens=TP,
                    decode_horizon=8, prefill_buckets=S["buckets"], num_pages=128,
                    kv_dtype=mode, prefill_batch=4, spec_decode=spec), params=p32, device=dev)
                if spec:
                    ops.reset_launch_counts()  # --- the byte pool's spec path starts here
                outs[spec] = serve(eng, [(p, sp) for p in prompts])
                if spec:
                    name, _, mod = spec_kernel.partition("+")
                    counts[f"{spec_kernel} {mt}"] = ops.launch_counts_by_dtype()[name].get(
                        mode + (f"+{mod}" if mod else ""), 0)
                    ms = eng.kv_metrics()["spec"]  # --- and ends here
                eng.shutdown()
                del eng
            same = outs[True] == outs[False]
            ties = near_ties(torch, c32, p32, S, dev, mode, prompts, outs, logits_tol) \
                if spec_ties and not same else []
            log(f"{part(3)} {mode} pool, float32 model, {len(prompts)} requests x "
                f"{S['spec_new_exact']} tokens: spec decode vs plain decode greedy tokens "
                f"identical: {same}; spec {json.dumps(ms)}; {spec_kernel} {mt} launches "
                f"{counts[f'{spec_kernel} {mt}']}"
                + "".join(f"; request {r} parts at token {j}, where the prefill path's top two "
                          f"logits {top} are {gap:.3e} apart (ids {ids}): a near-tie"
                          for r, j, top, ids, gap in ties))
            require(same or ties, f"float32 spec decode on the {mode} pool changed greedy tokens")
            require(ms["dispatches"] > 0, "the spec run dispatched no verify")
            if not rehearse:
                require(counts[f"{spec_kernel} {mt}"] > 0, f"{spec_kernel} {mt} was never launched")
        del p32
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if "4" in parts:
        # (4) the elastic gate on an int8 pool (bf16 model)
        phase_elastic(torch, cfg, params, S, dev, rehearse, tag=f"{tag}4 int8", kv_dtype="int8",
                      group=elastic_group)
    return counts, tok_s


# ---------------------------------------------------------------------------
# 8. the MLA family at DeepSeek-V2-Lite's widths
# ---------------------------------------------------------------------------


def phase_mla(torch, ops, S, dev, rehearse):
    """The MLA family served by ``LLMEngine`` at DeepSeek-V2-Lite's widths
    (bf16, weights drawn on the card from a seed): (a) phase 4's request mix
    with the launch counters zeroed just before and read just after, K5, K6
    and K3m each > 0; (b) the same mix with spec decode, K4's MLA form K5v
    > 0; (c) the same weights over int8 and e4m3 latent pools
    (:func:`phase_byte_pools`); (d) last-position logits kernel path vs
    plain path at float32; (e) float32 spec tokens (spec_exact) identical
    to plain decode's; (f) GREW/SHRANK/CORRECT under a live limit.  Returns
    the launch counts and the tok/s."""
    from kvcached_tpu_torch.engine import EngineConfig, LLMEngine
    from kvcached_tpu_torch.models import mla

    t_phase = time.perf_counter()
    cfg = getattr(mla.MLAConfig, S["mla_model"])()
    t0 = time.perf_counter()
    params = mla.init_mla_params(cfg, seed=0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[mla] {S['mla_model']}: L={cfg.num_layers} E={cfg.hidden_size} H={cfg.num_heads} "
        f"latent {cfg.kv_lora_rank}+{cfg.qk_rope_head_dim} (pool lanes "
        f"{cfg.cache_head_dim}) F={cfg.intermediate_size} V={cfg.vocab_size} {cfg.dtype}: "
        f"{n_params / 1e9:.2f} B params drawn on {dev} in {time.perf_counter() - t0:.1f} s")
    TP, V, new = S["TP"], cfg.vocab_size, S["max_new"]

    def make(c, p, spec=False, num_pages=320 if not rehearse else 96):
        return LLMEngine(c, EngineConfig(
            max_batch=8, max_model_len=2048 if not rehearse else 256, page_tokens=TP,
            decode_horizon=8, prefill_buckets=S["buckets"], num_pages=num_pages,
            kv_dtype=c.dtype, prefill_batch=4, spec_decode=spec,
            spec_exact=spec and c.dtype == "float32"), params=p, device=dev)

    tok_s, counts = {}, {}
    for spec in (False, True):
        eng = make(cfg, params, spec)
        require(eng.v_pools is None, "the MLA pool is one buffer")
        rand, greedy, wave1, wave2 = request_mix(S, V, new)
        got, out1, out2, wall = serve_mix(ops, eng, wave1, wave2)
        m = eng.kv_metrics()
        prof = None if rehearse else profile_decode(torch, eng, rand, greedy, spec=spec)
        eng.shutdown()
        del eng
        th = m["throughput"]
        outs = out1 + out2
        tag = "spec" if spec else "plain"
        tok_s[f"{tag} prefill"] = th["prefill_tokens"] / max(th["prefill_seconds"], 1e-9)
        tok_s[f"{tag} decode"] = th["decode_tokens"] / max(th["decode_seconds"], 1e-9)
        log(f"[mla] ({'b' if spec else 'a'}) {cfg.dtype}, spec_decode={spec}: "
            f"{len(outs)} requests, {sum(map(len, outs))} tokens; wave 2 in {wall:.2f} s: "
            f"prefill {tok_s[tag + ' prefill']:.1f} tok/s, decode "
            f"{tok_s[tag + ' decode']:.1f} tok/s; prefix cache {m['prefix_cache']}, "
            f"prefill batch {m['prefill_batch']}, spec {json.dumps(m.get('spec'))}; "
            f"kernel launches {json.dumps(got)}")
        if prof:
            log(f"[mla] one {'spec' if spec else 'decode'} dispatch ({prof['rows']} rows x "
                f"{prof['steps']} {'verify iterations' if spec else 'steps'}) under "
                f"torch.profiler: wall {prof['wall_ms']:.2f} ms, device busy "
                f"{prof['device_ms']:.2f} ms ({100 * prof['device_ms'] / prof['wall_ms']:.1f}%), "
                f"top kernels {json.dumps(prof['top'])}")
        require(all(len(o) == new for o in outs), "every MLA request yields max_new tokens")
        require(all(0 <= t < V for o in outs for t in o), "MLA tokens inside the vocabulary")
        require(m["prefix_cache"]["hits"] > 0, "the MLA prefix was a cache hit")
        require(m["prefill_batch"]["dispatches"] > 0, "MLA batched prefill ran")
        for k in (("K5v",) if spec else ("K5", "K6", "K3m")):
            counts[k] = got[k]
            if not rehearse:
                require(got[k] > 0, f"{k} was never launched on the MLA path")
    byte_counts, byte_tok_s = phase_byte_pools(
        torch, ops, cfg, params, S, dev, rehearse, tag="mla c", mix_kernels=("K5", "K6", "K3m"),
        spec_kernel="K5v", logits_tol=MLA_BYTE_LOGITS_TOL)
    counts.update(byte_counts)
    tok_s.update(byte_tok_s)
    rels = logits_check(torch, cfg, params, S, dev)
    log(f"[mla] (d) last-position logits, kernel path vs plain path on {dev}, "
        f"norm-relative error: float32 prefill {rels['f32_prefill']:.3e} decode "
        f"{rels['f32_decode']:.3e} verify {rels['f32_verify']:.3e} (tol {LOGITS_REL_TOL}); "
        f"bf16 prefill {rels['bf16_prefill']:.3e} decode {rels['bf16_decode']:.3e} verify "
        f"{rels['bf16_verify']:.3e} (bf16 plain path vs float32 plain path: prefill "
        f"{rels['bf16_vs_f32_prefill']:.3e} decode {rels['bf16_vs_f32_decode']:.3e} "
        f"verify {rels['bf16_vs_f32_verify']:.3e})")
    require(max(rels["f32_prefill"], rels["f32_decode"], rels["f32_verify"])
            <= LOGITS_REL_TOL, f"MLA logits disagree: {rels}")

    c32, p32 = float32_copy(cfg, params)
    spec_exact(torch, c32, p32, S, dev, rehearse, tag="[mla] (e)", num_pages=64)
    del p32
    phase_elastic(torch, cfg, params, S, dev, rehearse, tag="mla (f) elastic")
    log(f"[mla] phase 8 in {time.perf_counter() - t_phase:.1f} s")
    return counts, tok_s


# ---------------------------------------------------------------------------
# 10. the hybrid family at Gemma-2-27B's widths
# ---------------------------------------------------------------------------


def hybrid_config(S, model=None, **kw):
    """A hybrid model's widths: ``model`` (default ``S["hyb_model"]``) names
    a ``HybridConfig`` classmethod (``gemma2_27b``, ``gemma2_9b``), or in a
    rehearsal a toy with every Gemma2 knob on: ``toy`` at head_dim 128,
    ``toy256`` at head_dim 256 with a query width (4 x 256) other than its
    hidden size (384)."""
    from kvcached_tpu_torch.models.hybrid import HybridConfig

    model = model or S["hyb_model"]
    if not model.startswith("toy"):
        return getattr(HybridConfig, model)(**kw)
    L = kw.pop("num_layers", 4)  # even layers slide, as Gemma2's: group 1 is the full one
    widths = (dict(head_dim=256, hidden_size=384, query_scale=256.0) if model == "toy256"
              else dict(query_scale=144.0))
    return HybridConfig.toy(
        num_layers=L, layer_windows=tuple(S["hyb_window"] if i % 2 == 0 else None
                                          for i in range(L)),
        act="gelu_tanh", norm_offset=True, embed_scale=True, post_norms=True,
        attn_softcap=50.0, final_softcap=30.0, **widths, **kw)


def hybrid_logits(torch, cfg, params, S, dev, reference, plen, kv_dtype=None,
                  with_pools=False, prompt=None):
    """Last-position logits of a ``plen``-token prompt prefilled in chunks
    of the largest bucket, of one decode step after it and of one verify
    step of spec_T fed tokens after that, through the kernels or
    (``reference``) through their plain versions, on fresh pools of the
    model's dtype or ``kv_dtype`` (an int8 pool with the engine's default
    scales): one arena of ``layers_per_group`` layers whose pages each
    group takes from its own row of the table.  ``with_pools`` as in
    :func:`last_logits`, each model layer's pages gathered from its arena
    layer; ``prompt``: the prompt's tokens (default: ``plen`` drawn from
    seed 3)."""
    from kvcached_tpu_torch.models import hybrid as th

    TP, B0, Tv = S["TP"], max(S["buckets"]), S["spec_T"]
    G = len(cfg.group_windows)
    pdt, kw = _logits_pool(torch, cfg, dev, kv_dtype)
    n_pages = -(-(plen + 1 + Tv) // TP)
    shape = (cfg.layers_per_group, G * n_pages + 1, cfg.num_kv_heads, TP, cfg.head_dim)
    if prompt is None:
        g = torch.Generator(device=dev).manual_seed(3)
        prompt = torch.randint(0, cfg.vocab_size, (plen,), generator=g, device=dev,
                               dtype=torch.int32)
    else:
        prompt = torch.tensor(prompt, dtype=torch.int32, device=dev)
    table = torch.arange(1, G * n_pages + 1, dtype=torch.int32, device=dev).reshape(G, n_pages)
    kp = torch.zeros(shape, dtype=pdt, device=dev)
    vp = torch.zeros_like(kp)
    for q0 in range(0, plen, B0):
        n = min(B0, plen - q0)
        Tb = next(b for b in S["buckets"] if b >= n)
        toks = torch.zeros(Tb, dtype=torch.int32, device=dev)
        toks[:n] = prompt[q0:q0 + n]
        pos = q0 + torch.arange(Tb, dtype=torch.int32, device=dev)
        chunk = torch.zeros((G, Tb // TP), dtype=torch.int32, device=dev)
        nreal = -(-n // TP)
        chunk[:, :nreal] = table[:, q0 // TP: q0 // TP + nreal]
        lg_prefill, _, _ = th.hybrid_prefill_step(params, cfg, toks, pos, kp, vp, chunk, table,
                                                  q0, n, reference_attention=reference, **kw)
    one = lambda x: torch.tensor([x], dtype=torch.int32, device=dev)  # noqa: E731
    lg_decode, _, _ = th.hybrid_decode_step(
        params, cfg, prompt[:1], one(plen), kp, vp, table[:, None],
        table[:, plen // TP: plen // TP + 1].contiguous(), one(plen % TP), one(plen + 1),
        reference_attention=reference, **kw)
    vpos = plen + 1 + torch.arange(Tv, dtype=torch.int32, device=dev)
    lg_verify, _, _ = th.hybrid_verify_step(
        params, cfg, prompt[None, 1:Tv + 1], vpos[None], kp, vp, table[:, None],
        table[:, vpos // TP][:, None].contiguous(), (vpos % TP)[None], one(plen + 1 + Tv),
        reference_attention=reference, **kw)
    logits = lg_prefill, lg_decode[0], lg_verify[0, -1]
    if not with_pools:
        return logits
    layers = [pool[lg][table[g].long()] for pool in (kp, vp)
              for g, lg in zip(cfg.group_index, cfg.layer_in_group)]
    L = cfg.num_layers
    return logits, [torch.stack(layers[:L]), torch.stack(layers[L:])], \
        (plen + 1 + Tv) * cfg.num_kv_heads * cfg.head_dim


def spec_exact(torch, cfg, params, S, dev, rehearse, *, tag, num_pages=128):
    """A float32 model's greedy tokens with spec decode (spec_exact)
    identical to plain decode's, on prompts half of which repeat (phase 8
    (e), phase 10 (d))."""
    from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams

    rand = request_mix(S, cfg.vocab_size, S["max_new"])[0]
    B0 = max(S["buckets"])
    prompts = [(rand(12) * B0)[:B0 // 4], rand(B0 // 3), (rand(7) * B0)[:B0 // 8], rand(B0 // 5)]
    sp = SamplingParams(max_new_tokens=S["spec_new_exact"])
    outs, ms = {}, None
    for spec in (False, True):
        eng = LLMEngine(cfg, EngineConfig(
            max_batch=8, max_model_len=2048 if not rehearse else 256, page_tokens=S["TP"],
            decode_horizon=8, prefill_buckets=S["buckets"], num_pages=num_pages,
            kv_dtype="float32", prefill_batch=4, spec_decode=spec, spec_exact=spec),
            params=params, device=dev)
        outs[spec] = serve(eng, [(p, sp) for p in prompts])
        ms = eng.kv_metrics().get("spec")
        eng.shutdown()
        del eng
    same = outs[True] == outs[False]
    log(f"{tag} float32, {cfg.num_layers} layers, {len(prompts)} requests x "
        f"{S['spec_new_exact']} tokens: spec decode (spec_exact) vs plain decode greedy tokens "
        f"identical: {same}; spec {json.dumps(ms)}")
    require(same, f"{tag} float32 spec decode changed greedy tokens")
    require(ms["dispatches"] > 0, f"{tag} the float32 spec run dispatched no verify")


def phase_hybrid(torch, ops, S, dev, rehearse, *, model=None, pages=None, tag="hybrid",
                 phase="10"):
    """The hybrid family (two layer groups, sliding and full, on one shared
    arena) at ``model``'s widths (``hybrid_config``: Gemma-2-27B in phase
    10, Gemma-2-9B, head_dim 256, in phase 11) on ``pages`` bf16 arena
    pages (default ``S["hyb_pages"]``), after every earlier model is freed:
    (a) a 4-layer float32 model of the same widths, last-position logits of
    a prompt longer than the 4096-token window (prefill, one decode step and
    one verify step) through the kernels against the plain path,
    norm-relative, with the final soft-cap on; (b) the bf16 model at all 46 layers, weights
    drawn on the card from seed 0, serving phase 4's request mix plus a
    prompt longer than the window, with the launch counters zeroed just
    before and read just after (soft-capped K1 and K3, and K2, > 0), the
    sliding group freeing pages of that request while the full group keeps
    all of its own, both groups' pages from one arena, tok/s and one decode
    dispatch under torch.profiler; (c) GREW/SHRANK/CORRECT through a limit
    on the full group's segment (``_g1``); (d) the 4-layer float32 model's
    greedy tokens with spec decode (spec_exact) identical to plain decode's;
    (e) the bf16 model serving phase 4's request mix without and with spec
    decode, the launch counters zeroed just before and read just after the
    spec run (soft-capped K4 > 0), tok/s, tokens per verify iteration and
    one spec dispatch under torch.profiler; (f) int8 and e4m3 arenas
    (:func:`phase_byte_pools`: pages per budget, phase 4's mix, the 4-layer
    float32 logits gate and spec tokens, the elastic gate on int8 through
    ``_g1``).  (d) and (f)'s float32 part run right after (a), on its
    model: beside the 46-layer bf16 model its 17 GiB would not fit.  ``tag``
    and ``phase`` name the log lines.  Returns (launches by row of the
    kernel table, tok/s); the rows of a head_dim other than 128 carry it
    (``"K1 d256"``), whose launches count under ``"+d256"``."""
    import math

    from kvcached_tpu_torch.engine import EngineConfig, LLMEngine
    from kvcached_tpu_torch.models.hybrid import init_hybrid_params

    t_phase = time.perf_counter()
    mem = lambda: (f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated"  # noqa: E731
                   if dev.type == "cuda" else "on the CPU")
    # (a) the float32 gate at 4 layers (float32 at 46 layers would not fit)
    c32 = hybrid_config(S, model, num_layers=4, dtype="float32")
    hd = "" if c32.head_dim == 128 else f"+d{c32.head_dim}"  # launch keys' suffix
    log(f"[{tag}] (a) before the float32 model: {mem()}")
    p32 = init_hybrid_params(c32, seed=0, device=dev)
    plen = S["hyb_long"]
    kern = hybrid_logits(torch, c32, p32, S, dev, False, plen)
    plain = hybrid_logits(torch, c32, p32, S, dev, True, plen)
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    rels = {w: rel(a, b) for w, a, b in zip(("prefill", "decode", "verify"), kern, plain)}
    c = c32.final_softcap
    raw = [c * torch.atanh((x / c).double()) for x in plain]  # the logits before the cap
    moved = [float(((r - x.double()).abs() > 1e-3).double().mean()) for r, x in zip(raw, plain)]
    log(f"[{tag}] (a) {model or S['hyb_model']} widths at {c32.num_layers} layers, float32, a "
        f"{plen}-token prompt (window {c32.group_windows}): last-position logits, kernel path "
        f"vs plain path on {dev}, norm-relative {json.dumps(rels)} (tol {LOGITS_REL_TOL}); "
        f"final soft-cap {c}: share of logits it moved by more than 1e-3: prefill "
        f"{moved[0]:.3e} decode {moved[1]:.3e} verify {moved[2]:.3e}, largest logit before the cap "
        f"{max(float(r.abs().max()) for r in raw):.3f}")
    require(c is not None and c32.attn_softcap is not None, "the soft-caps are on")
    require(max(rels.values()) <= LOGITS_REL_TOL, f"hybrid logits disagree: {rels}")
    # (d) and (f)'s float32 part run here, on the 4-layer model: beside the
    # 46-layer bf16 model (53 GiB) its 17 GiB would not fit
    TP, V, new = S["TP"], c32.vocab_size, S["max_new"]
    spec_exact(torch, c32, p32, S, dev, rehearse, tag=f"[{tag}] (d)")
    mix_kernels = (f"K1+softcap{hd}", f"K2{hd}", f"K3+softcap{hd}")
    byte_counts, tok_s = phase_byte_pools(
        torch, ops, c32, p32, S, dev, rehearse, tag=f"{tag} f",
        mix_kernels=mix_kernels, spec_kernel=f"K4+softcap{hd}",
        logits_tol=LOGITS_REL_TOL, f32_model=lambda: (c32, p32), parts="3", spec_ties=True)
    del p32
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (b) the bf16 model at full depth
    cfg = hybrid_config(S, model)
    pages = pages or S["hyb_pages"]
    log(f"[{tag}] (b) before the bf16 model: {mem()}")
    t0 = time.perf_counter()
    params = init_hybrid_params(cfg, seed=0, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"[{tag}] (b) {model or S['hyb_model']}: L={cfg.num_layers} E={cfg.hidden_size} "
        f"H={cfg.num_heads} KH={cfg.num_kv_heads} D={cfg.head_dim} F={cfg.intermediate_size} "
        f"V={cfg.vocab_size} groups {cfg.group_windows} x {cfg.layers_per_group} layers, "
        f"softcaps {cfg.attn_softcap}/{cfg.final_softcap}, {cfg.dtype}: "
        f"{n_params / 1e9:.2f} B params drawn on {dev} in {time.perf_counter() - t0:.1f} s; "
        f"{mem()}")
    eng = LLMEngine(cfg, EngineConfig(
        max_batch=8, max_model_len=S["hyb_max_len"], page_tokens=TP, decode_horizon=8,
        prefill_buckets=S["buckets"], num_pages=pages, kv_dtype=cfg.dtype,
        prefill_batch=4), params=params, device=dev)
    log(f"[{tag}] (b) arena: {eng.pool.capacity} pages x {eng.kv_cfg.page_bytes} B "
        f"({eng.pool.capacity * eng.kv_cfg.page_bytes / 2**30:.2f} GiB, "
        f"{cfg.layers_per_group} layers a page); {mem()}")
    rand, greedy, wave1, wave2 = request_mix(S, V, new)
    sliding = next(g for g, w in enumerate(cfg.group_windows) if w)
    full_g = next(g for g, w in enumerate(cfg.group_windows) if not w)
    ops.reset_launch_counts()  # --- the main path starts here
    out1 = serve(eng, wave1)
    eng.stats.update(prefill_tokens=0, prefill_seconds=0.0, decode_tokens=0,
                     decode_seconds=0.0, decode_steps=0)
    t0 = time.perf_counter()
    ids = [eng.add_request(p, sp) for p, sp in wave2 + [(rand(plen), greedy)]]
    freed, kept, full_pages = 0, True, 0
    while eng.has_unfinished():
        eng.step()
        seq = next((s for s in eng.running if s.req.req_id == ids[-1]), None)
        if seq is not None:  # the long request, while it runs
            freed = max(freed, sum(b is None for b in seq.blocks_g[sliding]))
            kept = kept and None not in seq.blocks_g[full_g]
            full_pages = max(full_pages, len(seq.blocks_g[full_g]))
    wall = time.perf_counter() - t0
    counts, by_dtype = ops.launch_counts(), ops.launch_counts_by_dtype()  # --- and ends here
    by_id = {o.req_id: o.output_tokens for o in eng.finished_outputs}
    outs = out1 + [by_id[i] for i in ids]
    m = eng.kv_metrics()
    # one arena: what group 1 takes, group 0 can no longer obtain, and gets
    # back once group 1 frees it
    m0, m1 = eng.managers
    before = m0.available_size()
    taken = m1.alloc(max(m1.available_size() - 8, 1))
    drained = m0.available_size()
    m1.free(taken or [])
    m1.trim()
    after = m0.available_size()
    prof = None if rehearse else profile_decode(torch, eng, rand, greedy)
    eng.shutdown()
    del eng
    th = m["throughput"]
    tok_s.update(prefill=th["prefill_tokens"] / max(th["prefill_seconds"], 1e-9),
                 decode=th["decode_tokens"] / max(th["decode_seconds"], 1e-9))
    log(f"[{tag}] (b) {len(outs)} requests ({len(wave2)} of wave 2 plus a {plen}-token "
        f"prompt), {sum(map(len, outs))} tokens; wave 2 in {wall:.2f} s: prefill "
        f"{tok_s['prefill']:.1f} tok/s ({th['prefill_tokens']} tokens), decode "
        f"{tok_s['decode']:.1f} tok/s ({th['decode_tokens']} tokens); prefix cache "
        f"{m['prefix_cache']}; prefill batch {m['prefill_batch']}; preemptions "
        f"{m['preemptions']}; groups {json.dumps(m['groups'])}")
    log(f"[{tag}] (b) kernel launches on the main path {json.dumps(counts)}, by pool type "
        f"{json.dumps(by_dtype)}")
    log(f"[{tag}] (b) the {plen}-token request: the sliding group (window "
        f"{cfg.group_windows[sliding]}) freed up to {freed} pages of it, the full group kept "
        f"all of its {full_pages}: {kept}; one arena: group 0 could obtain {before} pages, "
        f"{drained} while group 1 held {len(taken or [])}, {after} after group 1 freed them")
    if prof:
        log(f"[{tag}] (b) one decode dispatch ({prof['rows']} rows x {prof['steps']} steps) "
            f"under torch.profiler: wall {prof['wall_ms']:.2f} ms, device busy "
            f"{prof['device_ms']:.2f} ms ({100 * prof['device_ms'] / prof['wall_ms']:.1f}%), "
            f"top kernels {json.dumps(prof['top'])}")
    require(all(len(o) == new for o in outs), "every hybrid request yields max_new tokens")
    require(all(0 <= t < V for o in outs for t in o), "hybrid tokens inside the vocabulary")
    require(m["prefix_cache"]["hits"] == 0, "the prefix cache is off for layer groups")
    require(m["prefill_batch"]["dispatches"] > 0, "hybrid batched prefill ran")
    require(freed > 0 and kept and full_pages * TP > plen,
            "the sliding group frees pages while the full group keeps its own")
    require(taken is not None and drained < before // 4 and after > before // 2,
            "both groups take their pages from one arena")
    # the soft-capped rows' launches (at head_dim 128 K2's row keeps phase
    # 4's count; at 256 K2 has a row of its own)
    row = (lambda k: f"{k} softcap") if not hd else (lambda k: f"{k} d{c32.head_dim}")
    hyb = {row("K1"): by_dtype["K1"].get(f"{cfg.dtype}+softcap{hd}", 0),
           row("K3"): by_dtype["K3"].get(f"{cfg.dtype}+softcap{hd}", 0)}
    if hd:
        hyb[row("K2")] = by_dtype["K2"].get(f"{cfg.dtype}{hd}", 0)
    if not rehearse:
        for k, n in dict(hyb, K2=counts["K2"]).items():
            require(n > 0, f"{k} was never launched on the {tag} path")
    # (c) the elastic gate through the full group's segment, _g1
    require(full_g == 1, "Gemma2's full-attention layers are group 1")
    phase_elastic(torch, cfg, params, S, dev, rehearse, tag=f"{tag} (c) elastic", group=1)

    # (e) the bf16 model at full depth: phase 4's mix without and with spec
    res = {}
    for spec in (False, True):
        eng = LLMEngine(cfg, EngineConfig(
            max_batch=8, max_model_len=S["hyb_max_len"], page_tokens=TP, decode_horizon=8,
            prefill_buckets=S["buckets"], num_pages=pages, kv_dtype=cfg.dtype,
            prefill_batch=4, spec_decode=spec), params=params, device=dev)
        rand, greedy, wave1, wave2 = request_mix(S, V, new)
        got, out1, out2, wall = serve_mix(ops, eng, wave1, wave2)  # spec: the main path
        by = ops.launch_counts_by_dtype()
        m = eng.kv_metrics()
        prof = None if rehearse else profile_decode(torch, eng, rand, greedy, spec=spec)
        eng.shutdown()
        del eng
        th = m["throughput"]
        res[spec] = r = dict(
            outs=out1 + out2, spec=m.get("spec"), prof=prof, counts=by,
            decode=th["decode_tokens"] / max(th["decode_seconds"], 1e-9),
            step_ms=1e3 * th["decode_seconds"] / max(th["decode_steps"], 1))
        log(f"[{tag}] (e) {cfg.dtype}, {cfg.num_layers} layers, spec_decode={spec}: "
            f"{len(r['outs'])} requests; wave 2 in {wall:.2f} s: decode {r['decode']:.1f} tok/s, "
            f"host wall {r['step_ms']:.2f} ms a {'verify iteration' if spec else 'decode step'}; "
            f"spec {json.dumps(r['spec'])}; kernel launches by pool type {json.dumps(by)}")
        if prof:
            log(f"[{tag}] (e) one {'spec' if spec else 'decode'} dispatch ({prof['rows']} rows "
                f"x {prof['steps']} {'verify iterations' if spec else 'steps'}) under "
                f"torch.profiler: wall {prof['wall_ms']:.2f} ms, device busy "
                f"{prof['device_ms']:.2f} ms ({100 * prof['device_ms'] / prof['wall_ms']:.1f}%), "
                f"top kernels {json.dumps(prof['top'])}")
        require(all(len(o) == new for o in r["outs"]), "every hybrid request yields max_new tokens")
        require(all(0 <= t < V for o in r["outs"] for t in o), "hybrid tokens inside the vocabulary")
    agree = sum(a == b for a, b in zip(res[True]["outs"], res[False]["outs"]))
    log(f"[{tag}] (e) decode {res[False]['decode']:.1f} tok/s plain, {res[True]['decode']:.1f} "
        f"tok/s spec; {res[True]['spec']['tokens_per_iteration']:.3f} tokens per row per verify "
        f"iteration; {agree}/{len(res[True]['outs'])} requests token-identical to plain decode "
        f"(bf16 is not exact)")
    require(res[True]["spec"]["dispatches"] > 0, "the hybrid spec run dispatched no verify")
    hyb[row("K4")] = res[True]["counts"]["K4"].get(f"{cfg.dtype}+softcap{hd}", 0)
    tok_s.update({"spec decode": res[True]["decode"], "mix plain decode": res[False]["decode"]})

    # (f) int8 and e4m3 arenas (their float32 part ran after (a))
    mix_counts, byte_tok_s = phase_byte_pools(
        torch, ops, cfg, params, S, dev, rehearse, tag=f"{tag} f",
        mix_kernels=mix_kernels, spec_kernel=f"K4+softcap{hd}",
        logits_tol=LOGITS_REL_TOL, bf16_pages=pages, elastic_group=1, parts="124")
    for mt in ("int8", "fp8"):
        hyb[f"{row('K4')} {mt}"] = byte_counts[f"K4+softcap{hd} {mt}"]
        if hd:  # at 256 the byte modes of K1, K2 and K3 have rows of their own
            for k, key in zip(("K1", "K2", "K3"), mix_kernels):
                hyb[f"{row(k)} {mt}"] = mix_counts[f"{key} {mt}"]
    tok_s.update(byte_tok_s)
    if not rehearse:
        for k, n in hyb.items():
            require(n > 0, f"{k} was never launched on the {tag} path")
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[{tag}] phase {phase} in {time.perf_counter() - t_phase:.1f} s ({math.ceil(plen / TP)} "
        f"pages of {TP} tokens for the long prompt)")
    return hyb, tok_s


# ---------------------------------------------------------------------------
# 6. real weights
# ---------------------------------------------------------------------------


class CharTokenizer:
    """The checkpoints' character-level WordLevel tokenizer, read from
    tokenizer.json (special tokens are dropped on decode)."""

    def __init__(self, ckpt):
        tj = json.load(open(os.path.join(ckpt, "tokenizer.json")))
        self.vocab = tj["model"]["vocab"]
        self.special = {t["id"] for t in tj.get("added_tokens", []) if t.get("special")}
        self.inv = {i: s for s, i in self.vocab.items()}
        self.eos_token_id = self.vocab["."]

    def encode(self, text):
        return [self.vocab[c] for c in text]

    def decode(self, ids):
        return "".join(self.inv[i] for i in ids if i not in self.special)


def phase_real_weights(torch, dev, rehearse):
    from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams
    from kvcached_tpu_torch.models.hf_loader import params_from_hf

    assets = os.path.join(HERE, "benchmarks", "assets")
    n = 32 if not rehearse else 8
    setups = {
        "tinyadd": (dict(max_model_len=32, page_tokens=16, prefill_buckets=(16,)),
                    lambda ex: (ex.split("=")[0] + "=", ex.split("=")[1].rstrip("."))),
        "winadd": (dict(max_model_len=128, page_tokens=32, prefill_buckets=(64,)),
                   lambda ex: (ex[0], ex[1])),
    }
    result = {}
    for name, (shape, split) in setups.items():
        ckpt = os.path.join(assets, name)
        tok = CharTokenizer(ckpt)
        held = json.load(open(os.path.join(ckpt, "heldout.json")))["examples"][:n]
        pairs = [split(ex) for ex in held]
        prompts = [tok.encode(p) for p, _ in pairs]
        sp = SamplingParams(max_new_tokens=6, stop_token_ids=(tok.eos_token_id,))
        toks = {}
        for spec in (False, True):
            for where in (dev, torch.device("cpu")):
                cfg, params = params_from_hf(ckpt, dtype="float32", device=where)
                eng = LLMEngine(cfg, EngineConfig(
                    max_batch=8, decode_horizon=2, num_pages=128, kv_dtype="float32",
                    adaptive_horizon=False, spec_decode=spec, **shape),
                    params=params, device=where)
                toks[where.type, spec] = serve(eng, [(p, sp) for p in prompts])
                eng.shutdown()
            same = toks[dev.type, spec] == toks["cpu", spec]
            exact = sum(tok.decode(t) == a for t, (_, a) in zip(toks[dev.type, spec], pairs))
            log(f"[real] {name} ({cfg.num_layers} layers, window {cfg.sliding_window}, "
                f"rope {cfg.rope_scaling}, bias {cfg.attention_bias}), spec_decode="
                f"{spec}: kernel path ({dev}) vs plain path (cpu) tokens identical: "
                f"{same}; exact match {exact}/{len(pairs)}")
            require(same, f"{name} spec_decode={spec}: kernel-path tokens differ "
                    "from the plain path")
            result[name] = f"{exact}/{len(pairs)}"
        log(f"[real] {name}: spec decode vs plain decode tokens identical on {dev}: "
            f"{toks[dev.type, True] == toks[dev.type, False]}")
    return result


# ---------------------------------------------------------------------------


def main(argv) -> int:
    rehearse = "--rehearse" in argv
    import torch

    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "kvcached_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(kvcached_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from kvcached_tpu_torch import ops

    S = REHEARSE if rehearse else CARD
    if rehearse:
        dev = torch.device("cpu")
        torch.cuda.synchronize = lambda *a: None
        smi = "rehearsal on the CPU"
    else:
        dev = torch.device("cuda")
        smi = phase_device(torch)
        phase_build()
        # the flex_attention yardstick is compiled (Triton through
        # inductor): its caches go into the build directory, and one
        # compile thread, so no worker processes are started
        from kvcached_tpu_torch.ops._build import build_dir

        os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", os.path.join(build_dir(), "inductor"))
        os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build_dir(), "triton"))
        os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")
    t0 = time.perf_counter()
    rows = {} if rehearse else phase_kernels(torch, ops, S, dev)
    if "--kernels-only" in argv:
        log("[done] kernels only: no result")
        return 4
    cfg, params, counts, tok_s = phase_engine(torch, ops, S, dev, rehearse)
    phase_elastic(torch, cfg, params, S, dev, rehearse)
    spec_counts, spec_tok_s = phase_spec(torch, ops, cfg, params, S, dev, rehearse)
    counts["K4"] = spec_counts["K4"]
    byte_counts, byte_tok_s = phase_byte_pools(
        torch, ops, cfg, params, S, dev, rehearse, tag="byte ", mix_kernels=("K1", "K2", "K3"),
        spec_kernel="K4", logits_tol=LOGITS_REL_TOL)
    counts.update(byte_counts)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mla_counts, mla_tok_s = phase_mla(torch, ops, S, dev, rehearse)
    counts.update(mla_counts)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    hyb_counts, hyb_tok_s = phase_hybrid(torch, ops, S, dev, rehearse)
    counts.update(hyb_counts)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    hyb9_counts, hyb9_tok_s = phase_hybrid(torch, ops, S, dev, rehearse, model=S["hyb9_model"],
                                           pages=S["hyb9_pages"], tag="gemma9", phase="11")
    counts.update(hyb9_counts)
    real = phase_real_weights(torch, dev, rehearse)
    log(f"[done] phases 3-11 in {time.perf_counter() - t0:.1f} s; engine tok/s "
        f"{json.dumps(tok_s)}; spec decode tok/s {json.dumps(spec_tok_s)}; byte pools "
        f"tok/s {json.dumps(byte_tok_s)}; MLA tok/s {json.dumps(mla_tok_s)}; hybrid tok/s "
        f"{json.dumps(hyb_tok_s)}; Gemma-2-9B tok/s {json.dumps(hyb9_tok_s)}; winadd exact "
        f"{real['winadd']}; card {smi}")
    if rehearse:
        log("[done] rehearsal only: no result")
        return 3
    # replaces: each TPU kernel's pl.pallas_call line
    meta = {
        "K1": ("paged_attention_decode", "paged_decode.cu",
               "kvcached_tpu/ops/paged_attention.py:609"),
        "K1r": ("paged_attention (K1 kernel, write off)", "paged_decode.cu",
                "kvcached_tpu/ops/paged_attention.py:636"),
        "K2": ("write_prefill_kv", "prefill_write.cu",
               "kvcached_tpu/ops/paged_attention.py:1220"),
        "K3": ("paged_prefill_attention_batch", "paged_prefill.cu",
               "kvcached_tpu/ops/paged_prefill.py:344"),
        "K4": ("paged_attention_verify", "paged_verify.cu",
               "kvcached_tpu/ops/paged_attention.py:1116"),
        "K5": ("paged_attention_decode (MLA mode)", "mla_attend.cu",
               "kvcached_tpu/ops/paged_attention.py:585"),
        "K5v": ("paged_attention_verify (MLA mode)", "mla_attend.cu",
                "kvcached_tpu/ops/paged_attention.py:1094"),
        "K6": ("write_prefill_kv_single", "prefill_write.cu",
               "kvcached_tpu/ops/paged_attention.py:1299"),
        "K3m": ("paged_prefill_attention_batch (MLA mode)", "mla_attend.cu",
                "kvcached_tpu/ops/paged_prefill.py:344"),
    }
    # the int8 and e4m3 modes of K1-K4 and of the MLA kernels: their
    # launches on phase 9's and phase 8 (c)'s paths (K1r is on no engine path)
    modes = {"int8": "int8", "fp8": "float8_e4m3fn"}
    for k in ("K1", "K1r", "K2", "K3", "K4", "K5", "K5v", "K6", "K3m"):
        for tag, mode in modes.items():
            fn, src, replaces = meta[k]
            meta[f"{k} {tag}"] = (f"{fn}, {mode} pool", src, replaces)
            counts.setdefault(f"{k} {tag}", 0)
    # the soft-capped mode of K1, K1r, K3 and K4 (bf16 pool) and K4's byte
    # modes: launches on phase 10's paths (K1r is on no engine path)
    for k in ("K1", "K1r", "K3", "K4"):
        fn, src, replaces = meta[k]
        meta[f"{k} softcap"] = (f"{fn}, soft-capped (logit_softcap)", src, replaces)
    for tag, mode in modes.items():
        fn, src, replaces = meta["K4"]
        meta[f"K4 softcap {tag}"] = (f"{fn}, soft-capped (logit_softcap), {mode} pool", src,
                                     replaces)
    counts.setdefault("K1r softcap", 0)
    # head_dim 256 (soft-capped, Gemma-2-9B's widths) on every pool type but
    # float32: launches on phase 11's paths (K1r is on no engine path)
    for k in ("K1", "K1r", "K2", "K3", "K4"):
        fn, src, replaces = meta[k]
        capped = "" if k == "K2" else ", soft-capped (logit_softcap)"
        meta[f"{k} d256"] = (f"{fn}{capped}, head_dim 256", src, replaces)
        counts.setdefault(f"{k} d256", 0)
        for tag, mode in modes.items():
            meta[f"{k} d256 {tag}"] = (f"{fn}{capped}, head_dim 256, {mode} pool", src, replaces)
            counts.setdefault(f"{k} d256 {tag}", 0)
    kernels = []
    for k, (fn, src, replaces) in meta.items():
        r = rows[k]
        tag = k.split()[-1] if " " in k else None
        kernels.append({
            "name": f"{k.split()[0]} {fn}", "route": "cuda",
            "source": f"kvcached_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": counts[k], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "host_ms": r["host_ms"], "tolerance": r["tolerance"],
            "dtype": modes.get(tag, "bfloat16"),
            **({"d128_ms": r["d128_ms"]} if "d128_ms" in r else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
