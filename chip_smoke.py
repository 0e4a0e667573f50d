#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``kvcached_tpu_torch``) on one
NVIDIA H100.

Run from the repository root, on a machine with one CUDA card, ``nvcc`` and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits nonzero):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: the four CUDA kernel sources are compiled from
   ``kvcached_tpu_torch/csrc`` (one nvcc per source, in parallel), with
   ptxas' register counts;
3. kernels: K1, K1r, K2, K3 and K4 against their plain PyTorch versions on
   the card at Llama-3-8B shapes (B=8, KH=8, QH=32, D=128, 64-token pages,
   contexts 512-2048 on shuffled pages, a windowed case, a K3 batch with
   q_start > 0 and a kv_len = 0 row, K4 with T=5 fed tokens, a row
   overhanging its table and a row whose writes are all discarded): pool
   writes bit-exact, outputs within 2e-2 at bf16 and 1e-4 at float32 (TF32
   off); each kernel's device time (calls back to back) and its time a call
   from the host, the plain version's and SDPA's, beside the kernel's bound;
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
   Phase 7 runs before phase 6, while the 8B weights are loaded.

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
BF16_TOL, F32_TOL, LOGITS_REL_TOL = 2e-2, 1e-4, 1e-2
HOLD_CYCLES = 60_000_000  # ~30 ms at the H100's clocks: longer than any enqueue below

CARD = dict(
    B=8, KH=8, QH=32, D=128, TP=64, L=4, contexts=(512, 2048, 768, 1536, 1024, 1792, 640, 1280),
    window=1024, prefill_T=512, model="llama3_8b", max_new=64, shared_prefix=256,
    buckets=(256, 512), long_prompt=700, iters=20, spec_T=5, spec_new_exact=32,
)
REHEARSE = dict(
    B=3, KH=2, QH=4, D=128, TP=16, L=2, contexts=(40, 70, 23), window=24,
    prefill_T=32, model="toy", max_new=48, shared_prefix=32, buckets=(32, 64),
    long_prompt=90, iters=2, spec_T=5, spec_new_exact=8,
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


def bound(bytes_, flops):
    t_b, t_f = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


class KernelCase:
    """Shared inputs at the main path's decode/prefill shapes."""

    def __init__(self, torch, dev, S):
        self.torch, self.dev, self.S = torch, dev, S
        g = torch.Generator(device=dev).manual_seed(0)
        self.g = g
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

    def pools(self, dtype):
        S = self.S
        shape = (S["L"], self.P, S["KH"], S["TP"], S["D"])
        k, v = self.randn(shape, dtype), self.randn(shape, dtype)
        k[:, 0] = 0
        v[:, 0] = 0
        return k, v


def _err(torch, a, b):
    return (a.float() - b.float()).abs().max().item()


def kernel_decode(torch, ops, F, case, dtype, window, timed):
    """K1 (fused write + attend) and K1r (read-only) vs plain."""
    S = case.S
    B, KH, QH, D, L = S["B"], S["KH"], S["QH"], S["D"], S["L"]
    kp, vp = case.pools(dtype)
    q = case.randn((B, QH, D), dtype)
    kn, vn = case.randn((B, KH, D), dtype), case.randn((B, KH, D), dtype)
    args = (case.page_tables, case.seq_lens)
    slots = (case.slot_pages, case.slot_offsets)
    kp2, vp2 = kp.clone(), vp.clone()
    out_k, _, _ = ops.paged_attention_decode(q, kp, vp, *args, 1, kn, vn, *slots, window=window)
    out_p, _, _ = ops.paged_attention_decode_plain(q, kp2, vp2, *args, 1, kn, vn, *slots, window=window)
    ro_k = ops.paged_attention(q, kp, vp, *args, 2, window=window)
    ro_p = ops.paged_attention_decode_plain(q, kp, vp, *args, 2, None, None, None, None,
                                            window=window, write_kv=False)[0]
    torch.cuda.synchronize()
    res = {
        "K1": dict(pools_bit_exact=bool(torch.equal(kp, kp2) and torch.equal(vp, vp2)),
                   max_abs_err=_err(torch, out_k, out_p)),
        "K1r": dict(max_abs_err=_err(torch, ro_k, ro_p)),
    }
    if not timed:
        return res
    it = S["iters"]
    eff = [min(c, window) if window else c for c in S["contexts"]]
    isz = kp.element_size()
    kv_bytes = sum(eff) * KH * D * isz * 2
    io_bytes = 2 * B * QH * D * isz + B * case.maxp * 4 + B * 4
    flops = 4 * QH * D * sum(eff)
    cyc = iter(range(10 ** 9))
    lay = lambda: next(cyc) % L  # noqa: E731
    k1 = lambda: ops.paged_attention_decode(  # noqa: E731
        q, kp, vp, *args, lay(), kn, vn, *slots, window=window)
    res["K1"].update(
        ms=time_ms(torch, k1, it), host_ms=time_ms(torch, k1, it, hold=False),
        plain_ms=time_ms(torch, lambda: ops.paged_attention_decode_plain(
            q, kp, vp, *args, lay(), kn, vn, *slots, window=window), it))
    k1r = lambda: ops.paged_attention(q, kp, vp, *args, lay(), window=window)  # noqa: E731
    res["K1r"].update(
        ms=time_ms(torch, k1r, it), host_ms=time_ms(torch, k1r, it, hold=False),
        plain_ms=time_ms(torch, lambda: ops.paged_attention_decode_plain(
            q, kp, vp, *args, lay(), None, None, None, None, window=window,
            write_kv=False), it))
    res["K1"]["bound_ms"], res["K1"]["bound_by"] = bound(
        kv_bytes + io_bytes + 4 * B * KH * D * isz + 2 * B * 4, flops)
    res["K1r"]["bound_ms"], res["K1r"]["bound_by"] = bound(kv_bytes + io_bytes, flops)
    # yardstick: one SDPA call on the gathered, contiguous K/V of each layer
    Sx = case.maxp * S["TP"]
    gathered = []
    for layer in range(L):
        k = kp[layer][case.page_tables.long()].permute(0, 2, 1, 3, 4).reshape(B, KH, Sx, D)
        v = vp[layer][case.page_tables.long()].permute(0, 2, 1, 3, 4).reshape(B, KH, Sx, D)
        gathered.append((k.contiguous(), v.contiguous()))
    pos = torch.arange(Sx, device=case.dev)[None]
    valid = pos < case.seq_lens[:, None]
    if window:
        valid &= pos >= (case.seq_lens[:, None] - window).clamp(min=0)
    mask = valid[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, *gathered[lay()], attn_mask=mask, enable_gqa=True), it)
    res["K1"]["library_ms"] = res["K1r"]["library_ms"] = lib
    return res


def kernel_prefill_write(torch, ops, case, dtype, timed):
    S = case.S
    KH, D, TP, T, L = S["KH"], S["D"], S["TP"], S["prefill_T"], S["L"]
    n = T // TP
    kp, vp = case.pools(dtype)
    kn, vn = case.randn((KH, T, D), dtype), case.randn((KH, T, D), dtype)
    pages = case.perm[-n:].clone()
    pages[1] = 0  # a discarded chunk
    kp2, vp2 = kp.clone(), vp.clone()
    ops.write_prefill_kv(kp, vp, kn, vn, pages, 1)
    ops.write_prefill_kv_plain(kp2, vp2, kn, vn, pages, 1)
    torch.cuda.synchronize()
    res = dict(pools_bit_exact=bool(torch.equal(kp, kp2) and torch.equal(vp, vp2)),
               max_abs_err=_err(torch, kp, kp2))
    if not timed:
        return res
    it = S["iters"]
    cyc = iter(range(10 ** 9))
    lay = lambda: next(cyc) % L  # noqa: E731
    k2 = lambda: ops.write_prefill_kv(kp, vp, kn, vn, pages, lay())  # noqa: E731
    res["ms"], res["host_ms"] = time_ms(torch, k2, it), time_ms(torch, k2, it, hold=False)
    res["plain_ms"] = time_ms(
        torch, lambda: ops.write_prefill_kv_plain(kp, vp, kn, vn, pages, lay()), it)
    live = int((pages != 0).sum())
    res["bound_ms"], res["bound_by"] = bound(
        2 * 2 * live * KH * TP * D * kp.element_size() + n * 4, 0)
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


def kernel_prefill(torch, ops, F, case, dtype, window, timed):
    """K3: a batch with a cached prefix (q_start > 0), a fresh chunk, a
    long-context row and a kv_len = 0 padding row."""
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
    q = case.randn((N, T, QH, D), dtype)
    out_k = ops.paged_prefill_attention_batch(q, kp, vp, pt, q_starts, kv_lens, 1, window=window)
    out_p = ops.paged_prefill_attention_batch_plain(q, kp, vp, pt, q_starts, kv_lens, 1,
                                                    window=window)
    torch.cuda.synchronize()
    live = [(r, slice(0, max(int(kv_lens[r] - q_starts[r]), 0))) for r in range(N)]
    err = max(_err(torch, out_k[r, s], out_p[r, s]) if s.stop else 0.0 for r, s in live)
    res = dict(max_abs_err=err, kv_len0_row_zero=not bool(out_k[N - 1].float().abs().max()))
    if not timed:
        return res
    it = S["iters"]
    cyc = iter(range(10 ** 9))
    lay = lambda: next(cyc) % L  # noqa: E731
    k3 = lambda: ops.paged_prefill_attention_batch(  # noqa: E731
        q, kp, vp, pt, q_starts, kv_lens, lay(), window=window)
    res["ms"], res["host_ms"] = time_ms(torch, k3, it), time_ms(torch, k3, it, hold=False)
    res["plain_ms"] = time_ms(torch, lambda: ops.paged_prefill_attention_batch_plain(
        q, kp, vp, pt, q_starts, kv_lens, lay(), window=window), it)
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
        2 * N * T * QH * D * isz + 2 * keys * KH * D * isz, 4 * QH * D * pairs)
    gathered = []
    for layer in range(L):
        k = kp[layer][pt.long()].permute(0, 2, 1, 3, 4).reshape(N, KH, Sx, D)
        v = vp[layer][pt.long()].permute(0, 2, 1, 3, 4).reshape(N, KH, Sx, D)
        gathered.append((k.contiguous(), v.contiguous()))
    q4 = q.transpose(1, 2).contiguous()
    mask = vis[:, None]
    res["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, *gathered[lay()], attn_mask=mask, enable_gqa=True), it)
    return res


def kernel_verify(torch, ops, F, case, dtype, window, timed):
    """K4: T fed tokens per row at the case's contexts (seq_len includes
    them); the longest row overhangs its table by 2 < T tokens (those two
    slots discarded, as the engine routes them) and one row's writes are
    all discarded.  Every query of this case lies inside its table."""
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
    q = case.randn((B, T, QH, D), dtype)
    kn, vn = case.randn((B, T, KH, D), dtype), case.randn((B, T, KH, D), dtype)
    args = (case.page_tables, sl)
    slots = (slot_pages, slot_offsets)
    kp2, vp2 = kp.clone(), vp.clone()
    out_k, _, _ = ops.paged_attention_verify(q, kp, vp, *args, 1, kn, vn, *slots, window=window)
    out_p, _, _ = ops.paged_attention_verify_plain(q, kp2, vp2, *args, 1, kn, vn, *slots,
                                                   window=window)
    torch.cuda.synchronize()
    res = dict(pools_bit_exact=bool(torch.equal(kp, kp2) and torch.equal(vp, vp2)),
               max_abs_err=_err(torch, out_k[inside], out_p[inside]))
    if not timed:
        return res
    it = S["iters"]
    cyc = iter(range(10 ** 9))
    lay = lambda: next(cyc) % L  # noqa: E731
    k4 = lambda: ops.paged_attention_verify(  # noqa: E731
        q, kp, vp, *args, lay(), kn, vn, *slots, window=window)
    res["ms"], res["host_ms"] = time_ms(torch, k4, it), time_ms(torch, k4, it, hold=False)
    res["parts"] = kernel_parts(torch, k4, it)
    res["plain_ms"] = time_ms(torch, lambda: ops.paged_attention_verify_plain(
        q, kp, vp, *args, lay(), kn, vn, *slots, window=window), it)
    # work this data needs: visible (query, key) pairs, each row's keys read
    # once, q / the fed K,V / tables read, the output and the fed tokens written
    kv = torch.arange(width, device=dev)[None, None]
    vis = (kv <= pos[:, :, None]) & (kv < sl.long()[:, None, None])
    if window:
        vis &= kv > pos[:, :, None] - window
    pairs = int(vis.sum()) * QH
    keys = int(vis.any(dim=1).sum())
    isz = kp.element_size()
    written = int((slot_pages != 0).sum())
    res["bound_ms"], res["bound_by"] = bound(
        2 * keys * KH * D * isz + 2 * B * T * QH * D * isz
        + 2 * (B * T + written) * KH * D * isz + B * case.maxp * 4 + 3 * B * T * 4,
        4 * D * pairs)
    gathered = []
    for layer in range(L):
        k = kp[layer][case.page_tables.long()].permute(0, 2, 1, 3, 4).reshape(B, KH, width, D)
        v = vp[layer][case.page_tables.long()].permute(0, 2, 1, 3, 4).reshape(B, KH, width, D)
        gathered.append((k.contiguous(), v.contiguous()))
    q4 = q.transpose(1, 2).contiguous()
    mask = vis[:, None]
    res["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, *gathered[lay()], attn_mask=mask, enable_gqa=True), it)
    return res


def phase_kernels(torch, ops, S, dev):
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    case = KernelCase(torch, dev, S)
    rows = {}
    for dtype, tol, timed in ((torch.bfloat16, BF16_TOL, True), (torch.float32, F32_TOL, False)):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
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
                    rows[name] = dict(r, tolerance=tol)
        w = kernel_prefill_write(torch, ops, case, dtype, timed)
        log(f"[kernels] K2 {tag}: pools bit-exact={w['pools_bit_exact']}")
        require(w["pools_bit_exact"], f"K2 {tag} pool bytes differ")
        if timed:
            rows["K2"] = dict(w, tolerance=0.0)
    for name, r in rows.items():
        log(f"[kernels] {name}: {r['ms']:.4f} ms on the device, {r['host_ms']:.4f} ms a "
            f"call from the host (plain {r['plain_ms']:.4f}, library "
            f"{r['library_ms']:.4f}, bound {r['bound_ms']:.4f} by {r['bound_by']})"
            + (f"; device ms per call by kernel {json.dumps(r['parts'])}"
               if "parts" in r else ""))
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


def last_logits(torch, cfg, params, S, dev, reference):
    """Last-position logits of a two-chunk prefill (the second chunk at
    q_start = one bucket), of one decode step after it, and of one verify
    step of spec_T fed tokens after that, through the kernels or
    (``reference``) through their plain versions, on fresh pools of the
    model's dtype."""
    from kvcached_tpu_torch.models.llama import (
        llama_decode_step,
        llama_prefill_step,
        llama_verify_step,
    )

    TP, T, Tv = S["TP"], max(S["buckets"]), S["spec_T"]
    tail = T // 4 + 9
    T2 = next(b for b in S["buckets"] if b >= tail)
    plen = T + tail
    n_pages = -(-(plen + 1 + Tv) // TP)
    shape = (cfg.num_layers, n_pages + 1, cfg.num_kv_heads, TP, cfg.head_dim)
    g = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (plen,), generator=g, device=dev,
                           dtype=torch.int32)
    table = torch.arange(1, n_pages + 1, dtype=torch.int32, device=dev)
    one = lambda x: torch.tensor([x], dtype=torch.int32, device=dev)  # noqa: E731
    kp = torch.zeros(shape, dtype=cfg.tdtype, device=dev)
    vp = torch.zeros_like(kp)
    for q0, n, Tb in ((0, T, T), (T, tail, T2)):
        toks = torch.zeros(Tb, dtype=torch.int32, device=dev)
        toks[:n] = prompt[q0:q0 + n]
        pos = q0 + torch.arange(Tb, dtype=torch.int32, device=dev)
        chunk = torch.zeros(Tb // TP, dtype=torch.int32, device=dev)
        nreal = -(-n // TP)
        chunk[:nreal] = table[q0 // TP: q0 // TP + nreal]
        lg_prefill, _, _ = llama_prefill_step(
            params, cfg, toks, pos, kp, vp, chunk, table, q0, n,
            reference_attention=reference)
    lg_decode, _, _ = llama_decode_step(
        params, cfg, prompt[:1], one(plen), kp, vp, table[None],
        one(int(table[plen // TP])), one(plen % TP), one(plen + 1),
        reference_attention=reference)
    vpos = plen + 1 + torch.arange(Tv, dtype=torch.int32, device=dev)
    lg_verify, _, _ = llama_verify_step(
        params, cfg, prompt[None, 1:Tv + 1], vpos[None], kp, vp, table[None],
        table[vpos // TP][None].contiguous(), (vpos % TP)[None], one(plen + 1 + Tv),
        reference_attention=reference)
    return lg_prefill, lg_decode[0], lg_verify[0, -1]


def logits_check(torch, cfg, params, S, dev):
    """Kernel path vs plain path on the card, norm-relative error of the
    last-position logits.  Gated at float32 (the same weights widened,
    float32 pools, TF32 off), where the two differ only by summation
    order; at bf16 the error is printed beside bf16's own distance from
    float32 (the plain path at both), since bf16 rounding differences
    compound over the layers of a random-weight model."""
    import dataclasses

    from kvcached_tpu_torch.models.llama import LlamaModel

    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    out = {}
    logits = {}
    for tag, c, p in (("bf16", cfg, params), ("f32", None, None)):
        if tag == "f32":
            c = dataclasses.replace(cfg, dtype="float32")
            p = LlamaModel(c, params.embed.float(),
                           {k: v.float() for k, v in params.layers.items()},
                           params.final_norm.float(), params.lm_head.float())
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


def phase_engine(torch, ops, S, dev, rehearse):
    import numpy as np

    from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams
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
    ops.reset_launch_counts()  # --- the main path starts here
    out1 = serve(eng, wave1)
    eng.stats.update(prefill_tokens=0, prefill_seconds=0.0, decode_tokens=0,
                     decode_seconds=0.0, decode_steps=0)
    t0 = time.perf_counter()
    out2 = serve(eng, wave2)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()  # --- and ends here
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


def phase_elastic(torch, cfg, params, S, dev, rehearse):
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
            kv_dtype=cfg.dtype, enable_prefix_caching=False, prefill_batch=1,
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
    cap = lambda m: m["in_use_pages"] + m["available_blocks"]  # noqa: E731

    def await_limit(pages):
        """Wait until the allocator has taken up the new limit: its watcher
        polls the segment every 100 ms, and the next alloc applies it."""
        deadline = time.time() + 30
        while eng.manager.page_allocator.limit_pages != pages:
            require(time.time() < deadline, f"limit {pages} never taken up")
            time.sleep(0.02)
            eng.manager.alloc(0)

    try:
        ids = [eng.add_request(p, sp) for p in prompts]
        while len(eng.running) < 8 and eng.has_unfinished():
            eng.step()
        m_load = eng.kv_metrics()
        small = max(m_load["in_use_pages"] // 2, 4)
        _set_limit(eng.ipc_name, small * page_bytes)
        await_limit(small)
        for _ in range(2):  # serve under the cut: growth now preempts
            if eng.has_unfinished():
                eng.step()
        m_cut = eng.kv_metrics()
        require(eng.has_unfinished(), "the cut landed mid-run")
        _set_limit(eng.ipc_name, full * page_bytes)
        await_limit(full)
        m_grow = eng.kv_metrics()
        while eng.has_unfinished():
            eng.step()
        by_id = {o.req_id: o.output_tokens for o in eng.finished_outputs}
        got = [by_id[i] for i in ids]
        m_end = eng.kv_metrics()
    finally:
        eng.shutdown()
    log(f"[elastic] under load: capacity {cap(m_load)} pages, mapped "
        f"{m_load['mapped_bytes']} B; limit cut to {small} pages -> capacity "
        f"{cap(m_cut)}, mapped {m_cut['mapped_bytes']} B, preemptions "
        f"{m_cut['preemptions']}; limit raised -> capacity {cap(m_grow)}; "
        f"finished with {m_end['preemptions']} preemptions")
    md5 = lambda x: hashlib.md5(str(x).encode()).hexdigest()  # noqa: E731
    log(f"[elastic] md5 constrained {md5(got)} unconstrained {md5(want)}")
    require(small < cap(m_load) and cap(m_cut) < cap(m_load), "SHRANK")
    require(cap(m_grow) > cap(m_cut), "GREW")
    require(md5(got) == md5(want), "CORRECT")
    log("[elastic] GREW/SHRANK/CORRECT ok")


# ---------------------------------------------------------------------------
# 7. speculative decoding at full width
# ---------------------------------------------------------------------------


def phase_spec(torch, ops, cfg, params, S, dev, rehearse):
    """(a) token exactness at float32, (b) speed at bf16, with K4's launches
    counted over the mixed spec run.  Returns that run's launch counts and
    every run's decode tok/s."""
    import dataclasses

    import numpy as np

    from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams
    from kvcached_tpu_torch.models.llama import LlamaModel

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
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = LlamaModel(c32, params.embed.float(), {k: v.float() for k, v in params.layers.items()},
                     params.final_norm.float(), params.lm_head.float())
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
    t0 = time.perf_counter()
    rows = {} if rehearse else phase_kernels(torch, ops, S, dev)
    if "--kernels-only" in argv:
        log("[done] kernels only: no result")
        return 4
    cfg, params, counts, tok_s = phase_engine(torch, ops, S, dev, rehearse)
    phase_elastic(torch, cfg, params, S, dev, rehearse)
    spec_counts, spec_tok_s = phase_spec(torch, ops, cfg, params, S, dev, rehearse)
    counts["K4"] = spec_counts["K4"]
    del params
    real = phase_real_weights(torch, dev, rehearse)
    log(f"[done] phases 3-7 in {time.perf_counter() - t0:.1f} s; engine tok/s "
        f"{json.dumps(tok_s)}; spec decode tok/s {json.dumps(spec_tok_s)}; winadd "
        f"exact {real['winadd']}; card {smi}")
    if rehearse:
        log("[done] rehearsal only: no result")
        return 3
    meta = {
        "K1": ("paged_attention_decode", "paged_decode.cu",
               "kvcached_tpu/ops/paged_attention.py:60"),
        "K1r": ("paged_attention (K1 kernel, write off)", "paged_decode.cu",
                "kvcached_tpu/ops/paged_attention.py:98"),
        "K2": ("write_prefill_kv", "prefill_write.cu",
               "kvcached_tpu/ops/paged_attention.py:1157"),
        "K3": ("paged_prefill_attention_batch", "paged_prefill.cu",
               "kvcached_tpu/ops/paged_prefill.py:35"),
        "K4": ("paged_attention_verify", "paged_verify.cu",
               "kvcached_tpu/ops/paged_attention.py:661"),
    }
    kernels = []
    for k, (fn, src, replaces) in meta.items():
        r = rows[k]
        kernels.append({
            "name": f"{k} {fn}", "route": "cuda",
            "source": f"kvcached_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": counts[k], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "host_ms": r["host_ms"], "tolerance": r["tolerance"], "dtype": "bfloat16",
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
