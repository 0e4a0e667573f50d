"""The plain versions of K7 and K8, the dp-replica equalizer's token writers,
against the JAX package's Pallas kernels run with ``interpret=True``, on the
same numpy inputs; and the rewrite check on every pool type.

K7 (``write_decode_tokens``) runs on int8 pools, once with the identity
``pool_layers`` and scales ``[L, KH]`` keyed by pool layer, with the
reference's edge values (steps exactly halfway, which round half to even,
and a value past 127, which clips), and once with four kv layers sharing two
pool layers (``[0, 1, 0, 1]``, on distinct pages, as a hybrid arena's
groups do), scales ``[Lk, KH]`` keyed by kv layer and a discarded row (the
zero page).  K8 (``write_decode_tokens_single``) runs on an int8 latent pool
of 640 lanes.  Each case is one JAX program at XLA's lowest optimisation
level.  Byte pools take 32-token pages: the reference's byte sublane is 32.

The rewrite check (torch only): the fused write of K1 (K5's decode form for
the latent pool), through its plain version, then K7 (K8) of the same
tokens, leaves the pools' bytes unchanged, on float32, bf16, int8 and e4m3
pools.  The same test holds the wrappers' contract: CPU tensors run the
plain versions and count no launch; a CUDA tensor (stubbed: no card here)
launches or raises, never the plain version.

Tolerance: none; pools are compared byte for byte.  The CUDA kernel runs
only on the card: tests/test_torch_dp_cuda.py holds it against these plain
versions there.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvcached_tpu.ops.paged_attention import write_decode_tokens as j_write
from kvcached_tpu.ops.paged_attention import write_decode_tokens_single as j_write_single
from kvcached_tpu_torch import ops
from test_torch_llama import jax_lowest

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

P, TP, B = 8, 32, 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _int8_pool(rng, L, KH, D):
    x = rng.integers(-127, 128, (L, P, KH, TP, D)).astype(np.int8)
    x[:, 0] = 0
    return x


def _case(rng, kind):
    """(pools, new tokens, pool_layers, slot_pages, slot_offsets, scales)
    of one case, numpy."""
    if kind == "k8":
        L, Lk, KH, D = 2, 2, 1, 640
    else:
        L, KH, D = 2, 2, 128
        Lk = 2 if kind == "identity" else 4
    pools = [_int8_pool(rng, L, KH, D) for _ in range(1 if kind == "k8" else 2)]
    new = [(2 * rng.standard_normal((Lk, B, KH, D))).astype(np.float32) for _ in pools]
    scales = [(0.02 + 0.03 * rng.random((L if kind != "shared" else Lk, KH))).astype(np.float32)
              for _ in pools]
    offsets = np.array([5, 31, 0], np.int32)
    if kind == "shared":
        pool_layers = np.array([0, 1, 0, 1], np.int32)
        # kv layers 0 and 2 (1 and 3) share a pool layer on distinct pages
        slot_pages = np.array([[1, 2, 0], [3, 4, 0], [5, 6, 0], [7, 1, 0]], np.int32)
    else:
        pool_layers = np.arange(Lk, dtype=np.int32)
        slot_pages = np.tile(np.array([[2, 6, 4]], np.int32), (Lk, 1))
    if kind == "identity":  # the reference's edge values at layer 0, head 0
        scales[0][0, 0] = 0.5
        new[0][0, 0, 0, :6] = [0.25, 0.75, 1.25, -0.25, -0.75, 100.0]
    return pools, new, pool_layers, slot_pages, offsets, scales


@pytest.mark.parametrize("kind", ["identity", "shared", "k8"])
def test_plain_matches_jax(kind):
    """K7 (identity pool layers; pool layers shared across kv layers with
    scales keyed by kv layer and a discarded row) and K8 on int8 pools:
    the plain versions' pools equal the JAX kernels' byte for byte."""
    pools, new, pl, sp, so, sc = _case(np.random.default_rng(7), kind)
    if kind == "k8":
        def run(kp, kn, pl, sp, so, ks):
            return (j_write_single(kp, kn, pl, sp, so, interpret=True, k_scales=ks),)

        args = (pools[0], new[0], pl, sp, so, sc[0])
    else:
        def run(kp, vp, kn, vn, pl, sp, so, ks, vs):
            return j_write(kp, vp, kn, vn, pl, sp, so, interpret=True, k_scales=ks, v_scales=vs)

        args = (*pools, *new, pl, sp, so, *sc)
    want = [np.asarray(x) for x in jax_lowest(run, *map(jnp.asarray, args))]
    tp = [_t(x) for x in pools]
    if kind == "k8":
        got = [ops.write_decode_tokens_single(tp[0], _t(new[0]), _t(pl), _t(sp), _t(so),
                                              k_scales=_t(sc[0]))]
    else:
        got = ops.write_decode_tokens(*tp, *map(_t, new), _t(pl), _t(sp), _t(so),
                                      k_scales=_t(sc[0]), v_scales=_t(sc[1]))
    for g, w, before in zip(got, want, pools):
        np.testing.assert_array_equal(g.numpy(), w)
        assert (w != before).any(), "the case wrote something"
    if kind == "identity":
        edge = got[0][0, 2, 0, 5, :6].tolist()
        assert edge == [0, 2, 2, 0, -2, 127], "round half to even, clip at 127"
    if kind == "shared":
        assert np.array_equal(want[0][:, 0], pools[0][:, 0]), "the zero page is untouched"


def _pool(rng, dtype, L, KH, D):
    x = torch.from_numpy(rng.standard_normal((L, P, KH, TP, D)).astype(np.float32))
    x = ops.quantize_kv(x, dtype, 0.05 if dtype == torch.int8 else None)
    x[:, 0] = 0
    return x


def test_rewrite_after_fused_write_keeps_bytes(monkeypatch):
    """K1's fused write (K5's for the latent pool) through its plain
    version, then K7 (K8) of the same tokens: the pools' bytes are
    unchanged on float32, bf16, int8 and e4m3 pools; the wrappers' contract
    on the way."""
    rng = np.random.default_rng(3)
    L, KH, D, H = 2, 2, 128, 4
    counts = ops.launch_counts()
    pt = torch.tensor([[2, 3], [4, 5], [6, 7]], dtype=torch.int32)
    seq_lens = torch.tensor([40, 33, 9], dtype=torch.int32)
    pos = (seq_lens - 1).long()
    sp = pt[torch.arange(B), pos // TP].contiguous()
    sp[2] = 0  # a discarded row
    so = (pos % TP).to(torch.int32)
    pool_layers = torch.arange(L, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16, torch.int8, torch.float8_e4m3fn):
        io = torch.float32 if dtype == torch.float32 else torch.bfloat16
        kp, vp = _pool(rng, dtype, L, KH, D), _pool(rng, dtype, L, KH, D)
        lp = _pool(rng, dtype, L, 1, 640)  # the latent pool
        sc = dict(k_scales=torch.full((L, KH), 0.05), v_scales=torch.full((L, KH), 0.05)) \
            if dtype == torch.int8 else {}
        lsc = dict(k_scales=torch.full((L, 1), 0.05)) if dtype == torch.int8 else {}
        kn = torch.from_numpy(rng.standard_normal((L, B, KH, D)).astype(np.float32)).to(io)
        vn = torch.from_numpy(rng.standard_normal((L, B, KH, D)).astype(np.float32)).to(io)
        ln = torch.from_numpy(rng.standard_normal((L, B, 1, 640)).astype(np.float32)).to(io)
        q = torch.zeros((B, H, D), dtype=io)
        for layer in range(L):
            ops.paged_attention_decode_plain(q, kp, vp, pt, seq_lens, layer, kn[layer],
                                             vn[layer], sp, so, **sc)
            ops.paged_attention_decode_plain(
                torch.zeros((B, H, 640), dtype=io), lp, None, pt, seq_lens, layer,
                ln[layer], None, sp, so, mla_v_dim=512, **lsc)
        before = [p.clone() for p in (kp, vp, lp)]
        pages = sp[None].expand(L, B).contiguous()
        ops.write_decode_tokens(kp, vp, kn, vn, pool_layers, pages, so, **sc)
        ops.write_decode_tokens_single(lp, ln, pool_layers, pages, so, **lsc)
        for a, b in zip((kp, vp, lp), before):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), dtype
        fresh = _pool(rng, dtype, L, KH, D)
        assert not torch.equal(fresh.view(torch.uint8), kp.view(torch.uint8))
    assert ops.launch_counts() == counts, "the plain path counts no launch"
    with pytest.raises(ValueError, match="scales"):
        ops.write_decode_tokens(kp.to(torch.int8), vp.to(torch.int8), kn, vn, pool_layers,
                                pages, so)

    pa = importlib.import_module("kvcached_tpu_torch.ops.paged_attention")

    def no_build(name):
        raise RuntimeError("build refused")

    monkeypatch.setattr(importlib.import_module("kvcached_tpu_torch.ops._build"), "load",
                        no_build)
    monkeypatch.setattr(pa, "_on_cpu", lambda *ts: False)
    ran = []
    for name in ("write_decode_tokens_plain", "write_decode_tokens_single_plain"):
        monkeypatch.setattr(pa, name, lambda *a, **k: ran.append(a))
    with pytest.raises(RuntimeError, match="build refused"):
        pa.write_decode_tokens(kp, vp, kn, vn, pool_layers, pages, so)
    with pytest.raises(RuntimeError, match="build refused"):
        pa.write_decode_tokens_single(lp, ln, pool_layers, pages, so)
    assert not ran, "the plain versions never ran"
