"""Logit soft-capping in the plain versions of K4 (verify) and K1r
(read-only decode) against the JAX package's Pallas kernels run with
``interpret=True``, on the same numpy inputs, over every pool type the
kernels take.

K4 runs on float32, bfloat16, int8 (per-head scales) and float8_e4m3fn
pools with T = 3 fed tokens, a window on two of them, a row overhanging
its one-page table, a discarded slot and a zero-length row.  K1r runs on
bfloat16 and e4m3 pools (K1's soft-capped float32 and int8 modes, the same
plain function with the write on, are held in
tests/test_torch_hybrid_ops.py).  The queries are scaled so that the
scores reach several times the cap: the uncapped outputs lie far outside
the tolerance (asserted).  All JAX calls compile as one program at XLA's
lowest optimisation level, the kernels copying one page a DMA chunk.  The
file holds one test, so that loadfile queues it after the older port
files.

Tolerances: written pools are equal byte for byte (an e4m3 NaN never
equals itself, so bytes are compared); outputs agree within atol 1e-5 on
float32 and byte pools (both sides compute in float32 and round q and the
softmax weights to bf16 operands at the same places) and within 2e-2 on
bfloat16 pools (a bf16 output, one ulp of a unit-scale value ~7.8e-3,
rounded after float32 sums taken in different orders).

The CUDA kernels run only on the card: tests/test_torch_hybrid_spec_cuda.py
holds them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import torch

from kvcached_tpu.ops.paged_attention import paged_attention as j_readonly
from kvcached_tpu.ops.paged_attention import paged_attention_verify as j_verify
from kvcached_tpu_torch import ops
from test_torch_llama import jax_lowest
from test_torch_quant_ops import NP_DTYPE, _bytes, _pools, _t

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

L, P, KH, QH, TP, D = 2, 8, 2, 4, 32, 128
CAP = 5.0  # scores reach ~4x the cap: q scaled by 4, sm_scale 1/12 (Gemma2's)
SM_SCALE = 144 ** -0.5
ATOL = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 1e-5, "float8_e4m3fn": 1e-5}
#: K4's window by pool type (None: full attention)
WINDOWS = {"float32": 20, "bfloat16": None, "int8": 24, "float8_e4m3fn": None}


def _io(mode):
    """numpy type of q and the fed K/V: the pool's for float pools,
    float32 (quantized in the kernel) for byte pools."""
    return NP_DTYPE[mode] if mode in ("float32", "bfloat16") else np.float32


def _verify_case(rng, mode):
    """K4 inputs: T = 3; row 0 a full page, row 1 with one discarded slot,
    row 2 overhanging its table by one token (that slot discarded, as the
    engine routes it), row 3 zero length."""
    B, T = 4, 3
    ks = (0.02 + 0.03 * rng.random((L, KH))).astype(np.float32)
    vs = (0.02 + 0.03 * rng.random((L, KH))).astype(np.float32)
    kp, vp = _pools(rng, mode, ks, vs)
    seq_lens = np.array([TP, 21, TP + 1, 0], np.int32)
    page_tables = np.array([[3], [2], [6], [0]], np.int32)
    positions = np.maximum(seq_lens[:, None] - T + np.arange(T)[None], 0)
    inside = positions < TP
    slot_pages = np.where(inside, page_tables, 0).astype(np.int32)
    slot_pages[1, 1] = 0
    slot_pages[3] = 0
    slot_offsets = (positions % TP).astype(np.int32)
    io = _io(mode)
    q = (4 * rng.standard_normal((B, T, QH, D))).astype(io)
    kn = rng.standard_normal((B, T, KH, D)).astype(io)
    vn = rng.standard_normal((B, T, KH, D)).astype(io)
    live = (seq_lens[:, None] - T + np.arange(T)[None] >= 0) & inside
    return [q, kp, vp, page_tables, seq_lens, kn, vn, slot_pages, slot_offsets, ks, vs], live


def _readonly_case(rng, mode):
    """K1r inputs: a full page, a short row and a zero-length row."""
    ks = (0.02 + 0.03 * rng.random((L, KH))).astype(np.float32)
    kp, vp = _pools(rng, mode, ks, ks)
    q = (4 * rng.standard_normal((3, QH, D))).astype(_io(mode))
    return [q, kp, vp, np.array([[5], [4], [0]], np.int32), np.array([TP, 9, 0], np.int32)]


def _scales(mode, ks, vs):
    return dict(k_scales=ks, v_scales=vs) if mode == "int8" else {}


def test_softcap_verify_and_readonly_match_jax():
    """Soft-capped K4 on every pool type and K1r on bf16 and e4m3 pools,
    all in one JAX program; the uncapped outputs lie far from the capped
    ones."""
    rng = np.random.default_rng(0)
    verifies = {m: _verify_case(rng, m) for m in ATOL}
    readonly = {m: _readonly_case(rng, m) for m in ("bfloat16", "float8_e4m3fn")}
    capped = dict(sm_scale=SM_SCALE, logit_softcap=CAP)

    def run(*arrays):
        outs, i = [], 0
        for mode in verifies:
            q, kp, vp, pt, sl, kn, vn, sp, so, ks, vs = arrays[i:i + 11]
            i += 11
            outs.append(j_verify(q, kp, vp, pt, sl, 1, kn, vn, sp, so, interpret=True,
                                 window=WINDOWS[mode], **_scales(mode, ks, vs), **capped))
        for mode in readonly:
            outs.append(j_readonly(*arrays[i:i + 5], 1, interpret=True, **capped))
            i += 5
        return outs

    got_j = jax_lowest(run, *[jnp.asarray(a) for c, _ in verifies.values() for a in c],
                       *[jnp.asarray(a) for c in readonly.values() for a in c])
    for (mode, (case, live)), (out_j, kp_j, vp_j) in zip(verifies.items(), got_j):
        q, kp, vp, pt, sl, kn, vn, sp, so, ks, vs = map(_t, case)
        sc = _scales(mode, ks, vs)
        out_t, kp_t, vp_t = ops.paged_attention_verify(
            q, kp, vp, pt, sl, 1, kn, vn, sp, so, window=WINDOWS[mode], **sc, **capped)
        np.testing.assert_array_equal(_bytes(kp_t), _bytes(kp_j), err_msg=mode)
        np.testing.assert_array_equal(_bytes(vp_t), _bytes(vp_j), err_msg=mode)
        out_t = out_t.float().numpy()
        np.testing.assert_allclose(out_t[live], np.asarray(out_j).astype(np.float32)[live],
                                   atol=ATOL[mode], rtol=0, err_msg=mode)
        assert not out_t[3].any(), "a zero-length row gives zeros"
        uncapped = ops.paged_attention_verify_plain(
            q, kp_t.clone(), vp_t.clone(), pt, sl, 1, kn, vn, sp, so,
            window=WINDOWS[mode], sm_scale=SM_SCALE, **sc)[0].float().numpy()
        assert np.abs(uncapped - out_t)[live].max() > 10 * max(ATOL[mode], 1e-2), mode

    for (mode, case), out_j in zip(readonly.items(), got_j[len(verifies):]):
        args = list(map(_t, case))
        out_t = ops.paged_attention(*args, 1, **capped).float().numpy()
        np.testing.assert_allclose(out_t, np.asarray(out_j).astype(np.float32),
                                   atol=ATOL[mode], rtol=0, err_msg=mode)
        assert not out_t[2].any(), "a zero-length row gives zeros"
        uncapped = ops.paged_attention(*args, 1, sm_scale=SM_SCALE).float().numpy()
        assert np.abs(uncapped - out_t).max() > 10 * max(ATOL[mode], 1e-2), mode
