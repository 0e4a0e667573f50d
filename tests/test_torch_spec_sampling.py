"""The port's speculative-decoding control pieces, on the CPU: the
acceptance rule's distribution, the n-gram draft, and the adaptive-gamma
ladder against the JAX package's.

``jax.random`` and ``torch.Generator`` give different bits, so sampled
acceptance is held by its distribution: over 40,000 vectorised draws the
first emitted token's frequencies match the target softmax within 0.012
(the JAX package's own bound, tests/test_spec_decode.py), and a top-k
filtered target is never left.  Greedy rows emit the argmax whatever the
generator.
"""

from types import SimpleNamespace

import numpy as np
import torch

from kvcached_tpu.engine.engine import LLMEngine as JLLMEngine
from kvcached_tpu_torch.engine.engine import LLMEngine, _ngram_draft, _spec_accept

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)


def _many(logits, drafts, temp, top_k, n, seed=42):
    """n independent acceptances of the same [1, T, V] logits in one call."""
    g = torch.Generator().manual_seed(seed)
    out, a = _spec_accept(
        torch.from_numpy(logits).expand(n, -1, -1),
        torch.tensor(drafts, dtype=torch.int32).expand(n, -1),
        torch.full((n,), temp), torch.full((n,), top_k, dtype=torch.int64),
        torch.ones(n), g, filters=top_k > 0)
    return out.numpy(), a.numpy()


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def test_acceptance_is_distribution_exact():
    n = 40000
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((1, 3, 6)).astype(np.float32)
    out, a = _many(logits, [[2, 4]], 1.0, 0, n)
    emp = np.bincount(out[:, 0], minlength=6) / n
    assert np.abs(emp - _softmax(logits[0, 0])).max() < 0.012
    assert 0 < (a >= 1).mean() < 1, "drafts are accepted and rejected"
    # top-k = 2: only the two highest-logit tokens, in their renormalized odds
    logits = rng.standard_normal((1, 2, 8)).astype(np.float32)
    out, _ = _many(logits, [[0]], 0.9, 2, n)
    scaled = logits[0, 0] / 0.9
    top2 = np.argsort(-scaled)[:2]
    emp = np.bincount(out[:, 0], minlength=8) / n
    assert emp[[i for i in range(8) if i not in top2]].sum() == 0
    assert np.abs(emp[top2] - _softmax(scaled[top2])).max() < 0.012
    # greedy rows emit the argmax at every position, whatever the generator
    logits = rng.standard_normal((2, 3, 6)).astype(np.float32)
    greedy = logits.argmax(-1)
    for seed in (0, 1):
        out, _ = _spec_accept(
            torch.from_numpy(logits), torch.from_numpy(greedy[:, 1:].astype(np.int32)),
            torch.zeros(2), torch.zeros(2, dtype=torch.int64), torch.ones(2),
            torch.Generator().manual_seed(seed), filters=False)
        np.testing.assert_array_equal(out.numpy(), greedy)


def _py_draft(toks, n, gamma):
    """Prompt lookup written plainly: the tokens after the latest earlier
    occurrence of the trailing n-gram, padded by repeating the last."""
    if len(toks) > n:
        key = toks[-n:]
        for s in range(len(toks) - n - 1, -1, -1):
            if toks[s : s + n] == key:
                out = list(toks[s + n : s + n + gamma]) or [toks[-1]]
                while len(out) < gamma:
                    out.append(out[-1])
                return out
    return [toks[-1]] * gamma


def test_ngram_draft_matches_python_lookup():
    W, n, gamma = 16, 2, 3
    histories = [[10, 11, 12, 13, 10, 11], [1, 2, 3], [5, 5, 5, 5, 5],
                 list(range(30)), [4, 9, 4, 9, 4, 9, 4]]
    ring = np.full((len(histories), W), -1, np.int32)
    for i, h in enumerate(histories):
        tail = h[-W:]
        ring[i, W - len(tail):] = tail
    got = _ngram_draft(torch.from_numpy(ring), n, gamma).numpy()
    for i, h in enumerate(histories):
        assert got[i].tolist() == _py_draft(h[-W:], n, gamma), h


def _ladder(engine_cls, emas):
    """Walk the engine class's ladder methods over a fixed acceptance
    sequence on a bare state; the rung, EMA and cooldown after each step."""
    st = SimpleNamespace(cfg=SimpleNamespace(spec_gamma=8, spec_adaptive=True),
                         _spec_ema=None, _spec_gamma_cur=8, _spec_cooldown=0)
    trace = []
    for x in emas:
        if x is None:
            trace.append(("cooling", engine_cls._spec_cooling(st)))
        else:
            engine_cls._spec_update_gamma(st, x)
        trace.append((st._spec_gamma_cur, st._spec_ema, st._spec_cooldown))
    return trace


def test_adaptive_gamma_ladder_matches_jax():
    emas = [0.5, 0.5] + [0.0] * 12 + [None] * 9 + [4.0] * 8 + [1.0, 3.0, 0.2]
    trace = _ladder(LLMEngine, emas)
    assert trace == _ladder(JLLMEngine, emas)
    rungs = {t[0] for t in trace if isinstance(t[0], int)}
    assert {2, 4, 8} <= rungs and any(t[2] > 0 for t in trace if len(t) == 3)
