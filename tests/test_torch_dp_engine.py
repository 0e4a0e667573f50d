"""The engine over dp = 2 replicas on the CPU (``make_mesh(dp=2,
devices=["cpu", "cpu"])``) against the same engine on one device, torch
only.

The setup is the reference's dp regression test (tests/test_parallel.py,
``test_dp_migration_and_replica_identity``): max_batch 4, prompts
``[[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12]]`` and new tokens
``[2, 2, 12, 12]`` at float32, prefilled in one batch, so that rows 0-1
(replica 0) finish early and rows 2-3 move from replica 1 to replica 0,
where they must read the tokens replica 1 decoded.  Each case asserts that
rows moved, that the tokens equal dp = 1's, and that the replicas' pools
are equal byte for byte after the run:

1. Llama at float32, the pools also within 1e-4 of dp = 1's.  The control:
   with the equalizer (K7) made a no-op the replicas differ, so the test
   can fail.
2. Llama on an int8 pool with spec decode (K4's writes equalized).
3. The MLA family (K8, the latent pool), float32 and int8.
4. The Gemma2 hybrid toy on an int8 arena: K7 with each model layer's
   arena layer and group slot, scales keyed by model layer.

The port's dp = 1 tokens are held against the JAX engine by the other
tests, and the JAX package holds its dp mesh against one device
(test_parallel.py), so this file closes the chain without a JAX mesh
engine.
"""

import importlib

import torch

from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams
from kvcached_tpu_torch.models.hybrid import HybridConfig
from kvcached_tpu_torch.models.llama import LlamaConfig
from kvcached_tpu_torch.models.mla import MLAConfig
from kvcached_tpu_torch.parallel import make_mesh

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12]]
NEW_TOKENS = [2, 2, 12, 12]  # rows 0-1 finish early: rows 2-3 move to replica 0
LLAMA = LlamaConfig(vocab_size=256, hidden_size=256, num_layers=2, num_heads=8,
                    num_kv_heads=4, head_dim=128, intermediate_size=512, dtype="float32")
GEMMA2_TOY = dict(dtype="float32", act="gelu_tanh", norm_offset=True, embed_scale=True,
                  post_norms=True, query_scale=64.0, attn_softcap=5.0, final_softcap=8.0)


def _serve(cfg, mesh, **ec):
    """(tokens by request, the engine) after serving the workload."""
    base = dict(max_batch=4, max_model_len=128, page_tokens=16, decode_horizon=2,
                prefill_buckets=(16,), num_pages=64, kv_dtype="float32", prefill_batch=4)
    if ec.get("kv_dtype") == "int8":  # byte pools take 32-token pages
        base.update(page_tokens=32, prefill_buckets=(32,))
    eng = LLMEngine(cfg, EngineConfig(**{**base, **ec}), device="cpu", mesh=mesh)
    ids = [eng.add_request(p, SamplingParams(max_new_tokens=n))
           for p, n in zip(PROMPTS, NEW_TOKENS)]
    while eng.has_unfinished():
        eng.step()
    eng.shutdown()
    by_id = {o.req_id: o.output_tokens for o in eng.finished_outputs}
    return [by_id[i] for i in ids], eng


def _pools(eng, r):
    return [p for p in (eng.replicas[r].k_pools, eng.replicas[r].v_pools) if p is not None]


def _identical(eng):
    return all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(_pools(eng, 0), _pools(eng, 1)))


def _check_dp(cfg, **ec):
    """Serve at dp = 1 and dp = 2; the tokens agree, rows moved and the
    replicas are identical.  Returns both engines."""
    want, one = _serve(cfg, None, **ec)
    got, two = _serve(cfg, make_mesh(dp=2, devices=["cpu", "cpu"]), **ec)
    assert got == want, f"dp = 2 diverged from dp = 1: {got} vs {want}"
    assert two.kv_metrics()["dp"]["row_moves"] > 0, "no row moved to another replica"
    assert _identical(two), "the dp replicas' pools differ"
    return one, two


def test_llama_float32_and_control(monkeypatch):
    """Llama at float32: tokens of dp = 1, identical replicas within 1e-4
    of dp = 1's pool; without the equalizer the replicas differ."""
    one, two = _check_dp(LLAMA)
    for a, b in zip(_pools(two, 0), _pools(one, 0)):
        assert (a - b).abs().max().item() < 1e-4
    engine = importlib.import_module("kvcached_tpu_torch.engine.engine")
    monkeypatch.setattr(engine, "write_decode_tokens", lambda *a, **k: a[:2])
    _, broken = _serve(LLAMA, make_mesh(dp=2, devices=["cpu", "cpu"]))
    assert not _identical(broken), "the control: replicas differ without the equalizer"


def test_llama_int8_spec():
    """Llama on an int8 pool with spec decode: tokens of dp = 1."""
    _, two = _check_dp(LLAMA, kv_dtype="int8", spec_decode=True, spec_gamma=2,
                       spec_horizon=2)
    assert two.kv_metrics()["spec"]["dispatches"] > 0, "the verify path ran"


def test_mla_latent_pool():
    """The MLA family on float32 and int8 latent pools: K8 keeps the
    replicas identical."""
    for kv_dtype in ("float32", "int8"):
        _check_dp(MLAConfig.toy(dtype="float32"), kv_dtype=kv_dtype)


def test_gemma2_hybrid_int8_arena():
    """The Gemma2 hybrid toy on an int8 arena: K7 through each layer
    group's slots, with scales keyed by model layer."""
    _, two = _check_dp(HybridConfig.toy(**GEMMA2_TOY), kv_dtype="int8", max_model_len=96)
    assert two.quant_scales[0].shape[0] == two.adapter.num_layers != two.kv_cfg.num_layers
