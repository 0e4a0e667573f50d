"""The port's engine on the two committed checkpoints against
transformers' own ``generate``: tinyadd (Llama) and winadd (Qwen2: GQA
4:2, a window of 24 that its ~60-token prompts exceed, linear rope x2, qkv
biases).  Greedy tokens must be identical, float32 throughout, the port on
the CPU through its kernels' plain versions.  The JAX package holds its own
engine against ``generate`` in tests/test_hf_loader.py."""

import json
import os

import pytest
import torch

from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams
from kvcached_tpu_torch.models.hf_loader import params_from_hf

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "benchmarks", "assets")
NEW = 6
#: per checkpoint: the engine's shape and how a held-out example splits
#: into its prompt
SETUPS = {
    "tinyadd": (dict(max_model_len=32, page_tokens=16, prefill_buckets=(16,)),
                lambda ex: ex.split("=")[0] + "="),
    "winadd": (dict(max_model_len=128, page_tokens=32, prefill_buckets=(64,)),
               lambda ex: ex[0]),
}


def _hf_generate(ckpt, prompts):
    """transformers' greedy tokens (after the prompt) for each prompt."""
    os.environ.setdefault("USE_TF", "0")  # skips TensorFlow's import (seconds)
    import transformers.utils.import_utils as hf_imports

    # scikit-learn serves only assisted generation's candidate heuristics,
    # and scipy only the object-detection losses, neither of which greedy
    # generate runs; their imports cost seconds
    hf_imports._sklearn_available = False
    hf_imports._scipy_available = False
    from transformers import AutoModelForCausalLM

    model = AutoModelForCausalLM.from_pretrained(ckpt, dtype=torch.float32).eval()
    with torch.no_grad():
        return [model.generate(torch.tensor([p]), max_new_tokens=NEW, do_sample=False,
                               pad_token_id=model.config.pad_token_id)[0, len(p):].tolist()
                for p in prompts]


@pytest.mark.parametrize("name", ["tinyadd", "winadd"])
def test_greedy_tokens_match_transformers(name):
    ckpt = os.path.join(ASSETS, name)
    shape, prompt_of = SETUPS[name]
    vocab = json.load(open(os.path.join(ckpt, "tokenizer.json")))["model"]["vocab"]
    held = json.load(open(os.path.join(ckpt, "heldout.json")))["examples"][:3]
    prompts = [[vocab[c] for c in prompt_of(ex)] for ex in held]
    cfg, params = params_from_hf(ckpt, dtype="float32", device="cpu")
    eng = LLMEngine(cfg, EngineConfig(max_batch=4, decode_horizon=2, num_pages=32,
                                      kv_dtype="float32", **shape),
                    params=params, device="cpu")
    try:
        sp = SamplingParams(max_new_tokens=NEW, stop_token_ids=(vocab["."],))
        got = [o.output_tokens for o in eng.generate(prompts, sp)]
    finally:
        eng.shutdown()
    if name == "winadd":
        assert cfg.sliding_window == 24 and min(map(len, prompts)) > 24
    assert got == _hf_generate(ckpt, prompts)
