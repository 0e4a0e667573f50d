"""The port's scheduler on the CPU, port only: admission order under each
policy, and stop strings.

The toy config at float32 with parameters from the port's own
``init_llama_params``; the engine runs the kernels' plain versions.
"""

import pytest
import torch

from kvcached_tpu_torch.engine import EngineConfig, LLMEngine, SamplingParams
from kvcached_tpu_torch.models.llama import LlamaConfig, init_llama_params

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ENGINE = dict(max_batch=4, max_model_len=128, page_tokens=16, decode_horizon=4,
              prefill_buckets=(32,), num_pages=16, kv_dtype="float32",
              adaptive_horizon=False)


@pytest.fixture(scope="module")
def toy():
    cfg = LlamaConfig.toy(dtype="float32")
    return cfg, init_llama_params(cfg, seed=0, device="cpu")


def _engine(cfg, params, **kw):
    return LLMEngine(cfg, EngineConfig(**{**ENGINE, **kw}), params=params, device="cpu")


def _serve(eng, prompts, sp):
    try:
        return [o.output_tokens for o in eng.generate(prompts, sp)]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("policy,expect", [
    ("fcfs", [0, 1, 2]), ("priority", [2, 1, 0]), ("sjf", [1, 2, 0])])
def test_admission_order(toy, policy, expect):
    cfg, params = toy
    eng = _engine(cfg, params, max_batch=1, scheduling_policy=policy)
    prompts = [[5] * 30, [6] * 3, [7] * 9]
    ids = [eng.add_request(p, SamplingParams(max_new_tokens=2), priority=pr)
           for p, pr in zip(prompts, (2, 1, 0))]
    while eng.has_unfinished():
        eng.step()
    order = [ids.index(o.req_id) for o in eng.finished_outputs]
    eng.shutdown()
    assert order == expect


class _LetterTokenizer:
    def decode(self, tokens):
        return "".join(chr(ord("a") + t % 26) for t in tokens)


def test_stop_strings(toy):
    cfg, params = toy
    new = 8
    full = _serve(_engine(cfg, params), [[7, 8, 9]], SamplingParams(max_new_tokens=new))[0]
    text = _LetterTokenizer().decode(full)
    stop = text[3:5]
    eng = LLMEngine(cfg, EngineConfig(**ENGINE), params=params, device="cpu",
                    tokenizer=_LetterTokenizer())
    out = eng.generate([[7, 8, 9]], SamplingParams(max_new_tokens=new, stop=(stop,)))[0]
    eng.shutdown()
    assert out.output_text == text[: text.find(stop)]
    assert out.output_tokens == full[: len(out.output_tokens)]
    assert len(out.output_tokens) < new
