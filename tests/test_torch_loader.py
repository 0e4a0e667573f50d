"""The port's HF loader against the JAX package's loader on the two
committed checkpoints: tinyadd (Llama) and winadd (Qwen2: GQA 4:2, a
window of 24, linear rope x2, qkv biases).  Configs must be equal field
by field and parameters equal element by element (float32; both loaders
only transpose and stack)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from kvcached_tpu.models import hf_loader as jh
from kvcached_tpu_torch.models import hf_loader as th

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "benchmarks", "assets")


@pytest.mark.parametrize("name", ["tinyadd", "winadd"])
def test_loader_matches_jax(name):
    ckpt = os.path.join(ASSETS, name)
    jcfg, jparams = jh.params_from_hf(ckpt, dtype="float32")
    tcfg, tparams = th.params_from_hf(ckpt, dtype="float32", device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    if name == "winadd":
        assert tcfg.sliding_window == 24 and tcfg.attention_bias
        assert tcfg.rope_scaling == ("linear", 2.0)
    assert set(tparams.layers) == set(jparams["layers"])
    for k, v in jparams["layers"].items():
        np.testing.assert_array_equal(tparams.layers[k].numpy(), np.asarray(v), err_msg=k)
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_array_equal(getattr(tparams, k).numpy(), np.asarray(jparams[k]), err_msg=k)


def test_bf16_safetensors_widen_exactly(tmp_path):
    import ml_dtypes

    a = np.array([[1.5, -2.25], [3.0e-3, 7.0e4]], np.float32).astype(ml_dtypes.bfloat16)
    jh.write_safetensors({"w": a}, str(tmp_path / "x.safetensors"))
    got = th.read_safetensors(str(tmp_path / "x.safetensors"))["w"]
    np.testing.assert_array_equal(got, a.astype(np.float32))


def test_gemma_family_not_ported(tmp_path):
    """Gemma3 (unequal layer groups) is not ported yet; Gemma2 is, and
    tests/test_torch_hd256_model.py holds its loader against the JAX
    package's."""
    (tmp_path / "config.json").write_text('{"architectures": ["Gemma3ForCausalLM"]}')
    with pytest.raises(NotImplementedError):
        th.config_from_hf(str(tmp_path))
