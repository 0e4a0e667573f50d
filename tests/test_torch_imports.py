"""The port stands alone: no file of ``kvcached_tpu_torch/`` and not
``chip_smoke.py`` imports JAX or the JAX package, and the entry points run
on the card unless the caller asks for the CPU, without falling back to
it."""

import ast
import os

import pytest
import torch

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "kvcached_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "kvcached_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 10 and os.path.exists(files[0])
    bad = {os.path.relpath(f, ROOT): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def _entry_points():
    from kvcached_tpu_torch.device.pool import DevicePagePool, PoolSpec
    from kvcached_tpu_torch.engine import EngineConfig, LLMEngine
    from kvcached_tpu_torch.models.llama import LlamaConfig, init_llama_params
    from kvcached_tpu_torch.parallel import make_mesh

    cfg = LlamaConfig.toy(dtype="float32", num_layers=1)
    spec = PoolSpec(1, 4, 2, 16, 128, torch.float32)
    ec = EngineConfig(max_model_len=64, page_tokens=16, prefill_buckets=(32,),
                      num_pages=4, kv_dtype="float32")
    return {
        "init_llama_params": lambda **kw: init_llama_params(cfg, **kw),
        "DevicePagePool": lambda **kw: DevicePagePool(spec, **kw),
        "LLMEngine": lambda **kw: LLMEngine(cfg, ec, **kw).shutdown() or True,
        "make_mesh": lambda device=None: make_mesh(
            dp=1, devices=None if device is None else [device]),
    }


@pytest.mark.parametrize("name", ["init_llama_params", "DevicePagePool", "LLMEngine",
                                  "make_mesh"])
def test_entry_points_default_to_cuda(name):
    make = _entry_points()[name]
    assert make(device="cpu") is not None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
