"""The dp mesh's contract: what is not ported raises, and a mesh takes the
devices it is given or the visible cards.

- ``max_batch`` not divisible by dp: ``ValueError``, as the reference's
  engine raises; replicas on one device share its weights and split the
  memory their pools are sized from;
- tp > 1 and a pipeline axis: ``NotImplementedError`` (ROADMAP A15), from
  ``make_mesh`` and from the engine given such a mesh;
- fewer visible cards than dp without an explicit device list: raises
  (none visible, or one, stubbed); an explicit list may repeat a device,
  and fewer entries than dp raise.

``make_mesh``'s CUDA default is also held by
tests/test_torch_imports.py's entry-point test.
"""

import pytest
import torch

from kvcached_tpu_torch.engine import EngineConfig, LLMEngine
from kvcached_tpu_torch.models.llama import LlamaConfig
from kvcached_tpu_torch.parallel import Mesh, make_mesh

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)

CFG = LlamaConfig.toy(dtype="float32", num_layers=1)
EC = dict(max_model_len=64, page_tokens=16, prefill_buckets=(32,), num_pages=8,
          kv_dtype="float32")
CPU2 = ["cpu", "cpu"]


def test_mesh_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="max_batch"):
        LLMEngine(CFG, EngineConfig(max_batch=3, **EC), mesh=make_mesh(dp=2, devices=CPU2))
    with pytest.raises(NotImplementedError, match="tp=2"):
        make_mesh(tp=2, dp=1, devices=CPU2)
    with pytest.raises(NotImplementedError, match="pipeline"):
        make_mesh(dp=2, devices=CPU2, axis_names=("pp", "tp"))
    cpu = torch.device("cpu")
    for mesh, what in ((Mesh(((cpu, cpu),)), "tp=2"),
                       (Mesh(((cpu,), (cpu,)), ("pp", "tp")), "pipeline")):
        with pytest.raises(NotImplementedError, match=what):
            LLMEngine(CFG, EngineConfig(max_batch=2, **EC), mesh=mesh)
    # pools sized from free memory: replicas sharing a device split its budget
    ec = EngineConfig(max_batch=2, **{**EC, "num_pages": None, "hbm_utilization": 0.002})
    one = LLMEngine(CFG, ec, device="cpu")
    eng = LLMEngine(CFG, ec, mesh=make_mesh(dp=2, devices=CPU2))
    assert eng.device == cpu and len(eng.replicas) == 2
    assert eng.replicas[0].params is eng.replicas[1].params, "one device: the same weights"
    assert eng.replicas[0].k_pools.data_ptr() != eng.replicas[1].k_pools.data_ptr()
    assert eng.pool.capacity == one.pool.capacity // 2
    one.shutdown()
    eng.shutdown()


def test_mesh_needs_enough_devices(monkeypatch):
    with pytest.raises(ValueError, match="need 2 devices"):
        make_mesh(dp=2, devices=["cpu"])
    mesh = make_mesh(dp=2, devices=CPU2 + ["cpu"])  # the first dp x tp, as the reference
    assert mesh.shape == {"dp": 2, "tp": 1} and mesh.replica_devices == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(dp=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="need 2 CUDA devices, 1 visible"):
        make_mesh(dp=2)
