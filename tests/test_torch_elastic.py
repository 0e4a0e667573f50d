"""The elastic gate on the CPU, port only: GREW/SHRANK/CORRECT through the
port's shm limit plane, the limit set from another process as ``kvctl
limit`` does (the engine and parameters of ``test_torch_scheduling.py``),
and a limit written right after the allocator starts."""

import hashlib
import subprocess
import sys
import time
import uuid

import torch

from kvcached_tpu_torch import KVCacheManager, KVConfig, shm
from kvcached_tpu_torch.core import HostPagePool
from kvcached_tpu_torch.engine import SamplingParams
from test_torch_scheduling import _engine, _serve, toy  # noqa: F401 (toy: a fixture)

# One intra-op thread: the suite runs in parallel worker processes, where
# each one's idle OpenMP threads would spin on the others' cores.
torch.set_num_threads(1)


def test_grew_shrank_correct_through_shm(toy):
    """GREW under load, SHRANK after a limit cut from another process,
    CORRECT: md5-identical outputs to an unconstrained run."""
    cfg, params = toy
    prompts = [[i + 1, i + 2, i + 3, i + 4] for i in range(6)]
    sp = SamplingParams(max_new_tokens=16)
    name = f"kvcached_torch_test_{uuid.uuid4().hex[:8]}"
    eng = _engine(cfg, params, num_pages=64, ipc_name=name)
    try:
        assert eng.ipc_name == name
        idle = eng.kv_metrics()["mapped_bytes"]
        ids = [eng.add_request(p, sp) for p in prompts]
        peak = 0
        while eng.has_unfinished():
            eng.step()
            peak = max(peak, eng.kv_metrics()["mapped_bytes"])
        outs = {o.req_id: o.output_tokens for o in eng.finished_outputs}
        assert peak > 1.5 * max(idle, eng.kv_cfg.page_bytes), "GREW"
        limit = 6 * eng.kv_cfg.page_bytes
        subprocess.run(
            [sys.executable, "-c",
             "import sys; from kvcached_tpu_torch import shm; "
             "shm.update_kv_cache_limit(sys.argv[1], int(sys.argv[2]))",
             name, str(limit)], check=True, timeout=120)
        again = eng.generate(prompts, sp)
        eng.managers[0].trim()
        assert eng.kv_metrics()["mapped_bytes"] <= limit < peak, "SHRANK"
    finally:
        eng.shutdown()
    free = _serve(_engine(cfg, params, num_pages=64), prompts, sp)
    md5 = lambda x: hashlib.md5(str(x).encode()).hexdigest()  # noqa: E731
    assert md5([outs[i] for i in ids]) == md5(free) == md5([o.output_tokens for o in again]), "CORRECT"


def test_limit_written_at_startup_is_applied():
    """A limit written the moment the manager exists is a change the resize
    watcher must see: the watcher takes its starting limit before the
    constructor returns, not whenever its thread first runs."""
    cfg = KVConfig(num_layers=2, num_kv_heads=2, head_dim=64,
                   block_tokens=16, page_tokens=64)
    mgr = KVCacheManager(cfg, HostPagePool(33), ipc_name=f"kvcached_torch_e2e_{uuid.uuid4().hex[:6]}",
                         enable_prealloc=False)
    try:
        full = mgr.available_size()
        shm.update_kv_cache_limit(mgr._tracker.ipc_name, 4 * cfg.page_bytes)
        deadline = time.time() + 5
        while time.time() < deadline and mgr.available_size() >= full:
            mgr.alloc(0)  # applies a pending resize target
            time.sleep(0.05)
        assert mgr.available_size() <= 4 * cfg.blocks_per_page
    finally:
        mgr.shutdown()

