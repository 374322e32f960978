"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, runs on CUDA by default (and says so when there is no card), and
never runs a plain version where a kernel was asked for.  Its four paths —
mining (on one device or over the ranks of a process group), the MoE
routing pass that feeds it, the dense validation path and LM serving —
each have their own kernel set.  The model on a device mesh
(``sharding/``) runs with JAX blocked too."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import device as D
from repro_torch.configs import get_smoke_config
from repro_torch.core import (BatchMiner, DistributedMiner, NOACMiner,
                              StreamingMiner, mine)
from repro_torch.core.keys import plan_context_keys
from repro_torch.core.windowed import mine_windowed
from repro_torch.data import synthetic as S
from repro_torch.kernels import decode_attention as KD
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import ops
from repro_torch.kernels import radix_sort as KR
from repro_torch.kernels import rmsnorm as KN
from repro_torch.kernels import segment_reduce as KS
from repro_torch.kernels import signature as KSig
from repro_torch.kernels import tricluster_density as KTD
from repro_torch.launch import (cluster_serve, mine_moe_routing, serve,
                                tricluster)
from repro_torch.launch.mesh import Mesh, init_distributed, make_local_mesh
from repro_torch.models.api import get_model
from repro_torch.models.params import from_jax_params
from repro_torch.serve import ServeEngine

SRC = Path(__file__).resolve().parents[1] / "src"

_BLOCKED_RUN = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # the smoke script imports nothing of JAX either

from repro_torch.core import BatchMiner, NOACMiner, mine
from repro_torch.data import synthetic as S
ctx = S.random_context((7, 6, 5), 80, seed=1, values=True)
res = BatchMiner(ctx.sizes, device="cpu")(ctx.tuples)
nres = NOACMiner(ctx.sizes, delta=50.0, device="cpu")(ctx.tuples, ctx.values)
run = mine(S.imdb_like(), device="cpu")
assert mine(S.imdb_like(), backend="reference").n_clusters == run.n_clusters

# the out-of-core and streaming paths, and a checkpoint round trip
import os, tempfile
from repro_torch.core import StreamingMiner
from repro_torch.core import runs as RS
for budget in ("chunk_budget", "window_budget"):
    assert mine(S.imdb_like(), device="cpu",
                **{budget: 1000}).n_clusters == run.n_clusters
sm = StreamingMiner(ctx.sizes, delta=50.0, window_budget=16, device="cpu")
sm.add(ctx.tuples, ctx.values)
sm.delete(ctx.tuples[:3])
with tempfile.TemporaryDirectory() as d:
    RS.save_checkpoint(sm.state.checkpoint(), os.path.join(d, "c"))
    sm.state = RS.RunStore.restore(RS.load_checkpoint(os.path.join(d, "c"))[0])
assert int(sm.snapshot().keep.sum()) > 0

# the distributed backend at one rank, both strategies
from repro_torch.core import DistributedMiner
from repro_torch.launch.mesh import make_local_mesh
mesh = make_local_mesh(device="cpu")
for strategy in ("replicate", "shuffle"):
    dres = DistributedMiner(ctx.sizes, mesh, strategy=strategy,
                            delta=50.0)(ctx.tuples, ctx.values)
    assert int(dres.keep.sum()) == int(nres.keep.sum())
dm = DistributedMiner(ctx.sizes, mesh, window_budget=16)
dm.ingest(ctx.tuples)
assert int(dm.serving_snapshot().keep.sum()) == int(res.keep.sum())

# the dense validation path
import torch
from repro_torch.core import dense_tensor, exact_density_dense, fibers
from repro_torch.kernels import ops
tup = torch.from_numpy(ctx.tuples)
masks = fibers(dense_tensor(tup, ctx.sizes), tup)
dens = exact_density_dense(dense_tensor(tup, ctx.sizes), masks)
sigs = [ops.set_signature(m, r) for m, r in
        zip(masks, BatchMiner(ctx.sizes, device="cpu")._lo)]
assert dens.shape == (ctx.num_tuples,) and len(sigs) == 3

# the smoke MoE routing path, attention through the kernel op
import dataclasses, torch
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.models.api import get_model
from repro_torch.models.telemetry import collect_moe_routing, routing_context
cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                          attn_impl="pallas")
params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
toks = TokenPipeline(cfg, 2, 32, seed=0).batch_at(0)["tokens"]
rctx = routing_context(cfg, toks, collect_moe_routing(cfg, params, toks))
rres = BatchMiner(rctx.sizes, theta=0.2, device="cpu")(rctx.tuples)

# LM serving with both kernel switches on (their plain versions here)
from repro_torch.serve import ServeEngine
scfg = dataclasses.replace(cfg, use_pallas=True)
gen = ServeEngine(scfg, params, max_len=64).generate([[1, 2, 3], [4, 5]], 5)

# the model on a mesh (sharding/): one rank serves and trains over a
# (1, 1) mesh, bit for bit what no mesh gives
from repro_torch.sharding import MeshRules
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    make_train_step, state_shardings)
rules = MeshRules(make_local_mesh(device="cpu"))
assert ServeEngine(scfg, params, max_len=64, rules=rules).generate(
    [[1, 2, 3], [4, 5]], 5).tokens == gen.tokens
tc = TrainConfig(total_steps=4, warmup_steps=1)
batch = {k: torch.from_numpy(v) for k, v in
         TokenPipeline(cfg, 2, 8, seed=0).batch_at(0).items()}
losses = []
for r in (None, rules):
    st = init_train_state(cfg, torch.Generator().manual_seed(0),
                          device="cpu", shardings=None if r is None
                          else state_shardings(cfg, r, tc))
    losses.append(make_train_step(dataclasses.replace(cfg,
                                                      attn_impl="blocked"),
                                  r, tc)(st, batch)[1]["loss"])
assert torch.equal(*losses)

leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("OK", len(names), int(res.keep.sum()), int(nres.keep.sum()),
      run.n_clusters, rctx.num_tuples, int(rres.is_unique.sum()),
      sum(len(t) for t in gen.tokens))
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ)
    root = str(SRC.parent)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), root])
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=root)
    assert out.returncode == 0, out.stderr
    ok, n_modules, kept, nkept, n_clusters, n_routes, n_routing, n_gen = \
        out.stdout.split()[-8:]
    assert ok == "OK" and int(n_modules) >= 74
    assert int(kept) > 0 and int(nkept) > 0 and int(n_clusters) > 0
    assert int(n_routes) > 0 and int(n_routing) > 0 and int(n_gen) == 10


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        BatchMiner((3, 3, 3))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        NOACMiner((3, 3, 3), delta=1.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mine(S.random_context((3, 3, 3), 10, seed=0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        StreamingMiner((3, 3, 3))
    for backend, kw in (("streaming", {}), ("batch", {"window_budget": 4}),
                        ("batch", {"chunk_budget": 4})):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            mine(S.random_context((3, 3, 3), 10, seed=0), backend=backend,
                 **kw)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tricluster.main(["--dataset", "random", "--backend", "streaming"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mine(S.random_context((3, 3, 3), 10, seed=0), backend="distributed")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_local_mesh()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_distributed()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        DistributedMiner((3, 3, 3), Mesh(("data",), (1,),
                                         torch.device("cpu")), device="cuda")
    lo = [torch.zeros(3, dtype=torch.int32)] * 3
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mine_windowed(np.zeros((4, 3), np.int32), None,
                      np.zeros((3, 4), np.int32),
                      plans=plan_context_keys((3, 3, 3), False), hash_lo=lo,
                      hash_hi=lo)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        D.resolve_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mine_moe_routing.main([])
    cfg = get_smoke_config("granite-moe-3b-a800m")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        get_model(cfg).init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        from_jax_params({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match='device="cpu"'):
        get_model(cfg).init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main(["--arch", "granite-moe-3b-a800m", "--smoke"])
    for plane in ([], ["--shards", "2", "--replicas", "1"]):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cluster_serve.main(["--dataset", "random", "--n-tuples", "64",
                                "--port", "0", *plane])
    assert D.resolve_device("cpu") == torch.device("cpu")


def test_use_kernels_true_on_cpu_tensors_raises():
    w = torch.zeros(16, dtype=torch.int32)
    f = torch.ones(16, dtype=torch.bool)
    starts = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.segment_reduce(w, w, f, use_kernels=True)
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.radix_histogram([w], (0,), (8,), use_kernels=True)
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.radix_rank(w, starts, use_kernels=True)
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.flash_attention(q, q, q, use_kernels=True)
    mask = torch.ones((4, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.set_signature(mask, w[:8], use_kernels=True)
    tens = torch.ones((8, 8, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.tricluster_density(tens, mask, mask, mask, use_kernels=True)
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.exact_density(tens, mask, mask, mask, use_kernels=True)
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.decode_attention(q[:, :, 0], q, q, use_kernels=True)
    with pytest.raises(ValueError, match="use_kernels=True"):
        ops.rmsnorm(q, torch.ones(16), use_kernels=True)
    ctx = S.random_context((7, 6, 5), 40, seed=2)
    with pytest.raises(ValueError, match="use_kernels=True"):
        BatchMiner(ctx.sizes, use_kernels=True, device="cpu")(ctx.tuples)
    assert D.resolve_use_kernels(None, w) is False
    assert D.resolve_use_kernels(False, w) is False


def test_kernel_wrappers_take_cuda_tensors_only():
    w = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        KS.segment_reduce(w, w, torch.ones(16, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        KR.radix_histogram([w], (0,), (8,))
    with pytest.raises(ValueError, match="CUDA"):
        KR.radix_rank(w, torch.zeros(256, dtype=torch.int32))
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        KF.flash_attention(q, q, q)
    mask = torch.ones((4, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        KSig.signature(mask, torch.zeros(8, dtype=torch.int32))
    tens = torch.ones((8, 8, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        KTD.tricluster_density(tens, mask, mask, mask)
    with pytest.raises(ValueError, match="CUDA"):
        KD.decode_attention(q[:, :, 0].contiguous(), q, q)
    with pytest.raises(ValueError, match="CUDA"):
        KN.rmsnorm(q[0, 0], torch.ones(16))


def test_launch_counters_only_count_kernel_launches():
    from repro_torch.core import dense_tensor, exact_density_dense, fibers
    ops.reset_launch_counts()
    ctx = S.random_context((7, 6, 5), 60, seed=3)
    BatchMiner(ctx.sizes, device="cpu")(ctx.tuples)
    mine_moe_routing.main(["--device", "cpu", "--attn-impl", "pallas",
                           "--batch", "2", "--seq", "16"])
    tup = torch.from_numpy(ctx.tuples)
    tens = dense_tensor(tup, ctx.sizes)
    masks = fibers(tens, tup)
    exact_density_dense(tens, masks)
    ops.set_signature(masks[0], torch.ones(7, dtype=torch.int32))
    serve.main(["--arch", "mixtral-8x7b", "--smoke", "--device", "cpu",
                "--attn-impl", "pallas", "--new-tokens", "3"])
    scfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"),
                               attn_impl="pallas", use_pallas=True)
    sp = get_model(scfg).init(scfg, torch.Generator().manual_seed(0),
                              device="cpu")
    ServeEngine(scfg, sp, max_len=32).generate([[1, 2, 3]], 3)
    assert ops.launch_counts() == {"segment_reduce": 0,
                                   "radix_histogram": 0, "radix_rank": 0,
                                   "flash_attention": 0, "signature": 0,
                                   "tricluster_density": 0,
                                   "decode_attention": 0, "rmsnorm": 0}


def test_kernel_sources_ship_with_the_package():
    """The build compiles one library per source in the package, for
    sm_90a; importing it needs no compiler."""
    from repro_torch.kernels import build
    assert build.SOURCES == ("segment_reduce", "radix_sort",
                             "flash_attention", "signature",
                             "tricluster_density", "decode_attention",
                             "rmsnorm")
    assert ops.PATH_KERNELS == {
        "mining": ("segment_reduce", "radix_histogram", "radix_rank"),
        "routing": ("flash_attention",),
        "dense": ("signature", "tricluster_density"),
        "serving": ("decode_attention", "rmsnorm")}
    on_paths = [k for ks in ops.PATH_KERNELS.values() for k in ks]
    assert sorted(on_paths) == sorted(ops.KERNELS)
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


_BLOCKED_SERVE = r"""
import importlib.abc, io, contextlib, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import numpy as np
from repro_torch.data import synthetic as S
from repro_torch.launch import cluster_serve, tricluster
from repro_torch.obs import Obs
from repro_torch.serve import (clusters, faults, protocol, ranking, router,
                               shm, supervise)
from repro_torch.serve.service import TriclusterService
# the LM engine stays unloaded until asked for
assert "repro_torch.serve.engine" not in sys.modules
assert "repro_torch.models" not in sys.modules
import os, tempfile, threading

ctx = S.random_context((8, 7, 6), 96, seed=7)
obs = Obs.create()
plan = faults.FaultPlan.build(faults.FaultPlan.drop_requests("replica", 0, 3))
pub = shm.ShmPublisher(f"tiso{os.getpid()}")
flags = tempfile.mkdtemp()
svc = TriclusterService(ctx.sizes, device="cpu", obs=obs, scrub_interval=0,
                        fault=plan.for_component("writer", 0),
                        publisher=pub, event_dir=flags)
svc.add(ctx.tuples)
snap = svc.refresh()
hits = svc.query_batch([0, 1, 2], k=3).hits
assert len(snap.index) > 0 and len(hits) == 3
assert "repro_service_swap_ms_count 1" in obs.metrics.expose()
# the serving plane in-process: a replica of the segment behind an HTTP
# endpoint, the writer behind another, a router over both
rep = shm.ReplicaService(pub.prefix).start()
servers = [protocol.make_server(s, port=0) for s in (svc, rep)]
for s in servers:
    threading.Thread(target=s.serve_forever, daemon=True).start()
rt = router.RouterService([router.Shard(
    f"http://127.0.0.1:{servers[0].port}",
    [f"http://127.0.0.1:{servers[1].port}"])])
cl = protocol.ClusterClient(f"http://127.0.0.1:{servers[1].port}")
assert cl.query(k=3)["hits"] == rt.query(k=3)["hits"]
supervise.write_event(flags, "writer", "probe", "ok")
assert supervise.Supervisor(flag_dir=flags).stats() == {"children": {}}
rt.close()
for s in servers:
    s.shutdown()
    s.server_close()
rep.stop()
svc.stop()
pub.close()
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc1 = tricluster.main(["--dataset", "imdb", "--device", "cpu",
                           "--print-top", "0", "--top-k", "2"])
    rc2 = tricluster.main(["--dataset", "imdb", "--device", "cpu",
                           "--print-top", "0", "--query-entity", "3",
                           "--query-mode", "0"])
assert (rc1, rc2) == (0, 0), out.getvalue()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("OK", len(snap.index), out.getvalue().count("score="))
"""


def test_serving_layer_and_obs_run_without_jax():
    """``repro_torch.obs``, ``serve.{clusters,ranking,service,faults}``,
    the serving plane (``serve.{supervise,shm,protocol,router}`` and
    ``launch.cluster_serve``) and the CLI's ``--top-k``/``--query-*``
    with JAX and the JAX package blocked; importing ``serve`` leaves the
    LM engine unloaded."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_SERVE], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(SRC.parent))
    assert out.returncode == 0, out.stderr
    ok, n_clusters, n_lines = out.stdout.split()[-3:]
    assert ok == "OK" and int(n_clusters) > 0 and int(n_lines) >= 3


def test_obs_none_adds_no_synchronisation(monkeypatch):
    """``PipelineMiner`` with ``obs=None`` queues no synchronisation on any
    of its three paths; with a hub, each stage timer synchronises once
    (``timer_sync``: a CUDA synchronize on the card, nothing on the CPU)."""
    from repro_torch.core import pipeline as P
    from repro_torch.obs import Obs
    calls = {"timer_sync": 0, "synchronize": 0}
    real = P.timer_sync

    def counted_timer_sync(device):
        calls["timer_sync"] += 1
        real(device)

    def counted_synchronize(device=None):
        calls["synchronize"] += 1

    monkeypatch.setattr(P, "timer_sync", counted_timer_sync)
    monkeypatch.setattr(torch.cuda, "synchronize", counted_synchronize)
    ctx = S.random_context((9, 8, 7), 160, seed=8)
    miner = BatchMiner(ctx.sizes, device="cpu")

    def run():
        miner(ctx.tuples)
        miner.mine_chunked(ctx.tuples, chunk_budget=50)
        miner.mine_windowed(ctx.tuples, window_budget=40)

    assert miner.obs is None
    run()
    assert calls == {"timer_sync": 0, "synchronize": 0}
    miner.obs = Obs.create()
    run()
    # __call__, mine_chunked, and each window of the windowed path's
    # three stages (4 windows; 3 modes in Stage 1)
    assert calls == {"timer_sync": 1 + 1 + 4 * 3 + 4 + 4, "synchronize": 0}


_BLOCKED_TRAIN = r"""
import importlib.abc, io, contextlib, json, os, sys, tempfile

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
from repro_torch import train
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as train_mod
from repro_torch.train import checkpoints, fault_tolerance, optim, step

cfg = get_smoke_config("granite-moe-3b-a800m")
state = train.init_train_state(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
fn = train.make_train_step(cfg, tc=train.TrainConfig(warmup_steps=1))
batch = {k: torch.from_numpy(v)
         for k, v in TokenPipeline(cfg, 2, 16, seed=0).batch_at(0).items()}
for _ in range(2):
    state, m = fn(state, batch)
d = tempfile.mkdtemp()
mgr = checkpoints.CheckpointManager(d)
mgr.save(2, state)
assert mgr.restore(template=state)[0] == 2
fault_tolerance.beat(os.path.join(d, "hb"), 2)
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = train_mod.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "2",
                         "--global-batch", "2", "--seq", "16",
                         "--device", "cpu", "--ckpt-dir", d,
                         "--ckpt-every", "1", "--log-every", "1"])
assert rc == 0 and out.getvalue().count("[train] step") == 2, out.getvalue()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not leaked, leaked
print("OK", int(state["opt"]["step"]), float(m["loss"]) > 0)
"""


def test_training_runs_without_jax():
    """``repro_torch.train.*`` and ``repro_torch.launch.train`` with JAX
    and the JAX package blocked: two steps of the MoE smoke config, a
    checkpoint round trip, a heartbeat and the driver."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    out = subprocess.run([sys.executable, "-c", _BLOCKED_TRAIN], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(SRC.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-3:] == ["OK", "2", "True"], out.stdout


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.launch import train as train_mod
    from repro_torch.train import init_train_state
    cfg = get_smoke_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        init_train_state(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_mod.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1"])
