"""The port's zero-copy shared-memory snapshots (``repro_torch.serve.shm``)
against the JAX package's on the CPU.

Parity: a segment the port's ``ShmPublisher`` publishes from the port's
service attaches with the JAX package's ``SnapshotBundle`` and the
reverse; for the same rows both packages' manifests and arrays are equal
apart from ``published_wall`` and ``epoch``, and the port's
``ReplicaService`` answers as the JAX package's does, over either
package's segments.  Every array the service hands the publisher is host
numpy.  Twins, against the port: ``tests/test_serve_faults.py``'s
``TestShmCrashSafety`` and ``TestShmIntegrity``, and the shared-memory
tests of ``tests/test_serve_scale.py`` (a reader process, the seqlock
spin, the held bundle after unlink)."""
import hashlib
import json
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from _torch_parity import hits_view
from repro.serve import shm as JSHM
from repro.serve.service import TriclusterService as JService
from repro_torch.core import StreamingMiner
from repro_torch.data import synthetic as TSyn
from repro_torch.serve import shm as TSHM
from repro_torch.serve.clusters import ClusterIndex
from repro_torch.serve.faults import KILL_EXIT_CODE, FaultPlan
from repro_torch.serve.protocol import health_doc
from repro_torch.serve.service import TriclusterService
from repro_torch.serve.shm import (ReplicaService, ShmCorruptionError,
                                   ShmPublisher, ShmReplica,
                                   WriterDeadError)

pytestmark = pytest.mark.skipif(not os.path.isdir("/dev/shm"),
                                reason="POSIX shm namespace required")

SIZES = (24, 12, 8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(refresh_interval=3600.0, dirty_threshold=10**9,
             scrub_interval=0.0)
#: segment fields that differ between two runs of the same rows
VOLATILE_META = ("published_wall", "epoch")


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


def _wait_for(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError(f"{what} not reached in {timeout}s")
        time.sleep(0.01)


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SIZES, size=(n, 3)).astype(np.int64)


def _bundle_view(b):
    meta = {k: v for k, v in b.meta.items() if k not in VOLATILE_META}
    return meta, b.manifest, b.version, b.stream_version


def _assert_bundles_equal(a, b):
    assert _bundle_view(a) == _bundle_view(b)
    assert sorted(a.arrays) == sorted(b.arrays)
    for k in a.arrays:
        x, y = a.arrays[k], b.arrays[k]
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def _services(tag):
    """One publishing service per package over the same rows."""
    pid = os.getpid()
    jpub = JSHM.ShmPublisher(f"tj{tag}{pid}")
    tpub = TSHM.ShmPublisher(f"tt{tag}{pid}")
    jsvc = JService(SIZES, seed=5, publisher=jpub, **QUIET)
    tsvc = TriclusterService(SIZES, seed=5, publisher=tpub, device="cpu",
                             **QUIET)
    return (jsvc, jpub), (tsvc, tpub)


def _replica_answers(rep, ents):
    return (rep.version, rep.stream_version,
            hits_view(rep.query(k=6).hits),
            [hits_view(h) for h in rep.query_batch(ents, mode=0, k=4).hits],
            hits_view(rep.query(entity=int(ents[1]), mode=1, k=5).hits))


def test_segments_attach_across_packages():
    """Each package attaches the other's segments, and the segments of
    the same write stream are equal but for the publish wall time and
    the epoch — across a full first build and a delta swap."""
    (jsvc, jpub), (tsvc, tpub) = _services("x")
    try:
        rows = _rows(61, 160)
        jrep, trep = JSHM.ShmReplica(tpub.prefix), TSHM.ShmReplica(
            jpub.prefix)
        for step, op in enumerate(("add", "upsert", "delete")):
            chunk = rows if op == "add" else _rows(62 + step, 9)
            for svc in (jsvc, tsvc):
                getattr(svc, op)(chunk)
                svc.refresh()
            tb, jb = jrep.current(), trep.current()   # cross attaches
            assert isinstance(tb, JSHM.SnapshotBundle)
            assert isinstance(jb, TSHM.SnapshotBundle)
            assert tb.version == jb.version == step + 1
            assert not tb.verify() and not jb.verify()
            _assert_bundles_equal(jb, tb)
            assert tb.meta["sizes"] == list(SIZES)
        jrep.close()
        trep.close()
    finally:
        jsvc.stop()
        tsvc.stop()
        jpub.close()
        tpub.close()


def test_replica_service_answers_as_jax():
    (jsvc, jpub), (tsvc, tpub) = _services("r")
    reps = []
    try:
        for svc in (jsvc, tsvc):
            svc.add(_rows(71, 200))
            svc.refresh()
        # the port's replica over either package's segment, and JAX's
        reps = [JSHM.ReplicaService(jpub.prefix, scrub_interval=0),
                ReplicaService(jpub.prefix, scrub_interval=0),
                ReplicaService(tpub.prefix, scrub_interval=0)]
        for r in reps:
            r.start(first_snapshot_timeout=30)
        ents = np.arange(12)
        want = _replica_answers(reps[0], ents)
        assert want[2]
        assert _replica_answers(reps[1], ents) == want
        assert _replica_answers(reps[2], ents) == want
        assert _replica_answers(tsvc, ents) == want
        st = [r.stats() for r in reps]
        keys = ("role", "version", "stream_version", "clusters", "dirty",
                "sizes", "attaches", "scrub_clean")
        assert [{k: s[k] for k in keys} for s in st[1:]] \
            == [{k: st[0][k] for k in keys}] * 2
        assert sorted(st[2]) == sorted(st[0])
        for svc in (jsvc, tsvc):
            svc.upsert(_rows(72, 6))
            svc.refresh()
        for r in reps:
            r.snapshot(at_least_version=2, timeout=30)
        want = _replica_answers(reps[0], ents)
        assert [_replica_answers(r, ents) for r in reps[1:]] == [want] * 2
    finally:
        for r in reps:
            r.stop()
        jsvc.stop()
        tsvc.stop()
        jpub.close()
        tpub.close()


class _Recording(ShmPublisher):
    def __init__(self, prefix):
        super().__init__(prefix)
        self.types = []

    def publish(self, version, stream_version, arrays, **kw):
        self.types.append({k: type(v) for k, v in arrays.items()})
        return super().publish(version, stream_version, arrays, **kw)


def test_published_arrays_are_host_numpy():
    """What the service publishes is host numpy — a tensor would be a
    device read hidden in the publish — and ``publish`` refuses one."""
    pub = _Recording(f"tnp{os.getpid()}")
    svc = TriclusterService(SIZES, seed=3, publisher=pub, device="cpu",
                            **QUIET)
    try:
        svc.add(_rows(81, 120))
        svc.refresh()
        svc.upsert(_rows(82, 5))
        svc.refresh()
        assert len(pub.types) == 2
        for types in pub.types:
            assert len(types) == 7 + 3 * len(SIZES)
            assert all(t is np.ndarray for t in types.values()), types
        with pytest.raises(TypeError, match="host numpy"):
            pub.publish(9, 9, {"a": torch.arange(4)})
        assert svc.stats()["publish_errors"] == 0
    finally:
        svc.stop()
        pub.close()


# -- twins of TestShmCrashSafety --------------------------------------------

def test_torn_publish_adopt_gc_epoch():
    from repro_torch.serve.shm import _Segment, _untrack
    prefix = f"ttfault{os.getpid()}"
    orphan = _Segment(name=f"{prefix}.v7", create=True, size=4096)
    _untrack(orphan._name)
    orphan.close()
    pub = ShmPublisher(prefix)
    try:
        assert pub.reclaimed >= 1
        pub.publish(1, 1, {"a": np.arange(6.)})
        rep = ShmReplica(prefix, connect_timeout=10, seqlock_spin_s=0.15)
        held = rep.current()
        assert (held.epoch, held.version) == (1, 1)
        child = f"""
import numpy as np
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.shm import ShmPublisher
plan = FaultPlan.build(FaultPlan.torn_publish(0, at_version=2))
p = ShmPublisher({prefix!r}, fault=plan.for_component("writer", 0))
p.publish(2, 9, {{"a": np.arange(8.)}})
raise SystemExit("unreachable")
"""
        proc = subprocess.run([sys.executable, "-c", child], env=_env(),
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == KILL_EXIT_CODE, proc.stderr
        with pytest.raises(WriterDeadError) as ei:
            rep.read_control()
        assert not ei.value.alive
        assert np.array_equal(held.arrays["a"], np.arange(6.))
        pub2 = ShmPublisher(prefix)
        assert pub2.epoch >= 3 and pub2.resumed_version == 2
        pub2.publish(2, 9, {"a": np.full(8, 5.0)})
        got = rep.current()
        assert (got.epoch, got.version) == (pub2.epoch, 2)
        assert np.array_equal(got.arrays["a"], np.full(8, 5.0))
        rep.close()
        pub2.close()
    finally:
        try:
            pub.close(unlink=False)
        except Exception:
            pass


def _index_arrays(seed=1, n=80):
    m = StreamingMiner(SIZES, seed=seed, device="cpu")
    m.upsert(_rows(seed, n))
    idx = ClusterIndex.from_result(m.snapshot())
    arrays = {"packed_sigs": idx.packed_sigs, "any_pairs": idx.any_pairs,
              "scores": np.zeros(len(idx)), "ages": np.zeros(len(idx)),
              "density": np.asarray(idx.density, np.float64),
              "gen_count": np.asarray(idx.gen_count, np.int64),
              "volume": np.asarray(idx.volume, np.float64)}
    for k in range(idx.arity):
        arrays[f"mode_pairs_{k}"] = idx.mode_pairs[k]
        arrays[f"comp_ents_{k}"] = idx.comp_ents[k]
        arrays[f"comp_bounds_{k}"] = idx.comp_bounds[k]
    return arrays, idx.arity


def _hit_sigs(out):
    return [(int(v.signature[0]), int(v.signature[1])) for v, _ in out.hits]


def test_replica_service_signals_writer_dead():
    prefix = f"ttdead{os.getpid()}"
    pub = ShmPublisher(prefix)
    arrays, n_modes = _index_arrays(seed=1)
    pub.publish(1, 1, arrays, meta={"n_modes": n_modes})
    deaths = []
    svc = ReplicaService(prefix, poll_interval=0.01, connect_timeout=10,
                         seqlock_spin_s=0.1, on_writer_dead=deaths.append,
                         dead_signal_cooldown=0.0)
    svc.start(first_snapshot_timeout=30)
    try:
        v = svc.version
        pub._seq += 1                        # wedged odd: dead mid-swing
        struct.pack_into("<Q", pub._ctl.buf, 0, pub._seq)
        _wait_for(lambda: len(deaths) >= 1, what="writer-dead signal")
        assert svc.version == v and svc.thread_alive
        assert svc.stats()["writer_dead_signals"] >= 1
        pub._seq += 1
        struct.pack_into("<Q", pub._ctl.buf, 0, pub._seq)
        assert svc.query(entity=0, k=2).version == v
    finally:
        svc.stop()
        pub.close()


# -- twins of TestShmIntegrity ----------------------------------------------

def test_flip_fault_refused_at_attach():
    prefix = f"ttcor{os.getpid()}"
    plan = FaultPlan.build(FaultPlan.flip_shm_word(0, at_version=2))
    pub = ShmPublisher(prefix, fault=plan.for_component("writer", 0))
    try:
        pub.publish(1, 1, {"a": np.arange(64.)})
        rep = ShmReplica(prefix, connect_timeout=10, seqlock_spin_s=0.2)
        held = rep.current()
        assert held.version == 1 and held.verify() == []
        pub.publish(2, 2, {"a": np.arange(64.) * 2})
        with pytest.raises(ShmCorruptionError, match="checksum"):
            rep.current()
        assert np.array_equal(held.arrays["a"], np.arange(64.))
        rep.close()
    finally:
        pub.close()


def test_replica_holds_snapshot_escalates_and_recovers():
    prefix = f"ttrsc{os.getpid()}"
    plan = FaultPlan.build(FaultPlan.flip_shm_word(0, at_version=2))
    pub = ShmPublisher(prefix, fault=plan.for_component("writer", 0))
    arrays, n_modes = _index_arrays(seed=1)
    pub.publish(1, 1, arrays, meta={"n_modes": n_modes})
    deaths = []
    svc = ReplicaService(prefix, poll_interval=0.01, connect_timeout=10,
                         seqlock_spin_s=0.2, on_writer_dead=deaths.append,
                         dead_signal_cooldown=0.0, scrub_interval=0.02)
    svc.start(first_snapshot_timeout=30)
    try:
        assert svc.version == 1
        base = _hit_sigs(svc.query(k=3))
        pub.publish(2, 2, arrays, meta={"n_modes": n_modes})
        _wait_for(lambda: svc.resilience_stats()["shm_corruptions"] >= 1,
                  what="corrupt segment refused")
        assert svc.version == 1 and _hit_sigs(svc.query(k=3)) == base
        assert deaths and isinstance(deaths[0], ShmCorruptionError)
        pub.publish(3, 3, arrays, meta={"n_modes": n_modes})
        _wait_for(lambda: svc.version == 3, what="clean republish attached")
        assert svc.scrub_clean and health_doc(svc)["healthy"]
        assert _hit_sigs(svc.query(k=3)) == base
    finally:
        svc.stop()
        pub.close()


def test_opportunistic_scrub_catches_post_attach_rot():
    prefix = f"ttsrb{os.getpid()}"
    pub = ShmPublisher(prefix)
    arrays, n_modes = _index_arrays(seed=2)
    pub.publish(1, 1, arrays, meta={"n_modes": n_modes})
    deaths = []
    svc = ReplicaService(prefix, poll_interval=0.01, connect_timeout=10,
                         seqlock_spin_s=0.2, on_writer_dead=deaths.append,
                         dead_signal_cooldown=0.0, scrub_interval=0.01)
    svc.start(first_snapshot_timeout=30)
    try:
        assert svc.version == 1 and svc.scrub_clean
        o = int(svc.replica._bundle.manifest[0]["offset"])
        pub._data.buf[o] = pub._data.buf[o] ^ 0xFF
        _wait_for(lambda: not svc.scrub_clean,
                  what="scrub caught held-bundle rot")
        assert svc.resilience_stats()["scrub_violations"]
        assert not health_doc(svc)["healthy"] and deaths
        pub.publish(2, 2, arrays, meta={"n_modes": n_modes})
        _wait_for(lambda: svc.version == 2, what="clean republish attached")
        assert svc.scrub_clean and health_doc(svc)["healthy"]
    finally:
        svc.stop()
        pub.close()


# -- twins of tests/test_serve_scale.py's shared-memory tests ---------------

_CHILD = r"""
import hashlib, json, sys
from repro_torch.serve.shm import ShmReplica

rep = ShmReplica(sys.argv[1], connect_timeout=30.0)
bundle = rep.current()
print(json.dumps({"version": bundle.version,
                  "stream_version": bundle.stream_version,
                  "hashes": {k: hashlib.sha256(v.tobytes()).hexdigest()
                             for k, v in sorted(bundle.arrays.items())}}))
rep.close()
"""


def test_replica_process_observes_exact_writer_arrays():
    ctx = TSyn.random_context((8, 7, 6), 96, seed=7)
    m = StreamingMiner(ctx.sizes, seed=7, device="cpu")
    m.upsert(ctx.tuples)
    idx = ClusterIndex.from_result(m.snapshot())
    arrays = {"packed_sigs": idx.packed_sigs, "any_pairs": idx.any_pairs,
              "density": idx.density}
    for k in range(idx.arity):
        arrays[f"mode_pairs_{k}"] = idx.mode_pairs[k]
        arrays[f"comp_ents_{k}"] = idx.comp_ents[k]
        arrays[f"comp_bounds_{k}"] = idx.comp_bounds[k]
    pub = ShmPublisher(f"ttrs-test-{os.getpid()}")
    try:
        pub.publish(3, 17, arrays, meta={"n_modes": idx.arity})
        proc = subprocess.run([sys.executable, "-c", _CHILD, pub.prefix],
                              capture_output=True, text=True, timeout=120,
                              env=_env())
        assert proc.returncode == 0, proc.stderr
        got = json.loads(proc.stdout)
    finally:
        pub.close()
    assert got["version"] == 3 and got["stream_version"] == 17
    assert got["hashes"] == {
        k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
        for k, v in arrays.items()}


def test_reader_waits_out_in_progress_publish():
    pub = ShmPublisher(f"ttrs-odd-{os.getpid()}")
    try:
        pub.publish(1, 5, {"a": np.arange(4.0)})
        rep = ShmReplica(pub.prefix, connect_timeout=10.0,
                         seqlock_spin_s=30.0)
        pub._seq += 1                        # a publish in progress
        struct.pack_into("<Q", pub._ctl.buf, 0, pub._seq)
        out, started = {}, threading.Event()

        def read():
            started.set()
            out["ctl"] = rep.read_control()

        t = threading.Thread(target=read, daemon=True)
        t.start()
        started.wait(10)
        assert t.is_alive()                  # spinning on the odd seq
        struct.pack_into(TSHM._CTL_FMT, pub._ctl.buf, 0, pub._seq,
                         pub.epoch, 2, 9, 0.0, 0, 0)
        pub._seq += 1
        struct.pack_into("<Q", pub._ctl.buf, 0, pub._seq)
        t.join(timeout=10)
        assert not t.is_alive()
        assert (out["ctl"]["version"], out["ctl"]["stream_version"]) \
            == (2, 9)
        rep.close()
    finally:
        pub.close()


def test_held_bundle_survives_unlink_bit_identical():
    a1 = {"a": np.arange(32, dtype=np.float64),
          "b": np.arange(8, dtype=np.int64) * 3}
    want = {k: hashlib.sha256(v.tobytes()).hexdigest()
            for k, v in a1.items()}
    pub = ShmPublisher(f"ttrs-unlink-{os.getpid()}")
    try:
        pub.publish(1, 1, a1)
        rep = ShmReplica(pub.prefix, connect_timeout=10.0)
        held = rep.current()
        assert held.version == 1
        pub.publish(2, 2, {"a": np.zeros(32), "b": np.zeros(8, np.int64)})
        assert not os.path.exists(f"/dev/shm/{pub.prefix}.v1")
        assert {k: hashlib.sha256(v.tobytes()).hexdigest()
                for k, v in held.arrays.items()} == want
        cur = rep.current()
        assert cur.version == 2 and float(cur.arrays["a"].sum()) == 0.0
        rep.close()
    finally:
        pub.close()
