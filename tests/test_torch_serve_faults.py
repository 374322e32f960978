"""Parity of the port's fault injection (``repro_torch.serve.faults``) and
of its service's durability code (WAL, checkpoints, recovery, scrubber)
with the JAX package on the CPU: the same plans serialise to the same
JSON and fire on the same counters; the same write stream writes the
same WAL bytes; checkpoint + WAL recovery replays to the JAX package's
served clusters bit for bit — also from a recovery directory the JAX
package wrote; and each corruption case recovers as JAX's does.
Modelled on ``tests/test_serve_faults.py``'s ``TestFaultPlan``,
``TestWriterRecovery``, ``TestCorruptionRecovery`` and ``TestScrubber``
(the HTTP, shared-memory, router and supervisor tests wait for ROADMAP
A10b)."""
import glob
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from repro.serve import faults as JF
from repro.serve.service import TriclusterService as JService
from repro_torch.core import runs as RS
from repro_torch.serve import faults as TF
from repro_torch.serve.service import TriclusterService

SIZES = (24, 12, 8)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plans(F):
    P = F.FaultPlan
    return [
        P.build(P.kill_writer(1, 7), P.hang_replica(0, 2, 5, for_s=0.5),
                P.drop_requests("replica", -1, at=3), seed=42),
        P.build(P.flip_wal_byte(0, at_stream_version=3),
                P.truncate_checkpoint(1, at_version=2),
                P.flip_shm_word(0, at_version=4)),
        P.scattered(7, "replica", 0, window=100, n_drop=3, n_slow=2),
        P.build(P.kill_writer_at_publish(0, 3), P.torn_publish(2, 9),
                P.slow_requests("router", 0, at=2, delay_s=0.25, every=3,
                                count=4), seed=5),
    ]


@pytest.mark.parametrize("i", range(4))
def test_plans_serialise_and_fire_alike(i):
    jp, tp = _plans(JF)[i], _plans(TF)[i]
    assert tp.to_json() == jp.to_json()
    assert TF.FaultPlan.from_json(jp.to_json()) == tp
    for role, shard, replica in (("writer", 0, -1), ("writer", 1, -1),
                                 ("replica", 0, 2), ("router", 0, -1)):
        ji = jp.for_component(role, shard, replica)
        ti = tp.for_component(role, shard, replica)
        assert len(ti.faults) == len(ji.faults)
        seen = []
        for inj, exc in ((ji, JF.DropRequest), (ti, TF.DropRequest)):
            fired = []
            for site in ("request", "write", "publish", "torn"):
                for v in range(1, 12):
                    f = inj.corrupt("wal", v) or inj.corrupt(
                        "checkpoint", v) or inj.corrupt("shm", v)
                    if f is not None:
                        fired.append(("corrupt", v, f.kind))
                    if any(f.kind in ("kill", "hang", "slow")
                           for f in inj.faults if f.site == site):
                        continue      # these act on the process
                    try:
                        inj.fire(site, v)
                    except exc:
                        fired.append((site, v))
            seen.append((fired, inj.fired()))
        assert seen[1] == seen[0]
    assert TF.KILL_EXIT_CODE == JF.KILL_EXIT_CODE


def test_counter_trigger_once_and_every():
    inj = TF.FaultInjector([TF.Fault("drop", "request", at=3),
                            TF.Fault("drop", "request", at=10, every=5,
                                     count=2)])
    fired = []
    for i in range(1, 21):
        try:
            inj.fire("request", i)
        except TF.DropRequest:
            fired.append(i)
    assert fired == [3, 10, 15] and inj.fired("request") == 3
    inj.clear("request")
    inj.fire("request", 3)


def _top_sigs(svc, k=8):
    return [(int(v.signature[0]), int(v.signature[1]), float(s))
            for v, s in svc.query(k=k).hits]


def _both(tmp_path, name, **kw):
    """(JAX service, port service), each with its own recovery dir."""
    out = []
    for cls, sub, extra in ((JService, "jax", {}),
                            (TriclusterService, "torch",
                             {"device": "cpu"})):
        rec = tmp_path / sub / name
        rec.mkdir(parents=True, exist_ok=True)
        out.append(cls(SIZES, recover_dir=str(rec), **kw, **extra))
    return out


def _chunks(seed, n_chunks=5, rows=4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, SIZES, size=(n_chunks, rows, 3)).astype(np.int64)


def test_checkpoint_wal_replay_bit_identical(tmp_path):
    """Both packages' victims write the same WAL bytes; each successor
    (and a port successor over the JAX package's directory) recovers to
    the uninterrupted control's clusters and scores."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, SIZES, size=(150, 3)).astype(np.int64)
    extra = rng.integers(0, SIZES, size=(5, 4, 3)).astype(np.int64)
    ctl = TriclusterService(SIZES, seed=11, device="cpu")
    for rows in (base, *extra):
        ctl.add(rows)
    ctl.refresh()
    jctl = JService(SIZES, seed=11)
    for rows in (base, *extra):
        jctl.add(rows)
    jctl.refresh()
    assert _top_sigs(ctl) == _top_sigs(jctl)

    victims = _both(tmp_path, "rec", seed=11, checkpoint_every=3)
    for vic in victims:
        vic.add(base)
        vic.refresh()
        for chunk in extra[:3]:
            vic.add(chunk)
        vic.refresh()                        # cadence checkpoint ran
        assert vic.stats()["checkpoints"] >= 1
        vic.add(extra[3])                    # only in the WAL
    jv, tv = victims
    sv, v_before = tv.stream_version, tv.version
    wal = [open(os.path.join(v.recover_dir, "wal.jsonl"), "rb").read()
           for v in victims]
    assert wal[1] == wal[0] and wal[1].count(b"\n") == 1
    blob_j, meta_j = RS.load_checkpoint(
        os.path.join(jv.recover_dir, "ckpt.npz"))
    blob_t, meta_t = RS.load_checkpoint(
        os.path.join(tv.recover_dir, "ckpt.npz"))
    assert meta_t == meta_j
    for key in ("buffer", "count"):
        np.testing.assert_array_equal(blob_t[key], blob_j[key])
    del victims, jv, tv                      # crash: no graceful stop

    for sub in ("torch", "jax"):             # the port reads both dirs
        succ = TriclusterService(SIZES, seed=11, device="cpu",
                                 recover_dir=str(tmp_path / sub / "rec"))
        r = succ.recovered
        assert (r["stream_version"], r["replayed_ops"]) == (sv, 1)
        assert r["checkpoint_generation"] == "current"
        succ.add(extra[4])
        snap = succ.refresh()
        assert snap.version > v_before
        assert succ.stream_version == ctl.stream_version
        assert _top_sigs(succ) == _top_sigs(ctl)
        np.testing.assert_array_equal(snap.index.packed_sigs,
                                      ctl.snapshot().index.packed_sigs)
        succ.stop()
    ctl.stop()


def test_wal_alone_recovers_without_checkpoint(tmp_path):
    rng = np.random.default_rng(13)
    rows = rng.integers(0, SIZES, size=(60, 3)).astype(np.int64)
    for vic in _both(tmp_path, "rec", seed=13, checkpoint_every=10**6):
        vic.add(rows[:40])
        vic.upsert(rows[40:55])
        vic.delete(rows[:5])
    views = []
    for cls, sub, kw in ((JService, "jax", {}),
                         (TriclusterService, "torch", {"device": "cpu"})):
        succ = cls(SIZES, seed=13, recover_dir=str(tmp_path / sub / "rec"),
                   **kw)
        assert succ.recovered["replayed_ops"] == 3
        succ.refresh()
        views.append((succ.recovered, succ.stream_version,
                       _top_sigs(succ)))
        succ.stop()
    assert views[1] == views[0] and views[1][1] == 3


def test_injected_kill_at_stream_version(tmp_path):
    """The kill-at-version fault in a child process of the port: it dies
    with KILL_EXIT_CODE right after its third write lands in the WAL, and
    its successor recovers every logged op."""
    rec = str(tmp_path / "reckill")
    child = f"""
import numpy as np
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.service import TriclusterService
plan = FaultPlan.build(FaultPlan.kill_writer(0, at_stream_version=3))
svc = TriclusterService({SIZES!r}, seed=2, recover_dir={rec!r},
                        device="cpu", fault=plan.for_component("writer", 0))
rng = np.random.default_rng(2)
for i in range(5):
    svc.add(rng.integers(0, {SIZES!r}, size=(4, 3)).astype(np.int64))
raise SystemExit("unreachable: kill fault must fire at sv=3")
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", child], env=env,
                          timeout=300, capture_output=True, text=True)
    assert proc.returncode == TF.KILL_EXIT_CODE, proc.stderr
    succ = TriclusterService(SIZES, seed=2, recover_dir=rec, device="cpu")
    assert succ.stream_version == 3
    assert succ.recovered["replayed_ops"] == 3
    succ.stop()


def _recovered_view(svc):
    """Recovery summary with the quarantine file's epoch cut off."""
    r = dict(svc.recovered)
    r["wal_quarantined"] = r["wal_quarantined"].split(".quarantine.")[0]
    return r, svc.stream_version, svc.resilience_stats()


def _flip_line(path, line, back=3):
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    ln = lines[line]
    pos = len(ln) - back                     # inside the json payload
    lines[line] = ln[:pos] + bytes([ln[pos] ^ 0x01]) + ln[pos + 1:]
    with open(path, "wb") as f:
        f.write(b"\n".join(lines))


@pytest.mark.parametrize("case", ["interior_flip", "torn_tail",
                                  "truncated_checkpoint", "injected_flip"])
def test_corruption_recovers_as_jax(tmp_path, case):
    """Each corruption case on both packages' directories: the same
    recovery summary, stream version, resilience counters and served
    clusters."""
    chunks = _chunks({"interior_flip": 31, "torn_tail": 37,
                      "truncated_checkpoint": 41,
                      "injected_flip": 43}[case])
    views = []
    for cls, sub, kw in ((JService, "jax", {}),
                         (TriclusterService, "torch", {"device": "cpu"})):
        F = JF if cls is JService else TF
        rec = str(tmp_path / sub)
        wal = os.path.join(rec, "wal.jsonl")
        if case == "truncated_checkpoint":
            plan = F.FaultPlan.build(
                F.FaultPlan.truncate_checkpoint(0, at_version=2))
            vic = cls(SIZES, seed=41, recover_dir=rec, checkpoint_every=2,
                      fault=plan.for_component("writer", 0), **kw)
            for i, c in enumerate(chunks):
                vic.add(c)
                if i in (1, 3):
                    vic.refresh()            # generations 1 and 2
            assert vic.stats()["checkpoints"] == 2
        elif case == "injected_flip":
            plan = F.FaultPlan.build(
                F.FaultPlan.flip_wal_byte(0, at_stream_version=3))
            vic = cls(SIZES, seed=43, recover_dir=rec,
                      checkpoint_every=10**6,
                      fault=plan.for_component("writer", 0), **kw)
            for c in chunks:
                vic.add(c)
            assert vic.stream_version == 5   # the victim never noticed
        else:
            vic = cls(SIZES, seed=31, recover_dir=rec,
                      checkpoint_every=10**6, **kw)
            for c in chunks[:5 if case == "interior_flip" else 3]:
                vic.add(c)
        del vic                              # crash
        if case == "interior_flip":
            _flip_line(wal, 1)               # rot record 2 of 5
        elif case == "torn_tail":
            good = os.path.getsize(wal)
            with open(wal, "ab") as f:       # the torn half-record
                f.write(b'00000000 {"op": "add", "rows"')
        succ = cls(SIZES, seed=7, recover_dir=rec, checkpoint_every=10**6,
                   **kw)
        view = _recovered_view(succ)
        if case == "torn_tail":
            assert os.path.getsize(wal) == good
            succ.add(chunks[3])              # resume appending in place
            del succ
            succ = cls(SIZES, seed=7, recover_dir=rec, **kw)
            view += (succ.recovered["replayed_ops"],)
        quarantined = sorted(os.path.basename(p).split(".quarantine.")[0]
                             for p in glob.glob(f"{rec}/*.quarantine.*"))
        succ.refresh()
        views.append((view, quarantined, _top_sigs(succ)))
        succ.stop()
    assert views[1] == views[0]
    summary = views[1][0][0]
    want = {"interior_flip": (1, "wal.jsonl"), "torn_tail": (3, ""),
            "truncated_checkpoint": (1, ""),
            "injected_flip": (2, "wal.jsonl")}[case]
    assert (summary["replayed_ops"], summary["wal_quarantined"]) == want


def test_checkpoint_frame_rejects_bit_rot_and_truncation(tmp_path):
    svc = TriclusterService(SIZES, seed=47, recover_dir=str(tmp_path),
                            device="cpu")
    svc.add(_chunks(47)[0])
    assert svc.final_checkpoint()
    svc.stop()
    path = os.path.join(str(tmp_path), "ckpt.npz")
    RS.load_checkpoint(path)
    with open(path, "rb") as f:
        data = f.read()
    i = len(data) // 2
    for bad in (data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:],
                data[:i], data + b"x"):
        with open(path, "wb") as f:
            f.write(bad)
        with pytest.raises(RS.CheckpointCorruptError):
            RS.load_checkpoint(path)


def _service(seed, **kw):
    rng = np.random.default_rng(seed)
    svc = TriclusterService(SIZES, refresh_interval=0.05, dirty_threshold=4,
                            seed=seed, device="cpu", **kw)
    svc.add(rng.integers(0, SIZES, size=(160, 3)).astype(np.int64))
    return svc


def test_scrub_clean_then_violations():
    svc = _service(9, scrub_interval=0.02)
    svc.refresh()
    svc.start()
    try:
        deadline = time.monotonic() + 30
        while svc.resilience_stats()["scrubs"] < 1:
            assert time.monotonic() < deadline, "no background scrub"
            time.sleep(0.01)
        rep = svc.scrub()
        assert rep["violations"] == [] and svc.scrub_clean
        assert svc.resilience_stats()["last_scrub_version"] == svc.version
        snap = svc._snap
        poisoned = types.SimpleNamespace(
            version=snap.version + 1, index=snap.index, result=snap.result,
            querier=types.SimpleNamespace(scores=np.array([1.0, np.nan])),
            ages=snap.ages)
        assert "non-finite ranking scores" in svc.scrub(poisoned)[
            "violations"]
        assert not svc.scrub_clean
        assert any(e[0] == "scrub_violation"
                   for e in svc.stats()["integrity_events"])
        smaller = types.SimpleNamespace(
            packed_sigs=snap.index.packed_sigs[:-1])
        rep = svc.scrub(types.SimpleNamespace(
            version=snap.version + 2, index=smaller, result=snap.result,
            querier=snap.querier, ages=snap.ages))
        assert any("divergence" in v for v in rep["violations"])
    finally:
        svc.stop()
