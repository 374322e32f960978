"""The port's supervisor (``repro_torch.train.fault_tolerance``, a copy of
the JAX module): the twins of ``tests/test_fault_tolerance.py``'s
crash-restart, straggler, restart-budget and heartbeat tests."""
import os
import sys
import textwrap

from repro_torch.train.fault_tolerance import Supervisor, beat, last_beat


def _script(tmp_path, body: str) -> list:
    path = os.path.join(str(tmp_path), "worker.py")
    with open(path, "w") as f:
        f.write(textwrap.dedent(body))
    return [sys.executable, path]


def test_crash_then_success(tmp_path):
    """First run crashes; the supervisor restarts; second run succeeds."""
    marker = os.path.join(str(tmp_path), "ran_once")
    hb = os.path.join(str(tmp_path), "hb")
    argv = _script(tmp_path, f"""
        import os, sys, time
        hb = {hb!r}; marker = {marker!r}
        for step in range(5):
            open(hb, "w").write(str(step))
            time.sleep(0.05)
        if not os.path.exists(marker):
            open(marker, "w").write("x")
            os._exit(13)          # injected crash on the first attempt
        sys.exit(0)
    """)
    sup = Supervisor(argv, heartbeat=hb, heartbeat_timeout=30,
                     max_restarts=2, poll_interval=0.05)
    assert sup.run() == 0


def test_straggler_killed_and_restarted(tmp_path):
    """A worker that stops heartbeating is killed and re-run."""
    marker = os.path.join(str(tmp_path), "hung_once")
    hb = os.path.join(str(tmp_path), "hb")
    argv = _script(tmp_path, f"""
        import os, sys, time
        hb = {hb!r}; marker = {marker!r}
        open(hb, "w").write("0")
        if not os.path.exists(marker):
            open(marker, "w").write("x")
            time.sleep(3600)      # simulated hang (no more heartbeats)
        for step in range(3):
            open(hb, "w").write(str(step))
            time.sleep(0.05)
        sys.exit(0)
    """)
    sup = Supervisor(argv, heartbeat=hb, heartbeat_timeout=1.0,
                     max_restarts=2, grace_period=5.0, poll_interval=0.1)
    assert sup.run() == 0


def test_restart_budget_exhausted(tmp_path):
    hb = os.path.join(str(tmp_path), "hb")
    argv = _script(tmp_path, """
        import os
        os._exit(7)
    """)
    sup = Supervisor(argv, heartbeat=hb, heartbeat_timeout=5,
                     max_restarts=1, poll_interval=0.05)
    assert sup.run() != 0


def test_beat_helpers(tmp_path):
    hb = os.path.join(str(tmp_path), "hb")
    assert last_beat(hb) is None
    beat(hb, 3)
    assert last_beat(hb) is not None
