"""Fault tolerance: supervised training with heartbeat watchdog
(DESIGN.md §8).  A copy of ``repro.train.fault_tolerance`` (plain Python,
no torch), kept here so that the port imports nothing of the JAX package;
``examples/torch_fault_tolerance_demo.py`` supervises
``python -m repro_torch.launch.train`` with it.

At cluster scale the unit of failure is a worker process/node. The
``Supervisor`` runs the trainer as a subprocess and implements the
JobTracker semantics the paper leans on (§1, §4.1):

* **crash** → restart from the newest valid checkpoint (the trainer's
  ``--resume auto``), up to ``max_restarts`` times;
* **straggler / hang** → a worker that stops writing its heartbeat for
  ``heartbeat_timeout`` seconds is killed and restarted — the speculative
  re-execution analogue (idempotent steps + atomic checkpoints make
  re-execution safe, exactly the paper's at-least-once argument for
  duplicated M/R tuples);
* restarts are *elastic*: the restarted process may see a different
  device count (in the port, another number of ``torchrun`` ranks) and
  its restore re-shards (``CheckpointManager.restore(shardings=...)``).

The heartbeat is a file the trainer touches every step — cheap, works over
shared filesystems, and survives the supervisor itself restarting.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import subprocess
import sys
import time
from typing import Optional, Sequence


def beat(path: str, step: int = 0):
    """Touch the heartbeat file (called by the trainer every step)."""
    with open(path, "w") as f:
        f.write(f"{step} {time.time()}\n")


def last_beat(path: str) -> Optional[float]:
    try:
        return os.stat(path).st_mtime
    except OSError:
        return None


@dataclasses.dataclass
class Supervisor:
    argv: Sequence[str]                 # trainer command line
    heartbeat: str                      # heartbeat file path
    heartbeat_timeout: float = 60.0
    max_restarts: int = 3
    grace_period: float = 30.0          # startup slack before watching
    poll_interval: float = 0.5
    env: Optional[dict] = None

    def run(self) -> int:
        """Supervise until clean exit (rc 0) or restart budget exhausted.
        Returns the final return code."""
        restarts = 0
        while True:
            if os.path.exists(self.heartbeat):
                os.unlink(self.heartbeat)
            proc = subprocess.Popen(
                list(self.argv),
                env={**os.environ, **(self.env or {})})
            started = time.time()
            rc = None
            killed_for = None
            while True:
                rc = proc.poll()
                if rc is not None:
                    break
                hb = last_beat(self.heartbeat)
                ref = hb if hb is not None else started
                slack = (self.grace_period if hb is None
                         else self.heartbeat_timeout)
                if time.time() - ref > slack:
                    killed_for = "heartbeat timeout (straggler/hang)"
                    proc.send_signal(signal.SIGKILL)
                    proc.wait()
                    rc = -9
                    break
                time.sleep(self.poll_interval)
            if rc == 0:
                return 0
            restarts += 1
            reason = killed_for or f"crash rc={rc}"
            print(f"[supervisor] worker died ({reason}); "
                  f"restart {restarts}/{self.max_restarts}",
                  file=sys.stderr, flush=True)
            if restarts > self.max_restarts:
                print("[supervisor] restart budget exhausted",
                      file=sys.stderr, flush=True)
                return rc if rc else 1
