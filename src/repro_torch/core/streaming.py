"""Online / streaming clustering (paper §2 online setting) with
merge-based incremental snapshots and upsert (tombstone) streams.
Port of ``repro.core.streaming``.

The paper's online Algorithm 1 keeps dictionaries and appends pointers
per incoming triple.  The accelerator analogue keeps, per mode, the
tuple table's *sorted order* as a set of sorted runs — the shared
``core.runs.RunStore`` storage layer, which this engine drives against
the shared pipeline of ``core.pipeline``:

* ``add(chunk)`` sorts **only the chunk** (O(c log c) per mode, on the
  host) into a new run; geometric compaction merges runs linearly, so
  every tuple is merged O(log T) times over the stream's lifetime.
* ``upsert(rows, values)`` / ``delete(rows)`` tombstone superseded
  versions in the store — last write wins, exactly the batch
  constructor's canonicalisation (``core.context``); a valued ``add``
  *is* an upsert.
* ``snapshot()`` compacts tombstones away, merges the surviving runs
  into full per-mode permutations (linear in T, no re-sort) and hands
  them to ``pipeline.mine_tuples`` via its ``perms`` argument, which
  skips Stage 1's sorts and recomputes segments, signatures and dedup
  from the pre-sorted order.  On CUDA the snapshot launches the
  ``segment_reduce`` kernel per mode and the radix kernels for Stage
  3's signature sort only.

Snapshots are *exact*: identical cluster sets (and bit-identical
signatures) to a full re-mine of the survivor table.  Both variants
stream: prime/multimodal (θ) and NOAC (δ/ρ_min/minsup).  The snapshot
table is padded with row-0 duplicates to ``runs.snapshot_cap`` (the JAX
package's power-of-two shapes), so its leaves equal that package's
snapshot leaves, pads included.

The store merges host-packed uint64 keys from the *same* ``core.keys``
bit-width plans the device pipeline sorts by, so host-merged
permutations and device sorts order identically by construction.  The
streaming plans keep the un-pruned float value lane (runs must stay
mergeable when later chunks bring unseen values).  If a context's key
does not fit in 64 bits, the engine falls back to an exact full device
re-sort per snapshot and reports it in ``stats['incremental']``;
upsert/delete still work (tombstones live in the log, not the runs).

Checkpoints: ``state.checkpoint()`` serialises the run arrays and
tombstones themselves (``runs.save_checkpoint`` writes them in the JAX
package's format), so restore is O(T) array loads — no re-sort; legacy
buffer-only blobs restore through one lazy rebuild sort.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import pipeline as P
from . import runs as RS

#: Checkpoint/restore entry point (kept under its historical name; the
#: state object *is* the shared run store).
StreamState = RS.RunStore


class StreamingMiner(P.PipelineMiner):
    """Online one-pass mining with exact snapshot-on-demand semantics.

    Ingestion: ``add`` (append; valued streams upsert — see module
    docstring), ``upsert`` (insert-or-replace by tuple, last write
    wins), ``delete`` (tombstone).  ``snapshot()`` mines the current
    survivor set exactly, on ``device`` (default CUDA)."""

    def __init__(self, sizes, theta: float = 0.0, seed: int = 0x5EED,
                 delta: Optional[float] = None, rho_min: float = 0.0,
                 minsup: int = 0, incremental: bool = True,
                 packed: Optional[bool] = None,
                 sort_backend: Optional[str] = None,
                 use_kernels: Optional[bool] = None,
                 prune_values: bool = True,
                 window_budget: Optional[int] = None,
                 device=None):
        # prune_values is accepted for registry-kwarg uniformity but has
        # no effect on snapshots: they share the host store's un-pruned
        # float value lane (see module docstring)
        super().__init__(sizes, theta=(rho_min if delta is not None
                                       else theta),
                         delta=delta, minsup=minsup, seed=seed,
                         packed=packed, sort_backend=sort_backend,
                         use_kernels=use_kernels, prune_values=prune_values,
                         window_budget=window_budget, device=device)
        self.incremental = bool(incremental) and all(
            p.fits for p in self.key_plans)
        self.state: Optional[RS.RunStore] = None
        self.stats = {"snapshots": 0, "full_resorts": 0, "merged_rows": 0,
                      "chunk_sorted_rows": 0, "tombstoned_rows": 0,
                      "incremental": self.incremental}
        # snapshot versioning: every mutating call bumps
        # ``stream_version``; ``snapshot()`` records the version it
        # covers, so a published snapshot can be tagged with exactly the
        # writes it reflects
        self.stream_version = 0
        self.snapshot_stream_version = 0
        # per-snapshot dirty-signature tracking (a serving delta index):
        # off by default — it copies the signature lanes to the host
        # inside snapshot(), which mining runs must not pay
        self.track_dirty_sigs = False
        self.last_kept_sigs: Optional[np.ndarray] = None
        self.last_dirty_sigs = 0

    # -- ingestion ----------------------------------------------------------

    def _store(self) -> RS.RunStore:
        """The run store, created on first use and re-adopted after a
        checkpoint restore (a restored store may lack plans — legacy
        blobs — or carry its own stats dict)."""
        if self.state is None:
            self.state = RS.RunStore(
                self.key_plans,
                radix=self.resolved_sort_backend == "radix",
                incremental=self.incremental, stats=self.stats)
        s = self.state
        if s.plans is None:
            s.plans = self.key_plans
        s.radix = self.resolved_sort_backend == "radix"
        s.incremental = s.incremental and self.incremental
        s.stats = self.stats
        return s

    def add(self, chunk: np.ndarray, values=None) -> None:
        self._store().add(chunk, values if self.delta is not None else None)
        self.stream_version += 1

    def upsert(self, rows: np.ndarray, values=None) -> None:
        self._store().upsert(rows,
                             values if self.delta is not None else None)
        self.stream_version += 1

    def delete(self, rows: np.ndarray) -> None:
        self._store().delete(rows)
        self.stream_version += 1

    # -- snapshots ----------------------------------------------------------

    def snapshot(self, full_remine: bool = False) -> P.PipelineResult:
        """Current cluster set of the survivor table (exact; padding is
        idempotent).

        ``full_remine=True`` forces the one-shot path (device sorts) —
        the baseline the incremental path is verified and timed against.
        With ``window_budget`` set, the incremental snapshot streams
        through ``core.windowed`` (host leaves) instead of one
        monolithic device call."""
        if self.state is None or self.state.count == 0:
            raise ValueError("no data ingested")
        self.snapshot_stream_version = self.stream_version
        s = self._store()
        if full_remine or not s.incremental:
            s.compact()          # survivor set only; leave runs unmerged
        else:
            s.prepare()
        if s.count == 0:
            raise ValueError("no live rows (everything deleted)")
        rows, vals = s.table()
        cap = RS.snapshot_cap(s.count)
        rows, vals = RS.padded_table(rows, vals, cap)
        self.stats["snapshots"] += 1
        if full_remine or not s.incremental:
            self.stats["full_resorts"] += 1
            res = self._mine_unpruned(rows, vals)
        elif self.window_budget and self.packed_active:
            res = self._mine_windows(rows, vals, s.perms(cap),
                                     self.window_budget)
        else:
            res = self._mine_unpruned(rows, vals, s.perms(cap))
        if self.track_dirty_sigs:
            self._note_sigs(res)
        return res

    def _note_sigs(self, result) -> None:
        """Record this snapshot's kept-signature set and how many
        signatures changed against the previous snapshot."""
        sigs = P.kept_sig_words(result)
        self.last_dirty_sigs = P.dirty_sig_count(self.last_kept_sigs, sigs)
        self.last_kept_sigs = sigs

    def snapshot_clusters(self, only_kept: bool = True):
        return self.materialise(self.snapshot(), only_kept=only_kept)
