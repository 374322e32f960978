"""Distributed three-stage clustering: the paper's M/R algorithm over the
ranks of a ``torch.distributed`` process group.  Port of
``repro.core.distributed``.

Both the prime/multimodal variant and the many-valued NOAC variant
(δ/ρ_min/minsup) run here: the per-shard compute is the shared pipeline
of ``core.pipeline`` with the variant's component operator plugged in,
so the distribution strategy is written exactly once.

The shard bodies are SPMD: every rank runs the same code.  The caller
passes the global tuple table on every rank (as the JAX package's caller
does); each rank takes its block of ``T / P`` rows onto its device, and
the result holds that block (``DistributedResult.gather`` assembles the
whole table on every rank).  The collectives (``core.collectives``) run
over the mesh axes the tuples are block-partitioned over.  Two merge
strategies, mirroring the centralise-vs-replicate discussion in the
paper's §1:

* ``replicate`` — all-gather the (small) tuple table over the data axes
  and let every shard run the batch pipeline on the full table, keeping
  only its own block's outputs.  Communication: one all-gather of
  ``T×N`` int32 (plus ``T`` float32 values for NOAC); compute is
  duplicated ×P.

* ``shuffle`` — the faithful M/R shuffle.  Stage 1 routes each tuple's
  ⟨subrelation, e_k[, value]⟩ record to the key's *owner shard* with a
  fixed-capacity ``all_to_all``; owners sort/segment/hash their key
  ranges — running the variant's component operator (whole segment, or
  δ-range binary searches) — and answer with ⟨signature, cardinality⟩
  per record (Stage 2).  Stage 3 deduplicates and counts generating
  tuples on 8-byte cluster signatures gathered over the mesh.  Skew
  shows up as capacity overflow and is *reported*, then retried with a
  doubled capacity, never silently dropped.

  When the context's sort key fits 64 bits (``core.keys``), senders ship
  the *pre-packed* key words and owners sort the received words directly
  (one radix sort with the validity flag folded in as the top bit); the
  owners are key *ranges* balanced by the radix top-digit histogram.
  Wider keys fall back to the original column records, hash-partitioned.

Both strategies return signatures/densities bit-identical to the
single-device ``BatchMiner``/``NOACMiner`` (same hash vectors), and
every leaf bit-identical to the JAX package's ``DistributedMiner``.
Hash lanes and key words are int32 bit patterns (``core.bits``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from . import keys as K
from . import pipeline as PL
from . import radix as RX
from . import runs as RS
from .bits import i32, srl, word_key
from .collectives import Collectives

#: The (T/P,) per-tuple leaves of a ``DistributedResult``; then the
#: (N, T/P) cardinalities and the two replicated scalars.
ROW_LEAVES = ("sig_lo", "sig_hi", "is_unique", "gen_count", "volume",
              "density", "keep")
LEAVES = ROW_LEAVES + ("cardinalities", "n_clusters", "overflow")


@dataclasses.dataclass
class DistributedResult:
    """Per-tuple outputs of this rank's block of the tuple table, and the
    replicated scalars (0-d int32)."""
    sig_lo: torch.Tensor
    sig_hi: torch.Tensor
    is_unique: torch.Tensor
    gen_count: torch.Tensor
    volume: torch.Tensor
    density: torch.Tensor
    keep: torch.Tensor
    cardinalities: torch.Tensor  # (N, T/P) distinct |component_k| per tuple
    n_clusters: torch.Tensor     # unique clusters of the whole table
    overflow: torch.Tensor       # dropped records (0 == exact)
    #: the collectives the result was computed over (for :meth:`gather`)
    comm: Optional[Collectives] = dataclasses.field(
        default=None, repr=False, compare=False)

    def gather(self) -> "DistributedResult":
        """The whole table's result on every rank (blocks in shard order);
        the result itself on a single rank without a group."""
        if self.comm is None or self.comm.group is None:
            return self
        g = self.comm.all_gather
        out = {name: g(getattr(self, name)) for name in ROW_LEAVES}
        out["cardinalities"] = g(self.cardinalities.t()).t().contiguous()
        return DistributedResult(**out, n_clusters=self.n_clusters,
                                 overflow=self.overflow, comm=self.comm)


def _hash_columns(cols: Sequence[torch.Tensor], salt: int) -> torch.Tensor:
    """uint32 mix of int32 id columns (key → owner-shard hashing), as
    int32 bit patterns."""
    h = torch.full(cols[0].shape, i32(salt), dtype=torch.int32,
                   device=cols[0].device)
    for c in cols:
        h = (h ^ c.to(torch.int32)) * i32(0x9E3779B1)
        h = h ^ srl(h, 15)
    return h


def _hash_owner(h: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owner shard of uint32 hash ``h`` (an int32 bit pattern)."""
    return ((h.to(torch.int64) & 0xFFFFFFFF) % n_shards).to(torch.int32)


def _range_partition(words, plan: K.ModeKeyPlan, comm: Collectives,
                     n_shards: int, capacity: int,
                     fallback_owner: torch.Tensor):
    """(owner shard per record, 0-d bool: the hash fallback was taken)
    from the radix plan's *top-digit* histogram: the all-reduced
    histogram of the subrelation prefix's top 8 live bits yields balanced
    contiguous key ranges (boundary of shard s at the digit where the
    cumulative count crosses s/n_shards of the total).

    Two skew escapes fall back to ``fallback_owner`` (the hash
    partition); both tests are all-reduced so every shard takes the same
    branch (a key's records must all reach one owner): a single bucket
    exceeding a fair shard share, and a source→owner *link* exceeding the
    dispatch ``capacity``."""
    dev = words[0].device
    # the digit may only read *subrelation* bits (above seg_shift)
    top_w = min(RX.HIST_DIGIT_BITS, plan.total_bits - plan.seg_shift)
    dig = RX.extract_digit(words, plan.total_bits - top_w, top_w).long()
    hist = comm.psum(torch.bincount(dig, minlength=1 << top_w)
                     .to(torch.int32))
    cum = torch.cumsum(hist, 0, dtype=torch.int32)
    cum_before = cum - hist
    total = torch.clamp(cum[-1], min=1)
    # boundary math in float32, as the JAX package: the digit -> shard
    # map decides the links' loads, so the overflow count and the
    # retries follow it
    shard_of_digit = torch.clamp(
        (cum_before.to(torch.float32) * PL._f32(n_shards, dev)
         / total.to(torch.float32)).to(torch.int32), 0, n_shards - 1)
    range_owner = shard_of_digit[dig]
    local_link = torch.bincount(range_owner.long(), minlength=n_shards)
    link_max = comm.pmax(local_link.max().to(torch.int32))
    skewed = (hist.max() > total // n_shards) | (link_max > capacity)
    return torch.where(skewed, fallback_owner, range_owner), skewed


# ---------------------------------------------------------------------------
# Shuffle strategy internals (per shard body)
# ---------------------------------------------------------------------------

def _dispatch(records: torch.Tensor, owner: torch.Tensor, n_shards: int,
              capacity: int):
    """Pack ``records`` (L, W) into a (n_shards*capacity, W) send buffer by
    owner shard, plus validity mask, slot handle per record (``nslots``
    for an overflowed record) and the overflow count (0-d int32)."""
    l = records.shape[0]
    dev = records.device
    # position of each record within its owner's group
    order = torch.argsort(owner, stable=True)
    sorted_owner = owner[order].contiguous()
    pos_in_group = (torch.arange(l, device=dev)
                    - torch.searchsorted(sorted_owner, sorted_owner,
                                         side="left"))
    rank = torch.zeros((l,), dtype=torch.int32, device=dev)
    rank[order] = pos_in_group.to(torch.int32)
    ok = rank < capacity
    nslots = n_shards * capacity
    # overflowed records go to a trash slot one past the end (written by
    # every one of them, then cut off; real slots are written once)
    slot = torch.where(ok, owner * capacity + rank, nslots)
    buf = records.new_zeros((nslots + 1, records.shape[1]))
    buf[slot] = records
    valid = torch.zeros((nslots + 1,), dtype=torch.bool, device=dev)
    valid[slot] = ok
    overflow = (~ok).sum().to(torch.int32)
    return buf[:nslots], valid[:nslots], slot, ok, overflow


def _sorted_components(w_lo, w_hi, first_occ, seg_flag, s_vals,
                       delta: Optional[float],
                       use_kernels: Optional[bool]):
    """Per sorted position: (sig_lo, sig_hi, distinct) of the position's
    component — the whole key segment (prime) or the δ-window inside it —
    as boundary differences of the fused masked prefix sums (the same
    reduction the single-device pipeline runs)."""
    pref_lo, pref_hi, pref_cnt = PL.masked_prefix(w_lo, w_hi, first_occ,
                                                  use_kernels)
    a, b = PL.segment_bounds(seg_flag)
    if delta is not None:
        d = PL._f32(delta, s_vals.device)
        a, b = (PL.bsearch(s_vals, a, b, s_vals - d, leq=False),
                PL.bsearch(s_vals, a, b, s_vals + d, leq=True))
    return (pref_lo[b] - pref_lo[a], pref_hi[b] - pref_hi[a],
            pref_cnt[b] - pref_cnt[a])


def _unsort(perm: torch.Tensor, *cols):
    """``cols`` (in ``perm``'s sorted order) back in original order."""
    l = perm.shape[0]
    inv = torch.zeros((l,), dtype=torch.int32, device=perm.device)
    inv[perm] = torch.arange(l, dtype=torch.int32, device=perm.device)
    return tuple(c[inv] for c in cols)


def _owner_stage(recv: torch.Tensor, rvalid: torch.Tensor, n_other: int,
                 r_lo: torch.Tensor, r_hi: torch.Tensor,
                 delta: Optional[float],
                 use_kernels: Optional[bool] = None):
    """Owner-side Reduce-1 (column-record fallback): segment received
    ⟨key, e[, value]⟩ records and run the variant's component operator,
    producing per-record (set-signature, distinct cardinality,
    tuple-first flag)."""
    big = torch.iinfo(torch.int32).max
    key_cols = [torch.where(rvalid, recv[:, j], big) for j in range(n_other)]
    e_col = torch.where(rvalid, recv[:, n_other], big)
    if delta is not None:
        vals = recv[:, n_other + 1].contiguous().view(torch.float32)
        vals = torch.where(rvalid, vals, PL._f32(np.inf, vals.device))
        perm = PL.lex_perm(key_cols + [vals, e_col])
    else:
        vals = None
        perm = PL.lex_perm(key_cols + [e_col])
    s_keys = [c[perm] for c in key_cols]
    s_e = e_col[perm]
    s_valid = rvalid[perm]
    seg_flag = PL.segment_starts(s_keys)
    s_vals = vals[perm] if vals is not None else None
    first_occ = PL.segment_starts(
        s_keys + ([s_vals] if s_vals is not None else []) + [s_e]) & s_valid
    e_safe = torch.where(s_valid, s_e, 0)
    sig_lo, sig_hi, distinct = _sorted_components(
        r_lo[e_safe], r_hi[e_safe], first_occ, seg_flag, s_vals, delta,
        use_kernels)
    return _unsort(perm, sig_lo, sig_hi, distinct, first_occ)


def _validity_words(words, inval: torch.Tensor, total_bits: int):
    """The key words with the validity flag folded in as one extra MSB
    (live bit ``total_bits``), so the owner sort runs as a single
    (total_bits+1)-bit radix instead of a variadic comparison sort.
    ``inval`` is int32 0/1; at ``total_bits`` 31 and 63 the flag is the
    sign bit of its int32 word."""
    if total_bits + 1 <= 32:
        return (words[-1] | (inval << total_bits),)
    hi = words[0] if len(words) == 2 else torch.zeros_like(words[-1])
    return (hi | (inval << (total_bits - 32)), words[-1])


def _owner_stage_packed(recv: torch.Tensor, rvalid: torch.Tensor,
                        plan: K.ModeKeyPlan, r_lo: torch.Tensor,
                        r_hi: torch.Tensor, delta: Optional[float],
                        use_kernels: Optional[bool] = None,
                        sort_backend: str = "radix",
                        value_domain: Optional[torch.Tensor] = None):
    """Owner-side Reduce-1 over *pre-packed* key words: one stable sort
    keyed on (validity, key words); entity ids and value columns are
    bit-field extractions from the shipped key, so owners never re-pack.
    The radix backend folds the validity flag into the key as one extra
    MSB; exactly-64-bit keys (no room for the flag) and the 'lax' backend
    take a stable two-column sort (validity, then the words' int64 order
    key), which orders as the JAX package's ``lax.sort`` does."""
    words = tuple(recv[:, i].contiguous() for i in range(recv.shape[1]))
    inval = (~rvalid).to(torch.int32)   # invalid slots sort last
    if sort_backend == "radix" and plan.total_bits + 1 <= 64:
        ext = _validity_words(words, inval, plan.total_bits)
        perm = RX.radix_sort_perm(ext, plan.total_bits + 1, use_kernels)
    else:
        perm = PL.lex_perm([inval, word_key(words)])
    s_inval = inval[perm]
    s_words = tuple(w[perm] for w in words)
    s_valid = rvalid[perm]
    seg_flag = PL.segment_starts(
        [s_inval] + list(K.drop_low_bits(s_words, plan.seg_shift)))
    first_occ = PL.segment_starts([s_inval] + list(s_words)) & s_valid
    e_safe = torch.where(s_valid, plan.extract_entity(s_words), 0)
    s_vals = (plan.extract_values(s_words, domain=value_domain)
              if delta is not None else None)
    sig_lo, sig_hi, distinct = _sorted_components(
        r_lo[e_safe], r_hi[e_safe], first_occ, seg_flag, s_vals, delta,
        use_kernels)
    return _unsort(perm, sig_lo, sig_hi, distinct, first_occ)


def _shuffle_mode(tuples, values, k, comm: Collectives, n_shards, capacity,
                  r_lo, r_hi, delta, plan: Optional[K.ModeKeyPlan] = None,
                  use_kernels: Optional[bool] = None,
                  sort_backend: str = "radix", value_domain=None):
    """Stages 1+2 of the M/R algorithm for one mode.  Returns per record
    of this shard (sig_lo, sig_hi, card, tuple-first, ok, overflow,
    hash fallback taken).

    With a fitting ``plan``, records on the wire are the packed key
    words and owners are key *ranges* balanced by the radix top-digit
    histogram; otherwise the original column records, hash-partitioned."""
    n = tuples.shape[1]
    others = [tuples[:, j] for j in range(n) if j != k]
    hash_owner = _hash_owner(_hash_columns(others, 0xA11CE + k), n_shards)
    fallback = torch.ones((), dtype=torch.bool, device=tuples.device)
    if plan is not None and plan.fits:
        words = plan.pack_device(tuples, values, domain=value_domain)
        owner = hash_owner
        if sort_backend == "radix":
            owner, fallback = _range_partition(words, plan, comm, n_shards,
                                               capacity, hash_owner)
        records = torch.stack(words, dim=1)
    else:
        plan = None
        owner = hash_owner
        cols = others + [tuples[:, k]]
        if delta is not None:
            cols = cols + [values.contiguous().view(torch.int32)]
        records = torch.stack(cols, dim=1)
    buf, valid, slot, ok, overflow = _dispatch(records, owner, n_shards,
                                               capacity)
    recv = comm.all_to_all(buf)
    rvalid = comm.all_to_all(valid.to(torch.int32)).to(torch.bool)
    if plan is not None:
        sig_lo, sig_hi, card, tfirst = _owner_stage_packed(
            recv, rvalid, plan, r_lo, r_hi, delta, use_kernels,
            sort_backend, value_domain)
    else:
        sig_lo, sig_hi, card, tfirst = _owner_stage(
            recv, rvalid, n - 1, r_lo, r_hi, delta, use_kernels)
    resp = torch.stack([sig_lo, sig_hi, card.to(torch.int32),
                        tfirst.to(torch.int32)], dim=1)
    resp = comm.all_to_all(resp)
    # an overflowed record's slot is one past the end: clamp it as the
    # JAX package's gather does (its row is discarded, ``ok`` is False)
    got = resp[torch.clamp(slot, max=n_shards * capacity - 1)]
    return (got[:, 0], got[:, 1], got[:, 2], got[:, 3].to(torch.bool), ok,
            overflow, fallback)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class DistributedMiner:
    """Multi-rank clustering over a mesh — prime *and* NOAC variants.

    Args:
      sizes: mode cardinalities.
      mesh: ``launch.mesh.Mesh`` containing ``axes``.
      axes: data-parallel mesh axis name(s) the tuple table is
        block-partitioned over; ranks that differ only on the mesh
        axes they leave out mine the same block (replicated compute), as
        in the JAX package.
      theta: minimal density threshold (paper Alg. 7 θ; prime variant).
      strategy: 'replicate' | 'shuffle'.
      capacity_factor: shuffle per-destination buffer slack (≥1).
      delta: many-valued δ — switches the engine to the NOAC variant.
      rho_min: NOAC minimal density (plays θ's role).
      minsup: NOAC minimal per-mode cardinality.
      packed: packed-key sort path (None: auto when the key fits 64 bits;
        False: column lexsort baseline).
      sort_backend: packed word-sort algorithm ('radix' default | 'lax';
        'lexsort' forces the column path).
      use_kernels: the CUDA kernels (None: when the tensors lie on CUDA).
      device: this rank's device (default: the mesh's).
    """

    def __init__(self, sizes: Sequence[int], mesh, axes="data",
                 theta: float = 0.0, strategy: str = "replicate",
                 capacity_factor: float = 2.0, seed: int = 0x5EED,
                 max_retries: int = 4, delta: Optional[float] = None,
                 rho_min: float = 0.0, minsup: int = 0,
                 packed: Optional[bool] = None,
                 sort_backend: Optional[str] = None,
                 use_kernels: Optional[bool] = None,
                 prune_values: bool = True,
                 window_budget: Optional[int] = None,
                 device=None):
        self.device = resolve_device(mesh.device if device is None
                                     else device)
        self.sizes = tuple(int(s) for s in sizes)
        self.prune_values = bool(prune_values)
        #: shared streaming unit: windows the incremental serving
        #: snapshot's device pipeline and rounds the shuffle's per-link
        #: dispatch capacity up to whole windows
        self.window_budget = (None if window_budget is None
                              else int(window_budget))
        self.mesh = mesh
        self.comm = Collectives(mesh, axes)
        self.delta = None if delta is None else float(delta)
        if self.delta is not None and self.delta < 0:
            raise ValueError(f"delta must be >= 0, got {self.delta}")
        self.theta = float(rho_min) if self.delta is not None else float(theta)
        self.minsup = int(minsup)
        if strategy not in ("replicate", "shuffle"):
            raise ValueError(strategy)
        self.strategy = strategy
        self.capacity_factor = float(capacity_factor)
        self.max_retries = int(max_retries)
        self.n_shards = self.comm.size
        self.packed = packed
        self.sort_backend = sort_backend
        self.key_plans = K.plan_context_keys(self.sizes,
                                             with_values=delta is not None)
        self.resolved_sort_backend = RX.resolve_sort_backend(
            sort_backend, packed, self.key_plans[0].fits)
        self.packed_active = self.resolved_sort_backend != "lexsort"
        self.use_kernels = use_kernels
        self._lo, self._hi = PL.hash_vectors_from_numpy(
            PL.mode_hash_vectors(self.sizes, seed), self.device)
        #: per mode of the last shuffle run: 0-d bool, True where the
        #: owners came from the hash partition (the range partition's
        #: skew fallback, or no range partition on this path)
        self.hash_fallback: list = []
        # incremental snapshot state (per-shard run stores)
        self._stores = None
        #: None = auto (runs maintained whenever the key fits); False =
        #: log-only stores, every snapshot re-sorts on the device
        self.stream_incremental: Optional[bool] = None
        self.stream_stats = {"snapshots": 0, "full_resorts": 0,
                             "merged_rows": 0, "chunk_sorted_rows": 0,
                             "tombstoned_rows": 0,
                             "incremental": self.key_plans[0].fits}
        # snapshot versioning: mutating stream calls bump
        # ``stream_version``; snapshots record the version covered
        self.stream_version = 0
        self.snapshot_stream_version = 0
        # per-snapshot dirty-signature tracking (the serving plane's delta
        # index); off by default — it syncs the signature lanes to host
        self.track_dirty_sigs = False
        self.last_kept_sigs: Optional[np.ndarray] = None
        self.last_dirty_sigs = 0

    # -- shard bodies -------------------------------------------------------

    def _slice_block(self, res: PL.PipelineResult, tl: int
                     ) -> DistributedResult:
        """This shard's block of a full-table ``PipelineResult`` as the
        ``DistributedResult`` both replicate bodies return."""
        sl = slice(self.comm.index() * tl, (self.comm.index() + 1) * tl)
        return DistributedResult(
            sig_lo=res.sig_lo[sl], sig_hi=res.sig_hi[sl],
            is_unique=res.is_unique[sl], gen_count=res.gen_count[sl],
            volume=res.volume[sl], density=res.density[sl],
            keep=res.keep[sl], cardinalities=res.cardinalities[:, sl],
            n_clusters=res.is_unique.sum().to(torch.int32),
            overflow=torch.zeros((), dtype=torch.int32, device=self.device),
            comm=self.comm)

    def _body_replicate(self, tuples, values, vdom, perms=None):
        """All-gather the blocks and mine the full table on every shard;
        ``perms`` (the incremental snapshot path) are precomputed global
        per-mode permutations, so Stage 1's sorts are skipped."""
        full = self.comm.all_gather(tuples)
        vfull = (self.comm.all_gather(values) if self.delta is not None
                 else None)
        res = PL.mine_tuples(full, self._lo, self._hi, values=vfull,
                             delta=self.delta, theta=self.theta,
                             minsup=self.minsup, perms=perms,
                             packed=self.packed,
                             sort_backend=self.sort_backend,
                             use_kernels=self.use_kernels,
                             value_domain=vdom)
        return self._slice_block(res, tuples.shape[0])

    def _body_shuffle(self, tuples, values, vdom):
        nsh = self.n_shards
        tl, n = tuples.shape
        capacity = max(1, int(np.ceil(tl / nsh * self.capacity_factor)))
        if self.window_budget:
            # per-link batches ship in whole windows of the shared plan
            # (capacity only sizes the dispatch buffers / overflow check,
            # so rounding up never changes a mined bit)
            wb = int(self.window_budget)
            capacity = -(-capacity // wb) * wb
        # plans with the value domain's slot count (None: the 32-bit
        # float lane)
        plans = K.plan_context_keys(
            self.sizes, with_values=self.delta is not None,
            value_slots=None if vdom is None else vdom.shape[0])
        # resolve from the PRUNED plans: a key that only fits thanks to
        # the rank-coded lane still takes the packed path
        backend = RX.resolve_sort_backend(self.sort_backend, self.packed,
                                          plans[0].fits)
        per_lo, per_hi, cards, self.hash_fallback = [], [], [], []
        overflow = torch.zeros((), dtype=torch.int32, device=self.device)
        tuple_first = None
        for k in range(n):
            slo, shi, card, tfirst, _, ovf, fallback = _shuffle_mode(
                tuples, values, k, self.comm, nsh, capacity, self._lo[k],
                self._hi[k], self.delta,
                plan=plans[k] if backend != "lexsort" else None,
                use_kernels=self.use_kernels, sort_backend=backend,
                value_domain=vdom)
            per_lo.append(slo)
            per_hi.append(shi)
            cards.append(card)
            overflow = overflow + ovf
            self.hash_fallback.append(fallback)
            if k == 0:
                tuple_first = tfirst
        sig_lo, sig_hi = PL.mix_signatures(per_lo, per_hi)
        volume = torch.ones((tl,), dtype=torch.float32, device=self.device)
        for c in cards:
            volume = volume * c.to(torch.float32)
        # Stage 3 on gathered signatures (12 bytes/tuple on the wire)
        g_lo = self.comm.all_gather(sig_lo)
        g_hi = self.comm.all_gather(sig_hi)
        g_tf = self.comm.all_gather(tuple_first)
        s3_backend = RX.resolve_sort_backend(self.sort_backend, self.packed,
                                             True)
        gen_of, is_unique = PL.stage3_dedup(g_lo, g_hi, g_tf,
                                            packed=s3_backend != "lexsort",
                                            sort_backend=s3_backend,
                                            use_kernels=self.use_kernels)
        sl = slice(self.comm.index() * tl, (self.comm.index() + 1) * tl)
        gen_l, uniq_l = gen_of[sl], is_unique[sl]
        density = gen_l.to(torch.float32) / torch.clamp(volume, min=1.0)
        keep = uniq_l & (density >= PL._f32(self.theta, self.device))
        if self.minsup:
            for c in cards:
                keep = keep & (c >= self.minsup)
        return DistributedResult(
            sig_lo=sig_lo, sig_hi=sig_hi, is_unique=uniq_l, gen_count=gen_l,
            volume=volume, density=density, keep=keep,
            cardinalities=torch.stack(cards),
            n_clusters=is_unique.sum().to(torch.int32),
            overflow=self.comm.psum(overflow), comm=self.comm)

    # -- public -------------------------------------------------------------

    def _coerce(self, tuples, values):
        """The global table as (T, N) int32 and (T,) float32 arrays (zeros
        for an unvalued table), host numpy or tensors as given."""
        if not isinstance(tuples, torch.Tensor):
            tuples = np.asarray(tuples, np.int32)
        if values is None:
            values = np.zeros((tuples.shape[0],), np.float32)
        elif not isinstance(values, torch.Tensor):
            values = np.asarray(values, np.float32)
        return tuples, values

    def _block(self, tuples, values):
        """This shard's block of the global table, on its device."""
        tl = tuples.shape[0] // self.n_shards
        sl = slice(self.comm.index() * tl, (self.comm.index() + 1) * tl)
        return (PL._as_tensor(tuples[sl], torch.int32, self.device),
                PL._as_tensor(values[sl], torch.float32, self.device))

    def _value_domain(self, values) -> Optional[torch.Tensor]:
        """Sorted distinct values for key-lane pruning, on every shard
        (None = pruning off: prime variant, lexsort path, or
        ``prune_values=False``)."""
        if self.delta is None or not RX.wants_value_pruning(
                self.prune_values, self.packed, self.sort_backend):
            return None
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        return torch.from_numpy(K.value_domain_host(values)).to(self.device)

    def lowered(self, tuples, values=None):
        """The JAX package lowers its shard body for the XLA dry-run; the
        port's dry-run is ROADMAP A13g."""
        raise NotImplementedError(
            "DistributedMiner.lowered (the dry-run) is not ported; see "
            "ROADMAP.md queue A, item A13g")

    def _run(self, block, vblock, vdom) -> DistributedResult:
        if self.strategy == "replicate":
            return self._body_replicate(block, vblock, vdom)
        return self._body_shuffle(block, vblock, vdom)

    def __call__(self, tuples, values=None) -> DistributedResult:
        """Run the pipeline on the global table (every rank passes the
        same one).  On shuffle-capacity overflow (the M/R skew failure
        mode the paper's §1 warns about) the capacity factor is doubled
        and the job re-executed — the analogue of Hadoop re-running a
        failed reducer with more memory.  The overflow count is all-
        reduced, so every rank retries together."""
        tuples, values = self._coerce(tuples, values)
        t = tuples.shape[0]
        if t % self.n_shards:
            raise ValueError(
                f"tuple count {t} not divisible by shard count "
                f"{self.n_shards}; pad with duplicated rows (idempotent)")
        vdom = self._value_domain(values)
        block, vblock = self._block(tuples, values)
        res = self._run(block, vblock, vdom)
        for _ in range(self.max_retries):
            if self.strategy != "shuffle" or int(res.overflow) == 0:
                break
            self.capacity_factor *= 2.0
            res = self._run(block, vblock, vdom)
        if self.strategy == "shuffle" and int(res.overflow):
            # overflowed records were dropped by _dispatch — returning
            # would hand back silently-wrong clusters
            raise RuntimeError(
                f"shuffle capacity overflow persists after "
                f"{self.max_retries} retries (capacity_factor="
                f"{self.capacity_factor}); the partition is too skewed "
                f"for n_shards={self.n_shards}")
        return res

    # -- incremental snapshots (per-shard run stores) -----------------------
    #
    # Every rank holds the same ``n_shards`` host stores, fed by the same
    # ``ingest`` calls (the JAX package's one controller holds them all),
    # so the ranks' snapshots agree.

    def reset_stream(self) -> None:
        """Drop all ingested stream state (per-shard stores)."""
        self._stores = None
        for k in ("snapshots", "full_resorts", "merged_rows",
                  "chunk_sorted_rows", "tombstoned_rows"):
            self.stream_stats[k] = 0

    def _ensure_stores(self):
        if self._stores is None:
            inc = self.key_plans[0].fits and self.stream_incremental \
                is not False
            radix = self.resolved_sort_backend == "radix"
            n = self.n_shards if inc else 1
            self._stores = [RS.RunStore(self.key_plans, radix=radix,
                                        incremental=inc,
                                        stats=self.stream_stats)
                            for _ in range(n)]
        return self._stores

    def _route(self, rows: np.ndarray) -> np.ndarray:
        stores = self._ensure_stores()
        if len(stores) == 1:
            return np.zeros(rows.shape[0], np.int64)
        return RS.shard_of_rows(rows, stores[0]._identity_plan(),
                                len(stores))

    def _scatter(self, op: str, rows, values=None) -> None:
        """Route rows to their owner shard's store by the fixed
        radix-range partition of the entity-only identity key — the
        host-side analogue of the shuffle's range partitioner — and
        apply ``op`` per shard."""
        rows = np.atleast_2d(np.asarray(rows, np.int32))
        if rows.shape[0] == 0:
            return
        vals = None
        if self.delta is not None and op != "delete":
            vals = (np.zeros(rows.shape[0], np.float32) if values is None
                    else np.asarray(values, np.float32))
        stores = self._ensure_stores()
        owner = self._route(rows)
        for s, store in enumerate(stores):
            sel = np.nonzero(owner == s)[0]
            if sel.size == 0:
                continue
            if op == "delete":
                store.delete(rows[sel])
            else:
                getattr(store, op)(rows[sel],
                                   None if vals is None else vals[sel])
        self.stream_version += 1

    def ingest(self, rows, values=None) -> None:
        """Stream a chunk into the per-shard run stores (valued streams
        upsert — last write wins, like the batch constructor)."""
        self._scatter("add", rows, values)

    def upsert(self, rows, values=None) -> None:
        self._scatter("upsert", rows, values)

    def delete(self, rows) -> None:
        self._scatter("delete", rows)

    @property
    def stream_count(self) -> int:
        """Live (non-tombstoned) rows across all shard stores."""
        if not self._stores:
            return 0
        return sum(s.count - s.dead for s in self._stores)

    def _gathered(self, with_run: bool):
        """Concatenated survivor tables + (incremental path) the
        globally merged run: shard runs offset into the concatenated
        table and merged linearly — mode 0 concatenates outright, its
        shard key ranges are disjoint by the range routing."""
        stores = [s for s in self._stores if s.count]
        rows = np.concatenate([s.table()[0] for s in stores])
        vals = (np.concatenate([s.table()[1] for s in stores])
                if self.delta is not None else None)
        run, off = None, 0
        if with_run:
            for s in stores:
                r = RS.offset_run(s.runs[0], off)
                if run is None:
                    run = r
                else:
                    run = RS.merge_runs(run, r)
                    self.stream_stats["merged_rows"] += run.size
                off += s.count
        return rows, vals, run

    def snapshot(self, full_remine: bool = False) -> DistributedResult:
        """Mine the current stream exactly.  The incremental path folds
        each shard's runs (linear merges of only what changed), merges
        the per-shard runs into global permutations, and runs the
        replicate body with Stage 1's sorts skipped; ``full_remine=True``
        (or a non-fitting key) is the re-sort-every-shard baseline —
        the padded table through the one-shot ``__call__`` path."""
        if self._stores is None:
            raise ValueError("no data ingested")
        self.snapshot_stream_version = self.stream_version
        incremental = (not full_remine
                       and all(s.incremental for s in self._stores))
        if incremental and self.strategy == "shuffle":
            # the merged-perms body replicates the full table per shard
            # (all_gather) — running it would silently break the memory
            # bound the shuffle strategy was chosen for
            raise ValueError(
                "incremental snapshots run the replicate-with-perms "
                "body; strategy='shuffle' mining is one-shot only — "
                "use snapshot(full_remine=True) or strategy='replicate'")
        self.stream_stats["snapshots"] += 1
        for s in self._stores:
            s.prepare() if incremental else s.compact()
        if self.stream_count == 0:
            raise ValueError("no live rows (everything deleted)")
        rows, vals, run = self._gathered(with_run=incremental)
        count = rows.shape[0]
        cap = RS.snapshot_cap(count, self.n_shards)
        rows, vals = RS.padded_table(rows, vals, cap)
        if not incremental or run is None:
            self.stream_stats["full_resorts"] += 1
            return self(rows, vals)
        perms = RS.padded_perms(run, self.key_plans, rows[:1],
                                None if vals is None else vals[:1],
                                count, cap)
        block, vblock = self._block(*self._coerce(rows, vals))
        return self._body_replicate(
            block, vblock, None,
            perms=PL._as_tensor(perms, torch.int32, self.device))

    def serving_snapshot(self,
                         full_remine: bool = False) -> PL.PipelineResult:
        """Serving twin of :meth:`snapshot`: a *full-table*
        ``PipelineResult`` — component windows included, which
        ``DistributedResult`` deliberately drops — so the serving plane
        can index a distributed stream.  Runs the single-device pipeline
        on the gathered survivor table (on every rank); on the
        incremental path the per-shard runs are folded and merged into
        global permutations exactly as :meth:`snapshot` does, so Stage 1
        never re-sorts here either, and with ``window_budget`` the merged
        permutations feed the windowed device pipeline
        (``core.windowed``, host leaves).  Signatures are bit-identical
        to :meth:`snapshot` / the batch miner (same hash vectors)."""
        if self._stores is None:
            raise ValueError("no data ingested")
        self.snapshot_stream_version = self.stream_version
        incremental = (not full_remine
                       and all(s.incremental for s in self._stores))
        self.stream_stats["snapshots"] += 1
        for s in self._stores:
            s.prepare() if incremental else s.compact()
        if self.stream_count == 0:
            raise ValueError("no live rows (everything deleted)")
        rows, vals, run = self._gathered(with_run=incremental)
        count = rows.shape[0]
        cap = RS.snapshot_cap(count)
        rows, vals = RS.padded_table(rows, vals, cap)
        targs = PL._as_tensor(rows, torch.int32, self.device)
        vargs = (None if vals is None
                 else PL._as_tensor(vals, torch.float32, self.device))
        kw = dict(delta=self.delta, theta=self.theta, minsup=self.minsup,
                  packed=self.packed, sort_backend=self.sort_backend,
                  use_kernels=self.use_kernels)
        if not incremental or run is None:
            self.stream_stats["full_resorts"] += 1
            # the same value-lane pruning the one-shot __call__ applies
            # (the perms paths below stay domain-free like snapshot()'s —
            # the stores' merged runs carry the unpruned float lane)
            vdom = self._value_domain(vals) if vals is not None else None
            res = PL.mine_tuples(targs, self._lo, self._hi, values=vargs,
                                 value_domain=vdom, **kw)
        else:
            perms = RS.padded_perms(run, self.key_plans, rows[:1],
                                    None if vals is None else vals[:1],
                                    count, cap)
            if self.window_budget and self.packed_active:
                # windowed serving remine: the merged global perms feed
                # the bounded device window loop — bit-identical to the
                # monolithic perms call below
                from . import windowed as WD
                res = WD.mine_windowed(
                    rows, vals, perms, plans=self.key_plans,
                    hash_lo=self._lo, hash_hi=self._hi, delta=self.delta,
                    theta=self.theta, minsup=self.minsup,
                    window_budget=self.window_budget,
                    sort_backend=self.resolved_sort_backend,
                    use_kernels=self.use_kernels, device=self.device)
            else:
                res = PL.mine_tuples(
                    targs, self._lo, self._hi, values=vargs,
                    perms=PL._as_tensor(perms, torch.int32, self.device),
                    **kw)
        if self.track_dirty_sigs:
            sigs = PL.kept_sig_words(res)
            self.last_dirty_sigs = PL.dirty_sig_count(
                self.last_kept_sigs, sigs)
            self.last_kept_sigs = sigs
        return res


def pad_tuples(tuples: np.ndarray, multiple: int) -> np.ndarray:
    """Pad the tuple table to a multiple by repeating the first row — the
    mining algebra is duplicate-idempotent (paper §5.1 / K3 argument)."""
    t = tuples.shape[0]
    pad = (-t) % multiple
    if pad == 0:
        return tuples
    return np.concatenate([tuples, np.repeat(tuples[:1], pad, 0)], 0)


def pad_values(values: np.ndarray, multiple: int) -> np.ndarray:
    """Value-column companion of ``pad_tuples`` (pads with the first value,
    keeping V a function of the tuple)."""
    t = values.shape[0]
    pad = (-t) % multiple
    if pad == 0:
        return values
    return np.concatenate([values, np.repeat(values[:1], pad, 0)], 0)
