"""Engine registry: one front-end for every (backend, variant) pair.
Port of ``repro.core.engines`` for the engines the port has.

``repro_torch.core.mine(ctx, backend=..., variant=...)`` is the single
entry point.  Engines register themselves under a ``(backend, variant)``
key; unknown combinations fail with an error that lists every valid
choice.  The port registers ``batch`` (one device), ``distributed``
(the ranks of a ``torch.distributed`` process group, ``core.distributed``),
``streaming`` (incremental sorted-run ingestion, ``core.streaming``) and
``reference`` (the pure-python oracle of ``core.reference``), each in the
``prime`` and ``noac`` variants.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np

from .batch import BatchMiner
from .context import PolyadicContext
from .distributed import DistributedMiner, pad_tuples, pad_values
from .manyvalued import NOACMiner
from .streaming import StreamingMiner

_REGISTRY: dict[tuple[str, str], Callable] = {}


def register_engine(backend: str, variant: str):
    """Class decorator-style registration of an engine runner."""
    def deco(fn):
        _REGISTRY[(backend, variant)] = fn
        return fn
    return deco


def available_engines() -> list[tuple[str, str]]:
    """Sorted (backend, variant) pairs with a registered engine."""
    return sorted(_REGISTRY)


def resolve_engine(backend: str, variant: str) -> Callable:
    try:
        return _REGISTRY[(backend, variant)]
    except KeyError:
        valid = ", ".join(f"{b}/{v}" for b, v in available_engines())
        raise ValueError(
            f"no engine for backend={backend!r} variant={variant!r}; "
            f"valid combinations: {valid}") from None


@dataclasses.dataclass
class MineRun:
    """Outcome of one ``mine()`` call."""
    backend: str
    variant: str
    n_clusters: int              # kept clusters
    elapsed_s: float             # wall time of the first mining execution
                                 # (excludes miner construction and
                                 # materialisation)
    clusters: Optional[list]     # [(components, density), ...] or None
    result: Any                  # backend-native result object (or None)
    miner: Any                   # the engine instance (None for reference)
    rerun: Any = None            # zero-arg warm re-execution of the mining
                                 # step; returns the result and records
                                 # its time in ``rerun.last_s``

    @property
    def tuples_per_s(self) -> float:
        return 0.0 if not self.elapsed_s else self._n_tuples / self.elapsed_s

    _n_tuples: int = 0


def mine(ctx: PolyadicContext, backend: str = "batch",
         variant: str = "prime", **params) -> MineRun:
    """Mine ``ctx`` with the selected backend/variant.

    Common params: ``theta`` (prime min density), ``delta``/``rho_min``/
    ``minsup`` (noac), ``seed``, ``packed`` (packed-key sort path; None =
    auto, False = lexsort baseline), ``sort_backend`` ('radix' | 'lax' |
    'lexsort'), ``use_kernels`` (the CUDA kernels; None = when on CUDA),
    ``prune_values`` and ``device`` (default CUDA; ``"cpu"`` runs the
    plain versions on the CPU).  Backend-specific: ``mesh``/``axes``/
    ``strategy``/``capacity_factor`` (distributed; the default mesh is
    ``launch.mesh.make_local_mesh``: the default process group's ranks,
    or one rank), ``chunks``/``incremental`` (streaming; distributed:
    chunked ingestion into per-shard run stores, then one incremental
    snapshot), ``chunk_budget`` (batch: out-of-core
    chunked Stage 1 via ``mine_chunked`` — host-sorted runs, the device
    never sorts in Stage 1), ``window_budget`` (the windowed device
    pipeline: on the batch backend via ``mine_windowed``, on streaming
    it windows the incremental snapshot).  ``variant='noac'`` requires
    ``delta``.
    """
    if variant == "noac" and params.get("delta") is None:
        raise ValueError("variant='noac' requires delta=<float>")
    engine = resolve_engine(backend, variant)
    t0 = time.perf_counter()
    n_clusters, clusters, result, miner, rerun = engine(ctx, params)
    total = time.perf_counter() - t0
    elapsed = getattr(rerun, "last_s", None) or total
    return MineRun(backend=backend, variant=variant, n_clusters=n_clusters,
                   elapsed_s=elapsed, clusters=clusters, result=result,
                   miner=miner, rerun=rerun, _n_tuples=ctx.num_tuples)


def _noac_ctx(ctx: PolyadicContext) -> PolyadicContext:
    """NOAC precondition: deduplicated, with a value column (§3.2: W={0,1},
    δ=0 degenerates to prime operators when values are absent)."""
    if ctx.values is None:
        ctx = PolyadicContext(ctx.sizes, ctx.tuples,
                              np.zeros(ctx.num_tuples, np.float32), ctx.names)
    return ctx.deduplicated()


# ---------------------------------------------------------------------------
# Engine runners.  Each returns (n_clusters, clusters, result, miner, rerun)
# where ``rerun`` re-executes the mining step warm.
# ---------------------------------------------------------------------------

def _pipe_kw(p):
    """Pipeline-core params shared by the batch engines."""
    return {"packed": p.get("packed"),
            "sort_backend": p.get("sort_backend"),
            "use_kernels": p.get("use_kernels"),
            "prune_values": p.get("prune_values", True),
            "window_budget": p.get("window_budget"),
            "device": p.get("device")}


def _timed(step):
    """Wrap a mining step: each call waits for the device result (when it
    has one: a result's ``keep``) and records its wall time in
    ``go.last_s``."""
    def go():
        t0 = time.perf_counter()
        out = step()
        if hasattr(out, "keep"):
            out.keep.cpu()
        go.last_s = time.perf_counter() - t0
        return out
    go.last_s = None
    return go


def _batch_step(miner, p, tuples, values=None):
    """One-shot in-core mining; out-of-core chunked Stage 1 when
    ``chunk_budget`` is set (``PipelineMiner.mine_chunked``); the
    windowed device pipeline when ``window_budget`` is set
    (``PipelineMiner.mine_windowed`` — host run sort *and* bounded
    device windows sharing the one budget)."""
    if p.get("window_budget"):
        return lambda: miner.mine_windowed(
            tuples, values=values, window_budget=int(p["window_budget"]))
    if p.get("chunk_budget"):
        return lambda: miner.mine_chunked(
            tuples, values=values, chunk_budget=int(p["chunk_budget"]))
    if values is not None:
        return lambda: miner(tuples, values)
    return lambda: miner(tuples)


@register_engine("batch", "prime")
def _batch_prime(ctx, p):
    miner = BatchMiner(ctx.sizes, theta=p.get("theta", 0.0),
                       seed=p.get("seed", 0x5EED), **_pipe_kw(p))
    rerun = _timed(_batch_step(miner, p, ctx.tuples))
    res = rerun()
    clusters = miner.materialise(res)
    return len(clusters), clusters, res, miner, rerun


@register_engine("batch", "noac")
def _batch_noac(ctx, p):
    ctx = _noac_ctx(ctx)
    miner = NOACMiner(ctx.sizes, delta=p["delta"],
                      rho_min=p.get("rho_min", 0.0),
                      minsup=p.get("minsup", 0), seed=p.get("seed", 0x5EED),
                      **_pipe_kw(p))
    rerun = _timed(_batch_step(miner, p, ctx.tuples, ctx.values))
    res = rerun()
    clusters = miner.materialise(res)
    return len(clusters), clusters, res, miner, rerun


def _run_distributed(ctx, p, values, **variant_kw):
    if p.get("mesh") is not None:
        mesh = p["mesh"]
    else:
        from ..launch.mesh import make_local_mesh
        mesh = make_local_mesh(device=p.get("device"))
    miner = DistributedMiner(
        ctx.sizes, mesh, axes=p.get("axes", "data"),
        strategy=p.get("strategy", "replicate"),
        capacity_factor=p.get("capacity_factor", 2.0),
        seed=p.get("seed", 0x5EED), **_pipe_kw(p), **variant_kw)
    if p.get("incremental"):
        # chunked ingestion + merged per-shard-run snapshot (core.runs)
        step = -(-ctx.num_tuples // max(1, int(p.get("chunks", 8))))

        def ingest_and_snapshot():
            miner.reset_stream()
            for lo in range(0, ctx.num_tuples, step):
                hi = lo + step
                miner.ingest(ctx.tuples[lo:hi],
                             values[lo:hi] if values is not None else None)
            return miner.snapshot()

        rerun = _timed(ingest_and_snapshot)
    else:
        tuples = pad_tuples(ctx.tuples, miner.n_shards)
        values = (pad_values(values, miner.n_shards)
                  if values is not None else None)
        rerun = _timed(lambda: miner(tuples, values))
    res = rerun()
    return int(res.gather().keep.sum()), None, res, miner, rerun


@register_engine("distributed", "prime")
def _distributed_prime(ctx, p):
    return _run_distributed(ctx, p, None, theta=p.get("theta", 0.0))


@register_engine("distributed", "noac")
def _distributed_noac(ctx, p):
    ctx = _noac_ctx(ctx)
    return _run_distributed(ctx, p, ctx.values, delta=p["delta"],
                            rho_min=p.get("rho_min", 0.0),
                            minsup=p.get("minsup", 0))


def _run_streaming(ctx, p, values, **variant_kw):
    miner = StreamingMiner(ctx.sizes, seed=p.get("seed", 0x5EED),
                           incremental=p.get("incremental", True),
                           **_pipe_kw(p), **variant_kw)
    step = -(-ctx.num_tuples // max(1, int(p.get("chunks", 8))))

    def ingest_and_snapshot():
        miner.state = None
        for lo in range(0, ctx.num_tuples, step):
            hi = lo + step
            miner.add(ctx.tuples[lo:hi],
                      values[lo:hi] if values is not None else None)
        return miner.snapshot()

    rerun = _timed(ingest_and_snapshot)
    res = rerun()
    clusters = miner.materialise(res)
    return len(clusters), clusters, res, miner, rerun


@register_engine("streaming", "prime")
def _streaming_prime(ctx, p):
    return _run_streaming(ctx, p, None, theta=p.get("theta", 0.0))


@register_engine("streaming", "noac")
def _streaming_noac(ctx, p):
    ctx = _noac_ctx(ctx)
    return _run_streaming(ctx, p, ctx.values, delta=p["delta"],
                          rho_min=p.get("rho_min", 0.0),
                          minsup=p.get("minsup", 0))


@register_engine("reference", "prime")
def _reference_prime(ctx, p):
    from . import reference as R
    rerun = _timed(lambda: R.multimodal_clusters(ctx,
                                                 theta=p.get("theta", 0.0)))
    _, _, density, kept = rerun()
    clusters = [(cl, density[tuple(tuple(sorted(c)) for c in cl)])
                for cl in kept]
    return len(clusters), clusters, None, None, rerun


@register_engine("reference", "noac")
def _reference_noac(ctx, p):
    from . import reference as R
    ctx = _noac_ctx(ctx)
    rerun = _timed(lambda: R.noac(ctx, p["delta"],
                                  rho_min=p.get("rho_min", 0.0),
                                  minsup=p.get("minsup", 0)))
    kept = rerun()
    clusters = [(cl, float("nan")) for cl in kept]
    return len(clusters), clusters, None, None, rerun
