"""Public API: multimodal (N-ary) OAC clustering with selectable backend.
Port of ``repro.core.multimodal`` for the backends the port has.

Mirrors the paper's naming: the three M/R stages of §4.1 correspond to

  Stage 1 (Alg. 2+3)  -> per-mode sort/segment + set hashing
  Stage 2 (Alg. 4+5)  -> gather cumuli back to generating tuples
  Stage 3 (Alg. 6+7)  -> signature dedup + density (θ) filtering

All engines compose the shared pipeline core (``core.pipeline``); backend
and variant selection goes through the engine registry
(``core.engines.mine`` / ``make_miner``).
"""
from __future__ import annotations

from typing import Optional, Sequence

from .batch import BatchMiner, MiningResult
from .context import PolyadicContext, from_named_triples, tricontext
from .distributed import (DistributedMiner, DistributedResult, pad_tuples,
                          pad_values)
from .engines import MineRun, available_engines, mine, resolve_engine
from .manyvalued import NOACMiner, NOACResult
from .pipeline import PipelineResult
from .streaming import StreamingMiner

__all__ = [
    "BatchMiner", "DistributedMiner", "StreamingMiner", "NOACMiner",
    "MiningResult", "DistributedResult", "NOACResult", "PipelineResult",
    "PolyadicContext", "tricontext", "from_named_triples", "pad_tuples",
    "pad_values", "make_miner", "mine", "MineRun", "available_engines",
    "resolve_engine",
]


def make_miner(sizes: Sequence[int], backend: str = "batch",
               theta: float = 0.0, mesh=None, axes="data",
               strategy: str = "replicate", delta: Optional[float] = None,
               rho_min: float = 0.0, minsup: int = 0, **kw):
    """Factory selecting the backend (the paper's algorithm variants).

    Thin compatibility wrapper over the engine registry; prefer
    ``repro_torch.core.mine(ctx, backend=..., variant=...)`` for one-shot
    runs.  ``kw`` goes to the miner (``seed``, ``sort_backend``,
    ``use_kernels``, ``window_budget``, ``device``, ...; ``incremental``
    for streaming).  ``mesh`` (a ``launch.mesh.Mesh``), ``axes`` and
    ``strategy`` are the distributed backend's."""
    variant = "noac" if delta is not None else "prime"
    resolve_engine(backend, variant)  # clear error on unknown combinations
    if backend == "reference":
        raise ValueError("the reference oracle has no miner object; "
                         "use repro_torch.core.mine(ctx, "
                         "backend='reference')")
    if backend == "distributed":
        if mesh is None:
            raise ValueError("distributed backend needs a mesh")
        variant_kw = ({"delta": delta, "rho_min": rho_min, "minsup": minsup}
                      if variant == "noac" else {"theta": theta})
        return DistributedMiner(sizes, mesh, axes=axes, strategy=strategy,
                                **variant_kw, **kw)
    if variant == "noac":
        cls = StreamingMiner if backend == "streaming" else NOACMiner
        return cls(sizes, delta=delta, rho_min=rho_min, minsup=minsup, **kw)
    cls = StreamingMiner if backend == "streaming" else BatchMiner
    return cls(sizes, theta=theta, **kw)
