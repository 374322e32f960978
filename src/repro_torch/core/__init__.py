"""Core: the paper's batch prime OAC and NOAC engines on one device,
composed from the shared Stage-1/2/3 pipeline (``core.pipeline``) and
selected through the engine registry:
``mine(ctx, backend="batch", variant="prime"|"noac")``."""
from .batch import BatchMiner, MiningResult
from .context import PolyadicContext, from_named_triples, tricontext
from .engines import (MineRun, available_engines, mine, register_engine,
                      resolve_engine)
from .manyvalued import NOACMiner, NOACResult
from .pipeline import PipelineResult

__all__ = [
    "BatchMiner", "NOACMiner", "MiningResult", "NOACResult",
    "PipelineResult", "PolyadicContext", "tricontext", "from_named_triples",
    "mine", "MineRun", "register_engine", "available_engines",
    "resolve_engine",
]
