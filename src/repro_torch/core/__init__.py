"""Core: the paper's batch prime OAC and NOAC engines on one device and
over the ranks of a process group (``core.distributed``), composed from
the shared Stage-1/2/3 pipeline (``core.pipeline``), the pure-python
reference oracle, the streaming engine over the sorted-run
store (``core.runs``, ``core.streaming``; out-of-core chunked and
windowed mining through ``core.windowed``), and the dense validation
backend (exact density), selected through the engine registry:
``mine(ctx, backend="batch"|"distributed"|"streaming"|"reference",
variant="prime"|"noac")``."""
from .batch import dense_tensor, exact_density_dense, fibers
from .multimodal import (BatchMiner, DistributedMiner, NOACMiner,
                         StreamingMiner, MiningResult, DistributedResult,
                         NOACResult, pad_tuples, pad_values,
                         PipelineResult, PolyadicContext, tricontext,
                         from_named_triples, make_miner, mine, MineRun,
                         available_engines, resolve_engine)
from .engines import register_engine

__all__ = [
    "BatchMiner", "DistributedMiner", "NOACMiner", "StreamingMiner",
    "MiningResult", "DistributedResult", "NOACResult", "pad_tuples",
    "pad_values",
    "PipelineResult", "PolyadicContext", "tricontext", "from_named_triples",
    "make_miner", "mine", "MineRun", "register_engine", "available_engines",
    "resolve_engine", "dense_tensor", "fibers", "exact_density_dense",
]
