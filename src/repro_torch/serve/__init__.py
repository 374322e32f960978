"""Serving of the port: the online cluster-serving subsystem over mined
results — the snapshot-swapped :class:`TriclusterService`
(``serve.service``), ranked and batched lookups (``serve.ranking``), the
cluster-query index with delta maintenance (``serve.clusters``), the
stdlib HTTP endpoint and client (``serve.protocol``), zero-copy
shared-memory snapshot replicas (``serve.shm``), the sharded query
router (``serve.router``), the fault-tolerance layer — deterministic
fault injection (``serve.faults``) and process supervision
(``serve.supervise``) — plus the LM-side batched prefill + decode engine
(``serve.engine``).  Ports of the same modules of ``repro.serve``.

``serve.engine`` pulls in the LM models, so it is imported lazily:
replica readers and routers import ``repro_torch.serve`` without them.
"""
from .clusters import (ClusterIndex, ClusterView, cluster_query,
                       pack_sig_words)
from .faults import (KILL_EXIT_CODE, DropRequest, Fault, FaultInjector,
                     FaultPlan)
from .protocol import (ClusterClient, ClusterServeServer, health_doc,
                       make_server)
from .ranking import (BatchQuerier, RankingPolicy, cluster_scores,
                      pack_signatures, rank_views, top_clusters,
                      top_from_scores)
from .router import (CircuitBreaker, GatewayTimeout, PooledClient,
                     RouterServer, RouterService, Shard,
                     make_router_server)
from .service import (QueryResult, Snapshot, TriclusterService,
                      snapshot_query, snapshot_query_batch)
from .shm import (ReplicaService, ShmPublisher, ShmReplica,
                  SnapshotBundle, WriterDeadError)
from .supervise import Supervisor, write_restart_flag

__all__ = [
    # cluster-query surface
    "ClusterIndex", "ClusterView", "cluster_query", "pack_sig_words",
    # ranking layer
    "BatchQuerier", "RankingPolicy", "cluster_scores", "pack_signatures",
    "rank_views", "top_clusters", "top_from_scores",
    # snapshot-swapped service + protocol
    "TriclusterService", "Snapshot", "QueryResult",
    "snapshot_query", "snapshot_query_batch",
    "ClusterClient", "ClusterServeServer", "make_server", "health_doc",
    # zero-copy shared-memory replicas
    "ShmPublisher", "ShmReplica", "ReplicaService", "SnapshotBundle",
    "WriterDeadError",
    # sharded query router
    "RouterService", "RouterServer", "Shard", "PooledClient",
    "make_router_server", "CircuitBreaker", "GatewayTimeout",
    # fault tolerance: injection + supervision
    "FaultPlan", "FaultInjector", "Fault", "DropRequest",
    "KILL_EXIT_CODE", "Supervisor", "write_restart_flag",
    # LM serving engine (lazy: the models)
    "ServeEngine", "GenerationResult",
]

_LAZY = {"ServeEngine": "engine", "GenerationResult": "engine"}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    from importlib import import_module
    return getattr(import_module(f".{mod}", __name__), name)
