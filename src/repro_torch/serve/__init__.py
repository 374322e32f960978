"""Serving of the port: the in-process cluster service and its parts —
the snapshot-swapped :class:`TriclusterService` (``serve.service``),
ranked and batched lookups (``serve.ranking``), the cluster-query index
with delta maintenance (``serve.clusters``) and deterministic fault
injection (``serve.faults``) — plus the LM-side batched prefill + decode
engine (``serve.engine``).  Ports of the same modules of
``repro.serve``; the rest of its serving plane (the HTTP endpoint, the
shared-memory replicas, the router and the supervisor) is ROADMAP A10b.
"""
from .clusters import (ClusterIndex, ClusterView, cluster_query,
                       pack_sig_words)
from .engine import GenerationResult, ServeEngine
from .faults import (KILL_EXIT_CODE, DropRequest, Fault, FaultInjector,
                     FaultPlan)
from .ranking import (BatchQuerier, RankingPolicy, cluster_scores,
                      pack_signatures, rank_views, top_clusters,
                      top_from_scores)
from .service import (QueryResult, Snapshot, TriclusterService,
                      snapshot_query, snapshot_query_batch)

__all__ = [
    # cluster-query surface
    "ClusterIndex", "ClusterView", "cluster_query", "pack_sig_words",
    # ranking layer
    "BatchQuerier", "RankingPolicy", "cluster_scores", "pack_signatures",
    "rank_views", "top_clusters", "top_from_scores",
    # snapshot-swapped service
    "TriclusterService", "Snapshot", "QueryResult",
    "snapshot_query", "snapshot_query_batch",
    # fault injection
    "FaultPlan", "FaultInjector", "Fault", "DropRequest",
    "KILL_EXIT_CODE",
    # LM serving engine
    "ServeEngine", "GenerationResult",
]
