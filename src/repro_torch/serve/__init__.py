"""LM serving of the port: the batched prefill + ragged decode engine.
Port of ``repro.serve.engine``; the cluster-serving modules of
``repro.serve`` (service, ranking, router, shm, ...) are ROADMAP A10."""
from .engine import GenerationResult, ServeEngine

__all__ = ["ServeEngine", "GenerationResult"]
