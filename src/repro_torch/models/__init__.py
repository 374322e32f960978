"""LM scaffolding of the port: configs' models, dense and MoE families
(``lm``), routing telemetry (``telemetry``)."""
from .api import Model, get_model

__all__ = ["Model", "get_model"]
