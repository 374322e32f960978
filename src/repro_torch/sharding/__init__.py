"""Logical-axis to mesh-axis sharding rules of the port
(``sharding.rules``)."""
from .rules import (DEFAULT_TABLE, MeshRules, PartitionSpec, Sharding,
                    logical_spec)

__all__ = ["DEFAULT_TABLE", "MeshRules", "PartitionSpec", "Sharding",
           "logical_spec"]
