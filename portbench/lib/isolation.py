"""The check that nothing the benchmark ran loaded JAX or the JAX
package: top-level module names compared whole (``repro_torch`` is the
port, ``repro`` the JAX package)."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """Sorted top-level names among ``names`` (default: ``sys.modules``)
    that are JAX or the JAX package."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names}
                  & set(FORBIDDEN))
