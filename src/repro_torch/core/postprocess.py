"""Post-processing: selection, ranking and export of mined clusters.
A copy of ``repro.core.postprocess`` for the port.

The paper (§2) treats duplicate elimination and user-constraint selection
as post-processing with O(|I|) cost; these helpers operate on the host
over the unified ``PipelineResult`` tensors (every engine returns
per-tuple ``cardinalities``), wherever they lie.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """Host numpy array of a result leaf (tensor on any device, or array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def select(result, min_density: float = 0.0, min_gen: int = 1,
           max_volume: Optional[float] = None,
           min_cardinality: int = 0) -> np.ndarray:
    """Indices of kept unique clusters under user constraints."""
    uniq = _np(result.is_unique)
    dens = _np(result.density)
    gen = _np(result.gen_count)
    vol = _np(result.volume)
    mask = uniq & (dens >= min_density) & (gen >= min_gen)
    if max_volume is not None:
        mask &= vol <= max_volume
    if min_cardinality:
        card = _np(result.cardinalities)
        mask &= (card >= min_cardinality).all(axis=0)
    return np.nonzero(mask)[0]


def top_k_by_density(result, k: int) -> np.ndarray:
    idx = select(result)
    dens = _np(result.density)[idx]
    return idx[np.argsort(-dens, kind="stable")[:k]]


def format_cluster(components: Iterable, names=None,
                   density: Optional[float] = None) -> str:
    """Paper §5.2 output format: one '{...}' line per modality."""
    lines = ["{"]
    for k, comp in enumerate(components):
        items = sorted(comp)
        if names is not None:
            items = [str(names[k][e]) for e in items]
        else:
            items = [str(e) for e in items]
        lines.append("{" + ", ".join(items) + "}")
    if density is not None:
        lines.append(f"# density={density:.4f}")
    lines.append("}")
    return "\n".join(lines)


def cluster_set(materialised) -> set:
    """Canonical comparable set from [(components, density), ...]."""
    return {tuple(tuple(sorted(c)) for c in comps)
            for comps, _ in materialised}
