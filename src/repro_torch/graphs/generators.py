"""Synthetic graph generators (numpy copies of ``repro/graphs/generators.py``:
the same seed gives the same arrays).

uniform / pareto / degree / ones property weights, as in the paper's
§6.2 evaluation regimes.  Graphs come back on the CPU; ``WalkEngine``
moves them to its device.
"""
from __future__ import annotations

from typing import Literal

import numpy as np

from repro_torch.graphs.csr import CSRGraph, from_edges

WeightDist = Literal["uniform", "pareto", "degree", "ones"]


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def attach_weights(src, dst, num_nodes: int,
                   weight_dist: WeightDist = "uniform", alpha: float = 2.0,
                   num_labels: int = 5, seed: int = 0) -> CSRGraph:
    """Attach property weights h and labels to an edge list.

    uniform: h ~ U[1, 5); pareto: h ~ 1 + Pareto(α); degree: h = deg(dst);
    ones: h = 1.
    """
    rng = _rng(seed + 1)
    E = src.shape[0]
    if weight_dist == "uniform":
        h = rng.uniform(1.0, 5.0, size=E).astype(np.float32)
    elif weight_dist == "pareto":
        h = (1.0 + rng.pareto(alpha, size=E)).astype(np.float32)
    elif weight_dist == "degree":
        deg = np.bincount(src, minlength=num_nodes)
        h = np.maximum(deg[dst], 1).astype(np.float32)
    elif weight_dist == "ones":
        h = np.ones(E, dtype=np.float32)
    else:
        raise ValueError(f"unknown weight_dist: {weight_dist}")
    labels = rng.integers(0, num_labels, size=E).astype(np.int32)
    return from_edges(src, dst, num_nodes, h=h, labels=labels)


def random_graph(num_nodes: int, avg_degree: int,
                 weight_dist: WeightDist = "uniform", alpha: float = 2.0,
                 num_labels: int = 5, seed: int = 0,
                 symmetric: bool = True) -> CSRGraph:
    """Erdős–Rényi-ish random graph with ≥1 out-edge per node (a ring), and
    reverse edges when ``symmetric`` so Node2Vec's dist = 1 cases occur."""
    rng = _rng(seed)
    E = num_nodes * avg_degree
    src = rng.integers(0, num_nodes, size=E)
    dst = rng.integers(0, num_nodes, size=E)
    ring_src = np.arange(num_nodes)
    ring_dst = (ring_src + 1) % num_nodes
    src = np.concatenate([src, ring_src])
    dst = np.concatenate([dst, ring_dst])
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * num_nodes + dst
    _, uniq = np.unique(key, return_index=True)
    src, dst = src[uniq], dst[uniq]
    return attach_weights(src, dst, num_nodes, weight_dist, alpha,
                          num_labels, seed)


def power_law_graph(num_nodes: int, avg_degree: int,
                    degree_alpha: float = 2.0,
                    weight_dist: WeightDist = "uniform", alpha: float = 2.0,
                    num_labels: int = 5, seed: int = 0) -> CSRGraph:
    """Zipf degree sequence with preferential destinations: the skewed
    degrees of the paper's web/social graphs."""
    rng = _rng(seed)
    raw = rng.zipf(degree_alpha, size=num_nodes).astype(np.int64)
    deg = np.clip(raw, 1, max(4, num_nodes // 4))
    scale = (avg_degree * num_nodes) / max(int(deg.sum()), 1)
    deg = np.maximum((deg * scale).astype(np.int64), 1)
    src = np.repeat(np.arange(num_nodes), deg)
    p = deg / deg.sum()
    dst = rng.choice(num_nodes, size=src.shape[0], p=p)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    ring = np.arange(num_nodes)
    src = np.concatenate([src, ring])
    dst = np.concatenate([dst, (ring + 1) % num_nodes])
    key = src.astype(np.int64) * num_nodes + dst
    _, uniq = np.unique(key, return_index=True)
    src, dst = src[uniq], dst[uniq]
    return attach_weights(src, dst, num_nodes, weight_dist, alpha,
                          num_labels, seed)
