"""CSR graph and per-node preprocessing (port of ``repro/graphs/csr.py``).

``indices`` is sorted within each row, so ``dist(v', u)`` (Node2Vec's "is
u a neighbour of the previous node" test) is a search of sorted keys: the
CUDA kernels binary-search the previous node's row per candidate edge,
and the plain version (:func:`has_edge`) looks ``v'·V + u`` up in the
ascending table of every edge's ``src·V + dst``, which answers the same
question in one ``searchsorted``.  Per-node statistics are computed host-side with
the reference's accumulation order (a sequential float32 sum per row, as
XLA's ``segment_sum`` does on the CPU), so they match bit for bit, once
per graph and label count.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Directed graph in CSR form; every field is a tensor on one device.

    indptr:  [V+1] int32 — row offsets.
    indices: [E] int32   — destination of each edge, sorted within a row.
    h:       [E] float32 — edge property weights.
    labels:  [E] int32   — edge labels (zeros when unlabeled).
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    h: torch.Tensor
    labels: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def to(self, device) -> "CSRGraph":
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev == self.device:
            return self  # like Tensor.to: keeps what the graph cached
        return CSRGraph(*(t.to(dev) for t in dataclasses.astuple(self)))

    @functools.cached_property
    def _stats_by_labels(self) -> dict:
        """:func:`node_stats` results by label count, filled on first use
        (the graph's arrays are never written, so they stay true)."""
        return {}

    @functools.cached_property
    def edge_keys(self) -> torch.Tensor:
        """[E] int64 ``src · V + dst`` of every edge, ascending (rows come
        in order and each is sorted): the table :func:`has_edge` searches,
        built on first use."""
        src = torch.repeat_interleave(
            torch.arange(self.num_nodes, device=self.device),
            self.degrees().long())
        return src * self.num_nodes + self.indices.long()

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def max_degree(self) -> int:
        return int(self.degrees().max()) if self.num_nodes else 0

    def row_starts(self, v: torch.Tensor) -> torch.Tensor:
        """Edge-array offset of each node's row (int64, ``v`` batched)."""
        return self.indptr[v.long()].long()

    def row_degs(self, v: torch.Tensor) -> torch.Tensor:
        """Degree of each node's row (int64, ``v`` batched)."""
        v = v.long()
        return (self.indptr[v + 1] - self.indptr[v]).long()


@dataclasses.dataclass(frozen=True)
class NodeStats:
    """Per-node statistics of the edge property weight h (the generated
    ``preprocess()`` of the paper's Fig. 9d)."""

    h_min: torch.Tensor  # [V] float32
    h_max: torch.Tensor  # [V] float32
    h_sum: torch.Tensor  # [V] float32
    h_mean: torch.Tensor  # [V] float32
    degree: torch.Tensor  # [V] int32
    label_count: torch.Tensor  # [V, L] int32


def from_edges(src, dst, num_nodes: int, h=None, labels=None) -> CSRGraph:
    """Build a CPU CSRGraph from an edge list (host-side, numpy); the same
    arrays as the reference's ``from_edges``."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if h is None:
        h = np.ones(src.shape[0], dtype=np.float32)
    if labels is None:
        labels = np.zeros(src.shape[0], dtype=np.int32)
    h = np.asarray(h, np.float32)
    labels = np.asarray(labels, np.int32)
    # Sort by (src, dst) so rows are contiguous and sorted.  The generators
    # hand over edges already in that order (np.unique sorted them), and a
    # stable sort of sorted keys is the identity, so skip the O(E log E)
    # lexsort then.
    key = src * max(int(num_nodes), 1) + dst
    if key.size and not bool((key[1:] >= key[:-1]).all()):
        order = np.lexsort((dst, src))
        src, dst, h, labels = src[order], dst[order], h[order], labels[order]
    counts = np.bincount(src, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return CSRGraph(
        indptr=torch.from_numpy(indptr),
        indices=torch.from_numpy(dst.astype(np.int32)),
        h=torch.from_numpy(np.ascontiguousarray(h)),
        labels=torch.from_numpy(np.ascontiguousarray(labels)),
    )


def row_scan(values, indptr, dtype, long_row: int = 256) -> np.ndarray:
    """Inclusive prefix sums within each CSR row, accumulated sequentially
    in ``dtype`` (bit for bit ``np.cumsum`` of every row on its own).

    Rows up to ``long_row`` long are taken a degree at a time: the rows
    of degree d gather into an [n, d] array, whose ``np.cumsum`` along
    axis 1 accumulates each row in order; the few longer rows take
    ``np.cumsum`` each.  That keeps the sequential order a bit-exact
    reference needs without a Python loop over all rows.
    """
    vals = np.asarray(values, dtype)
    indptr = np.asarray(indptr, np.int64)
    deg = np.diff(indptr)
    out = np.zeros(vals.shape[0], dtype)
    short = np.nonzero((deg > 0) & (deg <= long_row))[0]
    order = short[np.argsort(deg[short], kind="stable")]
    for rows in np.split(order, np.flatnonzero(np.diff(deg[order])) + 1):
        if rows.size:
            idx = indptr[rows][:, None] + np.arange(deg[rows[0]])
            out[idx] = np.cumsum(vals[idx], axis=1, dtype=dtype)
    for v in np.nonzero(deg > long_row)[0]:
        s, e = indptr[v], indptr[v + 1]
        out[s:e] = np.cumsum(vals[s:e], dtype=dtype)
    return out


def node_stats(graph: CSRGraph, num_labels: int = 8) -> NodeStats:
    """Per-node min/max/sum/mean of h and per-label edge counts, on the
    graph's device.  Computed host-side: ``h_sum`` is each row's
    sequential float32 sum, the order the reference's ``segment_sum``
    accumulates in, so every field matches the reference bitwise.  The
    graph keeps them, so engines on one graph compute them once."""
    memo = graph._stats_by_labels
    if num_labels not in memo:
        memo[num_labels] = _node_stats(graph, num_labels)
    return memo[num_labels]


def _node_stats(graph: CSRGraph, num_labels: int) -> NodeStats:
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    h = graph.h.cpu().numpy()
    labels = graph.labels.cpu().numpy()
    V, E = graph.num_nodes, graph.num_edges
    deg = np.diff(indptr)
    nz = np.nonzero(deg > 0)[0]
    h_min = np.zeros(V, np.float32)
    h_max = np.zeros(V, np.float32)
    h_sum = np.zeros(V, np.float32)
    if nz.size:
        h_min[nz] = np.minimum.reduceat(h, indptr[nz])
        h_max[nz] = np.maximum.reduceat(h, indptr[nz])
        h_sum[nz] = row_scan(h, indptr, np.float32)[indptr[nz + 1] - 1]
    h_mean = h_sum / np.maximum(deg, 1).astype(np.float32)
    seg = np.repeat(np.arange(V, dtype=np.int64), deg)
    lbl = seg * num_labels + np.clip(labels, 0, num_labels - 1)
    label_count = np.bincount(lbl, minlength=V * num_labels).astype(
        np.int32).reshape(V, num_labels) if E else np.zeros(
            (V, num_labels), np.int32)
    dev = graph.device
    return NodeStats(
        h_min=torch.from_numpy(h_min).to(dev),
        h_max=torch.from_numpy(h_max).to(dev),
        h_sum=torch.from_numpy(h_sum).to(dev),
        h_mean=torch.from_numpy(h_mean.astype(np.float32)).to(dev),
        degree=torch.from_numpy(deg.astype(np.int32)).to(dev),
        label_count=torch.from_numpy(label_count).to(dev),
    )


def has_edge(graph: CSRGraph, v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """True iff edge (v, u) exists (any shape, ``v`` broadcast with ``u``);
    ``v == -1`` gives False."""
    v, u = torch.broadcast_tensors(v.long(), u.long())
    V, E = graph.num_nodes, graph.num_edges
    ok = (v >= 0) & (u >= 0) & (u < V)
    if E == 0:
        return torch.zeros_like(ok)
    keys = graph.edge_keys
    q = v.clamp_min(0) * V + u.clamp(0, max(V - 1, 0))
    pos = torch.searchsorted(keys, q).clamp_max(E - 1)
    return ok & (keys[pos] == q)


def dist_code(graph: CSRGraph, v_prev: torch.Tensor, u: torch.Tensor
              ) -> torch.Tensor:
    """Node2Vec's dist(v', u) ∈ {0, 1, 2} (int64): 0 if u == v', 1 if
    (v'→u) ∈ E, else 2; 1 when v' == -1 (first step)."""
    v_prev, u = torch.broadcast_tensors(v_prev.long(), u.long())
    d = torch.where(u == v_prev, 0,
                    torch.where(has_edge(graph, v_prev, u), 1, 2))
    return torch.where(v_prev < 0, 1, d)
