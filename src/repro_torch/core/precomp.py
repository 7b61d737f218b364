"""Precomputed-regime ITS tables (port of the ITS half of
``repro/core/precomp.py``; C-SAW's static case).

For a program whose weight ignores the walk state
(``flexi_compiler.is_static``), every node's transition distribution is a
constant of the graph: its row is baked once into an inclusive CDF, and a
step is ``u·total`` plus a binary search of the row — O(log d), no weight
evaluation, no retries.  :func:`its_offsets` is the plain version of
kernel K3 (``kernels/its.py``).

The CDF must equal the reference's bit for bit: a float64 ``np.cumsum``
per row, cast to float32.  A parallel scan or a global cumsum minus each
row's base rounds differently, so the build runs :func:`row_scan`, which
keeps the sequential float64 order without a Python loop over 4.8M rows.
The alias tables, the rebuild queue and ``rebuild_rows`` wait for the
alias slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ctxutil import degrees_of
from repro_torch.core.types import EdgeCtx, WalkProgram
from repro_torch.graphs.csr import CSRGraph, row_scan
from repro_torch.kernels.prng import uniform_01

# Threefry counter salt of the ITS draw (the reference's ITS_SALT), so
# table draws never collide with the uniforms other regimes derive from
# the same per-(walker, step) key.
ITS_SALT = 0x175CDF


def threefry_seeds(keys: torch.Tensor) -> torch.Tensor:
    """[W, 2] per-(walker, step) key data → the Threefry key pairs the ITS
    draw uses (the key data itself)."""
    return keys[:, :2]


@dataclasses.dataclass(frozen=True)
class PrecompTables:
    """Per-node ITS tables over the CSR edge order plus the invalidation
    bitmap (all rows valid in this slice: weight updates wait)."""

    cdf: torch.Tensor  # [E] float32 — row-local inclusive prefix sums of w̃
    total: torch.Tensor  # [V] float32 — row sums
    invalid: torch.Tensor  # [V] bool — rows that must take the dynamic path

    def row_valid(self, v: torch.Tensor) -> torch.Tensor:
        """Per lane: may this node be served from the tables?"""
        return (v >= 0) & ~self.invalid[v.clamp_min(0)]

    def frac_stale(self) -> torch.Tensor:
        """Fraction of rows currently invalidated (float32 scalar)."""
        return self.invalid.to(torch.float32).mean()


def edge_weights_static(graph: CSRGraph, program: WalkProgram,
                        params) -> torch.Tensor:
    """w̃ of every edge of a static program, in CSR order ([E] float32).
    The state fields get the reference's neutral placeholders (dist=1,
    prev=-1, step=0) — any values give the same weights."""
    E = graph.num_edges
    dev = graph.device
    deg = graph.degrees().long()
    src = torch.repeat_interleave(
        torch.arange(graph.num_nodes, device=dev), deg)
    ctx = EdgeCtx(
        h=graph.h if program.weighted else torch.ones(E, device=dev),
        label=graph.labels.long(),
        dist=torch.ones(E, dtype=torch.int64, device=dev),
        nbr=graph.indices.long(),
        deg_cur=deg[src],
        deg_prev=torch.zeros(E, dtype=torch.int64, device=dev),
        cur=src,
        prev=torch.full((E,), -1, dtype=torch.int64, device=dev),
        step=torch.zeros(E, dtype=torch.int64, device=dev),
    )
    return torch.clamp_min(program.get_weight(ctx, params), 0.0).to(
        torch.float32)


def build_tables(graph: CSRGraph, program: WalkProgram,
                 params) -> PrecompTables:
    """One-time ITS table build for a static program (host-side float64
    accumulation per row; tables land on the graph's device)."""
    w = edge_weights_static(graph, program, params).cpu().numpy()
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    V = graph.num_nodes
    deg = np.diff(indptr)
    if V and int(deg.max(initial=0)) >= (1 << 24):
        raise ValueError("precomp tables require max degree < 2**24")
    cdf = row_scan(w.astype(np.float64), indptr, np.float64).astype(
        np.float32)
    total = np.zeros(V, np.float32)
    nz = np.nonzero(deg > 0)[0]
    total[nz] = cdf[indptr[nz + 1] - 1]
    dev = graph.device
    return PrecompTables(cdf=torch.from_numpy(cdf).to(dev),
                         total=torch.from_numpy(total).to(dev),
                         invalid=torch.zeros(V, dtype=torch.bool,
                                             device=dev))


def search_depth(max_degree: int) -> int:
    """Binary-search iterations that converge for rows of at most
    ``max_degree`` neighbours (+1 slack), as the reference computes it."""
    return int(np.ceil(np.log2(max(max_degree, 1) + 1))) + 1


def its_offsets(graph: CSRGraph, tables: PrecompTables, cur: torch.Tensor,
                keys: torch.Tensor, depth=None) -> torch.Tensor:
    """Plain version of kernel K3: the row offset the ITS draw picks for
    each walker ([W] int64; -1 for empty or zero-total rows).

    ``u = uniform_01(key, (0, ITS_SALT))``, target ``u·total``, and the
    first offset whose inclusive prefix exceeds the target (zero-weight
    neighbours share the previous prefix and are never landed on).
    ``depth`` bounds the halvings (default: :func:`search_depth` of the
    graph's largest row); extra halvings past convergence are no-ops."""
    if depth is None:
        depth = search_depth(graph.max_degree())
    E = graph.num_edges
    deg = degrees_of(graph, cur)
    vs = cur.clamp_min(0)
    start = graph.row_starts(vs)
    seeds = threefry_seeds(keys)
    u = uniform_01(seeds[:, 0], seeds[:, 1], 0, ITS_SALT)
    total = tables.total[vs]
    target = u * total
    lo = torch.zeros_like(deg)
    hi = deg.clone()
    for _ in range(depth):
        mid = (lo + hi) // 2
        val = tables.cdf[(start + mid).clamp(0, max(E - 1, 0))]
        go_right = (val <= target) & (lo < hi)
        new_lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | (lo >= hi), hi, mid)
        lo = new_lo
    sel = torch.minimum(lo, (deg - 1).clamp_min(0))
    return torch.where((deg > 0) & (total > 0), sel, -1)


def its_select(graph: CSRGraph, tables: PrecompTables, cur: torch.Tensor,
               keys: torch.Tensor, *, active: torch.Tensor,
               depth=None) -> torch.Tensor:
    """O(log d) inverse-transform draw from the baked CDF: next nodes [W];
    -1 for inactive, empty or zero-total lanes."""
    off = its_offsets(graph, tables, cur, keys, depth)
    start = graph.row_starts(cur.clamp_min(0))
    nxt = graph.indices[(start + off.clamp_min(0)).clamp(
        0, max(graph.num_edges - 1, 0))].long()
    return torch.where(active & (off >= 0), nxt, -1)
