"""Precomputed-regime tables (port of ``repro/core/precomp.py``; C-SAW's
static case).

For a program whose weight ignores the walk state
(``flexi_compiler.is_static``), every node's transition distribution is a
constant of the graph, baked once into two table families:

* **ITS** — per-row inclusive prefix sums of w̃ (``cdf``) + row totals.  A
  step is ``u·total`` plus a binary search of the row: O(log d).
  :func:`its_offsets` is the plain version of kernel K3
  (``kernels/its.py``).
* **Alias** — Vose tables (``alias_off`` / ``alias_prob``), built in
  float64.  A step is two uniforms and two reads: O(1).
  :func:`alias_offsets` is the plain version of kernel K5
  (``kernels/alias.py``).

Both must equal the reference's bit for bit.  The CDF is a float64
``np.cumsum`` per row cast to float32, so the build runs
:func:`row_scan`, which keeps that sequential order without a Python loop
over 4.8M rows.  The alias tables come from the reference's two-stack
Vose loop per row (``_vose_row``); :func:`vose_build` runs that loop in
lockstep over every row at once with numpy, with the same float64
``q[lg] -= 1.0 - q[sm]`` updates and the same stack order, and finishes
the few longest rows one by one on Python floats.
:meth:`PrecompTables.with_aligned` adds the tile-aligned streams the
aligned draw entries read.  The rebuild queue and ``rebuild_rows`` wait
for a later slice; the ``invalid`` bitmap is carried in from outside
(``interop.tables_from_arrays``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.ctxutil import degrees_of
from repro_torch.core.types import EdgeCtx, WalkProgram
from repro_torch.graphs.csr import CSRGraph, row_scan
from repro_torch.kernels.prng import uniform_01, uniform_pair_01

# Threefry counter salts of the table draws (the reference's ITS_SALT and
# ALIAS_SALT), so they never collide with the uniforms other regimes
# derive from the same per-(walker, step) key.
ITS_SALT = 0x175CDF
ALIAS_SALT = 0xA11A5
# rows still in the lockstep Vose loop below which the rest finish one by
# one on Python floats (a lockstep iteration costs ~20 numpy calls)
_VOSE_TAIL_ROWS = 64
# CDF entries a fence of ``PrecompTables.its_fence`` stands for: one 64 B
# segment of float32 (``kFenceBlock`` in kernels/csrc/its.cuh)
FENCE_BLOCK = 16


def threefry_seeds(keys: torch.Tensor) -> torch.Tensor:
    """[W, 2] per-(walker, step) key data → the Threefry key pairs the
    table draws use (the key data itself)."""
    return keys[:, :2]


@dataclasses.dataclass(frozen=True)
class PrecompTables:
    """Per-node ITS + alias tables over the CSR edge order plus the
    invalidation bitmap (rows marked there take the dynamic path)."""

    cdf: torch.Tensor  # [E] float32 — row-local inclusive prefix sums of w̃
    total: torch.Tensor  # [V] float32 — row sums
    # [E] int32 alias partner offset in the row and [E] float32 keep
    # probability of the column; None when built without alias tables
    alias_off: Optional[torch.Tensor]
    alias_prob: Optional[torch.Tensor]
    invalid: torch.Tensor  # [V] bool — rows that must take the dynamic path
    # the tile-aligned [R, 128] streams of cdf, alias_prob and alias_off
    # (kernels/ops.py align_rows geometry) and each node's first 128-row
    # ([V] int32): what the aligned draw entries read under
    # EngineConfig.precomp_exec="aligned" (with_aligned attaches them);
    # prob2d and alias2d stay None for tables without alias arrays
    cdf2d: Optional[torch.Tensor] = None
    prob2d: Optional[torch.Tensor] = None
    alias2d: Optional[torch.Tensor] = None
    arow0: Optional[torch.Tensor] = None

    def with_aligned(self, indptr) -> "PrecompTables":
        """These tables with the aligned streams attached, rebuilt from the
        flat arrays (the geometry is a function of ``indptr`` only); a new
        object, which keeps no layout cached on this one."""
        from repro_torch.kernels import ops as kernel_ops

        cdf2d, prob2d, alias2d, row0, _ = kernel_ops.aligned_precomp_tables(
            self, indptr)
        return dataclasses.replace(self, cdf2d=cdf2d, prob2d=prob2d,
                                   alias2d=alias2d, arow0=row0)

    def row_valid(self, v: torch.Tensor) -> torch.Tensor:
        """Per lane: may this node be served from the tables?"""
        return (v >= 0) & ~self.invalid[v.clamp_min(0)]

    def require_alias(self) -> None:
        """Raise unless the alias tables were built."""
        if self.alias_off is None or self.alias_prob is None:
            raise ValueError("these tables have no alias arrays; build them "
                             "with build_tables(..., alias=True)")

    def frac_stale(self) -> torch.Tensor:
        """Fraction of rows currently invalidated (float32 scalar)."""
        return self.invalid.to(torch.float32).mean()

    # The layouts the CUDA draws read (kernels/csrc/its.cuh, alias.cuh),
    # built from the fields on first use, on their device, and kept: the
    # tables are never edited in place, and one that changed would be a
    # new object.  The plain versions read the fields.
    @functools.cached_property
    def its_fence(self) -> torch.Tensor:
        """[E // FENCE_BLOCK] float32: the last CDF entry of each aligned
        block of ``FENCE_BLOCK`` entries, the table K3 and K4's ITS
        instance search before they read one block of the CDF."""
        return self.cdf[FENCE_BLOCK - 1::FENCE_BLOCK].contiguous()

    def draw_rows(self, indptr: torch.Tensor) -> torch.Tensor:
        """[V, 4] int32: each node's row start, degree and total (its
        float32 bits) and a 0, the 16 B record K3 and K5 read in place of
        ``indptr`` and ``total``.  Built from the ``indptr`` of the graph
        the tables belong to on first use, and kept (built again for
        another ``indptr`` tensor)."""
        kept = self.__dict__.get("_draw_rows")
        if kept is None or kept[0] is not indptr:
            start = indptr[:-1]
            kept = (indptr, torch.stack(
                (start, indptr[1:] - start, self.total.view(torch.int32),
                 torch.zeros_like(start)), dim=1))
            self.__dict__["_draw_rows"] = kept
        return kept[1]

    @functools.cached_property
    def alias_pair(self) -> torch.Tensor:
        """[E, 2] int32: each column's keep probability (its float32 bits)
        beside its alias offset, the table K5 and K4's alias instance read
        (one 8 B word a column)."""
        self.require_alias()
        return torch.stack((self.alias_prob.view(torch.int32),
                            self.alias_off), dim=1)


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
    # the walkers' state at its template (a static weight ignores it)
    template = program.wstate_template(dev)
    ws = None if template is None else tuple(
        leaf.expand((E,) + leaf.shape) for leaf in template)
    return torch.clamp_min(program.edge_weight(ctx, params, ws), 0.0).to(
        torch.float32)


def _vose_row(q: list, small: list, large: list):
    """The reference's two-stack Vose loop for one row, on Python floats
    (float64, rounding as numpy does): pops both stacks' tops until one
    runs out; ``q`` is updated in place.  Returns the popped small
    columns, their keep probabilities and alias partners (row-local), and
    the leftover columns, which are certain accepts."""
    cols, probs, partners = [], [], []
    pop_s, pop_l = small.pop, large.pop
    push_s, push_l = small.append, large.append
    while small and large:
        sm = pop_s()
        lg = pop_l()
        qs = q[sm]
        cols.append(sm)
        probs.append(qs)
        partners.append(lg)
        v = q[lg] - (1.0 - qs)
        q[lg] = v
        if v < 1.0:
            push_s(lg)
        else:
            push_l(lg)
    return cols, probs, partners, small + large


def row_sums(w: np.ndarray, indptr: np.ndarray) -> np.ndarray:
    """float64 ``w[row].sum()`` of every CSR row, bit for bit: numpy's
    pairwise sum, taken over rows of equal degree at once (a [n, d]
    array summed along its contiguous axis rounds as each row alone)."""
    deg = np.diff(indptr)
    out = np.zeros(deg.shape[0], np.float64)
    nz = np.nonzero(deg > 0)[0]
    order = nz[np.argsort(deg[nz], kind="stable")]
    bounds = np.flatnonzero(np.diff(deg[order])) + 1
    for rows in np.split(order, bounds):
        if rows.size:
            d = int(deg[rows[0]])
            out[rows] = w[indptr[rows][:, None] + np.arange(d)].sum(axis=1)
    return out


def _fill_stack(stack: np.ndarray, flag: np.ndarray, row_of: np.ndarray,
                start_e: np.ndarray, V: int) -> np.ndarray:
    """Write each row's flagged columns (row-local, ascending) into
    ``stack`` from the row's own offset on; returns the heights [V]."""
    e = np.flatnonzero(flag)
    r = row_of[e]
    height = np.bincount(r, minlength=V)
    first = np.cumsum(height) - height
    stack[start_e[e] + np.arange(e.size) - first[r]] = e - start_e[e]
    return height


def vose_build(w: np.ndarray, indptr: np.ndarray):
    """Vose alias tables of every CSR row, bitwise the reference's
    ``_vose_build`` (its ``_vose_row`` per row): (alias [E] int32
    row-local offsets, prob [E] float32).  Zero-total rows keep the
    neutral fill (alias 0, prob 1); ``total == 0`` masks them at draw
    time.

    Every row's small and large stacks live in two flat [E] arrays at the
    row's own offsets.  One lockstep iteration pops both tops of every row
    still running and pushes the large column back onto one of them, so
    each row sees the reference's float64 updates and stack order.  Once
    few rows remain (the hubs), they finish one by one in
    :func:`_vose_row`."""
    w = np.asarray(w, np.float64)
    indptr = np.asarray(indptr, np.int64)
    E, V = w.shape[0], indptr.shape[0] - 1
    alias = np.zeros(E, np.int32)
    prob = np.ones(E, np.float32)
    deg = np.diff(indptr)
    tot = row_sums(w, indptr)
    ok_row = (deg > 0) & (tot > 0)
    row_of = np.repeat(np.arange(V), deg)
    start_e = np.repeat(indptr[:-1], deg)
    ok = np.repeat(ok_row, deg)
    q = w * np.repeat(deg, deg) / np.repeat(np.where(ok_row, tot, 1.0), deg)
    S = np.empty(E, np.int64)  # small stack of row r from indptr[r] on
    L = np.empty(E, np.int64)
    ns = _fill_stack(S, ok & (q < 1.0), row_of, start_e, V)
    nl = _fill_stack(L, ok & (q >= 1.0), row_of, start_e, V)
    del row_of, start_e, ok
    rid = np.flatnonzero((ns > 0) & (nl > 0))
    base, slen, llen = indptr[rid], ns[rid], nl[rid]
    while rid.size > _VOSE_TAIL_ROWS:
        slen -= 1
        llen -= 1
        ps, pl = base + slen, base + llen
        sm, lg = S[ps], L[pl]
        es, el = base + sm, base + lg
        qs = q[es]
        prob[es] = qs
        alias[es] = lg
        v = q[el] - (1.0 - qs)
        q[el] = v
        # the large column goes back on top of one stack: the slot just
        # popped; the other write lands above that stack's top, unread
        S[ps] = lg
        L[pl] = lg
        to_small = v < 1.0
        slen += to_small
        llen += ~to_small
        keep = (slen > 0) & (llen > 0)
        if not keep.all():
            done = ~keep
            ns[rid[done]], nl[rid[done]] = slen[done], llen[done]
            rid, base = rid[keep], base[keep]
            slen, llen = slen[keep], llen[keep]
    for r, b, a, c in zip(rid.tolist(), base.tolist(), slen.tolist(),
                          llen.tolist()):
        cols, probs, partners, left = _vose_row(
            q[b:b + int(deg[r])].tolist(), S[b:b + a].tolist(),
            L[b:b + c].tolist())
        cols, left = np.asarray(cols, np.int64), np.asarray(left, np.int64)
        prob[b + cols] = probs
        alias[b + cols] = partners
        prob[b + left] = 1.0
        alias[b + left] = left
        ns[r] = nl[r] = 0
    # what is left on the lockstep rows' stacks: certain accepts
    for stack, height in ((S, ns), (L, nl)):
        rows = np.flatnonzero(height)
        h = height[rows]
        row0 = np.repeat(indptr[rows], h)
        cols = stack[row0 + np.arange(int(h.sum()))
                     - np.repeat(np.cumsum(h) - h, h)]
        prob[row0 + cols] = 1.0
        alias[row0 + cols] = cols
    return alias, prob


def build_tables(graph: CSRGraph, program: WalkProgram, params,
                 alias: bool = True) -> PrecompTables:
    """One-time ITS + alias table build for a static program (host-side
    float64 math per row; tables land on the graph's device).  With
    ``alias=False`` the Vose tables, which only the alias draw reads, are
    left out (None)."""
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    V = graph.num_nodes
    deg = np.diff(indptr)
    if V and int(deg.max(initial=0)) >= (1 << 24):
        # as in the reference, whose kernels read alias offsets as float32
        raise ValueError("precomp tables require max degree < 2**24")
    w = edge_weights_static(graph, program, params).cpu().numpy().astype(
        np.float64)
    cdf = row_scan(w, indptr, np.float64).astype(np.float32)
    total = np.zeros(V, np.float32)
    nz = np.nonzero(deg > 0)[0]
    total[nz] = cdf[indptr[nz + 1] - 1]
    dev = graph.device
    as_t = lambda a: torch.from_numpy(a).to(dev)
    alias_off = alias_prob = None
    if alias:
        alias_off, alias_prob = map(as_t, vose_build(w, indptr))
    return PrecompTables(cdf=as_t(cdf), total=as_t(total),
                         alias_off=alias_off, alias_prob=alias_prob,
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


def alias_offsets(graph: CSRGraph, tables: PrecompTables,
                  cur: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K5: the row offset the alias draw picks for
    each walker ([W] int64; -1 for empty or zero-total rows).

    ``(u₁, u₂) = uniform_pair_01(key, (0, ALIAS_SALT))``, column
    ``min(⌊u₁·d⌋, d-1)``, kept iff ``u₂ < prob`` of the column, else the
    column's alias partner."""
    tables.require_alias()
    E = graph.num_edges
    deg = degrees_of(graph, cur)
    vs = cur.clamp_min(0)
    start = graph.row_starts(vs)
    seeds = threefry_seeds(keys)
    u1, u2 = uniform_pair_01(seeds[:, 0], seeds[:, 1], 0, ALIAS_SALT)
    col = torch.minimum((u1 * deg.to(torch.float32)).to(torch.int64),
                        (deg - 1).clamp_min(0))
    pos = (start + col).clamp(0, max(E - 1, 0))
    sel = torch.where(u2 < tables.alias_prob[pos], col,
                      tables.alias_off[pos].long())
    return torch.where((deg > 0) & (tables.total[vs] > 0), sel, -1)


def offset_nodes(graph: CSRGraph, cur: torch.Tensor,
                 off: torch.Tensor) -> torch.Tensor:
    """The neighbour at row offset ``off`` of each node ``cur`` ([W]
    int64); -1 where ``off`` is -1."""
    start = graph.row_starts(cur.clamp_min(0))
    nxt = graph.indices[(start + off.clamp_min(0)).clamp(
        0, max(graph.num_edges - 1, 0))].long()
    return torch.where(off >= 0, nxt, -1)


def its_select(graph: CSRGraph, tables: PrecompTables, cur: torch.Tensor,
               keys: torch.Tensor, *, active: torch.Tensor,
               depth=None) -> torch.Tensor:
    """O(log d) inverse-transform draw from the baked CDF: next nodes [W];
    -1 for inactive, empty or zero-total lanes."""
    off = its_offsets(graph, tables, cur, keys, depth)
    return torch.where(active, offset_nodes(graph, cur, off), -1)


def alias_select(graph: CSRGraph, tables: PrecompTables, cur: torch.Tensor,
                 keys: torch.Tensor, *, active: torch.Tensor) -> torch.Tensor:
    """O(1) alias draw from the Vose tables: next nodes [W]; -1 for
    inactive, empty or zero-total lanes."""
    off = alias_offsets(graph, tables, cur, keys)
    return torch.where(active, offset_nodes(graph, cur, off), -1)
