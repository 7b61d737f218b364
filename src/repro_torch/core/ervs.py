"""eRVS — enhanced reservoir sampling (port of ``repro/core/ervs.py``;
paper §3.2, Alg. 1 + Fig. 4): the plain PyTorch versions of kernel K1.

* :func:`ervs_step` — exponential keys ln(u)/w̃, arg-max over the row.
* :func:`ervs_jump_step` — the A-ExpJ jump variant: each of the ``tile``
  lanes runs sequential A-ExpJ over its strided subsequence
  {l, l+tile, …} and the lanes are arg-maxed at the end.
* :func:`interleaved_step` — :func:`ervs_step` with tile 0 read from the
  ``interleaved`` sampler's prefetch carry, which it refills with the
  chosen node's first tile.

Both keep the reference's logical tiling, which feeds the RNG counters:
offset ``j`` sits in tile ``t = j // tile`` at lane ``j % tile``, and its
uniform is lane ``j % tile`` of ``uniform(fold_in(key, t), (tile,))``.
Only the offsets some walker's row reaches are computed; the rest would be
masked out anyway.  ``kernels/ervs.py`` runs
these on CPU tensors and the CUDA kernel on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ctxutil import degrees_of, eval_weights, tile_ctx
from repro_torch.core.types import EdgeCtx, WalkProgram, wstate_rows
from repro_torch.graphs.csr import CSRGraph, dist_code
from repro_torch.kernels.prng import (fold_in, threefry2x32, uniform,
                                      uniform_from_bits)
from repro_torch.kernels.ref import fma32, xla_exp, xla_log

NEG_INF = float("-inf")
# entries ([walkers, offsets]) of one ervs_step block
_BLOCK_ELEMS = 1 << 22


def _log_keys(u: torch.Tensor, w: torch.Tensor,
              log=torch.log) -> torch.Tensor:
    """ln(key) = ln(u)/w̃ for w̃ > 0, else -inf (``log`` evaluates ln)."""
    safe_w = torch.where(w > 0, w, 1.0)
    return torch.where(w > 0, log(u) / safe_w, NEG_INF)


def _tile_uniforms(keys: torch.Tensor, t: int, width: int) -> torch.Tensor:
    """Lanes [0, width) of tile t's uniforms: ``uniform(fold_in(k, t))``."""
    return uniform(fold_in(keys, t), width)


def _trip(deg: torch.Tensor, active: torch.Tensor, tile: int):
    """(tiles to scan, widest row) over the active walkers."""
    top = int(torch.where(active, deg, 0).max()) if deg.numel() else 0
    return -(-top // tile), top


def ervs_step(graph: CSRGraph, program: WalkProgram, params, cur, prev, step,
              keys: torch.Tensor, tile: int = 256,
              active: Optional[torch.Tensor] = None,
              wstate=None) -> torch.Tensor:
    """One eRVS step for a batch of walkers (program state ``wstate``).
    Returns next nodes [W] (int64): -1 when no neighbour has a positive
    weight, -2 for inactive walkers.  Ties keep the first offset holding
    the maximum key.

    Each pass takes the walkers whose rows reach its first tile and as
    many whole tiles as keep a block under ``_BLOCK_ELEMS`` entries, so
    a few hubs among many short rows cost their own length, not every
    walker's; when even one tile of those walkers is larger, the pass
    takes them in chunks of at most that many entries.  The first maximum of a block is the first
    maximum of its tiles taken in order, so blocks change no choice."""
    W = cur.shape[0]
    if active is None:
        active = torch.ones(W, dtype=torch.bool, device=cur.device)
    best_lk = torch.full((W,), NEG_INF, device=cur.device)
    best_nbr = torch.full((W,), -1, dtype=torch.int64, device=cur.device)
    scan_tiles(graph, program, params, cur, prev, step, keys, tile, active,
               wstate, 0, best_lk, best_nbr)
    return torch.where(active, best_nbr, -2)


def scan_tiles(graph: CSRGraph, program: WalkProgram, params, cur, prev,
               step, keys: torch.Tensor, tile: int, active: torch.Tensor,
               wstate, first: int, best_lk: torch.Tensor,
               best_nbr: torch.Tensor) -> None:
    """Fold tiles ``first``, ``first + 1``, ... of each active walker's
    row into its running best (key, neighbour), in place: a tile's
    maximum replaces the best only when strictly greater, so the first
    offset holding the maximum wins."""
    deg = degrees_of(graph, cur)
    needed, top = _trip(deg, active, tile)
    t = first
    while t < needed:
        reach = (active & (deg > t * tile)).nonzero().squeeze(1)
        k = max(1, min(needed - t, _BLOCK_ELEMS // (reach.numel() * tile)))
        width = min(k * tile, top - t * tile)
        tiles = torch.arange(t, t + k, device=cur.device)
        # lane j of a tile draws on counter j, so a block of one tile
        # narrower than ``tile`` draws only its own lanes
        per_tile = min(tile, width)
        for lanes in reach.split(max(1, _BLOCK_ELEMS // (k * per_tile))):
            ctx, mask = tile_ctx(graph, program, cur[lanes], prev[lanes],
                                 step[lanes], t * tile, width)
            w = eval_weights(program, params, ctx, mask,
                             wstate_rows(wstate, lanes))
            u = uniform(fold_in(keys[lanes, None, :], tiles[None, :]),
                        per_tile)
            u = u.reshape(lanes.numel(), k * per_tile)[:, :width]
            lk = torch.where(mask, _log_keys(u, w), NEG_INF)
            b = lk.argmax(dim=1, keepdim=True)
            blk_lk = lk.gather(1, b)[:, 0]
            upd = blk_lk > best_lk[lanes]
            best_lk[lanes] = torch.where(upd, blk_lk, best_lk[lanes])
            best_nbr[lanes] = torch.where(upd, ctx.nbr.gather(1, b)[:, 0],
                                          best_nbr[lanes])
        t += k


def tile0_payload(graph: CSRGraph, program: WalkProgram, node: torch.Tensor,
                  tile: int):
    """(nbr, h, label, mask), each [n, tile], of offsets [0, tile) of the
    rows of ``node`` (-1: no row): the values ``ctxutil.tile_ctx`` gives
    (nbr -1, h 0 and label -1 or 0 where masked; h 1 where unmasked for an
    unweighted program, label 0 for one that reads no labels)."""
    deg = degrees_of(graph, node)
    start = graph.row_starts(node.clamp_min(0))
    offs = torch.arange(tile, dtype=torch.int64, device=node.device)[None, :]
    mask = offs < deg[:, None]
    pos = (start[:, None] + offs).clamp(0, max(graph.num_edges - 1, 0))
    nbr = torch.where(mask, graph.indices[pos].long(), -1)
    if program.weighted:
        h = torch.where(mask, graph.h[pos], 0.0)
    else:
        h = mask.to(torch.float32)
    if program.needs_labels:
        label = torch.where(mask, graph.labels[pos].long(), -1)
    else:
        label = torch.zeros_like(nbr)
    return nbr, h, label, mask


def fill_tile0(carry, graph: CSRGraph, program: WalkProgram,
               slots: torch.Tensor, node: torch.Tensor, tile: int) -> None:
    """Write the first tile of the rows of ``node`` (:func:`tile0_payload`,
    fills included) into the carry rows ``slots`` and tag them with
    ``node``, in blocks of at most ``_BLOCK_ELEMS`` entries."""
    carry.node[slots] = node
    for part in torch.arange(slots.numel(), device=slots.device).split(
            max(1, _BLOCK_ELEMS // tile)):
        nbr, h, label, _ = tile0_payload(graph, program, node[part], tile)
        rows = slots[part]
        carry.nbr[rows] = nbr.to(carry.nbr.dtype)
        carry.h[rows] = h
        carry.label[rows] = label.to(carry.label.dtype)


def interleaved_step(graph: CSRGraph, program: WalkProgram, params, cur,
                     prev, step, keys: torch.Tensor, carry,
                     lanes: torch.Tensor, tile: int = 256,
                     wstate=None) -> torch.Tensor:
    """Plain version of K1's interleaved entry: one eRVS step of the n
    walkers in slots ``lanes`` of ``carry`` (a ``PrefetchTile`` of every
    slot), with ``cur``, ``prev``, ``step``, ``keys`` and ``wstate`` their
    rows.  Returns next nodes [n] (int64, -1 when no neighbour has a
    positive weight), bitwise :func:`ervs_step`'s, and rewrites ``carry``
    in place.

    The reference's order (``InterleavedSampler.select``): tile 0 from
    the carry on a hit lane (its tag equals ``cur``) and from the graph on
    a miss lane, the same uniforms and keys as the plain scan; tiles 1, ...
    as :func:`ervs_step` scans them; then each walker's carry row holds
    the first tile of the node it moved to, tagged with that node (-1
    where it did not move), and every other slot gets tag -1 and the
    masked fills.  Tile 0 runs in blocks of at most ``_BLOCK_ELEMS``
    entries, as :func:`ervs_step`'s tiles do."""
    n, dev = cur.shape[0], cur.device
    best_lk = torch.full((n,), NEG_INF, device=dev)
    best_nbr = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for part in torch.arange(n, device=dev).split(
            max(1, _BLOCK_ELEMS // tile)):
        c, p, slot = cur[part], prev[part], lanes[part]
        node = carry.node[slot]
        hit = ((node == c) & (node >= 0))[:, None]
        nbr_g, h_g, label_g, mask0 = tile0_payload(graph, program, c, tile)
        nbr0 = torch.where(hit, carry.nbr[slot].long(), nbr_g)
        h0 = torch.where(hit, carry.h[slot], h_g)
        label0 = torch.where(hit, carry.label[slot].long(), label_g)
        if program.needs_dist:
            dist0 = dist_code(graph, p[:, None], nbr0.clamp_min(0))
        else:
            dist0 = torch.ones_like(nbr0)
        wide = lambda x: x[:, None].expand(part.numel(), tile)
        ctx0 = EdgeCtx(h=h0, label=label0, dist=dist0, nbr=nbr0,
                       deg_cur=wide(degrees_of(graph, c)),
                       deg_prev=wide(degrees_of(graph, p)), cur=wide(c),
                       prev=wide(p), step=wide(step[part]))
        w0 = eval_weights(program, params, ctx0, mask0,
                          wstate_rows(wstate, part))
        u0 = _tile_uniforms(keys[part], 0, tile)
        lk0 = torch.where(mask0, _log_keys(u0, w0), NEG_INF)
        b0 = lk0.argmax(dim=1, keepdim=True)
        blk_lk = lk0.gather(1, b0)[:, 0]
        best_lk[part] = blk_lk
        best_nbr[part] = torch.where(blk_lk > NEG_INF,
                                     nbr0.gather(1, b0)[:, 0], -1)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    scan_tiles(graph, program, params, cur, prev, step, keys, tile, active,
               wstate, 1, best_lk, best_nbr)
    # the new carry: the chosen node's first tile, the fills elsewhere
    W = carry.node.shape[0]
    tag = torch.full((W,), -1, dtype=torch.int64, device=dev)
    tag[lanes] = best_nbr
    fill_tile0(carry, graph, program, torch.arange(W, device=dev), tag, tile)
    return best_nbr


def ervs_jump_step(graph: CSRGraph, program: WalkProgram, params, cur, prev,
                   step, keys: torch.Tensor, tile: int = 256,
                   active: Optional[torch.Tensor] = None,
                   wstate=None) -> torch.Tensor:
    """A-ExpJ (jump) variant; returns next nodes [W] as :func:`ervs_step`
    does.  The lane with the largest final key wins (first lane on ties)."""
    W = cur.shape[0]
    if active is None:
        active = torch.ones(W, dtype=torch.bool, device=cur.device)
    lk_max, nbr_best = jump_lanes(graph, program, params, cur, prev, step,
                                  keys, tile, active, wstate)
    if lk_max.shape[1] == 0:
        best = torch.full((W,), -1, dtype=torch.int64, device=cur.device)
    else:
        lane = lk_max.argmax(dim=1, keepdim=True)
        best = nbr_best.gather(1, lane)[:, 0]
        best = torch.where(lk_max.max(dim=1).values > NEG_INF, best, -1)
    return torch.where(active, best, -2)


def jump_lanes(graph: CSRGraph, program: WalkProgram, params, cur, prev,
               step, keys: torch.Tensor, tile: int, active: torch.Tensor,
               wstate=None):
    """Final (key, neighbour) of each A-ExpJ lane: ([W, lanes] float32,
    [W, lanes] int64) with lanes = min(tile, widest active row).

    Tile t draws u0 from ``fold_in(key, 2t)`` and u1 from ``fold_in(key,
    2t+1)``.  The float operations are the reference's as XLA on the CPU
    compiles them: ``u2 = t_w + u0 * (1 - t_w)`` is one fused multiply-add
    (``fma32``), and exp and log are XLA's polynomials (``xla_exp``,
    ``xla_log``); every other operation is a separate IEEE operation in
    the reference's order.  A-ExpJ magnifies a 1-ulp change (``log(u2)`` of
    a ``u2`` near 1 moves the next threshold), so on long rows anything
    else parts from the reference far from near-ties.  The CUDA kernel
    runs the same operations (``csrc/xla_math.cuh``).
    Tile t is computed only for the walkers whose rows reach it: on the
    others every edge is masked (w̃ = 0), which changes no lane."""
    W = cur.shape[0]
    dev = cur.device
    deg = degrees_of(graph, cur)
    needed, top = _trip(deg, active, tile)
    lanes = min(tile, top)
    lk_max = torch.full((W, lanes), NEG_INF, device=dev)
    nbr_best = torch.full((W, lanes), -1, dtype=torch.int64, device=dev)
    thresh = torch.zeros((W, lanes), device=dev)
    cumw = torch.zeros((W, lanes), device=dev)
    one = torch.tensor(1.0, device=dev)
    for t in range(needed):
        rows = (active & (deg > t * tile)).nonzero().squeeze(1)
        width = min(tile, top - t * tile)
        ctx, mask = tile_ctx(graph, program, cur[rows], prev[rows],
                             step[rows], t * tile, width)
        w = eval_weights(program, params, ctx, mask,
                         wstate_rows(wstate, rows))
        lk, nb = lk_max[rows, :width], nbr_best[rows, :width]
        th, cw = thresh[rows, :width], cumw[rows, :width]
        is_first = lk == NEG_INF
        u0 = _tile_uniforms(keys[rows], 2 * t, width)
        init_lk = _log_keys(u0, w, xla_log)
        crossed = ((cw + w) >= th) & (w > 0) & mask
        t_w = xla_exp(torch.clamp(w * lk, -80.0, 0.0))
        u2 = fma32(u0, one - t_w, t_w)
        cross_lk = _log_keys(torch.clamp(u2, 1e-38, 1.0), w, xla_log)
        new_key = torch.where(is_first, init_lk, cross_lk)
        take = (is_first & (w > 0) & mask) | crossed
        u1 = _tile_uniforms(keys[rows], 2 * t + 1, width)
        lk_new = torch.where(take, new_key, lk)
        denom = torch.where(lk_new < 0, lk_new, -1e-30)
        thresh[rows, :width] = torch.where(take, xla_log(u1) / denom, th)
        cumw[rows, :width] = torch.where(take, 0.0,
                                         cw + torch.where(mask, w, 0.0))
        nbr_best[rows, :width] = torch.where(take, ctx.nbr, nb)
        lk_max[rows, :width] = lk_new
    return lk_max, nbr_best


def offset_keys_f64(graph: CSRGraph, program: WalkProgram, params, cur, prev,
                    step, keys: torch.Tensor, offsets: torch.Tensor,
                    tile: int = 256, wstate=None) -> torch.Tensor:
    """float64 eRVS keys ln(u)/w̃ of one row offset per walker, from the
    same float32 uniforms and weights — what the near-tie contract checks a
    divergent choice against (float32 log keys are not bitwise portable
    between math libraries)."""
    from repro_torch.core.ctxutil import single_edge_ctx

    t, lane = offsets // tile, offsets % tile
    tk = fold_in(keys, t)
    r0, r1 = threefry2x32(tk[:, 0], tk[:, 1], 0, lane)
    u = uniform_from_bits(r0 ^ r1).to(torch.float64)
    ctx, valid = single_edge_ctx(graph, program, cur, prev, step, offsets)
    w = torch.where(valid, torch.clamp_min(
        program.edge_weight(ctx, params, wstate), 0.0), 0.0).to(torch.float64)
    return torch.where(w > 0, torch.log(u) / w, float("-inf"))


def within_ulps(a: torch.Tensor, b: torch.Tensor, n: int = 2) -> torch.Tensor:
    """|a - b| ≤ n float32 ulps at the larger magnitude of the two."""
    big = torch.maximum(a.abs(), b.abs()).to(torch.float32)
    ulp = (torch.nextafter(big, torch.tensor(float("inf"))) - big).to(
        torch.float64)
    return (a.to(torch.float64) - b.to(torch.float64)).abs() <= n * ulp
