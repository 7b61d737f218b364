"""Batched edge-context construction (port of ``repro/core/ctxutil.py``).

Builds :class:`EdgeCtx` blocks of shape [W, width] from the CSR rows,
computing only the fields the program needs (dist is a binary search per
edge, labels a gather).  These are the plain versions' gathers; the CUDA
kernels read the same rows themselves.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.types import EdgeCtx, WalkProgram
from repro_torch.graphs.csr import CSRGraph, dist_code


def degrees_of(graph: CSRGraph, v: torch.Tensor) -> torch.Tensor:
    """Degree of each node (int64); 0 for v < 0."""
    d = graph.row_degs(v.clamp_min(0))
    return torch.where(v >= 0, d, 0)


def _payload(graph: CSRGraph, program: WalkProgram, prev: torch.Tensor,
             pos: torch.Tensor, mask: torch.Tensor):
    nbr = torch.where(mask, graph.indices[pos].long(), -1)
    if program.weighted:
        h = torch.where(mask, graph.h[pos], 0.0)
    else:
        h = mask.to(torch.float32)
    if program.needs_labels:
        label = torch.where(mask, graph.labels[pos].long(), -1)
    else:
        label = torch.zeros_like(nbr)
    if program.needs_dist:
        dist = dist_code(graph, prev, nbr.clamp_min(0))
    else:
        dist = torch.ones_like(nbr)
    return nbr, h, label, dist


def tile_ctx(graph: CSRGraph, program: WalkProgram, cur, prev, step,
             tile_start: int, width: int) -> Tuple[EdgeCtx, torch.Tensor]:
    """(ctx[W, width], mask[W, width]) for neighbour offsets
    [tile_start, tile_start + width) of each walker's row."""
    start = graph.row_starts(cur.clamp_min(0))
    deg_cur = degrees_of(graph, cur)
    deg_prev = degrees_of(graph, prev)
    offs = tile_start + torch.arange(width, dtype=torch.int64,
                                     device=cur.device)[None, :]
    mask = offs < deg_cur[:, None]
    pos = (start[:, None] + offs).clamp(0, max(graph.num_edges - 1, 0))
    nbr, h, label, dist = _payload(graph, program, prev[:, None], pos, mask)
    shape = nbr.shape
    ctx = EdgeCtx(h=h, label=label, dist=dist, nbr=nbr,
                  deg_cur=deg_cur[:, None].expand(shape),
                  deg_prev=deg_prev[:, None].expand(shape),
                  cur=cur[:, None].expand(shape),
                  prev=prev[:, None].expand(shape),
                  step=step[:, None].expand(shape))
    return ctx, mask


def single_edge_ctx(graph: CSRGraph, program: WalkProgram, cur, prev, step,
                    offset: torch.Tensor) -> Tuple[EdgeCtx, torch.Tensor]:
    """EdgeCtx of exactly one candidate edge per walker (rejection trials)."""
    deg_cur = degrees_of(graph, cur)
    deg_prev = degrees_of(graph, prev)
    valid = offset < deg_cur
    pos = (graph.row_starts(cur.clamp_min(0)) + offset).clamp(
        0, max(graph.num_edges - 1, 0))
    nbr, h, label, dist = _payload(graph, program, prev, pos, valid)
    ctx = EdgeCtx(h=h, label=label, dist=dist, nbr=nbr, deg_cur=deg_cur,
                  deg_prev=deg_prev, cur=cur, prev=prev, step=step)
    return ctx, valid


def eval_weights(program: WalkProgram, params, ctx: EdgeCtx,
                 mask: torch.Tensor, wstate=None) -> torch.Tensor:
    """w̃ for a ctx block; masked lanes get 0 (never sampled).  ``wstate``
    is the walkers' program state (leaves lead with ctx's walker dim; the
    rule broadcasts them over the block's other dims), None if
    stateless."""
    w = program.edge_weight(ctx, params, wstate)
    return torch.where(mask, torch.clamp_min(w, 0.0), 0.0)


def transition_ctx(graph: CSRGraph, cur, prev, step, nxt,
                   deg_cur) -> EdgeCtx:
    """[W] EdgeCtx of the transition just taken (the hook contract of
    ``WalkProgram``): ``nbr`` = the node moved to, ``cur`` / ``prev`` /
    ``step`` the pre-move view, ``deg_cur`` / ``deg_prev`` their degrees;
    the per-edge payload is a placeholder (h=1, label=-1, dist=-1)."""
    minus = torch.full_like(cur, -1)
    return EdgeCtx(h=torch.ones(cur.shape, device=cur.device), label=minus,
                   dist=minus, nbr=nxt, deg_cur=deg_cur,
                   deg_prev=degrees_of(graph, prev), cur=cur, prev=prev,
                   step=step)


def apply_hooks(program: WalkProgram, params, tctx: EdgeCtx, wstate,
                stepped: torch.Tensor):
    """(new wstate, stop [W] bool) after a step: ``on_step`` commits on
    the lanes that moved, and ``should_stop`` sees the new state; only a
    lane that moved can stop."""
    stop = torch.zeros_like(stepped)
    if program.on_step is not None:
        cand = program.on_step(tctx, params, wstate)
        wstate = tuple(
            torch.where(stepped.reshape((-1,) + (1,) * (new.dim() - 1)),
                        new, old) for new, old in zip(cand, wstate))
    if program.should_stop is not None:
        stop = stepped & program.should_stop(tctx, params, wstate)
    return wstate, stop
