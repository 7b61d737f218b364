"""User walk programs that declare nothing: the compiler derives their
bound, Eq. 12 sum and taint from the traced weight, and the kernels run
the weight, and the hooks, as generated device code.

* :func:`degree_damped` — the reference's quickstart program
  (``examples/quickstart.py``): w = h / sqrt(d(v') + 1), a residual mass
  that decays by 0.85 a step, and a stop below 0.25.  Fused, K4 runs its
  hooks as generated code.
* :func:`non_backtracking` — w = 0 for the node the walker last left (a
  state leaf its ``on_step`` stores), else h.
* :func:`stripped` — a registry program without its declarations and
  device rules (``reads``, ``bound``, ``weight_sum``, ``kernel_rule``, and
  with ``hooks=True`` its ``hook_rule``): the same weight and hooks, run
  the way a user's program is.

Run one from the command line with ``--workload
repro_torch.walks.examples:degree_damped`` (``launch/walk.py`` registers
a ``module:factory`` workload at run time).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import EdgeCtx, WalkProgram


def degree_damped() -> WalkProgram:
    """Prefer low-degree previous nodes, damped by the property weight;
    each walker carries a mass (1.0 at start, x0.85 a step) and stops once
    it falls below 0.25."""

    def get_weight(ctx: EdgeCtx, params, wstate):
        return ctx.h / torch.sqrt(ctx.deg_prev.to(torch.float32) + 1.0)

    def init_walker_state(query_ids):
        return (torch.ones(query_ids.shape[0], dtype=torch.float32,
                           device=query_ids.device),)

    def on_step(tctx: EdgeCtx, params, wstate):
        return (wstate[0] * 0.85,)

    def should_stop(tctx: EdgeCtx, params, wstate):
        return wstate[0] < 0.25

    return WalkProgram(name="degree-damped", init=lambda: (),
                       get_weight=get_weight,
                       init_walker_state=init_walker_state, on_step=on_step,
                       should_stop=should_stop, weighted=True)


def non_backtracking() -> WalkProgram:
    """Never step straight back: w = 0 for the node the walker last left,
    else h.  Each walker holds that node as one int32 (-1 at start), which
    ``on_step`` sets to the node it leaves."""

    def get_weight(ctx: EdgeCtx, params, wstate):
        last = wstate[0].reshape(wstate[0].shape
                                 + (1,) * (ctx.nbr.dim() - 1))
        return torch.where(ctx.nbr == last, 0.0, ctx.h)

    def init_walker_state(query_ids):
        return (torch.full((query_ids.shape[0],), -1, dtype=torch.int32,
                           device=query_ids.device),)

    def on_step(tctx: EdgeCtx, params, wstate):
        return (tctx.cur.to(torch.int32),)

    return WalkProgram(name="non-backtracking", init=lambda: (),
                       get_weight=get_weight,
                       init_walker_state=init_walker_state, on_step=on_step)


def stripped(program: WalkProgram, hooks: bool = False) -> WalkProgram:
    """``program`` without its declarations and hand-written device rules:
    the engine analyses its traced weight and the kernels run the weight
    as generated code.  Its hooks' device form (``hook_rule``) stays
    unless ``hooks``: then K4 runs the hooks as generated code too."""
    out = dataclasses.replace(program, reads=None, bound=None,
                              weight_sum=None, kernel_rule=None)
    return dataclasses.replace(out, hook_rule=None) if hooks else out
