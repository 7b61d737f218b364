"""The walk programs: (un)weighted Node2Vec (paper Eq. 2), (un)weighted
MetaPath, second-order PageRank (Eq. 3), DeepWalk, and the two stateful
programs the bare ``Workload`` protocol could not express — a
visited-avoiding second-order walk and an ε-terminating PPR-Nibble walk
(port of ``repro/walks/workloads.py``).

Each program's ``get_weight`` is a batched torch rule, which the
Flexi-Compiler (``core/flexi_compiler.py``) traces and analyses like any
user program.  The declared bound, Eq. 12 sum and ``reads`` repeat, in
float32, what the reference compiler derives from the jaxpr of the same
rule; the engine does not read them: they are the oracle the tests hold
the analysis against.  Each names a hand-written device weight rule
(``kernel_rule``), which the kernels run in place of a generated one, and
PPR-Nibble the device form of its hooks (``hook_rule``), which the fused
epoch runs; constants are float32, as the reference's traced Python
constants are.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.flexi_compiler import (Interval, h_interval, iv_mul,
                                             iv_select)
from repro_torch.core.types import EdgeCtx, WalkProgram
from repro_torch.kernels.rules import (deepwalk_rule, metapath_rule,
                                       node2vec_rule, ppr_nibble_hooks,
                                       ppr_nibble_rule, second_order_pr_rule,
                                       visited_rule)

#: largest node id, the hi end of the reference's ``nbr`` interval
_NBR_MAX = (1 << 31) - 2


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _h_of(bi, weighted: bool) -> torch.Tensor:
    """The Eq. 12 stand-in for h: the row's mean, or 1 when unweighted."""
    return bi.h_mean if weighted else _f32(1.0, bi.h_mean)


def _eq12(acc: torch.Tensor, terms: int, bi) -> torch.Tensor:
    """Σ-estimate from the enumerated terms' sum: mean times degree (a
    tensor divisor, so the card divides as the CPU does)."""
    mean_w = acc / _f32(float(terms), acc)
    return mean_w * bi.deg_cur.clamp_min(0).to(torch.float32)


# --------------------------------------------------------------- Node2Vec
@dataclasses.dataclass(frozen=True)
class N2VParams:
    a: float = 2.0  # return parameter: w = 1/a at dist 0
    b: float = 0.5  # in-out parameter: w = 1/b at dist 2


def _n2v_factors(p: N2VParams):
    """float32 weight factors at dist 0, 1, 2 (the reference's traced
    constants 1/a, 1.0, 1/b)."""
    rule = node2vec_rule(p.a, p.b, True)
    return rule.c0, 1.0, rule.c2


def _n2v_rule(dist: torch.Tensor, p: N2VParams) -> torch.Tensor:
    c0, c1, c2 = _n2v_factors(p)
    return torch.where(dist == 0, _f32(c0, dist),
                       torch.where(dist == 1, _f32(c1, dist),
                                   _f32(c2, dist)))


def _n2v_top(bi, p, weighted: bool) -> torch.Tensor:
    """[W] hi end of Node2Vec's w over a row: the rule's interval over
    dist ∈ [0, 2] (both where-predicates are uncertain, so the hull of
    the three factors) times h's interval, as the reference's ``_mul``."""
    f = _n2v_factors(p)
    rule = Interval(_f32(min(min(f[2], f[1]), f[0]), bi.h_max),
                    _f32(max(max(f[2], f[1]), f[0]), bi.h_max))
    return iv_mul(rule, h_interval(bi, weighted)).hi.expand_as(bi.h_max)


def node2vec(a: float = 2.0, b: float = 0.5,
             weighted: bool = True) -> WalkProgram:
    """Eq. 2: w = 1/a if dist(v',u)=0; 1 if dist=1; 1/b if dist=2."""

    def init():
        return N2VParams(a=a, b=b)

    def get_weight(ctx: EdgeCtx, p: N2VParams, wstate=None):
        return _n2v_rule(ctx.dist, p) * ctx.h

    def bound(bi, p: N2VParams):
        return torch.clamp_min(_n2v_top(bi, p, weighted), 0.0)

    def weight_sum(bi, p: N2VParams):
        h = _h_of(bi, weighted)
        acc = _f32(0.0, bi.h_mean)
        for factor in _n2v_factors(p):  # dist = 0, 1, 2
            acc = acc + torch.clamp_min(_f32(factor, h) * h, 0.0)
        return _eq12(acc, 3, bi)

    return WalkProgram(
        name=f"node2vec[{'w' if weighted else 'u'}]",
        init=init,
        get_weight=get_weight,
        reads=frozenset({"dist", "h"} if weighted else {"dist"}),
        bound=bound,
        weight_sum=weight_sum,
        kernel_rule=lambda p: node2vec_rule(p.a, p.b, weighted),
        needs_dist=True,
        weighted=weighted,
        walk_len=80,
    )


# --------------------------------------------------------------- DeepWalk
def deepwalk(weighted: bool = True) -> WalkProgram:
    """Static walk (w = h): the precomputed regime's program."""

    def init():
        return ()
    return WalkProgram(
        name=f"deepwalk[{'w' if weighted else 'u'}]",
        init=init,
        get_weight=_static_weight,
        reads=frozenset({"h"} if weighted else set()),
        bound=_static_bound(weighted),
        weight_sum=_static_sum(weighted),
        kernel_rule=lambda p: deepwalk_rule(weighted),
        weighted=weighted,
        walk_len=80,
    )


def _static_weight(ctx: EdgeCtx, p, wstate=None):
    return ctx.h * 1.0


def _static_bound(weighted: bool):
    def bound(bi, p):
        if weighted:
            return torch.clamp_min(bi.h_max * 1.0, 0.0)
        return torch.ones_like(bi.h_max)
    return bound


def _static_sum(weighted: bool):
    def weight_sum(bi, p):
        h = bi.h_mean if weighted else torch.ones_like(bi.h_mean)
        mean_w = torch.clamp_min(h * 1.0, 0.0)
        return mean_w * bi.deg_cur.clamp_min(0).to(torch.float32)
    return weight_sum


# --------------------------------------------------------------- MetaPath
@dataclasses.dataclass(frozen=True)
class MetaPathParams:
    schema: Tuple[int, ...] = (0, 1, 2, 3, 4)


def metapath(schema: Tuple[int, ...] = (0, 1, 2, 3, 4),
             weighted: bool = True) -> WalkProgram:
    """Follow the label schema: w = h iff label(v,u) == schema[step mod
    len(schema)], else 0."""
    schema = tuple(int(x) for x in schema)
    num_labels = max(schema) + 1

    def init():
        return MetaPathParams(schema=schema)

    def want(step, p: MetaPathParams):
        sched = torch.tensor(p.schema, dtype=torch.int64, device=step.device)
        return sched[torch.remainder(step, len(p.schema))]

    def get_weight(ctx: EdgeCtx, p: MetaPathParams, wstate=None):
        w = torch.where(ctx.label == want(ctx.step, p), _f32(1.0, ctx.h),
                        _f32(0.0, ctx.h))
        return w * ctx.h

    def bound(bi, p: MetaPathParams):
        # label ∈ [0, L-1] against the exact wanted label: certainly equal
        # only when the interval is that one point, possibly when inside
        w_ = want(bi.step, p)
        top = num_labels - 1
        pick = iv_select((w_ == 0) & (top == 0), (w_ >= 0) & (w_ <= top),
                         Interval.point(_f32(0.0, bi.h_max)),
                         Interval.point(_f32(1.0, bi.h_max)))
        return torch.clamp_min(
            iv_mul(pick, h_interval(bi, weighted)).hi, 0.0)

    def weight_sum(bi, p: MetaPathParams):
        h = _h_of(bi, weighted)
        w_ = want(bi.step, p)
        terms = min(num_labels, 8)  # the reference's max_enum_labels
        acc = _f32(0.0, bi.h_mean)
        for label in range(terms):
            w = torch.where(w_ == label, _f32(1.0, h), _f32(0.0, h)) * h
            acc = acc + torch.clamp_min(w, 0.0)
        return _eq12(acc, terms, bi)

    return WalkProgram(
        name=f"metapath[{'w' if weighted else 'u'}]",
        init=init,
        get_weight=get_weight,
        reads=frozenset({"label", "step"} | ({"h"} if weighted else set())),
        bound=bound,
        weight_sum=weight_sum,
        kernel_rule=lambda p: metapath_rule(p.schema, weighted),
        needs_labels=True,
        num_labels=num_labels,
        weighted=weighted,
        walk_len=len(schema),
    )


# ------------------------------------------------- Second-Order PageRank
@dataclasses.dataclass(frozen=True)
class SOPRParams:
    gamma: float = 0.2


def second_order_pagerank(gamma: float = 0.2,
                          weighted: bool = True) -> WalkProgram:
    """Eq. 3: w = ((1-γ)/d(v) + γ/d(v')·[dist=1]) · max(d(v), d(v'))."""

    def init():
        return SOPRParams(gamma=gamma)

    def terms(deg_cur, deg_prev, p: SOPRParams):
        """(1-γ)/d(v), γ/d(v') and max(d(v), d(v')), d clamped at 1."""
        dv = torch.clamp_min(deg_cur.to(torch.float32), 1.0)
        dp = torch.clamp_min(deg_prev.to(torch.float32), 1.0)
        # the Python constants round to float32, as jax rounds them
        return (_f32(1.0 - p.gamma, dv) / dv, _f32(p.gamma, dp) / dp,
                torch.maximum(dv, dp))

    def get_weight(ctx: EdgeCtx, p: SOPRParams, wstate=None):
        base, bonus, max_d = terms(ctx.deg_cur, ctx.deg_prev, p)
        bonus = torch.where(ctx.dist == 1, bonus, _f32(0.0, bonus))
        return (base + bonus) * max_d * ctx.h

    def bound(bi, p: SOPRParams):
        base, bonus, max_d = terms(bi.deg_cur, bi.deg_prev, p)
        zero = _f32(0.0, bonus)
        # dist ∈ [0, 2] may or may not be 1: the hull of {0, γ/d(v')}
        u = Interval(base + torch.minimum(zero, bonus),
                     base + torch.maximum(zero, bonus))
        v = iv_mul(u, Interval.point(max_d))
        return torch.clamp_min(iv_mul(v, h_interval(bi, weighted)).hi, 0.0)

    def weight_sum(bi, p: SOPRParams):
        h = _h_of(bi, weighted)
        base, bonus, max_d = terms(bi.deg_cur, bi.deg_prev, p)
        acc = _f32(0.0, bi.h_mean)
        for dist in (0, 1, 2):
            b = bonus if dist == 1 else _f32(0.0, bonus)
            acc = acc + torch.clamp_min((base + b) * max_d * h, 0.0)
        return _eq12(acc, 3, bi)

    return WalkProgram(
        name=f"2ndpr[{'w' if weighted else 'u'}]",
        init=init,
        get_weight=get_weight,
        reads=frozenset({"dist", "deg_cur", "deg_prev"}
                        | ({"h"} if weighted else set())),
        bound=bound,
        weight_sum=weight_sum,
        kernel_rule=lambda p: second_order_pr_rule(p.gamma, weighted),
        needs_dist=True,
        weighted=weighted,
        walk_len=80,
    )


# ------------------------------------------- visited-avoiding SecondOrder
@dataclasses.dataclass(frozen=True)
class VisitedAvoidingParams:
    a: float = 2.0
    b: float = 0.5
    window: int = 16  # tabu capacity: nodes stepped on in the last `window`


def _ring_of(wstate, like: torch.Tensor) -> torch.Tensor:
    """The walkers' tabu rings [W, window], shaped to broadcast against
    ``like`` ([W] or [W, k]) with the ring as the last dim."""
    ring = wstate[0]
    return ring.reshape(ring.shape[0], *([1] * (like.dim() - 1)),
                        ring.shape[1])


def visited_avoiding(a: float = 2.0, b: float = 0.5, window: int = 16,
                     weighted: bool = True) -> WalkProgram:
    """Second-order (Node2Vec-weighted) walk that never re-visits a node it
    stepped on within the last ``window`` steps.

    ``wstate`` is ``(ring,)``: the last ``window`` visited node ids per
    walker ([W, window] int32, -1 = empty slot).  ``get_weight`` zeroes
    edges into ring nodes, ``on_step`` writes the chosen node into slot
    ``step % window``; when every neighbour is in the ring the walk
    dead-ends."""

    def init():
        return VisitedAvoidingParams(a=a, b=b, window=window)

    def init_walker_state(query_ids):
        return (torch.full((query_ids.shape[0], window), -1,
                           dtype=torch.int32, device=query_ids.device),)

    def get_weight(ctx: EdgeCtx, p: VisitedAvoidingParams, wstate):
        base = _n2v_rule(ctx.dist, p) * ctx.h
        tabu = (_ring_of(wstate, ctx.nbr) == ctx.nbr.unsqueeze(-1)).any(-1)
        return torch.where(tabu, _f32(0.0, base), base)

    def on_step(tctx: EdgeCtx, p: VisitedAvoidingParams, wstate):
        ring = wstate[0].clone()
        lanes = torch.arange(ring.shape[0], device=ring.device)
        ring[lanes, torch.remainder(tctx.step, p.window)] = \
            tctx.nbr.to(torch.int32)
        return (ring,)

    def bound(bi, p: VisitedAvoidingParams):
        top = _n2v_top(bi, p, weighted)
        # nbr ∈ [0, 2^31-2] is never certainly in the ring, and possibly
        # so once the ring holds a node: then the hull of {0, Node2Vec's w}
        ring = bi.wstate[0]
        maybe = ((ring >= 0) & (ring <= _NBR_MAX)).any(-1)
        top = torch.where(maybe, torch.maximum(top, _f32(0.0, top)), top)
        return torch.clamp_min(top, 0.0)

    def weight_sum(bi, p: VisitedAvoidingParams):
        h = _h_of(bi, weighted)
        tabu = (bi.wstate[0] == 0).any(-1)  # the enumeration's nbr is 0
        acc = _f32(0.0, bi.h_mean)
        for factor in _n2v_factors(p):  # dist = 0, 1, 2
            w = torch.where(tabu, _f32(0.0, h), _f32(factor, h) * h)
            acc = acc + torch.clamp_min(w, 0.0)
        return _eq12(acc, 3, bi)

    return WalkProgram(
        name=f"visited[{'w' if weighted else 'u'}]",
        init=init,
        get_weight=get_weight,
        init_walker_state=init_walker_state,
        on_step=on_step,
        reads=frozenset({"dist", "nbr", "wstate"}
                        | ({"h"} if weighted else set())),
        bound=bound,
        weight_sum=weight_sum,
        kernel_rule=lambda p: visited_rule(p.a, p.b, p.window, weighted),
        needs_dist=True,
        weighted=weighted,
        walk_len=80,
    )


# ------------------------------------------------- ε-terminating PPR-Nibble
@dataclasses.dataclass(frozen=True)
class PPRNibbleParams:
    alpha: float = 0.15  # teleport probability: residual decays by (1-α)
    eps: float = 2e-2  # push threshold: stop when mass < ε·d(v)


def ppr_nibble(alpha: float = 0.15, eps: float = 2e-2,
               weighted: bool = True) -> WalkProgram:
    """PPR-Nibble-style walk with data-dependent early termination: each
    walker carries residual mass ``(mass,)`` ([W] float32, 1.0 at start)
    that decays by (1-α) per step; after stepping out of node v it stops
    as soon as ``mass < ε·d(v)``.  The weights are plain edge weights, so
    the program is static and the table regimes serve it."""

    def init():
        return PPRNibbleParams(alpha=alpha, eps=eps)

    def init_walker_state(query_ids):
        return (torch.ones(query_ids.shape[0], dtype=torch.float32,
                           device=query_ids.device),)

    def on_step(tctx: EdgeCtx, p: PPRNibbleParams, wstate):
        mass = wstate[0]
        return (mass * _f32(1.0 - p.alpha, mass),)

    def should_stop(tctx: EdgeCtx, p: PPRNibbleParams, wstate):
        mass = wstate[0]
        return mass < _f32(p.eps, mass) * tctx.deg_cur.to(torch.float32)

    return WalkProgram(
        name=f"ppr_nibble[{'w' if weighted else 'u'}]",
        init=init,
        get_weight=_static_weight,
        init_walker_state=init_walker_state,
        on_step=on_step,
        should_stop=should_stop,
        reads=frozenset({"h"} if weighted else set()),
        bound=_static_bound(weighted),
        weight_sum=_static_sum(weighted),
        kernel_rule=lambda p: ppr_nibble_rule(weighted),
        hook_rule=lambda p: ppr_nibble_hooks(p.alpha, p.eps),
        weighted=weighted,
        walk_len=80,
    )


def make_workload(name: str, **kw) -> WalkProgram:
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; have {sorted(WORKLOADS)}")
    return WORKLOADS[name](**kw)


def register_workload(name: str, factory, *, overwrite: bool = False):
    """Register a walk-program factory by name (the counterpart of
    ``core.samplers.register_sampler`` on the workload axis).  The program
    needs no declarations: the engine analyses its traced weight, and the
    kernels run it as generated device code."""
    if name in WORKLOADS and not overwrite:
        existing = WORKLOADS[name]
        existing_name = getattr(existing, "__name__",
                                type(existing).__name__)
        raise ValueError(
            f"workload {name!r} already registered by {existing_name} "
            f"(pass overwrite=True to replace); registered workloads: "
            f"{', '.join(sorted(WORKLOADS))}")
    WORKLOADS[name] = factory
    return factory


WORKLOADS = {
    "node2vec": node2vec,
    "node2vec_unweighted": lambda **kw: node2vec(weighted=False, **kw),
    "metapath": metapath,
    "metapath_unweighted": lambda **kw: metapath(weighted=False, **kw),
    "2ndpr": second_order_pagerank,
    "deepwalk": deepwalk,
    "visited_avoiding": visited_avoiding,
    "ppr_nibble": ppr_nibble,
}
