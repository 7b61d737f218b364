"""The walk programs of this slice: Node2Vec (paper Eq. 2) and DeepWalk
(port of ``repro/walks/workloads.py``; the other programs wait).

Each program's ``get_weight`` is a batched torch rule; its declared bound
and Eq. 12 sum repeat, operation for operation in float32, what the
reference compiler's interval and enumeration passes compute from the
jaxpr of the same rule, so the cost-model decisions match bitwise.  Its
declared ``reads`` (and ``needs_dist``) stand for the reference's taint
set: they decide the static regime and ``flexi_compiler.fuse_report``
(deepwalk fuses with a node-local bound; node2vec's weight reads ``dist``,
so it runs staged).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import EdgeCtx, WalkProgram
from repro_torch.kernels.rules import deepwalk_rule, node2vec_rule


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _max4(a, b, c, d):
    return torch.maximum(torch.maximum(a, b), torch.maximum(c, d))


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


def node2vec(a: float = 2.0, b: float = 0.5,
             weighted: bool = True) -> WalkProgram:
    """Eq. 2: w = 1/a if dist(v',u)=0; 1 if dist=1; 1/b if dist=2."""

    def init():
        return N2VParams(a=a, b=b)

    def get_weight(ctx: EdgeCtx, p: N2VParams):
        return _n2v_rule(ctx.dist, p) * ctx.h

    def bound(bi, p: N2VParams):
        # interval of the rule over dist ∈ [0, 2] (both where-predicates
        # are uncertain, so the hull of the three factors), times h's
        # interval: the four corner products, as the reference's _mul
        f = _n2v_factors(p)
        lo = _f32(min(min(f[2], f[1]), f[0]), bi.h_max)
        hi = _f32(max(max(f[2], f[1]), f[0]), bi.h_max)
        if weighted:
            top = _max4(lo * bi.h_min, lo * bi.h_max,
                        hi * bi.h_min, hi * bi.h_max)
        else:
            top = (hi * _f32(1.0, hi)).expand_as(bi.h_max)
        return torch.clamp_min(top, 0.0)

    def weight_sum(bi, p: N2VParams):
        h = bi.h_mean if weighted else _f32(1.0, bi.h_mean)
        acc = _f32(0.0, bi.h_mean)
        for factor in _n2v_factors(p):  # dist = 0, 1, 2
            acc = acc + torch.clamp_min(_f32(factor, h) * h, 0.0)
        mean_w = acc / 3
        return mean_w * bi.deg_cur.clamp_min(0).to(torch.float32)

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

    def get_weight(ctx: EdgeCtx, p):
        return ctx.h * 1.0

    def bound(bi, p):
        if weighted:
            return torch.clamp_min(bi.h_max * 1.0, 0.0)
        return torch.ones_like(bi.h_max)

    def weight_sum(bi, p):
        h = bi.h_mean if weighted else torch.ones_like(bi.h_mean)
        mean_w = torch.clamp_min(h * 1.0, 0.0)
        return mean_w * bi.deg_cur.clamp_min(0).to(torch.float32)

    return WalkProgram(
        name=f"deepwalk[{'w' if weighted else 'u'}]",
        init=init,
        get_weight=get_weight,
        reads=frozenset({"h"} if weighted else set()),
        bound=bound,
        weight_sum=weight_sum,
        kernel_rule=lambda p: deepwalk_rule(weighted),
        weighted=weighted,
        walk_len=80,
    )


WORKLOADS = {
    "deepwalk": deepwalk,
    "node2vec": node2vec,
}


def make_workload(name: str, **kw) -> WalkProgram:
    if name not in WORKLOADS:
        raise KeyError(f"unknown workload {name!r}; have {sorted(WORKLOADS)}")
    return WORKLOADS[name](**kw)
