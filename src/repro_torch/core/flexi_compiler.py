"""Flexi-Compiler (paper §4.2): compile-time analysis of a walk program's
weight rule (port of ``repro/core/flexi_compiler.py``).

The paper analyses the user's CUDA ``get_weight`` with Clang/LLVM and
generates a bound helper (``get_weight_max``, feeds eRJS), an Eq. 12 sum
helper (``get_weight_sum``, feeds the cost model of Eq. 11) and a flag.
The reference traces the rule to a jaxpr; the port traces the program's
torch ``get_weight`` once, on [1]-shaped example fields and a batch of
one walker's ``wstate``, into an ATen-level ``torch.fx`` graph
(:func:`trace_weight`, ``make_fx``) and runs the reference's two abstract
interpretations over it, rule for rule:

1. **Intervals** (:class:`Interval`): every value carries [lo, hi]
   endpoints, runtime tensors, so the synthesised bound is evaluated per
   walker per step.  Per-edge fields (h, label, dist, nbr) enter as
   intervals (h's from the node statistics), node and step fields and
   the walker's program state as exact points.  The output's hi end is
   ``get_weight_max()``: ``analyze(...).bound_fn``.
2. **Taint**: each interval carries the set of runtime inputs its
   endpoints depend on.  None gives PER_KERNEL (one bound per launch),
   any gives PER_STEP; :func:`static_taint` runs the same interpreter
   with every field tainted by its own name, which decides
   :func:`is_static` (the ITS / alias table gate) and :func:`fuse_report`.
3. **Soundness fallback** (§7.1): an op outside the abstract domain
   (sort, nonzero, a division by an uncertain divisor, ...) or a rule
   that cannot be traced (Python branching on a tensor, data-dependent
   shapes) gives FALLBACK with a warning that names it: the engine runs
   eRVS only.  Nothing here raises for such a program.

The Eq. 12 sum enumerates dist ∈ {0, 1, 2} and labels < L with h at the
row's mean through the same interpreter on exact points, so ``exp`` and
``log`` are XLA-CPU's (``kernels.ref.xla_exp`` / ``xla_log``), as the
reference's jnp evaluates them.  Each walker is interpreted on the
traced [1] shapes under ``torch.func.vmap``, as the reference's
estimators are vmapped over walkers.

The registry programs' declared bounds (``walks/workloads.py``) are
written with :class:`Interval`, :func:`iv_mul`, :func:`iv_select` and
:func:`h_interval`; the tests hold them against this analysis.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, FrozenSet, List, Optional, Tuple

import torch

from repro_torch.core.types import (EDGE_FIELDS, NODE_FIELDS, EdgeCtx,
                                    WalkProgram, WState)

PER_KERNEL = "PER_KERNEL"
PER_STEP = "PER_STEP"
FALLBACK = "FALLBACK"

#: inputs that vary with walk state; a weight that reads none of them is
#: a constant of the graph, so its rows can be baked into ITS tables
STATE_FIELDS = frozenset({"dist", "prev", "deg_prev", "step", "wstate"})

#: every EdgeCtx field, in the order the traced graph takes them
CTX_FIELDS = EDGE_FIELDS + NODE_FIELDS

#: largest node id, the hi end of the ``nbr`` interval (int32's max - 1)
NBR_MAX = (1 << 31) - 2


@dataclasses.dataclass(frozen=True)
class BoundInputs:
    """Per-walker runtime values the estimators read ([W] tensors): the
    current node's h statistics and the walker's own state, with the
    program's per-walker ``wstate`` leaves ([W]-leading; None when
    stateless), concrete like ``cur`` / ``prev`` / ``step``."""

    h_min: torch.Tensor
    h_max: torch.Tensor
    h_mean: torch.Tensor
    deg_cur: torch.Tensor
    deg_prev: torch.Tensor
    cur: torch.Tensor
    prev: torch.Tensor
    step: torch.Tensor
    wstate: WState = None


@dataclasses.dataclass(frozen=True)
class Interval:
    """[lo, hi] of a value (the reference's ``IVal``): ``exact`` when lo
    is hi by construction, ``taint`` the runtime inputs the endpoints
    depend on.  A comparison's interval is (certainly, possibly)."""

    lo: torch.Tensor
    hi: torch.Tensor
    exact: bool = False
    taint: FrozenSet[str] = frozenset()

    @staticmethod
    def point(x: torch.Tensor,
              taint: FrozenSet[str] = frozenset()) -> "Interval":
        return Interval(x, x, True, taint)


IVal = Interval


class Unsupported(Exception):
    """An op outside the abstract domain."""


def iv_mul(a: Interval, b: Interval) -> Interval:
    """The reference's ``_mul``: exact product, else the corner hull."""
    t = a.taint | b.taint
    if a.exact and b.exact:
        return Interval.point(a.lo * b.lo, t)
    c = (a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi)
    return Interval(torch.minimum(torch.minimum(c[0], c[1]),
                                  torch.minimum(c[2], c[3])),
                    torch.maximum(torch.maximum(c[0], c[1]),
                                  torch.maximum(c[2], c[3])), False, t)


def iv_select(certainly: torch.Tensor, possibly: torch.Tensor,
              if_false: Interval, if_true: Interval) -> Interval:
    """The reference's ``_select_n`` of two cases under an uncertain
    predicate (``certainly`` / ``possibly`` true): a known branch where
    the predicate is settled, else the hull of both."""
    lo = torch.minimum(if_false.lo, if_true.lo)
    hi = torch.maximum(if_false.hi, if_true.hi)
    return Interval(
        torch.where(certainly, if_true.lo,
                    torch.where(~possibly, if_false.lo, lo)),
        torch.where(certainly, if_true.hi,
                    torch.where(~possibly, if_false.hi, hi)),
        False, if_false.taint | if_true.taint)


def h_interval(bi: BoundInputs, weighted: bool) -> Interval:
    """h over the row: [h_min, h_max] when weighted, else the point 1."""
    if weighted:
        return Interval(bi.h_min, bi.h_max)
    return Interval.point(torch.ones((), device=bi.h_max.device))


@dataclasses.dataclass
class CompiledWorkload:
    """What the compiler knows about one program.  ``bound_fn`` returns the
    upper bound of w̃ (the reference's ``bound_fn`` hi endpoint)."""

    workload: WalkProgram
    flag: str
    warnings: List[str]
    bound_fn: Optional[Callable[[BoundInputs], torch.Tensor]]
    sum_fn: Optional[Callable[[BoundInputs], torch.Tensor]]

    @property
    def usable(self) -> bool:
        return self.flag != FALLBACK


# ---------------------------------------------------------------- tracing
def example_ctx() -> EdgeCtx:
    """The [1]-shaped fields a rule is traced on (the reference's
    template: h 1, dist 1, the rest 0 or 1)."""
    i = lambda v: torch.full((1,), v, dtype=torch.int64)
    return EdgeCtx(h=torch.ones(1), label=i(0), dist=i(1), nbr=i(0),
                   deg_cur=i(1), deg_prev=i(1), cur=i(0), prev=i(0),
                   step=i(0))


def trace_weight(program: WalkProgram, params=None):
    """(graph module, the traced wstate leaves) of the program's weight
    rule on :func:`example_ctx` and one walker's initial state; the
    module takes the nine fields, then the leaves.  Raises where the rule
    cannot be traced."""
    from torch.fx.experimental.proxy_tensor import make_fx

    params = program.params() if params is None else params
    ws = program.init_wstate_batch(torch.zeros(1, dtype=torch.int64))
    leaves = () if ws is None else tuple(ws)
    n = len(CTX_FIELDS)

    def rule(*args):
        ctx = EdgeCtx(*args[:n])
        return program.edge_weight(ctx, params,
                                   None if ws is None else tuple(args[n:]))

    ctx = example_ctx()
    gm = make_fx(rule)(*(getattr(ctx, f) for f in CTX_FIELDS), *leaves)
    return gm, leaves


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One ``wstate`` leaf as a walker holds it: its dtype and per-walker
    shape (``()`` for one value a walker, ``(k,)`` for a vector of k)."""

    dtype: torch.dtype
    shape: Tuple[int, ...]


def leaf_specs(leaves) -> Tuple[LeafSpec, ...]:
    """The :class:`LeafSpec` of each traced ([1]-leading) leaf."""
    return tuple(LeafSpec(x.dtype, tuple(x.shape[1:])) for x in leaves)


def example_tctx() -> EdgeCtx:
    """The [1]-shaped transition ctx the hooks are traced on (the fields
    of ``ctxutil.transition_ctx``: h 1, label and dist -1)."""
    i = lambda v: torch.full((1,), v, dtype=torch.int64)
    return EdgeCtx(h=torch.ones(1), label=i(-1), dist=i(-1), nbr=i(0),
                   deg_cur=i(1), deg_prev=i(1), cur=i(0), prev=i(0),
                   step=i(0))


@dataclasses.dataclass(frozen=True)
class HookTrace:
    """A program's hooks as ATen graphs on :func:`example_tctx` and one
    walker's initial state (None where the program has no such hook);
    each module takes the nine fields, then the leaves."""

    on_step: Optional[torch.fx.GraphModule]
    should_stop: Optional[torch.fx.GraphModule]
    leaves: Tuple[LeafSpec, ...]


def trace_hooks(program: WalkProgram, params=None) -> HookTrace:
    """``on_step`` and ``should_stop`` traced once each (``make_fx`` of the
    functionalized hook, so that ``clone`` + ``index_put_`` trace to one
    ``index_put``).  Raises where a hook cannot be traced."""
    from torch.fx.experimental.proxy_tensor import make_fx

    params = program.params() if params is None else params
    ws = program.init_wstate_batch(torch.zeros(1, dtype=torch.int64))
    leaves = () if ws is None else tuple(ws)
    n = len(CTX_FIELDS)
    ctx = example_tctx()
    fields = [getattr(ctx, f) for f in CTX_FIELDS]

    def trace(hook):
        if hook is None:
            return None

        def fn(*args):
            return hook(EdgeCtx(*args[:n]), params,
                        None if ws is None else tuple(args[n:]))
        return make_fx(torch.func.functionalize(fn))(*fields, *leaves)

    return HookTrace(trace(program.on_step), trace(program.should_stop),
                     leaf_specs(leaves))


# ------------------------------------------------------------ interpreter
def _op_name(target) -> str:
    packet = getattr(target, "overloadpacket", None)
    return packet.__name__ if packet is not None else getattr(
        target, "__name__", str(target))


def _hull(vals: List[Interval], extra: FrozenSet[str] = frozenset()
          ) -> Interval:
    lo, hi = vals[0].lo, vals[0].hi
    for v in vals[1:]:
        lo = torch.minimum(lo, v.lo)
        hi = torch.maximum(hi, v.hi)
    return Interval(lo, hi, False,
                    frozenset().union(*[v.taint for v in vals]) | extra)


def _cmp(kind: str, a: Interval, b: Interval) -> Interval:
    t = a.taint | b.taint
    ops = {"lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
           "eq": torch.eq, "ne": torch.ne}
    if a.exact and b.exact:
        return Interval.point(ops[kind](a.lo, b.lo), t)
    if kind in ("lt", "le"):
        strict = kind == "lt"
        certainly = (a.hi < b.lo) if strict else (a.hi <= b.lo)
        possibly = (a.lo < b.hi) if strict else (a.lo <= b.hi)
        return Interval(certainly, possibly, False, t)
    if kind in ("gt", "ge"):
        return _cmp("lt" if kind == "gt" else "le", b, a)
    if kind == "ne":
        e = _cmp("eq", a, b)
        return Interval(~e.hi, ~e.lo, False, t)
    certainly = (a.lo == a.hi) & (b.lo == b.hi) & (a.lo == b.lo)
    possibly = (a.lo <= b.hi) & (b.lo <= a.hi)
    return Interval(certainly, possibly, False, t)


def _select(pred: Interval, if_false: Interval, if_true: Interval
            ) -> Interval:
    """The reference's ``_select_n`` of two cases."""
    if pred.exact:
        return Interval(torch.where(pred.lo, if_true.lo, if_false.lo),
                        torch.where(pred.lo, if_true.hi, if_false.hi),
                        if_false.exact and if_true.exact,
                        pred.taint | if_false.taint | if_true.taint)
    hull = _hull([if_false, if_true], pred.taint)
    return Interval(
        torch.where(pred.lo, if_true.lo,
                    torch.where(~pred.hi, if_false.lo, hull.lo)),
        torch.where(pred.lo, if_true.hi,
                    torch.where(~pred.hi, if_false.hi, hull.hi)),
        False, hull.taint)


def _div(a: Interval, b: Interval) -> Interval:
    t = a.taint | b.taint
    if a.exact and b.exact:
        return Interval.point(a.lo / b.lo, t)
    if not b.exact:
        # a divisor that may straddle zero cannot be bounded (§7.1)
        raise Unsupported("interval division by non-exact divisor")
    lo, hi = a.lo / b.lo, a.hi / b.lo
    return Interval(torch.minimum(lo, hi), torch.maximum(lo, hi), False, t)


def _integer_pow(a: Interval, n: int) -> Interval:
    if a.exact:
        return Interval.point(a.lo ** n, a.taint)
    if n % 2 == 1:
        return Interval(a.lo ** n, a.hi ** n, False, a.taint)
    c_lo, c_hi = a.lo ** n, a.hi ** n
    straddles = (a.lo <= 0) & (a.hi >= 0)
    return Interval(
        torch.where(straddles, torch.zeros_like(c_lo),
                    torch.minimum(c_lo, c_hi)),
        torch.maximum(c_lo, c_hi), False, a.taint)


def _xla(fn):
    """``exp`` / ``log`` as XLA-CPU evaluates them (the reference's jnp)."""
    def run(x):
        from repro_torch.kernels import ref

        x = x if x.is_floating_point() else x.to(torch.float32)
        return getattr(ref, fn)(x)
    return run


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt correctly rounded (as XLA's and the card's
    ``__fsqrt_rn``; torch's CPU sqrt can be 1 ulp off): the float64 root
    rounded once more loses nothing."""
    x = x if x.is_floating_point() else x.to(torch.float32)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


_MONOTONE = {
    "exp": _xla("xla_exp"), "log": _xla("xla_log"), "sqrt": sqrt_rn,
    "tanh": torch.tanh, "sigmoid": torch.sigmoid, "floor": torch.floor,
    "ceil": torch.ceil, "round": torch.round, "sign": torch.sign,
    "erf": torch.erf, "log1p": torch.log1p, "expm1": torch.expm1,
}
_PASSTHROUGH = {"lift_fresh_copy", "clone", "alias", "detach",
                "contiguous"}
# value-preserving shape ops: applied to both endpoints
_SHAPE_OPS = {"view", "_unsafe_view", "reshape", "expand", "unsqueeze",
              "squeeze", "permute", "t", "transpose", "flip", "select",
              "slice"}
_REDUCE = {"amin", "amax", "sum", "any", "all", "min", "max"}
_CONST = {"scalar_tensor", "full", "zeros", "ones", "zeros_like",
          "ones_like", "full_like"}
_CMP = {"eq", "ne", "lt", "le", "gt", "ge"}
_LOGIC = {"logical_and": "and", "bitwise_and": "and", "logical_or": "or",
          "bitwise_or": "or", "logical_not": "not", "bitwise_not": "not",
          "logical_xor": "xor", "bitwise_xor": "xor"}


class _Interp:
    """The abstract interpreter of one traced rule on one device."""

    def __init__(self, gm, device):
        self.gm = gm
        self.device = device

    def scalar(self, x, like) -> Interval:
        """A Python number operand as an exact 0-d point of the dtype
        torch promotes it to beside ``like`` (on the device, so that no
        kernel takes it for a host scalar)."""
        if like is None:
            dtype = (torch.bool if isinstance(x, bool) else torch.int64
                     if isinstance(x, int) else torch.get_default_dtype())
        else:
            dtype = torch.result_type(like, x)
        return Interval.point(torch.tensor(x, dtype=dtype,
                                           device=self.device))

    def operands(self, args, env) -> List[Interval]:
        """The node's value operands as intervals (scalars converted)."""
        vals = [env[a] if isinstance(a, torch.fx.Node) else a for a in args]
        like = next((v.lo for v in vals if isinstance(v, Interval)), None)
        return [v if isinstance(v, Interval) else self.scalar(v, like)
                for v in vals]

    def run(self, ins: List[Interval]) -> Interval:
        env: Dict[Any, Interval] = {}
        holders = [n for n in self.gm.graph.nodes if n.op == "placeholder"]
        if len(holders) != len(ins):
            raise Unsupported(
                f"input arity mismatch: {len(ins)} abstract inputs for "
                f"{len(holders)} traced inputs (wstate missing or "
                f"mis-structured?)")
        env.update(zip(holders, ins))
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                continue
            elif node.op == "get_attr":
                env[node] = Interval.point(
                    getattr(self.gm, node.target).to(self.device))
            elif node.op == "call_function":
                env[node] = self.eval(node, env)
            elif node.op == "output":
                out = node.args[0]
                if isinstance(out, (tuple, list)):
                    if len(out) != 1:
                        raise Unsupported("a rule must return one tensor")
                    out = out[0]
                return env[out]
            else:
                raise Unsupported(node.op)
        raise Unsupported("no output")

    def eval(self, node, env) -> Interval:
        name = _op_name(node.target)
        args, kw = node.args, node.kwargs
        if name in _PASSTHROUGH:
            return env[args[0]]
        if name in ("add", "sub", "rsub") and kw.get("alpha", 1) != 1:
            raise Unsupported(f"{name} with alpha")
        if name == "add":
            a, b = self.operands(args[:2], env)
            return Interval(a.lo + b.lo, a.hi + b.hi, a.exact and b.exact,
                            a.taint | b.taint)
        if name in ("sub", "rsub"):
            a, b = self.operands(args[:2], env)
            if name == "rsub":
                a, b = b, a
            return Interval(a.lo - b.hi, a.hi - b.lo, a.exact and b.exact,
                            a.taint | b.taint)
        if name == "mul":
            return iv_mul(*self.operands(args[:2], env))
        if name == "div":
            if kw.get("rounding_mode") is not None:
                raise Unsupported(f"div with rounding_mode "
                                  f"{kw['rounding_mode']!r}")
            a, b = self.operands(args[:2], env)
            if not (a.lo.is_floating_point() or b.lo.is_floating_point()):
                f = lambda v: Interval(v.lo.float(), v.hi.float(), v.exact,
                                       v.taint)
                a, b = f(a), f(b)
            return _div(a, b)
        if name == "neg":
            (a,) = self.operands(args[:1], env)
            return Interval(-a.hi, -a.lo, a.exact, a.taint)
        if name == "abs":
            (a,) = self.operands(args[:1], env)
            if a.exact:
                return Interval.point(a.lo.abs(), a.taint)
            straddles = (a.lo <= 0) & (a.hi >= 0)
            return Interval(
                torch.where(straddles, torch.zeros_like(a.lo),
                            torch.minimum(a.lo.abs(), a.hi.abs())),
                torch.maximum(a.lo.abs(), a.hi.abs()), False, a.taint)
        if name in ("maximum", "minimum", "clamp_min", "clamp_max") or (
                name in ("max", "min") and len(args) == 2
                and not isinstance(args[1], int)):
            a, b = self.operands(args[:2], env)
            f = (torch.maximum if name in ("maximum", "clamp_min", "max")
                 else torch.minimum)
            return Interval(f(a.lo, b.lo), f(a.hi, b.hi),
                            a.exact and b.exact, a.taint | b.taint)
        if name == "clamp":
            x = env[args[0]]
            bounds = [args[i] if i < len(args) else kw.get(k)
                      for i, k in ((1, "min"), (2, "max"))]
            t = x.taint
            lo, hi = x.lo, x.hi
            for bnd, f in zip(bounds, (torch.maximum, torch.minimum)):
                if bnd is None:
                    continue
                (b,) = self.operands([bnd], env) if isinstance(
                    bnd, torch.fx.Node) else [self.scalar(bnd, x.lo)]
                if not b.exact:
                    raise Unsupported("clamp with non-exact bounds")
                lo, hi, t = f(lo, b.lo), f(hi, b.lo), t | b.taint
            return Interval(lo, hi, x.exact, t)
        if name in _MONOTONE:
            (a,) = self.operands(args[:1], env)
            fn = _MONOTONE[name]
            if a.exact:
                return Interval.point(fn(a.lo), a.taint)
            return Interval(fn(a.lo), fn(a.hi), False, a.taint)
        if name == "pow":
            a, b = self.operands(args[:2], env)
            n = args[1]
            if isinstance(n, int) and not isinstance(n, bool) \
                    and not isinstance(args[0], (int, float)):
                return _integer_pow(a, n)
            if a.exact and b.exact:
                return Interval.point(a.lo ** b.lo, a.taint | b.taint)
            if b.exact:  # monotone in the base for base >= 0
                return Interval(a.lo ** b.lo, a.hi ** b.lo, False,
                                a.taint | b.taint)
            raise Unsupported("pow with non-exact exponent")
        if name in _CMP:
            return _cmp(name, *self.operands(args[:2], env))
        if name in _LOGIC:
            kind = _LOGIC[name]
            if kind == "not":
                (a,) = self.operands(args[:1], env)
                return Interval(~a.hi, ~a.lo, a.exact, a.taint)
            a, b = self.operands(args[:2], env)
            t = a.taint | b.taint
            if kind == "and":
                return Interval(a.lo & b.lo, a.hi & b.hi,
                                a.exact and b.exact, t)
            if kind == "or":
                return Interval(a.lo | b.lo, a.hi | b.hi,
                                a.exact and b.exact, t)
            if a.exact and b.exact:
                return Interval.point(a.lo ^ b.lo, t)
            false = torch.zeros((), dtype=torch.bool, device=self.device)
            return Interval(false, ~false, False, t)
        if name == "where":
            pred = env[args[0]]
            x, y = self.operands(args[1:3], env)
            return _select(pred, y, x)
        if name in ("_to_copy", "to", "_to_dtype", "type"):
            a = env[args[0]]
            dtype = kw.get("dtype", a.lo.dtype)
            if not isinstance(dtype, torch.dtype):
                raise Unsupported(f"{name} to {dtype!r}")
            return Interval(a.lo.to(dtype), a.hi.to(dtype), a.exact, a.taint)
        if name in _SHAPE_OPS:
            a = env[args[0]]
            f = lambda x: node.target(x, *args[1:], **kw)
            return Interval(f(a.lo), f(a.hi), a.exact, a.taint)
        if name in ("remainder", "fmod"):
            a, b = self.operands(args[:2], env)
            t = a.taint | b.taint
            if a.exact and b.exact:
                fn = torch.remainder if name == "remainder" else torch.fmod
                return Interval.point(fn(a.lo, b.lo), t)
            if b.exact:
                # lhs non-negative assumed (steps, labels): [0, |b| - 1]
                return Interval(torch.zeros_like(b.lo), b.lo.abs() - 1,
                                False, t)
            raise Unsupported("rem by non-exact divisor")
        if name in ("cat", "stack"):
            parts = [env[a] for a in args[0]]
            f = lambda xs: node.target(xs, *args[1:], **kw)
            return Interval(f([v.lo for v in parts]), f([v.hi for v in parts]),
                            all(v.exact for v in parts),
                            frozenset().union(*[v.taint for v in parts]))
        if name in ("index", "index_select", "gather"):
            return self.gather(node, name, env)
        if name in _REDUCE:
            a = env[args[0]]
            f = lambda x: node.target(x, *args[1:], **kw)
            return Interval(f(a.lo), f(a.hi), a.exact, a.taint)
        if name in _CONST:
            if "device" in kw or name in ("scalar_tensor", "full", "zeros",
                                          "ones"):
                kw = {**kw, "device": self.device}
            vals = [env[a].lo if isinstance(a, torch.fx.Node) else a
                    for a in args]
            return Interval.point(node.target(*vals, **kw))
        raise Unsupported(name)

    def gather(self, node, name, env) -> Interval:
        args = node.args
        op = env[args[0]]
        if name == "index":
            idx_nodes = [i for i in args[1] if i is not None]
        else:
            idx_nodes = [args[2]]
        if any(i.meta["val"].dtype == torch.bool for i in idx_nodes):
            raise Unsupported(f"{name} by a boolean mask (a data-dependent "
                              f"shape)")
        idxs = [env[i] for i in idx_nodes]
        taint = op.taint.union(*[i.taint for i in idxs])
        if all(i.exact for i in idxs):
            if name == "index":
                pick = lambda o: node.target(o, [
                    None if i is None else env[i].lo for i in args[1]])
            else:
                pick = lambda o: node.target(o, args[1], idxs[0].lo)
            return Interval(pick(op.lo), pick(op.hi), op.exact, taint)
        # an uncertain index: the hull over the whole operand
        shape = node.meta["val"].shape
        return Interval(op.lo.amin().expand(shape),
                        op.hi.amax().expand(shape), False, taint)


def interpret(gm, ins: List[Interval], device) -> Interval:
    """Run the abstract interpreter of ``gm`` on ``ins`` (the nine fields,
    then the wstate leaves, in the traced shapes)."""
    return _Interp(gm, device).run(ins)


# ------------------------------------------------------------- public API
def _per_walker(fn, cols: List[torch.Tensor]) -> torch.Tensor:
    """``fn`` on each walker's [1]-shaped inputs (``cols`` lead with the
    walker dim), vmapped over the walkers: a [W] result."""
    if cols[0].shape[0] == 0:
        return torch.zeros(0, device=cols[0].device)
    return torch.func.vmap(
        lambda *xs: fn(*(x.unsqueeze(0) for x in xs)).reshape(()))(*cols)


def _bound_cols(bi: BoundInputs, weighted: bool) -> List[torch.Tensor]:
    leaves = () if bi.wstate is None else tuple(bi.wstate)
    h = [bi.h_min.to(torch.float32), bi.h_max.to(torch.float32)] \
        if weighted else []
    return h + [bi.h_mean.to(torch.float32)] + [
        getattr(bi, f).to(torch.int64) for f in NODE_FIELDS] + list(leaves)


def _field_ivals(program: WalkProgram, device, h_min, h_max, node_vals,
                 leaves) -> List[Interval]:
    """The reference's ``_input_ivals`` + ``_wstate_ivals``: per-edge
    fields as intervals, node fields and wstate leaves as tainted
    points, in the traced order."""
    i64 = lambda v: torch.full((1,), v, dtype=torch.int64, device=device)
    if program.weighted:
        h = Interval(h_min, h_max, False, frozenset({"h"}))
    else:
        h = Interval.point(torch.ones(1, device=device))
    top = max(program.num_labels, 1) - 1
    vals = {"h": h, "label": Interval(i64(0), i64(top)),
            "dist": Interval(i64(0), i64(2)),
            "nbr": Interval(i64(0), i64(NBR_MAX))}
    for f, v in zip(NODE_FIELDS, node_vals):
        vals[f] = Interval.point(v, frozenset({f}))
    return [vals[f] for f in CTX_FIELDS] + [
        Interval.point(x, frozenset({"wstate"})) for x in leaves]


def analyze(program: WalkProgram, max_enum_labels: int = 8
            ) -> CompiledWorkload:
    """Run Flexi-Compiler on a walk program (or a legacy ``Workload``).
    Never raises: a rule that cannot be traced, or one with an op outside
    the abstract domain, gives FALLBACK (eRVS-only mode) and a warning
    naming it."""
    params = program.params()
    try:
        gm, leaves = trace_weight(program, params)
    except Exception as e:  # noqa: BLE001 — untraceable user code
        return CompiledWorkload(program, FALLBACK,
                                [f"get_weight not traceable: {e!r}"],
                                None, None)
    weighted = program.weighted

    def bound_one(device, *xs):
        k = 2 if weighted else 0
        h_min, h_max = (xs[0], xs[1]) if weighted else (None, None)
        node_vals = xs[k + 1:k + 1 + len(NODE_FIELDS)]
        ins = _field_ivals(program, device, h_min, h_max, node_vals,
                           xs[k + 1 + len(NODE_FIELDS):])
        return interpret(gm, ins, device)

    try:  # probe once for the flag (taint) and the domain
        one = lambda v, dt: torch.full((1,), v, dtype=dt)
        h = [one(1.0, torch.float32)] * (3 if weighted else 1)
        ints = [one(1, torch.int64)] * len(NODE_FIELDS)
        probe = bound_one(torch.device("cpu"), *h, *ints, *leaves)
        if probe.hi.numel() != 1:
            raise Unsupported(f"the rule gives {probe.hi.numel()} values "
                              f"for one edge")
    except Exception as e:  # noqa: BLE001 — outside the domain
        return CompiledWorkload(
            program, FALLBACK,
            [f"unsupported primitive in get_weight: {e} — eRVS-only mode"],
            None, None)
    flag = PER_STEP if probe.taint else PER_KERNEL

    def bound_fn(bi: BoundInputs) -> torch.Tensor:
        dev = bi.h_max.device
        out = _per_walker(lambda *xs: bound_one(dev, *xs).hi,
                          _bound_cols(bi, weighted))
        return torch.clamp_min(out, 0.0).to(torch.float32)

    num = max(program.num_labels, 1)
    dists = (0, 1, 2) if program.needs_dist else (1,)
    labels = (tuple(range(min(num, max_enum_labels)))
              if program.needs_labels else (0,))

    def sum_one(device, h, *rest):
        node_vals = rest[:len(NODE_FIELDS)]
        ws = rest[len(NODE_FIELDS):]
        i64 = lambda v: torch.full((1,), v, dtype=torch.int64,
                                   device=device)
        acc = torch.zeros(1, device=device)
        for d, lab in itertools.product(dists, labels):
            vals = {"h": h, "label": i64(lab), "dist": i64(d),
                    "nbr": i64(0), **dict(zip(NODE_FIELDS, node_vals))}
            ins = [Interval.point(vals[f]) for f in CTX_FIELDS] + [
                Interval.point(x) for x in ws]
            w = interpret(gm, ins, device).lo
            acc = acc + torch.clamp_min(w, 0.0)
        # a tensor divisor: the card divides a float32 by a Python
        # number as a multiply by its reciprocal
        mean_w = acc / torch.tensor(float(len(dists) * len(labels)),
                                    device=device)
        return mean_w * node_vals[0].clamp_min(0).to(torch.float32)

    def sum_fn(bi: BoundInputs) -> torch.Tensor:
        dev = bi.h_mean.device
        cols = _bound_cols(bi, weighted)[2 if weighted else 0:]
        if not weighted:
            cols[0] = torch.ones_like(cols[0])
        return _per_walker(lambda *xs: sum_one(dev, *xs), cols)

    return CompiledWorkload(program, flag, [], bound_fn, sum_fn)


# ------------------------------------------------- static-regime analysis
_TAINTS: Dict[int, Tuple[WalkProgram, Optional[FrozenSet[str]]]] = {}


def static_taint(program: WalkProgram) -> Optional[FrozenSet[str]]:
    """The set of inputs ``get_weight``'s output depends on, over every
    EdgeCtx field (each entered as an exact point tainted by its own
    name) and the wstate; None when the rule cannot be traced or leaves
    the abstract domain (treated as state-dependent).  Computed once per
    program object (the fused epoch asks at every launch)."""
    hit = _TAINTS.get(id(program))
    if hit is not None and hit[0] is program:
        return hit[1]
    taint = _static_taint(program)
    _TAINTS[id(program)] = (program, taint)
    return taint


def probe_taint(gm, leaves) -> FrozenSet[str]:
    """The taint of a traced rule's output with every field an exact point
    tainted by its own name; raises :class:`Unsupported` at the first op
    outside the abstract domain."""
    ctx = example_ctx()
    ins = [Interval.point(getattr(ctx, f), frozenset({f}))
           for f in CTX_FIELDS] + [
        Interval.point(x, frozenset({"wstate"})) for x in leaves]
    return interpret(gm, ins, torch.device("cpu")).taint


def _static_taint(program: WalkProgram) -> Optional[FrozenSet[str]]:
    try:
        return probe_taint(*trace_weight(program))
    except Exception:  # noqa: BLE001 — conservative: state-dependent
        return None


def is_static(program: WalkProgram) -> bool:
    """True iff the weight provably ignores the walk state — the gate of
    the precomputed (ITS / alias table) regime."""
    taint = static_taint(program)
    return taint is not None and not (taint & STATE_FIELDS)


#: per-edge fields the fused epoch does not build for a candidate edge
#: (it evaluates weights with dist=1, label=0): a weight that reads one of
#: them runs staged
FUSE_EDGE_EXCLUDED = frozenset({"dist", "label"})

#: inputs that are not node-local: a bound that reads one of them cannot
#: be baked into the per-node table the fused rejection regime reads
FUSE_BOUND_STATE = frozenset(
    {"dist", "label", "deg_prev", "prev", "step", "wstate"})


@dataclasses.dataclass(frozen=True)
class FuseReport:
    """Whether a walk program can run in the fused epoch (K4).

    ``weight_fusable``   the weight provably reads neither ``dist`` nor
                         ``label``;
    ``hooks_fusable``    it has no hooks, or its ``on_step`` keeps the
                         state's leaf shapes and dtypes and its
                         ``should_stop`` gives one flag per walker (K4 runs
                         the hand hook rule a program declares, else the
                         hooks ``rulegen`` generates, or raises naming
                         what it cannot lower);
    ``bound_node_local`` its bound depends on node-local inputs only, so
                         the rejection regime can read a baked per-node
                         table.

    ``fusable`` needs the first two; the rejection regime also the third.
    """

    weight_fusable: bool
    hooks_fusable: bool
    bound_node_local: bool
    reasons: Tuple[str, ...] = ()

    @property
    def fusable(self) -> bool:
        return self.weight_fusable and self.hooks_fusable


def fuse_report(program: WalkProgram) -> FuseReport:
    """What the fused epoch may run for ``program``, from the taint of its
    traced weight.  Never raises: a miss keeps the staged scan."""
    reasons: List[str] = []
    taint = static_taint(program)
    if taint is None:
        weight_fusable = bound_node_local = False
        reasons.append("get_weight not analyzable (trace failed or "
                       "unsupported primitive) — staged fallback")
    else:
        bad = sorted(taint & FUSE_EDGE_EXCLUDED)
        flagged = [f for f, need in (("dist", program.needs_dist),
                                     ("label", program.needs_labels))
                   if need]
        weight_fusable = not bad and not flagged
        if bad:
            reasons.append(f"get_weight depends on {', '.join(bad)} — the "
                           f"kernel cannot build these per candidate edge")
        elif flagged:
            reasons.append(f"program requests {', '.join(flagged)} "
                           f"payloads the kernel does not materialise")
        state = sorted(taint & FUSE_BOUND_STATE)
        bound_node_local = not state
        if state:
            reasons.append(f"bound depends on non-node-local inputs "
                           f"{state} — no baked per-node bound; rejection "
                           f"stays staged")
    hooks_fusable = True
    if program.has_hooks:
        try:
            _check_hooks(program)
        except Exception as e:  # noqa: BLE001 — a miss keeps staged
            hooks_fusable = False
            reasons.append(f"hooks not stageable: {e!r}")
    return FuseReport(weight_fusable=weight_fusable,
                      hooks_fusable=hooks_fusable,
                      bound_node_local=bound_node_local,
                      reasons=tuple(reasons))


def _check_hooks(program: WalkProgram) -> None:
    """Raise unless ``on_step`` maps the state of one walker onto leaves of
    the same shapes and dtypes and ``should_stop`` gives one flag for it
    (the reference's shape checks, on a batch of one)."""
    ws = program.init_wstate_batch(torch.zeros(1, dtype=torch.int64))
    one = lambda x, dtype=torch.int64: torch.full((1,), x, dtype=dtype)
    tctx = EdgeCtx(h=one(1.0, torch.float32), label=one(-1), dist=one(-1),
                   nbr=one(0), deg_cur=one(1), deg_prev=one(0), cur=one(0),
                   prev=one(-1), step=one(0))
    if program.on_step is not None:
        out = program.on_step(tctx, program.params(), ws)
        want = [(tuple(x.shape), x.dtype) for x in ws or ()]
        got = [(tuple(x.shape), x.dtype) for x in out or ()]
        if got != want:
            raise TypeError(f"on_step leaves {got} != {want}")
    if program.should_stop is not None:
        stop = program.should_stop(tctx, program.params(), ws)
        if tuple(stop.shape) != (1,):
            raise TypeError(f"should_stop gives shape {tuple(stop.shape)} "
                            f"for one walker, want (1,)")
