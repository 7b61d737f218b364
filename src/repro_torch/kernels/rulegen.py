"""Generated device rules: a program's traced weight as CUDA code (the
port's counterpart of the reference inlining ``program.edge_weight`` into
the TPU mega-step, ``repro/kernels/megastep_kernel.py:211`` / ``:255``).

:func:`lower` takes the ATen graph the Flexi-Compiler traces
(``core.flexi_compiler.trace_weight``) and lowers it, op by op, to a list
of scalar operations on one edge (:class:`LOp`): the edge's ``h``,
``label``, ``nbr`` and ``dist`` and the walker's ``deg_cur``,
``deg_prev``, ``cur``, ``prev`` and ``step``.  Shape ops on one value
vanish; a constant table (MetaPath's schema) stays a table that a scalar
index reads.  :func:`cuda_source` prints the list as a header defining

    template <class Dist> __device__ float generated_weight(
        const WalkerCtx& w, float h, long long label, long long nbr,
        Dist dist)

(``csrc/weights.cuh``, ``PROGRAM_GENERATED``): every float operation is
rounded on its own (``__fadd_rn`` / ``__fmul_rn`` / ``__fdiv_rn`` /
``__fsqrt_rn``), ``exp`` / ``log`` are XLA-CPU's (``csrc/xla_math.cuh``),
constants are hex-float literals and tables ``constexpr`` arrays;
``dist()`` is called once an edge, and only by a rule that reads it.
:func:`evaluate` runs the same list with torch on CPU tensors (``exp`` /
``log`` through ``ref.xla_exp`` / ``xla_log``), which the tests hold
against ``get_weight``.

Fields the plain path does not build read as it gives them: ``label`` is
0 unless the program ``needs_labels``, ``dist`` 1 unless it
``needs_dist``, ``h`` 1 for an unweighted program.  An op it cannot
lower, or a weight that reads ``wstate``, raises ``ValueError`` naming
it: such a program does not run on the card.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Dict, List, Tuple

import torch

from repro_torch.core import flexi_compiler as fc
from repro_torch.kernels.rules import GENERATED, KernelRule

#: (kind of LOp) for the ops with one float-or-integer rule
_BINARY = {"add": "add", "sub": "sub", "rsub": "rsub", "mul": "mul",
           "div": "div", "maximum": "max", "minimum": "min",
           "clamp_min": "max", "clamp_max": "min", "max": "max",
           "min": "min"}
_UNARY = {"neg": "neg", "abs": "abs", "exp": "exp", "log": "log",
          "sqrt": "sqrt", "floor": "floor", "ceil": "ceil"}
_FLOAT_ONLY = {"exp", "log", "sqrt", "floor", "ceil"}
_CMP = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
        "ge": ">="}
_LOGIC = {"logical_and": "and", "bitwise_and": "and", "logical_or": "or",
          "bitwise_or": "or", "logical_xor": "xor", "bitwise_xor": "xor",
          "logical_not": "not", "bitwise_not": "not"}
_IDENTITY = {"lift_fresh_copy", "clone", "alias", "detach", "contiguous",
             "view", "_unsafe_view", "reshape", "expand", "unsqueeze",
             "squeeze", "permute", "t", "transpose", "flip", "select",
             "slice", "amin", "amax", "any", "all", "sum"}
_WSTATE = ("rulegen cannot lower a weight that reads the program state "
           "wstate: its generated form is not written yet")
_DTYPES = (torch.float32, torch.int64, torch.int32, torch.bool)
_CTYPE = {torch.float32: "float", torch.int64: "long long",
          torch.int32: "int", torch.bool: "bool"}


@dataclasses.dataclass(frozen=True)
class LOp:
    """``v<out> = kind(args)`` of dtype ``dtype``.  Kinds: ``field`` (args:
    name), ``const`` (args: value), ``cast``, ``gather`` (args: table
    index, index value), the arithmetic of ``_BINARY`` / ``_UNARY``,
    ``cmp`` (args: C operator, a, b), ``and`` / ``or`` / ``xor`` /
    ``not``, ``where`` and ``rem`` / ``fmod``."""

    out: int
    kind: str
    args: Tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class Lowered:
    """A lowered rule: its ops, the value it returns, its constant tables
    (dtype, values) and the fields it reads."""

    ops: Tuple[LOp, ...]
    result: int
    tables: Tuple[Tuple[torch.dtype, Tuple], ...]
    reads: frozenset


class _Lowering:
    def __init__(self, program, gm):
        self.program, self.gm = program, gm
        self.ops: List[LOp] = []
        self.tables: List[Tuple[torch.dtype, Tuple]] = []
        self.reads = set()
        self.field_vals: Dict[str, int] = {}

    def emit(self, kind, args, dtype) -> int:
        if dtype not in _DTYPES:
            raise ValueError(f"rulegen cannot lower values of dtype {dtype}")
        self.ops.append(LOp(len(self.ops), kind, tuple(args), dtype))
        return len(self.ops) - 1

    def const(self, value, dtype) -> int:
        if dtype == torch.bool:
            value = bool(value)
        elif dtype.is_floating_point:
            value = float(torch.tensor(value, dtype=dtype))
        else:
            value = int(value)
        return self.emit("const", (value,), dtype)

    def cast(self, v: int, dtype) -> int:
        if self.ops[v].dtype == dtype:
            return v
        return self.emit("cast", (v,), dtype)

    def field(self, name: str) -> int:
        """The edge / walker field ``name`` as the plain path builds it."""
        if name not in self.field_vals:
            p = self.program
            if name == "label" and not p.needs_labels:
                v = self.const(0, torch.int64)
            elif name == "dist" and not p.needs_dist:
                v = self.const(1, torch.int64)
            elif name == "h" and not p.weighted:
                v = self.const(1.0, torch.float32)
            else:
                self.reads.add(name)
                v = self.emit("field", (name,),
                              torch.float32 if name == "h" else torch.int64)
            self.field_vals[name] = v
        return self.field_vals[name]

    # --------------------------------------------------------------- graph
    def run(self) -> Lowered:
        self.gm.graph.eliminate_dead_code()
        env = {}
        holders = [n for n in self.gm.graph.nodes if n.op == "placeholder"]
        fields = dict(zip(holders, fc.CTX_FIELDS))
        if any(n.users for n in holders[len(fc.CTX_FIELDS):]):
            raise ValueError(_WSTATE)
        result = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = ("field", fields.get(node))
            elif node.op == "get_attr":
                t = getattr(self.gm, node.target)
                env[node] = self.tensor_const(t)
            elif node.op == "call_function":
                env[node] = self.lower(node, env)
            elif node.op == "output":
                out = node.args[0]
                if isinstance(out, (tuple, list)):
                    out = out[0]
                result = self.scalar(env[out])
        result = self.emit("cast", (result,), torch.float32) \
            if self.ops[result].dtype != torch.float32 else result
        return Lowered(tuple(self.ops), result, tuple(self.tables),
                       frozenset(self.reads))

    def tensor_const(self, t: torch.Tensor):
        if t.numel() == 1:
            return ("value", self.const(t.reshape(()).item(), t.dtype))
        if t.dim() != 1 or t.dtype not in _DTYPES:
            raise ValueError(f"rulegen cannot lower a constant of shape "
                             f"{tuple(t.shape)} and dtype {t.dtype}")
        self.tables.append((t.dtype, tuple(t.tolist())))
        return ("table", len(self.tables) - 1)

    def scalar(self, val) -> int:
        """The value id of an env entry that holds one value per edge."""
        kind, x = val
        if kind == "field":
            if x is None:
                raise ValueError(_WSTATE)
            return self.field(x)
        if kind == "table":
            raise ValueError("rulegen cannot lower a constant table used as "
                             "a value (only a table indexed by one scalar)")
        return x

    def operand(self, arg, env, like_dtype=None) -> int:
        if isinstance(arg, torch.fx.Node):
            return self.scalar(env[arg])
        if isinstance(arg, (bool, int, float)):
            return self.const(arg, like_dtype or _py_dtype(arg))
        raise ValueError(f"rulegen cannot lower the operand {arg!r}")

    def lower(self, node, env):
        if node.target is operator.getitem:
            raise ValueError("rulegen cannot lower getitem of a "
                             "multi-output op")
        name = fc._op_name(node.target)
        args, kw = node.args, node.kwargs
        meta = node.meta.get("val")
        dtype = getattr(meta, "dtype", None)
        if name in _IDENTITY:
            src = env[args[0]] if isinstance(args[0], torch.fx.Node) \
                else None
            if src is not None and src[0] == "table":
                if name in ("lift_fresh_copy", "clone", "alias", "detach"):
                    return src
                raise ValueError(f"rulegen cannot lower {name} of a "
                                 f"constant table")
            if meta is not None and meta.numel() != 1:
                raise ValueError(f"rulegen cannot lower {name}: it gives "
                                 f"{meta.numel()} values for one edge")
            v = self.scalar(src)
            return ("value", self.cast(v, dtype) if dtype else v)
        if name in ("_to_copy", "to"):
            return ("value", self.cast(self.scalar(env[args[0]]),
                                       kw.get("dtype", dtype)))
        if name in ("add", "sub", "rsub") and kw.get("alpha", 1) != 1:
            raise ValueError(f"rulegen cannot lower {name} with alpha")
        if name == "div" and kw.get("rounding_mode") is not None:
            raise ValueError("rulegen cannot lower div with rounding_mode")
        if name in ("max", "min") and (
                len(args) != 2 or not isinstance(args[1], torch.fx.Node)):
            raise ValueError(f"rulegen cannot lower the reduction {name}")
        if name in _BINARY or name == "clamp":
            return ("value", self.arith(name, args, kw, env, dtype))
        if name in _UNARY:
            kind = _UNARY[name]
            a = self.operand(args[0], env)
            if kind in _FLOAT_ONLY:
                if dtype != torch.float32:
                    raise ValueError(f"rulegen cannot lower {name} of "
                                     f"{dtype}")
            return ("value", self.emit(kind, (self.cast(a, dtype),), dtype))
        if name == "pow":
            return ("value", self.power(args, env, dtype))
        if name in _CMP:
            a, b = self.binary_operands(args, env, _compute_dtype(args))
            return ("value", self.emit("cmp", (_CMP[name], a, b),
                                       torch.bool))
        if name in _LOGIC:
            kind = _LOGIC[name]
            if kind == "not":
                a = self.operand(args[0], env)
                if self.ops[a].dtype != torch.bool:
                    raise ValueError(f"rulegen cannot lower {name} of "
                                     f"{self.ops[a].dtype}")
                return ("value", self.emit("not", (a,), torch.bool))
            a, b = self.binary_operands(args, env, torch.bool)
            if dtype != torch.bool:
                raise ValueError(f"rulegen cannot lower {name} of {dtype}")
            return ("value", self.emit(kind, (a, b), torch.bool))
        if name == "where":
            c = self.operand(args[0], env)
            x, y = self.binary_operands(args[1:3], env, dtype)
            return ("value", self.emit("where", (c, x, y), dtype))
        if name in ("remainder", "fmod"):
            if dtype.is_floating_point:
                raise ValueError(f"rulegen cannot lower {name} of floats")
            a, b = self.binary_operands(args, env, dtype)
            return ("value", self.emit(
                "rem" if name == "remainder" else "fmod", (a, b), dtype))
        if name == "index":
            src = env[args[0]]
            idx = [i for i in args[1] if i is not None]
            if src[0] != "table" or len(args[1]) != 1 or len(idx) != 1:
                raise ValueError("rulegen cannot lower index other than a "
                                 "constant table read at one scalar")
            i = self.cast(self.scalar(env[idx[0]]), torch.int64)
            return ("value", self.emit("gather", (src[1], i),
                                       self.tables[src[1]][0]))
        if name in ("scalar_tensor", "full", "zeros", "ones", "zeros_like",
                    "ones_like", "full_like"):
            if meta is None or meta.numel() != 1:
                raise ValueError(f"rulegen cannot lower {name} of more "
                                 f"than one value")
            value = {"zeros": 0, "zeros_like": 0, "ones": 1,
                     "ones_like": 1}.get(name)
            if value is None:
                value = args[0] if name == "scalar_tensor" else args[1]
            return ("value", self.const(value, dtype))
        raise ValueError(f"rulegen cannot lower the op {name}")

    def binary_operands(self, args, env, dtype):
        """Both operands of a binary op, cast to ``dtype``."""
        like = next((self.ops[self.scalar(env[a])].dtype for a in args[:2]
                     if isinstance(a, torch.fx.Node)), None)
        a, b = (self.operand(x, env, dtype or like) for x in args[:2])
        return self.cast(a, dtype), self.cast(b, dtype)

    def arith(self, name, args, kw, env, dtype) -> int:
        if name == "clamp":
            x = self.cast(self.operand(args[0], env), dtype)
            bounds = [args[i] if i < len(args) else kw.get(k)
                      for i, k in ((1, "min"), (2, "max"))]
            for bnd, kind in zip(bounds, ("max", "min")):
                if bnd is not None:
                    b = self.cast(self.operand(bnd, env, dtype), dtype)
                    x = self.emit(kind, (x, b), dtype)
            return x
        kind = _BINARY[name]
        if kind == "div" and dtype != torch.float32:
            raise ValueError(f"rulegen cannot lower div to {dtype}")
        a, b = self.binary_operands(args, env, dtype)
        if kind == "rsub":
            kind, a, b = "sub", b, a
        return self.emit(kind, (a, b), dtype)

    def power(self, args, env, dtype) -> int:
        n = args[1]
        if not isinstance(n, int) or isinstance(n, bool) or n < 0 \
                or not isinstance(args[0], torch.fx.Node):
            raise ValueError("rulegen cannot lower pow other than a value "
                             "to a non-negative integer power")
        x = self.cast(self.operand(args[0], env), dtype)
        # the reference's integer_pow: binary exponentiation
        acc = None
        while n > 0:
            if n & 1:
                acc = x if acc is None else self.emit("mul", (acc, x), dtype)
            n >>= 1
            if n > 0:
                x = self.emit("mul", (x, x), dtype)
        return acc if acc is not None else self.const(1, dtype)


def _py_dtype(x):
    return (torch.bool if isinstance(x, bool) else torch.int64
            if isinstance(x, int) else torch.float32)


def _meta_or_scalar(a):
    if isinstance(a, torch.fx.Node):
        return a.meta["val"]
    return a


def _compute_dtype(args):
    """The dtype torch compares two operands in."""
    a, b = (_meta_or_scalar(x) for x in args[:2])
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    return torch.result_type(a, b)


def lower(program, params=None) -> Lowered:
    """The program's weight as a :class:`Lowered` op list; raises
    ``ValueError`` naming the op or field it cannot lower."""
    try:
        gm, leaves = fc.trace_weight(program, params)
    except Exception as e:
        raise ValueError(f"rulegen: the weight of {program.name!r} cannot "
                         f"be traced: {e!r}") from e
    try:
        fc.probe_taint(gm, leaves)
    except fc.Unsupported as e:  # outside the analysis: name the op
        raise ValueError(f"program {program.name!r}: rulegen cannot lower "
                         f"the op {e}") from e
    try:
        return _Lowering(program, gm).run()
    except ValueError as e:
        raise ValueError(f"program {program.name!r}: {e}") from e


# ------------------------------------------------------------------ CUDA
def _literal(value, dtype) -> str:
    if dtype == torch.bool:
        return "true" if value else "false"
    if dtype == torch.float32:
        if value != value:
            return "__int_as_float(0x7fc00000)"
        if value in (float("inf"), float("-inf")):
            return ("__int_as_float(0x7f800000)" if value > 0
                    else "__int_as_float(0xff800000)")
        return f"{float(value).hex()}f"
    if dtype == torch.int64:
        return f"{int(value)}LL"
    return f"{int(value)}"


_F32 = {"add": "__fadd_rn", "sub": "__fsub_rn", "mul": "__fmul_rn",
        "div": "__fdiv_rn", "max": "fmaxf", "min": "fminf"}
_F32_UNARY = {"exp": "xla_exp", "log": "xla_log", "sqrt": "__fsqrt_rn",
              "floor": "floorf", "ceil": "ceilf", "abs": "fabsf"}
_FIELD_C = {"h": "h", "label": "label", "nbr": "nbr", "dist": "d_",
            "deg_cur": "static_cast<long long>(w.deg_cur)",
            "deg_prev": "static_cast<long long>(w.deg_prev)",
            "cur": "static_cast<long long>(w.cur)",
            "prev": "static_cast<long long>(w.prev)",
            "step": "static_cast<long long>(w.step)"}


def _cast_c(src: str, frm, to) -> str:
    if to == torch.bool:
        return f"({src} != 0)"
    if frm == torch.bool:
        return f"({src} ? {_literal(1, to)} : {_literal(0, to)})"
    if to == torch.float32:
        return (f"__ll2float_rn({src})" if frm == torch.int64
                else f"__int2float_rn({src})")
    return f"static_cast<{_CTYPE[to]}>({src})"


def _op_c(op: LOp, low: Lowered, dtypes: Dict[int, torch.dtype]) -> str:
    t, a = op.dtype, op.args
    v = lambda i: f"v{i}"
    if op.kind == "field":
        return _FIELD_C[a[0]]
    if op.kind == "const":
        return _literal(a[0], t)
    if op.kind == "cast":
        return _cast_c(v(a[0]), dtypes[a[0]], t)
    if op.kind == "cmp":
        return f"({v(a[1])} {a[0]} {v(a[2])})"
    if op.kind in ("and", "or", "xor"):
        sym = {"and": "&&", "or": "||", "xor": "!="}[op.kind]
        return f"({v(a[0])} {sym} {v(a[1])})"
    if op.kind == "not":
        return f"(!{v(a[0])})"
    if op.kind == "where":
        return f"({v(a[0])} ? {v(a[1])} : {v(a[2])})"
    if op.kind == "gather":
        n = len(low.tables[a[0]][1])
        i = v(a[1])
        return f"kTable{a[0]}[{i} < 0 ? max({i} + {n}LL, 0LL) : " \
               f"min({i}, {n - 1}LL)]"
    x = v(a[0])
    y = v(a[1]) if len(a) > 1 else None
    if t == torch.float32:
        if op.kind in _F32:
            return f"{_F32[op.kind]}({x}, {y})"
        if op.kind == "neg":
            return f"(-{x})"
        return f"{_F32_UNARY[op.kind]}({x})"
    ctype = _CTYPE[t]
    u = "unsigned long long" if t == torch.int64 else "unsigned int"
    if op.kind in ("add", "sub", "mul"):
        # through the unsigned type: wraps as torch's integers do
        sym = {"add": "+", "sub": "-", "mul": "*"}[op.kind]
        return (f"static_cast<{ctype}>(static_cast<{u}>({x}) {sym} "
                f"static_cast<{u}>({y}))")
    if op.kind == "neg":
        return f"static_cast<{ctype}>(0u - static_cast<{u}>({x}))"
    if op.kind == "abs":
        return f"({x} < 0 ? static_cast<{ctype}>(0u - static_cast<{u}>(" \
               f"{x})) : {x})"
    if op.kind in ("max", "min"):
        sym = ">" if op.kind == "max" else "<"
        return f"({x} {sym} {y} ? {x} : {y})"
    if op.kind == "fmod":
        return f"({y} == 0 ? 0 : {x} % {y})"
    if op.kind == "rem":  # floored: the sign of the divisor
        r = f"({x} % {y})"
        return (f"({y} == 0 ? 0 : ({r} != 0 && (({r} < 0) != ({y} < 0)) ? "
                f"{r} + {y} : {r}))")
    raise ValueError(f"rulegen: no CUDA form of {op.kind} on {t}")


def cuda_source(low: Lowered, name: str = "") -> str:
    """The generated header ``csrc/weights.cuh`` includes for a
    ``PROGRAM_GENERATED`` rule."""
    dtypes = {op.out: op.dtype for op in low.ops}
    lines = [f"// Generated by repro_torch/kernels/rulegen.py from the "
             f"traced weight of {name or 'a walk program'}.",
             "#pragma once", "namespace repro {"]
    for f in ("label", "nbr", "dist", "deg_prev"):
        flag = f in low.reads or (f == "nbr" and "dist" in low.reads)
        lines.append(f"constexpr bool kGenReads{_camel(f)} = "
                     f"{'true' if flag else 'false'};")
    lines += ["template <class Dist>",
              "__device__ __forceinline__ float generated_weight(",
              "    const WalkerCtx& w, float h, long long label, long long "
              "nbr, Dist dist) {",
              "  (void)w; (void)h; (void)label; (void)nbr;"]
    for i, (dtype, vals) in enumerate(low.tables):
        body = ", ".join(_literal(x, dtype) for x in vals)
        lines.append(f"  constexpr {_CTYPE[dtype]} kTable{i}[{len(vals)}] "
                     f"= {{{body}}};")
    if "dist" in low.reads:
        lines.append("  const long long d_ = static_cast<long long>("
                     "dist());")
    else:
        lines.append("  (void)dist;")
    for op in low.ops:
        lines.append(f"  const {_CTYPE[op.dtype]} v{op.out} = "
                     f"{_op_c(op, low, dtypes)};")
    lines += [f"  return v{low.result};", "}", "}  // namespace repro", ""]
    return "\n".join(lines)


def _camel(f: str) -> str:
    return "".join(p.capitalize() for p in f.split("_"))


# ------------------------------------------------------- plain evaluator
def evaluate(low: Lowered, ctx) -> torch.Tensor:
    """The lowered rule on an :class:`EdgeCtx` block with torch (the plain
    version of ``generated_weight``): one float32 value per edge, before
    the clamp at 0."""
    from repro_torch.kernels import ref

    shape = ctx.h.shape
    dev = ctx.h.device
    vals: Dict[int, torch.Tensor] = {}
    for op in low.ops:
        a, t = op.args, op.dtype
        x = lambda i: vals[a[i]]
        if op.kind == "field":
            r = getattr(ctx, a[0]).to(t)
        elif op.kind == "const":
            r = torch.full(shape, a[0], dtype=t, device=dev)
        elif op.kind == "cast":
            r = x(0).to(t)
        elif op.kind == "cmp":
            r = {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
                 "<=": torch.le, ">": torch.gt, ">=": torch.ge}[a[0]](
                     vals[a[1]], vals[a[2]])
        elif op.kind in ("and", "or", "xor"):
            r = {"and": torch.logical_and, "or": torch.logical_or,
                 "xor": torch.logical_xor}[op.kind](x(0), x(1))
        elif op.kind == "not":
            r = torch.logical_not(x(0))
        elif op.kind == "where":
            r = torch.where(x(0), x(1), x(2))
        elif op.kind == "gather":
            dtype, table = low.tables[a[0]]
            tab = torch.tensor(table, dtype=dtype, device=dev)
            n = len(table)
            i = x(1)
            i = torch.where(i < 0, (i + n).clamp_min(0), i.clamp_max(n - 1))
            r = tab[i]
        elif op.kind in ("add", "sub", "mul", "div", "max", "min"):
            fn = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
                  "div": torch.div, "max": torch.maximum,
                  "min": torch.minimum}[op.kind]
            r = fn(x(0), x(1))
        elif op.kind == "neg":
            r = torch.neg(x(0))
        elif op.kind == "abs":
            r = torch.abs(x(0))
        elif op.kind == "exp":
            r = ref.xla_exp(x(0))
        elif op.kind == "log":
            r = ref.xla_log(x(0))
        elif op.kind == "sqrt":
            r = fc.sqrt_rn(x(0))
        elif op.kind in ("floor", "ceil"):
            r = getattr(torch, op.kind)(x(0))
        elif op.kind in ("rem", "fmod"):
            den = x(1)
            safe = torch.where(den == 0, torch.ones_like(den), den)
            fn = torch.remainder if op.kind == "rem" else torch.fmod
            r = torch.where(den == 0, torch.zeros_like(den), fn(x(0), safe))
        else:
            raise ValueError(f"rulegen: no plain form of {op.kind}")
        vals[op.out] = r.to(t).expand(shape)
    return vals[low.result]


# ----------------------------------------------------------- kernel rule
_CACHE: Dict[Tuple[int, int], Tuple[object, object, KernelRule]] = {}


def generated_rule(program, params) -> KernelRule:
    """The program's weight as a generated :class:`KernelRule` (its header
    in ``header``), built once per (program, params) object; raises
    ``ValueError`` naming what cannot be lowered."""
    key = (id(program), id(params))
    hit = _CACHE.get(key)
    if hit is not None and hit[0] is program and hit[1] is params:
        return hit[2]
    low = lower(program, params)
    rule = KernelRule(GENERATED, bool(program.weighted),
                      header=cuda_source(low, program.name))
    _CACHE[key] = (program, params, rule)
    return rule
