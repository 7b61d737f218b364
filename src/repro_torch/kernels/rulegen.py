"""Generated device rules: a program's traced weight, and its hooks, as
CUDA code (the port's counterpart of the reference inlining
``program.edge_weight`` into the TPU mega-step,
``repro/kernels/megastep_kernel.py:211`` / ``:255``, and its ``on_step``
/ ``should_stop``, ``:344-361``).

:func:`lower` takes the ATen graph the Flexi-Compiler traces
(``core.flexi_compiler.trace_weight``) and lowers it, op by op, to a list
of scalar operations on one edge (:class:`LOp`): the edge's ``h``,
``label``, ``nbr`` and ``dist``, the walker's ``deg_cur``, ``deg_prev``,
``cur``, ``prev`` and ``step``, and its ``wstate`` leaves.  Shape ops on
one value vanish; a constant table (MetaPath's schema) stays a table that
a scalar index reads.  A leaf is one value a walker or a vector of a fixed
width (visited_avoiding's ring): a vector stays a tuple of scalar values,
so that an elementwise op on it is one op an element, a compare against
a broadcast scalar likewise, ``any`` / ``all`` / ``sum`` / ``amax`` /
``amin`` over its last dim a chain of fixed length and ``index`` at a
scalar a pick of one element.  The walker dim of the [1]-shaped trace is
not a data dim: ``reshape`` / ``unsqueeze`` / ``expand`` that keep a
vector's values in its last dim are identities, and ``arange`` over it
indexes the walker itself.  :func:`lower_hooks` lowers ``on_step`` (one
value or vector a leaf: ``clone`` then ``index_put`` of a slot is a pick
an element) and ``should_stop`` (one bool) on the transition ctx (``h`` 1,
``label`` and ``dist`` -1).  :func:`cuda_source` prints the lists as a
header defining

    struct GenState;  // one walker's leaves: scalars, vector row pointers
    template <class W, class Dist> __device__ float generated_weight(
        const W& w, float h, long long label, long long nbr, Dist dist)
    __device__ void generated_on_step(const HookCtx& t, GenState& s,
                                      bool writer)
    __device__ bool generated_should_stop(const HookCtx& t,
                                          const GenState& s)

(``csrc/weights.cuh``, ``PROGRAM_GENERATED`` and ``HOOK_GENERATED``):
every float operation is rounded on its own (``__fadd_rn`` /
``__fmul_rn`` / ``__fdiv_rn`` / ``__fsqrt_rn``), ``exp`` / ``log`` are
XLA-CPU's (``csrc/xla_math.cuh``), constants are hex-float literals and
tables ``constexpr`` arrays; ``dist()`` is called once an edge, and only
by a rule that reads it; ``generated_on_step`` computes every new value
before it commits one.  :func:`evaluate` runs the same lists with torch on
CPU tensors (``exp`` / ``log`` through ``ref.xla_exp`` / ``xla_log``),
which the tests hold against ``get_weight``, ``on_step`` and
``should_stop``.

Fields the plain path does not build read as it gives them: ``label`` is
0 unless the program ``needs_labels``, ``dist`` 1 unless it
``needs_dist``, ``h`` 1 for an unweighted program.  An op it cannot
lower, a float sum over a leaf (torch's order of additions is not a
chain's), a leaf of another dtype than int32 / int64 / float32 / bool or
wider than ``rules.MAX_GEN_WIDTH``, raises ``ValueError`` naming it: such
a program does not run on the card.
"""
from __future__ import annotations

import collections
import dataclasses
import operator
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import flexi_compiler as fc
from repro_torch.kernels.rules import (GENERATED, HOOK_GENERATED,
                                       MAX_GEN_LEAVES, MAX_GEN_WIDTH,
                                       HookRule, KernelRule)

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
#: shape ops a vector passes through while its values stay in its last dim
_VEC_SHAPE = {"lift_fresh_copy", "clone", "alias", "detach", "contiguous",
              "view", "_unsafe_view", "reshape", "expand", "unsqueeze",
              "squeeze"}
_REDUCE = {"amin", "amax", "any", "all", "sum"}
#: identities on one value
_IDENTITY = _VEC_SHAPE | _REDUCE | {"permute", "t", "transpose", "flip",
                                    "select", "slice"}
_DTYPES = (torch.float32, torch.int64, torch.int32, torch.bool)
_CTYPE = {torch.float32: "float", torch.int64: "long long",
          torch.int32: "int", torch.bool: "bool"}
#: the transition ctx's per-edge placeholders (``ctxutil.transition_ctx``)
_TCTX_CONST = {"h": (1.0, torch.float32), "label": (-1, torch.int64),
               "dist": (-1, torch.int64)}
_KINDS = ("weight", "on_step", "should_stop")


@dataclasses.dataclass(frozen=True)
class LOp:
    """``v<out> = kind(args)`` of dtype ``dtype``.  Kinds: ``field`` (args:
    name), ``leaf`` (args: leaf, element or None for a scalar leaf),
    ``const`` (args: value), ``cast``, ``gather`` (args: table index,
    index value), ``pick`` (args: index value, then the elements it
    picks from), the arithmetic of ``_BINARY`` / ``_UNARY``, ``cmp``
    (args: C operator, a, b), ``and`` / ``or`` / ``xor`` / ``not``,
    ``where`` and ``rem`` / ``fmod``."""

    out: int
    kind: str
    args: Tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class Lowered:
    """A lowered weight or hook: its ops, what it returns, its constant
    tables (dtype, values), the ctx fields and wstate leaves it reads, and
    the program's leaves (``flexi_compiler.LeafSpec``).  ``kind``
    ``weight`` (``result``: one float32 value), ``on_step`` (a value id a
    scalar leaf, a tuple of ids a vector leaf) or ``should_stop`` (one
    bool)."""

    ops: Tuple[LOp, ...]
    result: object
    tables: Tuple[Tuple[torch.dtype, Tuple], ...]
    reads: frozenset
    leaves: Tuple = ()
    reads_leaves: frozenset = frozenset()
    kind: str = "weight"


@dataclasses.dataclass(frozen=True)
class LoweredHooks:
    """A program's lowered ``on_step`` and ``should_stop`` (None where it
    has no such hook) over its leaves."""

    on_step: Optional[Lowered]
    should_stop: Optional[Lowered]
    leaves: Tuple


def _leaf_width(spec) -> int:
    return spec.shape[0] if spec.shape else 0


def check_leaf(i: int, spec) -> None:
    """Raise unless a generated rule can hold leaf ``i``."""
    where = f"wstate leaf {i}"
    if i >= MAX_GEN_LEAVES:
        raise ValueError(f"rulegen cannot lower {where}: a generated rule "
                         f"holds at most {MAX_GEN_LEAVES} leaves")
    if spec.dtype not in _DTYPES:
        raise ValueError(f"rulegen cannot lower {where} of dtype "
                         f"{spec.dtype} (int32, int64, float32 or bool)")
    if len(spec.shape) > 1:
        raise ValueError(f"rulegen cannot lower {where} of per-walker shape "
                         f"{spec.shape} (one value or one vector a walker)")
    if _leaf_width(spec) > MAX_GEN_WIDTH:
        raise ValueError(f"rulegen cannot lower {where} of width "
                         f"{_leaf_width(spec)}: a generated rule holds at "
                         f"most {MAX_GEN_WIDTH} values a leaf")


class _Lowering:
    def __init__(self, program, gm, leaves=(), kind="weight"):
        self.program, self.gm, self.leaves, self.kind = (program, gm,
                                                         leaves, kind)
        self.ops: List[LOp] = []
        self.tables: List[Tuple[torch.dtype, Tuple]] = []
        self.reads = set()
        self.reads_leaves = set()
        self.field_vals: Dict[str, int] = {}
        self.leaf_vals: Dict[Tuple[int, Optional[int]], int] = {}

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
            if self.kind != "weight" and name in _TCTX_CONST:
                v = self.const(*_TCTX_CONST[name])
            elif name == "label" and not p.needs_labels:
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

    def leaf(self, i: int):
        """Leaf ``i`` of the walker: one value, or a vector of values."""
        spec = self.leaves[i]
        check_leaf(i, spec)
        self.reads_leaves.add(i)

        def elem(j):
            if (i, j) not in self.leaf_vals:
                self.leaf_vals[i, j] = self.emit("leaf", (i, j), spec.dtype)
            return self.leaf_vals[i, j]
        if not spec.shape:
            return ("value", elem(None))
        return ("vec", tuple(elem(j) for j in range(_leaf_width(spec))))

    def resolve(self, val):
        kind, x = val
        if kind == "field":
            return ("value", self.field(x))
        if kind == "leaf":
            return self.leaf(x)
        return val

    # --------------------------------------------------------------- graph
    def run(self) -> Lowered:
        self.gm.graph.eliminate_dead_code()
        env = {}
        holders = [n for n in self.gm.graph.nodes if n.op == "placeholder"]
        n = len(fc.CTX_FIELDS)
        for k, node in enumerate(holders):
            env[node] = (("field", fc.CTX_FIELDS[k]) if k < n
                         else ("leaf", k - n))
        out = None
        for node in self.gm.graph.nodes:
            if node.op == "get_attr":
                env[node] = self.tensor_const(getattr(self.gm, node.target))
            elif node.op == "call_function":
                env[node] = self.lower(node, env)
            elif node.op == "output":
                out = node.args[0]
        if self.kind == "on_step":
            result = self.new_leaves(out, env)
        else:
            if isinstance(out, (tuple, list)):
                out = out[0]
            want = torch.float32 if self.kind == "weight" else torch.bool
            result = self.cast(self.scalar(env[out]), want)
        return Lowered(tuple(self.ops), result, tuple(self.tables),
                       frozenset(self.reads), tuple(self.leaves),
                       frozenset(self.reads_leaves), self.kind)

    def new_leaves(self, out, env) -> Tuple:
        """on_step's new value of each leaf, cast to the leaf's dtype."""
        out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        if len(out) != len(self.leaves):
            raise ValueError(f"on_step gives {len(out)} leaves for "
                             f"{len(self.leaves)}")
        result = []
        for i, (node, spec) in enumerate(zip(out, self.leaves)):
            check_leaf(i, spec)
            val = self.resolve(env[node])
            if not spec.shape:
                result.append(self.cast(self.scalar(val), spec.dtype))
                continue
            if val[0] != "vec" or len(val[1]) != _leaf_width(spec):
                raise ValueError(f"on_step's wstate leaf {i} is not a vector "
                                 f"of {_leaf_width(spec)} values a walker")
            result.append(tuple(self.cast(e, spec.dtype) for e in val[1]))
        return tuple(result)

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
        kind, x = self.resolve(val)
        if kind == "vec":
            raise ValueError(f"rulegen cannot lower a vector of {len(x)} "
                             f"wstate values where one value is wanted")
        if kind == "table":
            raise ValueError("rulegen cannot lower a constant table used as "
                             "a value (only a table indexed by one scalar)")
        if kind == "walker":
            raise ValueError("rulegen cannot lower arange over the walker "
                             "dim used as a value (only as an index)")
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
        if name == "arange":
            meta = node.meta.get("val")
            if meta is None or meta.numel() != 1:
                raise ValueError("rulegen cannot lower arange other than "
                                 "over the walker dim")
            return ("walker", None)
        if name == "index_put":
            return self.index_put(node, env)
        if name == "index":
            return self.index(node, env)
        vecs = [a for a in _node_args(node)
                if self.resolve(env[a])[0] == "vec"]
        if vecs:
            return self.vector_op(node, name, env, vecs)
        return self.lower_scalar(node, name, env)

    # ------------------------------------------------------------ vectors
    def vector_op(self, node, name, env, vecs):
        """An op with a wstate vector among its operands."""
        meta = node.meta.get("val")
        src = self.resolve(env[node.args[0]]) \
            if isinstance(node.args[0], torch.fx.Node) else None
        width = len(self.resolve(env[vecs[0]])[1])
        if name in _VEC_SHAPE and src is not None and src[0] == "vec":
            if meta is None or meta.numel() != width \
                    or meta.shape[-1] != width:
                raise ValueError(f"rulegen cannot lower {name} of a wstate "
                                 f"vector to shape {tuple(meta.shape)}: its "
                                 f"values must stay in the last dim")
            return ("vec", tuple(self.cast(e, meta.dtype) for e in src[1]))
        if name in _REDUCE and src is not None and src[0] == "vec":
            return ("value", self.reduce(node, name, src[1]))
        if name in ("select", "slice") and src is not None \
                and src[0] == "vec":
            return self.vec_part(node, name, src[1])
        if name in _IDENTITY:
            raise ValueError(f"rulegen cannot lower {name} of a wstate "
                             f"vector")
        if any(len(self.resolve(env[a])[1]) != width for a in vecs):
            raise ValueError(f"rulegen cannot lower {name} of wstate "
                             f"vectors of different widths")
        ids = []
        for j in range(width):  # one op an element
            over = {a: ("value", self.resolve(env[a])[1][j]) for a in vecs}
            ids.append(self.scalar(self.lower_scalar(
                node, name, collections.ChainMap(over, env))))
        return ("vec", tuple(ids))

    def reduce(self, node, name, elems) -> int:
        """``name`` over a vector's last dim: a chain of fixed length."""
        args, kw = node.args, node.kwargs
        dims = args[1] if len(args) > 1 else kw.get("dim")
        rank = args[0].meta["val"].dim()
        if dims is None:
            raise ValueError(f"rulegen cannot lower {name} over every dim of "
                             f"a wstate vector (the walker dim included)")
        dims = [dims] if isinstance(dims, int) else list(dims)
        if [d % rank for d in dims] != [rank - 1]:
            raise ValueError(f"rulegen cannot lower {name} of a wstate "
                             f"vector over dims {dims}: only its last dim")
        dtype = node.meta["val"].dtype
        if name == "sum" and dtype.is_floating_point:
            raise ValueError("rulegen cannot lower a float sum over a wstate "
                             "vector: torch's order of additions is not a "
                             "chain's")
        kind, cdt = {"sum": ("add", dtype), "any": ("or", torch.bool),
                     "all": ("and", torch.bool), "amax": ("max", dtype),
                     "amin": ("min", dtype)}[name]
        acc = self.cast(elems[0], cdt)
        for e in elems[1:]:
            acc = self.emit(kind, (acc, self.cast(e, cdt)), cdt)
        return self.cast(acc, dtype)

    def vec_part(self, node, name, elems):
        """``select`` / ``slice`` of a vector along its last dim."""
        args = node.args
        rank = args[0].meta["val"].dim()
        dim = (args[1] if len(args) > 1 else 0) % rank
        if dim != rank - 1:
            raise ValueError(f"rulegen cannot lower {name} of a wstate vector "
                             f"along the walker dim")
        if name == "select":
            return ("value", elems[args[2]])
        start = args[2] if len(args) > 2 else None
        end = args[3] if len(args) > 3 else None
        step = args[4] if len(args) > 4 else 1
        return ("vec", tuple(elems[start:end:step]))

    def index(self, node, env):
        """``index`` of a constant table, or of a wstate vector at one
        scalar (its other dims indexed by the walker)."""
        args = node.args
        meta = node.meta.get("val")
        src = self.resolve(env[args[0]])
        idx = list(args[1])
        if src[0] == "table":
            picks = [i for i in idx if i is not None]
            if len(idx) != 1 or len(picks) != 1:
                raise ValueError("rulegen cannot lower index other than a "
                                 "constant table read at one scalar")
            i = self.cast(self.scalar(env[picks[0]]), torch.int64)
            return ("value", self.emit("gather", (src[1], i),
                                       self.tables[src[1]][0]))
        at = self.slot(idx, args[0].meta["val"].dim(), src, env, "index")
        if src[0] != "vec":
            return ("value", self.scalar(src))
        if at is None:
            return src
        k = self.cast(self.scalar(env[at]), torch.int64)
        return ("value", self.emit("pick", (k,) + src[1], meta.dtype))

    def slot(self, idx, rank: int, val, env, op: str):
        """The slot an index list ``idx`` names in a walker's value ``val``
        (of ``rank`` traced dims): every dim but a vector's last must be
        the walker's (``arange`` over it, or ``None``); the node indexing a
        vector's last dim, or None for the whole value."""
        vec = val[0] == "vec"
        walker = idx[:rank - 1] if vec else idx
        if len(idx) > rank or any(
                i is not None and self.resolve(env[i])[0] != "walker"
                for i in walker):
            raise ValueError(f"rulegen cannot lower {op} other than at the "
                             f"walker (arange over its dim) and one scalar "
                             f"slot")
        return idx[rank - 1] if vec and len(idx) == rank else None

    def index_put(self, node, env):
        """``index_put`` of one slot (or of the whole) of a walker's leaf
        value: each element picks the new value where the slot is its
        own."""
        args, kw = node.args, node.kwargs
        acc = args[3] if len(args) > 3 else kw.get("accumulate", False)
        if acc:
            raise ValueError("rulegen cannot lower index_put with "
                             "accumulate")
        base = self.resolve(env[args[0]])
        dtype = node.meta["val"].dtype
        v = self.cast(self.operand(args[2], env, dtype), dtype)
        at = self.slot(list(args[1]), args[0].meta["val"].dim(), base, env,
                       "index_put")
        if base[0] != "vec":
            self.scalar(base)
            return ("value", v)
        width = len(base[1])
        if at is None:
            return ("vec", (v,) * width)
        k = self.cast(self.scalar(env[at]), torch.int64)
        neg = self.emit("cmp", ("<", k, self.const(0, torch.int64)),
                        torch.bool)
        k = self.emit("where", (neg, self.emit(
            "add", (k, self.const(width, torch.int64)), torch.int64), k),
            torch.int64)
        out = []
        for j, e in enumerate(base[1]):
            hit = self.emit("cmp", ("==", k, self.const(j, torch.int64)),
                            torch.bool)
            out.append(self.emit("where", (hit, v, self.cast(e, dtype)),
                                 dtype))
        return ("vec", tuple(out))

    # ------------------------------------------------------------- values
    def lower_scalar(self, node, name, env):
        args, kw = node.args, node.kwargs
        meta = node.meta.get("val")
        dtype = getattr(meta, "dtype", None)
        if name in _IDENTITY:
            src = self.resolve(env[args[0]]) \
                if isinstance(args[0], torch.fx.Node) else None
            if src is not None and src[0] == "table":
                if name in ("lift_fresh_copy", "clone", "alias", "detach"):
                    return src
                raise ValueError(f"rulegen cannot lower {name} of a "
                                 f"constant table")
            v = self.scalar(src)
            v = self.cast(v, dtype) if dtype else v
            if meta is not None and meta.numel() != 1:
                width = meta.numel()
                if name in _VEC_SHAPE and meta.shape[-1] == width:
                    return ("vec", (v,) * width)  # broadcast to a vector
                raise ValueError(f"rulegen cannot lower {name}: it gives "
                                 f"{meta.numel()} values for one edge")
            return ("value", v)
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
        raise ValueError(f"rulegen cannot lower the op {name}"
                         + _leaf_note(node))

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


def _node_args(node) -> List[torch.fx.Node]:
    """The fx nodes among a node's arguments (in lists too)."""
    out = []
    for a in list(node.args) + list(node.kwargs.values()):
        for x in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(x, torch.fx.Node):
                out.append(x)
    return out


def _leaf_note(node) -> str:
    """" (on wstate leaf i, ...)" where the node's value depends on
    leaves, for an error that names the op."""
    holders = [n for n in node.graph.nodes if n.op == "placeholder"]
    leaf_of = {h: i - len(fc.CTX_FIELDS) for i, h in enumerate(holders)
               if i >= len(fc.CTX_FIELDS)}
    seen, todo, found = set(), [node], set()
    while todo:
        n = todo.pop()
        if n in seen:
            continue
        seen.add(n)
        if n in leaf_of:
            found.add(leaf_of[n])
        todo.extend(n.all_input_nodes)
    if not found:
        return ""
    return " (on wstate leaf " + ", ".join(map(str, sorted(found))) + ")"


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
    ``ValueError`` naming the op, field or leaf it cannot lower."""
    try:
        gm, leaves = fc.trace_weight(program, params)
    except Exception as e:
        raise ValueError(f"rulegen: the weight of {program.name!r} cannot "
                         f"be traced: {e!r}") from e
    try:
        low = _Lowering(program, gm, fc.leaf_specs(leaves)).run()
    except ValueError as e:
        raise ValueError(f"program {program.name!r}: {e}") from e
    try:
        fc.probe_taint(gm, leaves)
    except fc.Unsupported as e:  # outside the analysis: name the op
        raise ValueError(f"program {program.name!r}: rulegen cannot lower "
                         f"the op {e}") from e
    return low


def lower_hooks(program, params=None) -> LoweredHooks:
    """The program's ``on_step`` and ``should_stop`` as op lists on the
    transition ctx; raises ``ValueError`` naming the hook and the op or
    leaf it cannot lower.  Every leaf must be one a generated rule holds
    (K4 carries them all)."""
    try:
        tr = fc.trace_hooks(program, params)
    except Exception as e:
        raise ValueError(f"rulegen: the hooks of {program.name!r} cannot "
                         f"be traced: {e!r}") from e
    lowered = []
    for kind in ("on_step", "should_stop"):
        gm = getattr(tr, kind)
        try:
            for i, spec in enumerate(tr.leaves):
                check_leaf(i, spec)
            lowered.append(None if gm is None else
                           _Lowering(program, gm, tr.leaves, kind).run())
        except ValueError as e:
            raise ValueError(f"program {program.name!r}, {kind}: {e}") from e
    return LoweredHooks(*lowered, tr.leaves)


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
#: the fields of the transition ctx (``HookCtx``) a hook reads
_HOOK_FIELD_C = {f: f"static_cast<long long>(t.{f})"
                 for f in ("nbr", "deg_cur", "deg_prev", "cur", "prev",
                           "step")}


def _cast_c(src: str, frm, to) -> str:
    if to == torch.bool:
        return f"({src} != 0)"
    if frm == torch.bool:
        return f"({src} ? {_literal(1, to)} : {_literal(0, to)})"
    if to == torch.float32:
        return (f"__ll2float_rn({src})" if frm == torch.int64
                else f"__int2float_rn({src})")
    return f"static_cast<{_CTYPE[to]}>({src})"


def _is_row(low: Lowered, elems) -> Optional[int]:
    """The leaf whose elements 0, 1, ... ``elems`` are, or None."""
    first = low.ops[elems[0]]
    if first.kind != "leaf":
        return None
    i = first.args[0]
    ok = all(low.ops[e].kind == "leaf" and low.ops[e].args == (i, j)
             for j, e in enumerate(elems))
    return i if ok else None


def _op_c(op: LOp, low: Lowered, dtypes: Dict[int, torch.dtype]) -> str:
    t, a = op.dtype, op.args
    v = lambda i: f"v{i}"
    state = "w.gen" if low.kind == "weight" else "s"
    if op.kind == "field":
        return (_FIELD_C if low.kind == "weight" else _HOOK_FIELD_C)[a[0]]
    if op.kind == "leaf":
        return f"{state}.l{a[0]}" + ("" if a[1] is None else f"[{a[1]}]")
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
    if op.kind == "pick":
        elems, n, i = a[1:], len(a) - 1, v(a[0])
        at = f"({i} < 0 ? max({i} + {n}LL, 0LL) : min({i}, {n - 1}LL))"
        row = _is_row(low, elems)
        if row is not None:  # a leaf's own row: one load at the index
            return f"{state}.l{row}[{at}]"
        chain = v(elems[-1])
        for j in range(n - 2, -1, -1):
            chain = f"(k_ == {j} ? {v(elems[j])} : {chain})"
        return f"[&] {{ const long long k_ = {at}; return {chain}; }}()"
    x = v(a[0])
    y = v(a[1]) if len(a) > 1 else None
    if t == torch.float32:
        if op.kind in _F32:
            return f"{_F32[op.kind]}({x}, {y})"
        if op.kind == "neg":
            return f"(-{x})"
        return f"{_F32_UNARY[op.kind]}({x})"
    ctype = _CTYPE[t]
    if t == torch.bool:  # max / min of bools: or / and
        if op.kind in ("max", "min"):
            return f"({x} {'||' if op.kind == 'max' else '&&'} {y})"
        raise ValueError(f"rulegen: no CUDA form of {op.kind} on bool")
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


def _body(low: Lowered) -> List[str]:
    """A lowered list's tables and ops as statements."""
    dtypes = {op.out: op.dtype for op in low.ops}
    lines = []
    for i, (dtype, vals) in enumerate(low.tables):
        body = ", ".join(_literal(x, dtype) for x in vals)
        lines.append(f"  constexpr {_CTYPE[dtype]} kTable{i}[{len(vals)}] "
                     f"= {{{body}}};")
    for op in low.ops:
        lines.append(f"  const {_CTYPE[op.dtype]} v{op.out} = "
                     f"{_op_c(op, low, dtypes)};")
    return lines


def _state_lines(leaves, reads_leaves) -> List[str]:
    """``GenState`` and its load, store and shuffle for the leaves a
    generated rule holds (scalars by value, a vector as a pointer to the
    walker's row)."""
    held = []
    for i, spec in enumerate(leaves):
        try:
            check_leaf(i, spec)
        except ValueError:
            continue  # a leaf nothing generated reads
        held.append((i, _CTYPE[spec.dtype], _leaf_width(spec)))
    lines = ["// one walker's wstate leaves: a scalar by value, a vector as "
             "a pointer to", "// the walker's row", "struct GenState {"]
    for i, c, width in held:
        lines.append(f"  {c}* l{i};  // [{width}] a walker" if width
                     else f"  {c} l{i};")
    lines += ["};", "template <bool kAll>",
              "__device__ __forceinline__ GenState gen_state("
              "const GenLeaves& L, int64_t w) {",
              "  GenState s{};", "  (void)L; (void)w;"]
    for i, c, width in held:
        cond = "kAll" if i not in reads_leaves else "true"
        if width:
            lines.append(f"  if ({cond}) s.l{i} = static_cast<{c}*>(L.p[{i}])"
                         f" + w * {width};")
        else:
            lines.append(f"  if ({cond}) s.l{i} = static_cast<const {c}*>("
                         f"L.p[{i}])[w];")
    lines += ["  return s;", "}",
              "__device__ __forceinline__ void gen_state_store("
              "const GenLeaves& L, int64_t w, const GenState& s) {",
              "  (void)L; (void)w; (void)s;"]
    for i, c, width in held:
        if not width:
            lines.append(f"  static_cast<{c}*>(L.p[{i}])[w] = s.l{i};")
    lines += ["}",
              "__device__ __forceinline__ GenState gen_state_shfl("
              "const GenState& s, int src) {",
              "  GenState c = s;", "  (void)src;"]
    for i, c, width in held:
        if width:
            lines.append(f"  c.l{i} = reinterpret_cast<{c}*>(__shfl_sync("
                         f"kFullWarp, reinterpret_cast<unsigned long long>("
                         f"s.l{i}), src));")
        elif c == "bool":
            lines.append(f"  c.l{i} = __shfl_sync(kFullWarp, static_cast<int>"
                         f"(s.l{i}), src) != 0;")
        else:
            lines.append(f"  c.l{i} = __shfl_sync(kFullWarp, s.l{i}, src);")
    lines += ["  return c;", "}"]
    return lines


def cuda_source(low: Optional[Lowered], name: str = "",
                hooks: Optional[LoweredHooks] = None) -> str:
    """The generated header ``csrc/weights.cuh`` includes for a
    ``PROGRAM_GENERATED`` rule (``low``, the weight; None for a hand
    weight rule) and ``HOOK_GENERATED`` hooks (``hooks``; None: stubs,
    ``kGenHooks`` false)."""
    leaves = low.leaves if low is not None else (
        hooks.leaves if hooks is not None else ())
    reads = low.reads if low is not None else frozenset()
    lines = [f"// Generated by repro_torch/kernels/rulegen.py from the "
             f"traced weight and hooks of {name or 'a walk program'}.",
             "#pragma once", "namespace repro {"]
    for f in ("label", "nbr", "dist", "deg_prev"):
        flag = f in reads or (f == "nbr" and "dist" in reads)
        lines.append(f"constexpr bool kGenReads{_camel(f)} = "
                     f"{'true' if flag else 'false'};")
    parts = [] if hooks is None else [x for x in (hooks.on_step,
                                                  hooks.should_stop) if x]
    hook_deg = any("deg_prev" in x.reads for x in parts)
    vector = any(spec.shape for spec in leaves)
    lines += [f"constexpr bool kGenHooks = "
              f"{'true' if hooks is not None else 'false'};",
              f"constexpr bool kGenHooksReadDegPrev = "
              f"{'true' if hook_deg else 'false'};",
              f"constexpr bool kGenVectorState = "
              f"{'true' if vector else 'false'};"]
    lines += _state_lines(leaves, low.reads_leaves if low else frozenset())
    lines += ["template <class W, class Dist>",
              "__device__ __forceinline__ float generated_weight(",
              "    const W& w, float h, long long label, long long "
              "nbr, Dist dist) {",
              "  (void)w; (void)h; (void)label; (void)nbr;"]
    if low is None:  # a hand weight rule: never called
        lines += ["  (void)dist;", "  return h;", "}"]
    else:
        if "dist" in low.reads:
            lines.append("  const long long d_ = static_cast<long long>("
                         "dist());")
        else:
            lines.append("  (void)dist;")
        lines += _body(low) + [f"  return v{low.result};", "}"]
    lines += ["__device__ __forceinline__ void generated_on_step(",
              "    const HookCtx& t, GenState& s, bool writer) {",
              "  (void)t; (void)s; (void)writer;"]
    on = hooks.on_step if hooks is not None else None
    if on is not None:  # every new value first, then the commits
        lines += _body(on)
        vec = []
        for i, r in enumerate(on.result):
            if isinstance(r, tuple):
                vec += [f"    s.l{i}[{j}] = v{e};" for j, e in enumerate(r)
                        if on.ops[e].kind != "leaf"
                        or on.ops[e].args != (i, j)]
            elif on.ops[r].kind != "leaf" or on.ops[r].args != (i, None):
                lines.append(f"  s.l{i} = v{r};")
        if vec:
            lines += ["  if (writer) {"] + vec + ["  }"]
    lines += ["}", "__device__ __forceinline__ bool generated_should_stop(",
              "    const HookCtx& t, const GenState& s) {",
              "  (void)t; (void)s;"]
    stop = hooks.should_stop if hooks is not None else None
    if stop is None:
        lines.append("  return false;")
    else:
        lines += _body(stop) + [f"  return v{stop.result};"]
    lines += ["}", "}  // namespace repro", ""]
    return "\n".join(lines)


def _camel(f: str) -> str:
    return "".join(p.capitalize() for p in f.split("_"))


# ------------------------------------------------------- plain evaluator
def evaluate(low: Lowered, ctx, wstate=None):
    """The lowered list on an :class:`EdgeCtx` block (the transition ctx,
    [W], for a hook) and the walkers' ``wstate`` with torch: the plain
    version of ``generated_weight`` (one float32 value per edge, before
    the clamp at 0), of ``generated_on_step`` (the new leaves) or of
    ``generated_should_stop`` ([W] bool)."""
    from repro_torch.kernels import ref

    shape = ctx.nbr.shape
    dev = ctx.nbr.device
    vals: Dict[int, torch.Tensor] = {}
    for op in low.ops:
        a, t = op.args, op.dtype
        x = lambda i: vals[a[i]]
        if op.kind == "field":
            r = getattr(ctx, a[0]).to(t)
        elif op.kind == "leaf":
            leaf = wstate[a[0]] if a[1] is None else wstate[a[0]][:, a[1]]
            r = leaf.reshape(leaf.shape[0], *([1] * (len(shape) - 1)))
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
        elif op.kind in ("gather", "pick"):
            if op.kind == "gather":
                dtype, table = low.tables[a[0]]
                tab = torch.tensor(table, dtype=dtype, device=dev).expand(
                    shape + (len(table),))
            else:
                tab = torch.stack([vals[e] for e in a[1:]], dim=-1)
            n = tab.shape[-1]
            i = x(1) if op.kind == "gather" else x(0)
            i = torch.where(i < 0, (i + n).clamp_min(0), i.clamp_max(n - 1))
            r = tab.gather(-1, i.unsqueeze(-1)).squeeze(-1)
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
    if low.kind != "on_step":
        return vals[low.result]
    return tuple(vals[r].contiguous() if not isinstance(r, tuple)
                 else torch.stack([vals[e] for e in r], dim=-1)
                 for r in low.result)


# ----------------------------------------------------------- kernel rule
@dataclasses.dataclass(frozen=True)
class _Generated:
    rule: Optional[KernelRule]
    hooks: Optional[HookRule]
    hooks_error: Optional[ValueError]


_CACHE: Dict[Tuple[int, int], Tuple[object, object, _Generated]] = {}


def _generated(program, params) -> _Generated:
    """The program's generated header, built once per (program, params)
    object: its weight where it names no hand rule, its hooks where it
    has hooks and declares no hand hook rule."""
    key = (id(program), id(params))
    hit = _CACHE.get(key)
    if hit is not None and hit[0] is program and hit[1] is params:
        return hit[2]
    weight = lower(program, params) if program.kernel_rule is None else None
    hooks = err = None
    if program.has_hooks and program.hook_rule is None:
        try:
            hooks = lower_hooks(program, params)
        except ValueError as e:
            err = e
    header = cuda_source(weight, program.name, hooks)
    rule = None if weight is None else KernelRule(
        GENERATED, bool(program.weighted), header=header,
        leaves=weight.leaves, reads_leaves=tuple(sorted(
            weight.reads_leaves)))
    hook_rule = None if hooks is None else HookRule(
        HOOK_GENERATED, header=header, leaves=hooks.leaves)
    gen = _Generated(rule, hook_rule, err)
    _CACHE[key] = (program, params, gen)
    return gen


def generated_rule(program, params) -> KernelRule:
    """The program's weight as a generated :class:`KernelRule` (its header
    in ``header``, with the program's generated hooks), built once per
    (program, params) object; raises ``ValueError`` naming what cannot be
    lowered."""
    rule = _generated(program, params).rule
    if rule is None:
        raise ValueError(f"program {program.name!r} names a hand-written "
                         f"weight rule: nothing to generate")
    return rule


def generated_hooks(program, params) -> HookRule:
    """The program's ``on_step`` / ``should_stop`` as a ``HOOK_GENERATED``
    :class:`HookRule` (the header that holds them in ``header``: its
    generated weight's, or one of its own beside a hand weight rule);
    raises ``ValueError`` naming what cannot be lowered."""
    gen = _generated(program, params)
    if gen.hooks_error is not None:
        raise gen.hooks_error
    if gen.hooks is None:
        raise ValueError(f"program {program.name!r} has no hooks to "
                         f"generate (or declares a hand hook rule)")
    return gen.hooks
