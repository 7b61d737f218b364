"""Device rules the CUDA kernels evaluate (``csrc/weights.cuh``).

A program's transition weight runs in kernels K1, K2 and K4 as a
:class:`KernelRule`: one of the hand-written rules below with its float32
constants, where the program names one, else ``GENERATED``, whose
``header`` holds the device code ``kernels/rulegen.py`` generates from
the traced weight (each header builds its own instances of the kernels).
When it has ``on_step`` / ``should_stop`` hooks, K4 runs them as a
:class:`HookRule`: a hand-written one the program declares, else
``HOOK_GENERATED``, the hooks ``rulegen`` generates into the same header
as the weight.  A generated rule reads the walkers' ``wstate`` leaves
(``leaves``: each one's dtype and per-walker shape), at most
:data:`MAX_GEN_LEAVES` of at most :data:`MAX_GEN_WIDTH` values a walker.
The ids must match ``PROGRAM_*`` and ``HOOK_*`` in ``csrc/weights.cuh``.  Constants are rounded to float32 on the host, as
jax rounds the Python constants of the reference's rules.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np

DEEPWALK = 0
NODE2VEC = 1
METAPATH = 2
SECOND_ORDER_PR = 3
VISITED = 4
PPR_NIBBLE = 5
GENERATED = 6

#: longest MetaPath schema a device rule holds (``kMaxSchema``)
MAX_SCHEMA = 8

HOOK_NONE = 0
HOOK_PPR_NIBBLE = 1
HOOK_GENERATED = 2

#: most wstate leaves, and most values of one a walker, a generated rule
#: reads (``kMaxGenLeaves`` / ``kMaxGenWidth``)
MAX_GEN_LEAVES = 8
MAX_GEN_WIDTH = 64


def f32(x: float) -> float:
    """``x`` rounded to float32 (kept as a Python float)."""
    return float(np.float32(x))


class RuleStruct(ctypes.Structure):
    """``repro::Rule`` of ``csrc/weights.cuh``, passed by pointer."""

    _fields_ = [("program", ctypes.c_int), ("weighted", ctypes.c_int),
                ("c0", ctypes.c_float), ("c2", ctypes.c_float),
                ("g1", ctypes.c_float), ("g", ctypes.c_float),
                ("schema_len", ctypes.c_int),
                ("schema", ctypes.c_int * MAX_SCHEMA),
                ("window", ctypes.c_int)]


@dataclasses.dataclass(frozen=True)
class KernelRule:
    """``program``: rule id; ``weighted``: whether h enters; ``c0`` /
    ``c2``: Node2Vec's factors at dist 0 and 2 (1/a, 1/b); ``g1`` / ``g``:
    second-order PageRank's 1−γ and γ; ``schema``: MetaPath's label
    schema; ``window``: the visited-avoiding ring's length.  A generated
    rule: ``header``, its program's state leaves ``leaves``
    (``flexi_compiler.LeafSpec``) and the ones its weight reads,
    ``reads_leaves``."""

    program: int
    weighted: bool
    c0: float = 1.0
    c2: float = 1.0
    g1: float = 0.0
    g: float = 0.0
    schema: Tuple[int, ...] = ()
    window: int = 0
    header: str = dataclasses.field(default="", repr=False)
    leaves: Tuple = ()
    reads_leaves: Tuple[int, ...] = ()

    def as_struct(self) -> RuleStruct:
        s = RuleStruct(program=self.program, weighted=int(self.weighted),
                       c0=self.c0, c2=self.c2, g1=self.g1, g=self.g,
                       schema_len=len(self.schema), window=self.window)
        for i, label in enumerate(self.schema):
            s.schema[i] = label
        return s


@dataclasses.dataclass(frozen=True)
class HookRule:
    """``kind``: hook id; ``decay`` / ``eps``: PPR-Nibble's 1−α and ε;
    ``header`` / ``leaves``: the generated rule that holds
    ``HOOK_GENERATED``'s hooks, and the state leaves they update."""

    kind: int
    decay: float = 1.0
    eps: float = 0.0
    header: str = dataclasses.field(default="", repr=False)
    leaves: Tuple = ()


def leaf_pointers(tensors) -> "ctypes.Array":
    """The kernels' ``GenLeaves`` argument: one data pointer a leaf (None
    for a leaf not passed), padded to :data:`MAX_GEN_LEAVES`."""
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    return (ctypes.c_void_p * MAX_GEN_LEAVES)(*ptrs)


def node2vec_rule(a: float, b: float, weighted: bool) -> KernelRule:
    return KernelRule(NODE2VEC, weighted, f32(1.0 / a), f32(1.0 / b))


def deepwalk_rule(weighted: bool) -> KernelRule:
    return KernelRule(DEEPWALK, weighted)


def metapath_rule(schema, weighted: bool) -> KernelRule:
    schema = tuple(int(x) for x in schema)
    if not 0 < len(schema) <= MAX_SCHEMA:
        raise ValueError(f"a MetaPath device rule holds 1 to {MAX_SCHEMA} "
                         f"labels, got a schema of {len(schema)}")
    return KernelRule(METAPATH, weighted, schema=schema)


def second_order_pr_rule(gamma: float, weighted: bool) -> KernelRule:
    return KernelRule(SECOND_ORDER_PR, weighted, g1=f32(1.0 - gamma),
                      g=f32(gamma))


def visited_rule(a: float, b: float, window: int,
                 weighted: bool) -> KernelRule:
    return dataclasses.replace(node2vec_rule(a, b, weighted),
                               program=VISITED, window=int(window))


def ppr_nibble_rule(weighted: bool) -> KernelRule:
    return KernelRule(PPR_NIBBLE, weighted)


def ppr_nibble_hooks(alpha: float, eps: float) -> HookRule:
    return HookRule(HOOK_PPR_NIBBLE, decay=f32(1.0 - alpha), eps=f32(eps))

