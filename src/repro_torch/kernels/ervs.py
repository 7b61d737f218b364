"""Wrapper of kernel K1 (``csrc/ervs.cu``): per-step eRVS selection.

``ervs_select`` picks the next node of each given walker — exponential
keys (``jump=False``) or the lane-strided A-ExpJ variant (``jump=True``).
``ervs_interleaved_select`` is the ``interleaved`` sampler's entry: the
exponential keys with tile 0 read from the walkers' prefetch carry, which
it refills.  On CPU tensors they run the plain versions
``core.ervs.ervs_step`` / ``ervs_jump_step`` / ``interleaved_step``; on
CUDA tensors they launch the kernel (building it on first use: a program
without a hand-written rule gets its own instance of the kernel, built
from its generated rule, which may read the walkers' ``wstate`` leaves)
or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ervs import ervs_jump_step, ervs_step, interleaved_step
from repro_torch.kernels import build, rulegen
from repro_torch.kernels.rules import (DEEPWALK, METAPATH, NODE2VEC,
                                       PPR_NIBBLE, SECOND_ORDER_PR, VISITED,
                                       KernelRule, leaf_pointers)

#: rule ids ``csrc/weights.cuh`` implements
DEVICE_RULES = (DEEPWALK, NODE2VEC, METAPATH, SECOND_ORDER_PR, VISITED,
                PPR_NIBBLE)


def kernel_rule(program, params) -> KernelRule:
    """The program's device weight rule: its hand-written rule where it
    names one, else the rule generated from its traced weight
    (``rulegen.generated_rule``, whose ``header`` selects the library).
    Raises where neither exists: a hand rule the kernels do not implement,
    or a weight rulegen cannot lower (the error names the op or field)."""
    if program.kernel_rule is None:
        return rulegen.generated_rule(program, params)
    rule = program.kernel_rule(params)
    if rule is None or rule.program not in DEVICE_RULES:
        raise ValueError(f"program {program.name!r} has no device weight "
                         f"rule the CUDA kernels implement")
    return rule


def require_leaves(rule, wstate, idx, n: int, dev) -> list:
    """Check the leaves ``idx`` of ``wstate`` (n walkers) against the
    generated rule's leaf specs; the leaves, None at the others."""
    if not idx:
        return [None] * len(rule.leaves)
    if wstate is None or len(wstate) != len(rule.leaves):
        raise ValueError(f"the generated rule reads the walkers' wstate "
                         f"leaves {list(idx)}: pass wstate, "
                         f"{len(rule.leaves)} leaves")
    out = [None] * len(rule.leaves)
    for i in idx:
        spec = rule.leaves[i]
        build.require(wstate[i], f"wstate[{i}]", spec.dtype,
                      (n,) + tuple(spec.shape), dev)
        out[i] = wstate[i]
    return out


def walker_inputs(graph, rule: KernelRule, cur, prev, step, keys, wstate,
                  dev):
    """Check what a per-walker kernel reads beside the graph, and return
    (the pointer of the walkers' ring rows, visited-avoiding's, else None;
    the kernels' array of the leaves a generated rule reads, else None)."""
    n = cur.shape[0]
    build.require_graph(graph, dev)
    for name, t in (("cur", cur), ("prev", prev), ("step", step)):
        build.require(t, name, torch.int64, (n,), dev)
    build.require(keys, "keys", torch.int64, (n, 2), dev)
    if rule.reads_leaves:
        return None, leaf_pointers(require_leaves(
            rule, wstate, rule.reads_leaves, n, dev))
    if rule.program != VISITED:
        return None, None
    if wstate is None:
        raise ValueError("the visited-avoiding rule reads the walkers' "
                         "rings: pass wstate")
    build.require(wstate[0], "wstate[0]", torch.int32, (n, rule.window), dev)
    return wstate[0].data_ptr(), None


def ervs_select(graph, program, params, cur, prev, step, keys, *,
                tile: int = 256, jump: bool = False,
                wstate=None) -> torch.Tensor:
    """Next node [n] (int64; -1 when no neighbour has a positive weight) of
    the n walkers at ``cur`` with previous nodes ``prev``, steps ``step``,
    program state ``wstate`` and per-step keys ``keys`` [n, 2]."""
    if cur.device.type == "cpu":
        plain = ervs_jump_step if jump else ervs_step
        return plain(graph, program, params, cur, prev, step, keys,
                     tile=tile, wstate=wstate)
    rule = kernel_rule(program, params)
    n = cur.shape[0]
    dev = cur.device
    ring, leaves = walker_inputs(graph, rule, cur, prev, step, keys, wstate,
                                 dev)
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    lib = build.library("ervs", rule.header)
    rs = rule.as_struct()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the jump instance lists the walkers a whole block serves
    todo = build.scratch("ervs_jump.todo", dev, stream, n + 2,
                         torch.int32).data_ptr() if jump else None
    err = lib.repro_ervs_select(
        graph.indptr.data_ptr(), graph.indices.data_ptr(),
        graph.h.data_ptr(), graph.labels.data_ptr(), ctypes.byref(rs),
        cur.data_ptr(), prev.data_ptr(), step.data_ptr(), ring, leaves,
        keys.data_ptr(), n, tile, int(jump), out.data_ptr(), todo, stream)
    build.check(err, "ervs_select")
    build.LAUNCHES["ervs_jump_select" if jump else "ervs_select"] += 1
    return out


def ervs_interleaved_select(graph, program, params, cur, prev, step, keys,
                            carry, lanes, *, tile: int = 256,
                            wstate=None) -> torch.Tensor:
    """Next node [n] (int64; -1 when no neighbour has a positive weight) of
    the n walkers in slots ``lanes`` ([n] int64) of ``carry``, the
    ``interleaved`` sampler's ``PrefetchTile`` of every slot; ``cur``,
    ``prev``, ``step``, ``keys`` and ``wstate`` are those walkers' rows.
    The choice is ``ervs_select``'s (``jump=False``), bitwise.

    Tile 0 of a walker whose carry tag equals ``cur`` comes from its
    carry row, of any other from the graph; after the choice its carry
    row holds the first ``min(deg, tile)`` entries of the chosen node's
    row (nbr, h and label as the program reads them), tagged with that
    node (-1 where it chose none), and every other slot gets tag -1.  The
    carry is rewritten in place.  On the card the entries past ``min(deg,
    tile)`` are left as they were (``PrefetchTile``'s docstring)."""
    if cur.device.type == "cpu":
        return interleaved_step(graph, program, params, cur, prev, step,
                                keys, carry, lanes, tile=tile, wstate=wstate)
    rule = kernel_rule(program, params)
    n = cur.shape[0]
    dev = cur.device
    ring, leaves = walker_inputs(graph, rule, cur, prev, step, keys, wstate,
                                 dev)
    if tile < 1:
        raise ValueError(f"tile must be positive, got {tile}")
    W = carry.node.shape[0]
    build.require(lanes, "lanes", torch.int64, (n,), dev)
    build.require(carry.node, "carry.node", torch.int64, (W,), dev)
    for name, dtype in (("nbr", torch.int32), ("h", torch.float32),
                        ("label", torch.int32)):
        build.require(getattr(carry, name), f"carry.{name}", dtype,
                      (W, tile), dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    other = torch.ones(W, dtype=torch.bool, device=dev)
    other[lanes] = False
    if n:
        lib = build.library("ervs", rule.header)
        rs = rule.as_struct()
        stream = torch.cuda.current_stream(dev).cuda_stream
        flags = int(program.weighted) | int(program.needs_labels) << 1
        err = lib.repro_ervs_interleaved_select(
            graph.indptr.data_ptr(), graph.indices.data_ptr(),
            graph.h.data_ptr(), graph.labels.data_ptr(), ctypes.byref(rs),
            cur.data_ptr(), prev.data_ptr(), step.data_ptr(), ring, leaves,
            keys.data_ptr(), n, tile, lanes.data_ptr(),
            carry.node.data_ptr(), carry.nbr.data_ptr(), carry.h.data_ptr(),
            carry.label.data_ptr(), flags, out.data_ptr(), stream)
        build.check(err, "ervs_interleaved_select")
        build.LAUNCHES["ervs_interleaved_select"] += 1
    carry.node.masked_fill_(other, -1)
    return out
