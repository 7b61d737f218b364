"""Wrappers of kernels K9–K12 (``csrc/baselines.cu``): the Table 2
baseline samplers' row kernels.

* K9  ``its_row``         C-SAW's ITS: the row's prefix sum, then the count;
* K10 ``rvs_prefix_row``  FlowWalker's prefix reservoir;
* K11 ``als_row``         Skywalker's per-step Vose build and draw;
* K12 ``row_max``         NextDoor's full-row max, which ``rjs_maxreduce``
  feeds to K2 (eRJS) as the bound before K9 serves K2's fallbacks.

On CPU tensors each runs its plain version (``core/baselines.py``); on
CUDA tensors it launches its kernel (building it on first use: a program
without a hand-written rule gets its own instance, built from its
generated rule) or raises.  The kernels read each walker's own row, never
a [n, pad] block: K9–K11 keep a row's weights and the levels of its
nested sums in scratch, at offsets the wrapper lays out from the walkers'
degrees (:func:`scratch_words`), so a launch serves walkers whose scratch
fits :data:`SCRATCH_BUDGET`, and a call makes as many launches as that
takes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import baselines as plain
from repro_torch.core.ctxutil import degrees_of
from repro_torch.kernels import build
from repro_torch.kernels.erjs import erjs_select
from repro_torch.kernels.ervs import kernel_rule, walker_inputs

#: bytes of row scratch one launch of K9–K11 may use; a walker whose own
#: row needs more (a row of over 10^8 neighbours) gets a launch of its own
SCRATCH_BUDGET = 2 << 30

#: the C entry's kernel ids (``kIts`` ... in ``csrc/baselines.cu``)
ROW_KERNELS = {"its_row": 0, "rvs_prefix_row": 1, "als_row": 2}


def _levels(deg: torch.Tensor, base: int) -> torch.Tensor:
    """Entries of the upper levels of a nested sum with ``base``-wide
    windows over rows of ``deg`` weights: ceil(n / base) for every level
    of n > base entries (``level_words`` in ``csrc/baselines.cu``)."""
    total = torch.zeros_like(deg)
    n = deg
    while bool((n > base).any()):
        n = torch.where(n > base, (n + base - 1) // base, 0)
        total = total + n
    return total


def scratch_words(kind: str, deg: torch.Tensor) -> torch.Tensor:
    """4-byte words of scratch a walker of degree ``deg`` takes: K9 and
    K10 keep the weights and, per upper level of the base-16 scan, the
    level's entries and its prefixes; K11 keeps q, the alias column and
    the stacks, and the upper levels of the 32-wide sum."""
    if kind == "als_row":
        return 3 * deg + _levels(deg, 32)
    return deg + 2 * _levels(deg, 16)


def _chunks(words: torch.Tensor):
    """(first walker, end walker, word offsets of its walkers) of each
    launch: consecutive walkers whose scratch fits the budget."""
    ends = words.cumsum(0)
    n = words.shape[0]
    budget = SCRATCH_BUDGET // 4
    if int(ends[-1]) <= budget:
        return [(0, n, ends - words)]
    host = ends.cpu()
    out, a = [], 0
    while a < n:
        base = int(host[a - 1]) if a else 0
        b = int(torch.searchsorted(host, base + budget, right=True))
        b = max(b, a + 1)
        out.append((a, b, ends[a:b] - words[a:b] - base))
        a = b
    return out


def _row_kernel(kind: str, graph, program, params, cur, prev, step, keys,
                pad: int, wstate) -> torch.Tensor:
    """Launch K9, K10 or K11 (``kind``) over the n walkers at ``cur``."""
    rule = kernel_rule(program, params)
    n = cur.shape[0]
    dev = cur.device
    whole = walker_inputs(graph, rule, cur, prev, step, keys, wstate, dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    lib = build.library("baselines", rule.header)
    rs = rule.as_struct()
    stream = torch.cuda.current_stream(dev).cuda_stream
    words = scratch_words(kind, degrees_of(graph, cur))
    for a, b, offs in _chunks(words):
        need = int(offs[-1] + words[b - 1]) if b > a else 0
        buf = build.scratch("baselines.rows", dev, stream, max(need, 1),
                            torch.float32)
        sl = slice(a, b)
        ws = None if wstate is None else tuple(x[sl] for x in wstate)
        # a launch of part of the walkers takes the pointers of its rows
        ring, leaves = whole if b - a == n else walker_inputs(
            graph, rule, cur[sl], prev[sl], step[sl], keys[sl], ws, dev)
        err = lib.repro_baseline_rows(
            ROW_KERNELS[kind], graph.indptr.data_ptr(),
            graph.indices.data_ptr(), graph.h.data_ptr(),
            graph.labels.data_ptr(), ctypes.byref(rs), cur[sl].data_ptr(),
            prev[sl].data_ptr(), step[sl].data_ptr(), ring, leaves,
            keys[sl].data_ptr(), b - a, pad, offs.data_ptr(),
            buf.data_ptr(), out[sl].data_ptr(), stream)
        build.check(err, kind)
        build.LAUNCHES[kind] += 1
    return out


def its_select(graph, program, params, cur, prev, step, keys, *, pad: int,
               wstate=None) -> torch.Tensor:
    """Next node [n] (int64; -1 when no neighbour has a positive weight)
    of C-SAW's ITS for the n walkers at ``cur`` (K9)."""
    if cur.device.type == "cpu":
        return plain.its_step(graph, program, params, cur, prev, step, keys,
                              pad, wstate=wstate)
    return _row_kernel("its_row", graph, program, params, cur, prev, step,
                       keys, pad, wstate)


def rvs_prefix_select(graph, program, params, cur, prev, step, keys, *,
                      pad: int, wstate=None) -> torch.Tensor:
    """Next node [n] of FlowWalker's prefix reservoir (K10)."""
    if cur.device.type == "cpu":
        return plain.rvs_prefix_step(graph, program, params, cur, prev, step,
                                     keys, pad, wstate=wstate)
    return _row_kernel("rvs_prefix_row", graph, program, params, cur, prev,
                       step, keys, pad, wstate)


def als_select(graph, program, params, cur, prev, step, keys, *, pad: int,
               wstate=None) -> torch.Tensor:
    """Next node [n] of Skywalker's alias sampling with the table built
    anew every step (K11)."""
    if cur.device.type == "cpu":
        return plain.als_step(graph, program, params, cur, prev, step, keys,
                              pad, wstate=wstate)
    return _row_kernel("als_row", graph, program, params, cur, prev, step,
                       keys, pad, wstate)


def row_max(graph, program, params, cur, prev, step, *, pad: int,
            wstate=None) -> torch.Tensor:
    """The exact maximum [n] (float32) of each walker's padded weight row
    (K12)."""
    if cur.device.type == "cpu":
        return plain.row_max(graph, program, params, cur, prev, step, pad,
                             wstate=wstate)
    rule = kernel_rule(program, params)
    n = cur.shape[0]
    dev = cur.device
    keys = torch.zeros((n, 2), dtype=torch.int64, device=dev)
    ring, leaves = walker_inputs(graph, rule, cur, prev, step, keys, wstate,
                                 dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = build.library("baselines", rule.header)
    rs = rule.as_struct()
    err = lib.repro_row_max(
        graph.indptr.data_ptr(), graph.indices.data_ptr(), graph.h.data_ptr(),
        graph.labels.data_ptr(), ctypes.byref(rs), cur.data_ptr(),
        prev.data_ptr(), step.data_ptr(), ring, leaves, n, pad,
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "row_max")
    build.LAUNCHES["row_max"] += 1
    return out


def rjs_maxreduce_select(graph, program, params, cur, prev, step, keys, *,
                         pad: int, trials_per_round: int = 8,
                         max_rounds: int = 64, wstate=None) -> torch.Tensor:
    """Next node [n] of NextDoor's max-reduce rejection: K12's exact row
    maximum as K2's bound, then K9 (same keys) on the walkers K2 left to
    the fallback."""
    if cur.device.type == "cpu":
        return plain.rjs_maxreduce_step(
            graph, program, params, cur, prev, step, keys, pad,
            trials_per_round=trials_per_round, max_rounds=max_rounds,
            wstate=wstate)
    bound = row_max(graph, program, params, cur, prev, step, pad=pad,
                    wstate=wstate)
    nxt, fb, _ = erjs_select(graph, program, params, cur, prev, step, keys,
                             bound, trials=trials_per_round,
                             rounds=max_rounds, wstate=wstate)
    idx = fb.nonzero().squeeze(1)
    if idx.numel():
        ws = None if wstate is None else tuple(x[idx] for x in wstate)
        nxt[idx] = its_select(graph, program, params, cur[idx], prev[idx],
                              step[idx], keys[idx], pad=pad, wstate=ws)
    return nxt


# the samplers' step functions by registry name
BASELINE_SELECT_FNS = {
    "its": its_select,
    "als": als_select,
    "rvs_prefix": rvs_prefix_select,
    "rjs_maxreduce": rjs_maxreduce_select,
}
