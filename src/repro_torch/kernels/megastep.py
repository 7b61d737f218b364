"""The fused epoch: kernel K4 (``csrc/megastep.cu``) and its plain
version, the port of the TPU mega-step kernel
``repro/kernels/megastep_kernel.py`` (``make_streamed_epoch`` /
``make_fused_epoch``, body ``_make_kernel``).

:func:`fused_epoch` runs ``epoch_len`` walk steps of every walker slot in
one launch: per step the degree, the per-step key ``fold_in(rng, step)``,
the regime's draw, the live / stepped / alive update, the emitted node and
an int32 flag word (bits ``StepStats.LIVE`` … ``STALE``).  One regime per
call (:data:`FUSED_KINDS`):

* ``reservoir``      — eRVS (the ``ervs`` sampler);
* ``rejection``      — eRJS against a baked per-node bound ``bmax``, eRVS
  when the trials run out (the ``erjs`` sampler);
* ``precomp_its`` / ``precomp_alias`` — the table draw on valid rows, eRVS
  on stale ones (``its_precomp`` / ``alias_precomp``).

It reads the plain CSR: the TPU kernel's ``[R, 128]`` row alignment and
slack tiles were DMA constraints.  The logical ``tile`` stays, since it
feeds the reservoir's RNG counters.  Every draw uses the staged scan's
Threefry counters, so paths, end state and flags equal the staged scan's
bit for bit.

A program with ``on_step`` / ``should_stop`` hooks runs them inside the
epoch as the staged step does (the reference kernel's hook branch): on
the transition ctx, committed on the lanes that moved, a stop folded into
``alive``; the program state comes in and goes out in
``WalkerState.wstate``.  The kernel runs the hand hook rule a program
declares (PPR-Nibble's), else the hooks ``rulegen`` generates
(``HOOK_GENERATED``, every leaf in and out); :func:`kernel_hooks` raises,
naming the op, for hooks it cannot lower.

On CPU tensors :func:`fused_epoch` runs :func:`fused_epoch_plain`, a loop
over the steps that calls the plain selectors; on CUDA tensors it launches
K4 (building it on first use) or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import flexi_compiler as fc
from repro_torch.core.ctxutil import apply_hooks, degrees_of, transition_ctx
from repro_torch.core.erjs import erjs_step
from repro_torch.core.ervs import ervs_step
from repro_torch.core.precomp import (PrecompTables, alias_offsets,
                                      its_offsets, offset_nodes)
from repro_torch.core.types import StepStats, WalkerState, wstate_rows
from repro_torch.kernels import build, rulegen
from repro_torch.kernels.ervs import kernel_rule, require_leaves
from repro_torch.kernels.its import require_cdf
from repro_torch.kernels.prng import fold_in
from repro_torch.kernels.rules import (HOOK_GENERATED, HOOK_NONE,
                                       HOOK_PPR_NIBBLE, HookRule,
                                       leaf_pointers)

#: fused regimes, in the order of the kernel's instances
FUSED_KINDS = ("reservoir", "rejection", "precomp_its", "precomp_alias")


#: hook rules the kernel has instances of
DEVICE_HOOKS = (HOOK_NONE, HOOK_PPR_NIBBLE, HOOK_GENERATED)


def kernel_hooks(program, params) -> HookRule:
    """The device form of the program's hooks: HOOK_NONE without hooks,
    the hand hook rule it declares, else its generated hooks
    (``rulegen.generated_hooks``, which raises naming what it cannot
    lower)."""
    if not program.has_hooks:
        return HookRule(HOOK_NONE)
    if program.hook_rule is not None:
        return program.hook_rule(params)
    return rulegen.generated_hooks(program, params)


def runs_hooks(program) -> bool:
    """Whether the kernel runs the program's hooks: none, a declared hook
    rule it has an instance of, or hooks ``rulegen`` lowers."""
    try:
        return kernel_hooks(program, program.params()).kind in DEVICE_HOOKS
    except ValueError:
        return False


def _check(program, kind, bmax, tables) -> None:
    if kind not in FUSED_KINDS:
        raise ValueError(f"kind {kind!r} not one of {FUSED_KINDS}")
    rep = fc.fuse_report(program)
    if not rep.fusable:
        raise ValueError(f"program {program.name!r} cannot run fused: "
                         f"{'; '.join(rep.reasons)}")
    if program.hook_rule is not None and kernel_hooks(
            program, program.params()).kind not in DEVICE_HOOKS:
        raise ValueError(f"program {program.name!r}: the fused epoch does "
                         f"not implement its declared hook rule")
    if kind == "rejection" and bmax is None:
        raise ValueError("kind='rejection' needs the baked bound table bmax")
    if kind.startswith("precomp") and tables is None:
        raise ValueError(f"kind={kind!r} needs the precomp tables")
    if kind == "precomp_alias":
        tables.require_alias()


def fused_epoch(graph, program, params, state: WalkerState, *, kind: str,
                tile: int, rjs_trials: int, rjs_max_rounds: int,
                epoch_len: int, num_steps: int,
                bmax: Optional[torch.Tensor] = None,
                tables: Optional[PrecompTables] = None
                ) -> Tuple[WalkerState, torch.Tensor, torch.Tensor]:
    """``epoch_len`` steps of every slot of ``state``: (state after the
    epoch, emitted [W, T] int32 — the node each slot moved to, -1 where it
    did not step —, flag words [W, T] int32)."""
    if state.cur.device.type == "cpu":
        return fused_epoch_plain(
            graph, program, params, state, kind=kind, tile=tile,
            rjs_trials=rjs_trials, rjs_max_rounds=rjs_max_rounds,
            epoch_len=epoch_len, num_steps=num_steps, bmax=bmax,
            tables=tables)
    _check(program, kind, bmax, tables)
    rule = kernel_rule(program, params)
    hooks = kernel_hooks(program, params)
    W, T = state.cur.shape[0], int(epoch_len)
    V, E = graph.num_nodes, graph.num_edges
    dev = state.cur.device
    build.require_graph(graph, dev)
    for name in ("cur", "prev", "step"):
        build.require(getattr(state, name), f"state.{name}", torch.int64,
                      (W,), dev)
    build.require(state.alive, "state.alive", torch.bool, (W,), dev)
    build.require(state.rng, "state.rng", torch.int64, (W, 2), dev)
    mass = None
    if hooks.kind == HOOK_PPR_NIBBLE:
        if rule.reads_leaves:
            raise ValueError(f"program {program.name!r}: the PPR-Nibble hook "
                             f"rule updates no state a generated weight "
                             f"reads")
        mass = state.wstate[0]
        build.require(mass, "wstate[0] (mass)", torch.float32, (W,), dev)
    # the leaves a generated weight reads, or all of them (copied: the
    # kernel updates them in place) for generated hooks
    if hooks.kind == HOOK_GENERATED:
        leaves = [leaf.clone() for leaf in require_leaves(
            hooks, state.wstate, range(len(hooks.leaves)), W, dev)]
    else:
        leaves = require_leaves(rule, state.wstate, rule.reads_leaves, W,
                                dev) if rule.reads_leaves else []
    if tile < 1 or T < 1 or rjs_trials < 1 or rjs_max_rounds < 1:
        raise ValueError(f"tile, epoch_len, rjs_trials and rjs_max_rounds "
                         f"must be positive, got {tile}, {T}, {rjs_trials}, "
                         f"{rjs_max_rounds}")
    ptr = {k: None for k in ("bmax", "cdf", "fence", "total", "pair",
                             "invalid")}
    if kind == "rejection":
        build.require(bmax, "bmax", torch.float32, (V,), dev)
        ptr["bmax"] = bmax.data_ptr()
    elif kind.startswith("precomp"):
        build.require(tables.total, "tables.total", torch.float32, (V,), dev)
        build.require(tables.invalid, "tables.invalid", torch.bool, (V,),
                      dev)
        ptr["total"] = tables.total.data_ptr()
        ptr["invalid"] = tables.invalid.data_ptr()
        if kind == "precomp_its":
            require_cdf(tables, E, dev)
            ptr["cdf"] = tables.cdf.data_ptr()
            ptr["fence"] = tables.its_fence.data_ptr()
        else:
            build.require(tables.alias_pair, "tables.alias_pair",
                          torch.int32, (E, 2), dev)
            ptr["pair"] = tables.alias_pair.data_ptr()
    emitted = torch.empty((W, T), dtype=torch.int32, device=dev)
    flags = torch.empty((W, T), dtype=torch.int32, device=dev)
    out_mass = None if mass is None else torch.empty_like(mass)
    wstate = (out_mass,) if mass is not None else (
        tuple(leaves) if hooks.kind == HOOK_GENERATED else state.wstate)
    out = WalkerState(cur=torch.empty_like(state.cur),
                      prev=torch.empty_like(state.prev),
                      step=torch.empty_like(state.step),
                      alive=torch.empty_like(state.alive), rng=state.rng,
                      carry=state.carry, wstate=wstate)
    if W == 0:
        return out, emitted, flags
    lib = build.library("megastep", rule.header or hooks.header)
    rs = rule.as_struct()
    ptr_of = lambda t: None if t is None else t.data_ptr()
    err = lib.repro_fused_epoch(
        graph.indptr.data_ptr(), graph.indices.data_ptr(),
        graph.h.data_ptr(), graph.labels.data_ptr(), ctypes.byref(rs),
        hooks.kind, hooks.decay, hooks.eps, FUSED_KINDS.index(kind),
        state.cur.data_ptr(), state.prev.data_ptr(), state.step.data_ptr(),
        state.alive.data_ptr(), state.rng.data_ptr(), ptr_of(mass),
        leaf_pointers(leaves), ptr["bmax"], ptr["cdf"], ptr["fence"], E,
        ptr["total"], ptr["pair"], ptr["invalid"], W, tile, rjs_trials,
        rjs_max_rounds, T, int(num_steps), emitted.data_ptr(),
        flags.data_ptr(),
        out.cur.data_ptr(), out.prev.data_ptr(), out.step.data_ptr(),
        out.alive.data_ptr(), ptr_of(out_mass),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, f"fused_epoch[{kind}]")
    build.LAUNCHES[f"fused_epoch_{kind}"] += 1
    return out, emitted, flags


def _reservoir(graph, program, params, cur, prev, step, keys, wstate, lanes,
               tile):
    """Plain eRVS of the listed lanes (next node per lane, -1 if none)."""
    return ervs_step(graph, program, params, cur[lanes], prev[lanes],
                     step[lanes], keys[lanes], tile=tile,
                     wstate=wstate_rows(wstate, lanes))


def fused_epoch_plain(graph, program, params, state: WalkerState, *,
                      kind: str, tile: int, rjs_trials: int,
                      rjs_max_rounds: int, epoch_len: int, num_steps: int,
                      bmax: Optional[torch.Tensor] = None,
                      tables: Optional[PrecompTables] = None
                      ) -> Tuple[WalkerState, torch.Tensor, torch.Tensor]:
    """Plain version of K4: a loop over ``epoch_len`` steps calling the
    plain selectors (``core.ervs.ervs_step``, ``core.erjs.erjs_step``,
    ``core.precomp.its_offsets`` / ``alias_offsets``) on each regime's
    lanes, with the kernel's flag words and the program's hooks.  Returns
    what :func:`fused_epoch` returns."""
    _check(program, kind, bmax, tables)
    cur, prev, step, alive = state.cur, state.prev, state.step, state.alive
    wstate = state.wstate
    W, dev = cur.shape[0], cur.device
    emitted = torch.full((W, epoch_len), -1, dtype=torch.int32, device=dev)
    flags = torch.zeros((W, epoch_len), dtype=torch.int32, device=dev)
    bit = lambda b: torch.tensor(1 << b, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(epoch_len):
        deg = degrees_of(graph, cur)
        wants = alive & (step < num_steps)
        live = wants & (deg > 0)
        keys = fold_in(state.rng, step)
        nxt = torch.full_like(cur, -1)
        extra = torch.zeros(W, dtype=torch.int32, device=dev)
        lanes = live.nonzero().squeeze(1)
        args = (graph, program, params, cur, prev, step, keys, wstate)
        if kind == "reservoir":
            nxt[lanes] = _reservoir(*args, lanes, tile)
        elif kind == "rejection":
            chosen, fb, _ = erjs_step(
                graph, program, params, cur[lanes], prev[lanes], step[lanes],
                keys[lanes], bmax[cur[lanes]], trials_per_round=rjs_trials,
                max_rounds=rjs_max_rounds, wstate=wstate_rows(wstate, lanes))
            nxt[lanes] = chosen
            extra[lanes] = torch.where(
                fb, bit(StepStats.FALLBACK),
                torch.where(chosen >= 0, bit(StepStats.RJS), zero))
            back = lanes[fb]
            nxt[back] = _reservoir(*args, back, tile)
        else:
            ok = live & tables.row_valid(cur)
            good = ok.nonzero().squeeze(1)
            draw = its_offsets if kind == "precomp_its" else alias_offsets
            off = draw(graph, tables, cur[good], keys[good])
            nxt[good] = offset_nodes(graph, cur[good], off)
            extra[good] = torch.where(off >= 0, bit(StepStats.PRECOMP), zero)
            stale = (live & ~ok).nonzero().squeeze(1)
            nxt[stale] = _reservoir(*args, stale, tile)
            extra[stale] = torch.where(nxt[stale] >= 0, bit(StepStats.STALE),
                                       zero)
        stepped = live & (nxt >= 0)
        emitted[:, t] = torch.where(stepped, nxt, -1).to(torch.int32)
        flags[:, t] = torch.where(live, bit(StepStats.LIVE) | extra, zero)
        stop = torch.zeros_like(stepped)
        if program.has_hooks:
            tctx = transition_ctx(graph, cur, prev, step, nxt, deg)
            wstate, stop = apply_hooks(program, params, tctx, wstate,
                                       stepped)
        # a lane that wanted to step but could not has dead-ended; a lane
        # whose program said stop is equally finished
        alive = alive & ~(wants & ~stepped) & ~stop
        prev = torch.where(stepped, cur, prev)
        cur = torch.where(stepped, nxt, cur)
        step = step + stepped.to(torch.int64)
    return (WalkerState(cur=cur, prev=prev, step=step, alive=alive,
                        rng=state.rng, carry=state.carry, wstate=wstate),
            emitted, flags)
