#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU — the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build   — compile K1–K5 from ``src/repro_torch/kernels/csrc`` with nvcc
             (one process per source, in parallel).
2. graph   — ``power_law_graph`` at soc-LiveJournal1 scale (4,847,571
             nodes, average degree 14, uniform weights, seed 0), the node
             statistics and deepwalk's ITS tables; then one deepwalk engine per
             fused regime (methods ervs, erjs, its_precomp, alias_precomp,
             ``step_exec="fused"``).
3. check   — each kernel against its plain PyTorch version on the card, on
             a few thousand walkers of the full graph (hubs included):
             K2, K3 and K5 bitwise; K1 bitwise or differing only at
             near-ties (two float32 keys within 2 ulp); K4 for one epoch of
             16 steps in each regime, with forced eRJS fallbacks
             (rjs_trials=1, rjs_max_rounds=1) and every third row stale:
             paths, end state and flag words bitwise, except that a path
             may part at a reservoir near-tie; then the whole engine on a
             small graph, kernels (cuda) against plain versions (cpu).
4. main    — ``WalkEngine(graph, program, EngineConfig(method="adaptive",
             jump_threshold=8)).run(np.arange(V), num_steps=80)`` for
             node2vec, then deepwalk; then deepwalk with each fused method,
             ``step_exec="fused"`` and again ``"staged"``: the fused run
             must resolve "fused", launch K4 and give the staged run's
             paths and telemetry bit for bit.  Launch counts are reset just
             before each run and read just after; ``run()`` reports its own
             host-clock split (setup, admit, steps, harvest).  Every emitted
             step must be an edge and stopped lanes must emit -1.
5. timing  — each kernel and its plain version on the lanes one main-path
             step hands it (the state after 8 steps) under each program
             that launches it, with CUDA events; the kernel must agree
             with the plain version there as in phase 3.  K4: one timed
             launch of 16 steps from the state after 8 steps, per regime,
             held against its plain version on the same state; for the
             reservoir regime, whose torch row scans take minutes per
             step here (~10^11 edges), both versions run one step of all
             walkers from that state, and the 16-step launch is timed
             beside it.

``jump_threshold`` is lowered from the default 1024 to 8, the cost
model's ``min_rjs_degree``: at uniform weights Eq. 11 sends every hub to
eRJS, which resolves without fallbacks, so at 1024 the jump reservoir
would serve no lane at all.  At 8 it serves the reservoir lanes the cost
model could have sent to eRJS but did not, and plain eRVS the rows
shorter than eRJS's minimum.

The line before the last is a JSON object with one entry per kernel and
program (``"ervs_select/deepwalk"``, ``"fused_epoch_reservoir/deepwalk"``,
...); the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LJ_NODES = 4_847_571  # soc-LiveJournal1
LJ_AVG_DEGREE = 14
WALK_STEPS = 80
# the cost model's min_rjs_degree; see the module docstring
JUMP_THRESHOLD = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
PEAK_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# integer operations of one Threefry-2x32 (20 rounds of add/rotate/xor,
# five key injections), counted at the float32 rate above, since the
# H100's peak-rate table used here lists no 32-bit integer rate
THREEFRY_OPS = 122
# the fused regimes and the deepwalk method that runs each
FUSED_METHODS = {"reservoir": "ervs", "rejection": "erjs",
                 "precomp_its": "its_precomp",
                 "precomp_alias": "alias_precomp"}
# kernels each staged fused-method run must launch
STAGED_NEEDS = {"ervs": ("ervs_select",), "erjs": ("erjs_select",),
                "its_precomp": ("its_search",),
                "alias_precomp": ("alias_pick",)}
# steps of the K4 launches checked (phase 3) and timed (phase 5)
K4_EPOCH = 16
# steps over which phase 5 holds K4's reservoir regime against its plain
# version on every walker (the plain row scans take minutes per step)
K4_RESERVOIR_PLAIN_EPOCH = 1


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def probes(deg):
    """Reads of a lower-bound binary search over rows of ``deg`` entries."""
    import torch

    d = deg.to(torch.float64)
    return torch.where(deg > 0, torch.ceil(torch.log2(d + 1)) + 1, 0.0)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs after
    one warm-up run (CUDA events around the whole run)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_once(fn):
    """(result, milliseconds) of one ``fn()`` on the card (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- checks
def walkers(graph, n: int, seed: int, max_deg=None):
    """n walkers (cur, prev, keys) on the card: the top hubs plus random
    nodes, each with a random neighbour as the previous node (-1 for
    every tenth)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    deg = graph.degrees().cpu().numpy().astype(np.int64)
    ok = deg > 0 if max_deg is None else (deg > 0) & (deg <= max_deg)
    cand = np.nonzero(ok)[0]
    hubs = cand[np.argsort(-deg[cand], kind="stable")[:32]]
    cur = np.concatenate([hubs, rng.choice(cand, n - hubs.size)])
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    off = (rng.random(n) * deg[cur]).astype(np.int64)
    prev = graph.indices.cpu().numpy()[indptr[cur] + off].astype(np.int64)
    prev[::10] = -1
    keys = rng.integers(0, 1 << 32, size=(n, 2), dtype=np.int64)
    dev = graph.device
    as_t = lambda a: torch.from_numpy(a).to(dev)
    return as_t(cur), as_t(prev), as_t(keys)


def node_offsets(graph, cur, nodes):
    """Row offset of ``nodes`` in the rows of ``cur`` (rows are sorted)."""
    import numpy as np

    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    idx = graph.indices.cpu().numpy()
    out = []
    for v, u in zip(cur.tolist(), nodes.tolist()):
        row = idx[indptr[v]:indptr[v + 1]]
        out.append(int(np.searchsorted(row, u)))
    return out


def k1_mismatches(graph, program, params, cur, prev, keys, got, want,
                  tile: int, jump: bool):
    """(mismatches, unexplained): walkers where the kernel and the plain
    version chose differently, and those of them that are not near-ties."""
    import torch
    from repro_torch.core import ervs as ervs_mod

    bad = (got != want).nonzero().squeeze(1)
    if not bad.numel():
        return 0, 0
    step = torch.zeros_like(cur[bad])
    c, p, k = cur[bad], prev[bad], keys[bad]
    if jump:
        lk, _ = ervs_mod.jump_lanes(graph, program, params, c, p, step, k,
                                    tile, torch.ones_like(c, dtype=torch.bool))
        top2 = lk.topk(2, dim=1).values
        near = ervs_mod.within_ulps(top2[:, 0], top2[:, 1])
    else:
        dev = cur.device
        oa = torch.tensor(node_offsets(graph, c, got[bad]), device=dev)
        ob = torch.tensor(node_offsets(graph, c, want[bad]), device=dev)
        ka = ervs_mod.offset_keys_f64(graph, program, params, c, p, step, k,
                                      oa, tile)
        kb = ervs_mod.offset_keys_f64(graph, program, params, c, p, step, k,
                                      ob, tile)
        near = ervs_mod.within_ulps(ka, kb)
    return int(bad.numel()), int((~near).sum())


def check_kernels(graph, n2v, dw, seed: int) -> None:
    """Phase 3a: each kernel against its plain version on the card."""
    import torch
    from repro_torch.core import erjs as erjs_mod
    from repro_torch.core import ervs as ervs_mod
    from repro_torch.core.precomp import its_offsets
    from repro_torch.core.types import WalkerState
    from repro_torch.kernels.erjs import erjs_select
    from repro_torch.kernels.ervs import ervs_select
    from repro_torch.kernels.its import its_search

    cfg = n2v.config
    # K2 and K3 on hubs and random walkers of the full graph
    cur, prev, keys = walkers(graph, 4096, seed)
    step = torch.zeros_like(cur)
    state = WalkerState(cur=cur, prev=prev, step=step,
                        alive=torch.ones_like(cur, dtype=torch.bool),
                        rng=keys)
    bnd = n2v.sampler_ctx.estimates(state).bound_max
    params = n2v.sampler_ctx.params
    got = erjs_select(graph, n2v.workload, params, cur, prev, step, keys, bnd,
                      trials=cfg.rjs_trials, rounds=cfg.rjs_max_rounds)
    want = erjs_mod.erjs_step(graph, n2v.workload, params, cur, prev, step,
                              keys, bnd, cfg.rjs_trials, cfg.rjs_max_rounds)
    for g, w, what in zip(got, want, ("next", "fallback", "trials")):
        if not torch.equal(g, w):
            fail(f"erjs_select {what} differs from erjs_step on "
                 f"{int((g != w).sum())} of {cur.numel()} walkers")
    got = its_search(graph, dw.precomp, cur, keys)
    want = its_offsets(graph, dw.precomp, cur, keys)
    if not torch.equal(got, want):
        fail(f"its_search differs from its_offsets on "
             f"{int((got != want).sum())} of {cur.numel()} walkers")
    # K1: the plain version scans [W, tile] blocks, so keep rows short
    cur, prev, keys = walkers(graph, 4096, seed + 1, max_deg=4096)
    step = torch.zeros_like(cur)
    for eng in (n2v, dw):
        for jump in (False, True):
            name = "ervs_jump_select" if jump else "ervs_select"
            plain = ervs_mod.ervs_jump_step if jump else ervs_mod.ervs_step
            p = eng.sampler_ctx.params
            got = ervs_select(graph, eng.workload, p, cur, prev, step, keys,
                              tile=cfg.tile, jump=jump)
            want = plain(graph, eng.workload, p, cur, prev, step, keys,
                         tile=cfg.tile)
            n_bad, unexplained = k1_mismatches(
                graph, eng.workload, p, cur, prev, keys, got, want, cfg.tile,
                jump)
            log(f"check {name} [{eng.workload.name}]: {cur.numel()} walkers, "
                f"{n_bad} differ from the plain version, all near-ties: "
                f"{unexplained == 0}")
            if unexplained:
                fail(f"{name} [{eng.workload.name}]: {unexplained} "
                     f"differences are not near-ties")


def stale_every_third(tables):
    """The same tables with every third row marked stale."""
    import dataclasses

    invalid = tables.invalid.clone()
    invalid[::3] = True
    return dataclasses.replace(tables, invalid=invalid)


def state_at(state0, emitted, i: int, t: int):
    """(cur, prev, step) of walker i before step t of an epoch that started
    at ``state0`` and emitted ``emitted`` ([W, T], -1 where it did not
    move)."""
    cur, prev, step = (int(state0.cur[i]), int(state0.prev[i]),
                       int(state0.step[i]))
    for x in emitted[i, :t].tolist():
        if x >= 0:
            cur, prev, step = x, cur, step + 1
    return cur, prev, step


def k4_mismatches(eng, state0, got, want, tile: int):
    """(walkers whose K4 epoch differs from the plain version's, those of
    them whose first difference is not a reservoir near-tie).  A walker
    may part at a near-tie; everything before that step, and the whole
    epoch and end state of every other walker, must be equal."""
    import torch
    from repro_torch.core import ervs as ervs_mod
    from repro_torch.kernels.prng import fold_in

    (s1, e1, f1), (s2, e2, f2) = got, want
    same_end = ((s1.cur == s2.cur) & (s1.prev == s2.prev)
                & (s1.step == s2.step) & (s1.alive == s2.alive))
    rows = ((e1 != e2) | (f1 != f2)).any(dim=1) | ~same_end
    bad = rows.nonzero().squeeze(1).tolist()
    unexplained = 0
    g, dev = eng.graph, eng.device
    e1h, e2h, f1h, f2h = (x.cpu() for x in (e1, e2, f1, f2))
    for i in bad:
        diff = ((e1h[i] != e2h[i]) | (f1h[i] != f2h[i])).nonzero()
        t = int(diff[0]) if diff.numel() else None
        if t is None or int(e1h[i, t]) < 0 or int(e2h[i, t]) < 0 \
                or int(f1h[i, t]) != int(f2h[i, t]):
            unexplained += 1
            continue
        cur, prev, step = state_at(state0, e2h, i, t)
        one = lambda x: torch.tensor([x], dtype=torch.int64, device=dev)
        key = fold_in(state0.rng[i:i + 1], one(step))
        offs = torch.tensor(node_offsets(g, one(cur).expand(2), torch.tensor(
            [int(e1h[i, t]), int(e2h[i, t])])), device=dev)
        keys = [ervs_mod.offset_keys_f64(g, eng.workload,
                                         eng.sampler_ctx.params, one(cur),
                                         one(prev), one(step), key,
                                         offs[k:k + 1], tile)
                for k in (0, 1)]
        if not bool(ervs_mod.within_ulps(keys[0], keys[1])):
            unexplained += 1
    return len(bad), unexplained


def check_fused(graph, fused: dict, seed: int) -> None:
    """Phase 3c: K5 and every K4 instance against their plain versions on
    the card, on check walkers of the full graph (hubs included)."""
    import torch
    from repro_torch.core.precomp import alias_offsets
    from repro_torch.core.types import WalkerState
    from repro_torch.kernels import megastep
    from repro_torch.kernels.alias import alias_pick

    cur, prev, keys = walkers(graph, 4096, seed)
    tables = fused["precomp_alias"].precomp
    got = alias_pick(graph, tables, cur, keys)
    want = alias_offsets(graph, tables, cur, keys)
    if not torch.equal(got, want):
        fail(f"alias_pick differs from alias_offsets on "
             f"{int((got != want).sum())} of {cur.numel()} walkers")
    log(f"check alias_pick: {cur.numel()} walkers, bitwise equal to "
        f"alias_offsets")
    W = cur.numel()
    step = torch.zeros_like(cur)
    step[::7] = WALK_STEPS - 5  # these stop inside the epoch
    alive = torch.ones_like(cur, dtype=torch.bool)
    alive[::11] = False
    state0 = WalkerState(cur=cur, prev=prev, step=step, alive=alive,
                         rng=keys)
    for kind, eng in fused.items():
        cfg = eng.config
        args = dict(kind=kind, tile=cfg.tile, rjs_trials=cfg.rjs_trials,
                    rjs_max_rounds=cfg.rjs_max_rounds, epoch_len=K4_EPOCH,
                    num_steps=WALK_STEPS, bmax=eng._fused_bmax,
                    tables=eng.precomp)
        what = "default"
        if kind == "rejection":
            args.update(rjs_trials=1, rjs_max_rounds=1)
            what = "rjs_trials=1, rjs_max_rounds=1"
        elif kind.startswith("precomp"):
            args.update(tables=stale_every_third(eng.precomp))
            what = "every third row stale"
        p = eng.sampler_ctx.params
        got, ms = cuda_once(lambda: megastep.fused_epoch(
            graph, eng.workload, p, state0, **args))
        want, plain_ms = cuda_once(lambda: megastep.fused_epoch_plain(
            graph, eng.workload, p, state0, **args))
        n_bad, unexplained = k4_mismatches(eng, state0, got, want, cfg.tile)
        flags = want[2]
        counts = {b: int(((flags >> i) & 1).sum()) for i, b in enumerate(
            ("live", "rjs", "fallback", "precomp", "stale"))}
        log(f"check fused_epoch_{kind} ({what}): {W} walkers x {K4_EPOCH} "
            f"steps, kernel {ms:.4f} ms (first launch), plain "
            f"{plain_ms:.4f} ms, flag bits {counts}; {n_bad} walkers differ "
            f"from the plain version, all at reservoir near-ties: "
            f"{unexplained == 0}")
        if unexplained:
            fail(f"fused_epoch_{kind}: {unexplained} walkers differ from the "
                 f"plain version other than at a reservoir near-tie")
        if kind == "rejection" and not counts["fallback"]:
            fail("the forced-fallback check of fused_epoch_rejection made "
                 "no fallback")
        if kind.startswith("precomp") and not counts["stale"]:
            fail(f"the stale-row check of fused_epoch_{kind} served no "
                 f"stale row")


def check_small_engine() -> None:
    """Phase 3b: the whole engine on a small graph, kernels on the card
    against the plain versions on the CPU — paths and telemetry."""
    import numpy as np
    from repro_torch.core import EngineConfig, WalkEngine
    from repro_torch.graphs import power_law_graph
    from repro_torch.walks import make_workload

    g = power_law_graph(3000, 8, seed=5)
    starts = np.arange(g.num_nodes)
    cells = [(name, dict(method="adaptive", jump_threshold=JUMP_THRESHOLD))
             for name in ("node2vec", "deepwalk")]
    cells += [("deepwalk", dict(method=m, step_exec="fused"))
              for m in FUSED_METHODS.values()]
    for name, kw in cells:
        res = {}
        for dev in ("cuda", "cpu"):
            eng = WalkEngine(g, make_workload(name), EngineConfig(
                device=dev, **kw))
            res[dev] = eng.run(starts, num_steps=20, batch=1024, epoch_len=7)
        a, b = res["cuda"], res["cpu"]
        same = (a.paths == b.paths).all(axis=1)
        what = f"{name}/{kw['method']}, {eng.step_exec_resolved}"
        log(f"check engine [{what}] on V=3000: cuda paths equal cpu paths "
            f"on {same.mean():.6f} of queries; frac_rjs {a.frac_rjs:.4f} / "
            f"{b.frac_rjs:.4f}, frac_precomp {a.frac_precomp:.4f} / "
            f"{b.frac_precomp:.4f}")
        if not same.all() or (a.frac_rjs, a.frac_precomp, a.rjs_fallbacks,
                              a.live_steps) != (
                b.frac_rjs, b.frac_precomp, b.rjs_fallbacks, b.live_steps):
            fail(f"engine [{what}]: kernel run differs from the plain run")


def check_paths(graph, paths) -> None:
    """Every emitted step is an edge of the graph; after a -1 only -1."""
    import torch
    from repro_torch.graphs.csr import has_edge

    P = torch.from_numpy(paths).to(graph.device)
    if not bool((P[:, 0] >= 0).all()):
        fail("a path does not start at a node")
    for t in range(P.shape[1] - 1):
        u, v = P[:, t].long(), P[:, t + 1].long()
        if bool(((u < 0) & (v >= 0)).any()):
            fail(f"a stopped lane emitted a node at step {t + 1}")
        m = v >= 0
        if not bool(has_edge(graph, u[m], v[m]).all()):
            fail(f"an emitted step {t + 1} is not an edge of the graph")


# ------------------------------------------------------------- main path
def main_path(eng, steps: int, need: tuple) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels import build

    V = eng.graph.num_nodes
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(np.arange(V), num_steps=steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    live = res.live_steps
    name = eng.workload.name.split("[")[0]
    log(f"main [{name}]: {V} walkers x {steps} steps in "
        f"{dt:.2f} s, {live} live walker-steps, {live / dt:.4g} "
        f"walker-steps/s; frac_rjs={res.frac_rjs:.4f} "
        f"frac_precomp={res.frac_precomp:.4f} "
        f"frac_reservoir={1 - res.frac_rjs - res.frac_precomp:.4f} "
        f"fallbacks={res.rjs_fallbacks}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {counts}")
    split = ", ".join(f"{k} {v:.3f} s" for k, v in res.seconds.items())
    log(f"main [{name}]: run() phases (host clock): {split}; "
        f"{res.seconds['steps'] / steps * 1e3:.2f} ms per step")
    for name in need:
        if counts[name] <= 0:
            fail(f"main path [{eng.workload.name}] never launched {name}")
    check_paths(eng.graph, res.paths)
    log(f"main [{eng.workload.name}]: every emitted step is an edge, "
        f"stopped lanes emit -1")
    return counts


def fused_main_path(fused_eng, staged_eng, steps: int) -> int:
    """Phase 4b: one fused run and one staged run of a deepwalk method;
    returns the fused run's K4 launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import build

    kind = fused_eng._fused_kind
    method = fused_eng.config.method
    if fused_eng.step_exec_resolved != "fused":
        fail(f"deepwalk/{method} with step_exec='fused' resolved "
             f"{fused_eng.step_exec_resolved!r}")
    V = fused_eng.graph.num_nodes
    res, counts = {}, {}
    for eng in (fused_eng, staged_eng):
        ex = eng.step_exec_resolved
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        r = eng.run(np.arange(V), num_steps=steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts[ex] = {k: n for k, n in build.LAUNCHES.items() if n}
        res[ex] = r
        split = ", ".join(f"{k} {v:.3f} s" for k, v in r.seconds.items())
        log(f"main [deepwalk/{method}, {ex}]: {V} walkers x {steps} steps "
            f"in {dt:.2f} s, {r.live_steps / dt:.4g} walker-steps/s; "
            f"frac_rjs={r.frac_rjs:.4f} frac_precomp={r.frac_precomp:.4f} "
            f"frac_stale={r.frac_stale:.4f} fallbacks={r.rjs_fallbacks}; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches {counts[ex]}; run() phases (host clock): {split}")
    a, b = res["fused"], res["staged"]
    name = f"fused_epoch_{kind}"
    if counts["fused"].get(name, 0) <= 0:
        fail(f"deepwalk/{method} fused never launched {name}")
    for k in STAGED_NEEDS[method]:
        if counts["staged"].get(k, 0) <= 0:
            fail(f"deepwalk/{method} staged never launched {k}")
    same = (a.paths == b.paths).all(axis=1)
    tele = ("frac_rjs", "frac_precomp", "frac_stale", "rjs_fallbacks",
            "live_steps")
    log(f"main [deepwalk/{method}]: fused paths equal staged paths on "
        f"{same.mean():.6f} of queries; telemetry "
        f"{[getattr(a, f) for f in tele]} / {[getattr(b, f) for f in tele]}")
    if not same.all() or any(getattr(a, f) != getattr(b, f) for f in tele):
        fail(f"deepwalk/{method}: the fused run differs from the staged run")
    check_paths(fused_eng.graph, a.paths)
    log(f"main [deepwalk/{method}]: every emitted step is an edge, stopped "
        f"lanes emit -1")
    return counts["fused"][name], counts["staged"]


def mid_walk_state(eng, steps_before: int, num_steps: int = WALK_STEPS):
    """Slot state of all V queries of a ``num_steps`` walk after
    ``steps_before`` steps."""
    import numpy as np
    from repro_torch.core.runtime import EpochScheduler
    from repro_torch.kernels.prng import key_data

    V = eng.graph.num_nodes
    sched = EpochScheduler(eng, num_steps=num_steps,
                           key=key_data(eng.config.seed), slots=V,
                           epoch_len=steps_before, capacity=V)
    sched.admit(np.arange(V), np.arange(V))
    sched.run_epoch()
    return sched.state


def time_kernels(engines, reps: int) -> dict:
    """Phase 5: each kernel at the shapes one main-path step gives it,
    held against its plain version on the same lanes: K2 and K3 bitwise,
    K1 bitwise or differing only at near-ties.  Rows are keyed by
    (kernel, program)."""
    import torch
    from repro_torch.core import erjs as erjs_mod
    from repro_torch.core import ervs as ervs_mod
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.core.precomp import its_offsets
    from repro_torch.kernels.erjs import erjs_select
    from repro_torch.kernels.ervs import ervs_select
    from repro_torch.kernels.its import its_search

    rows = {}

    def lanes_of(state, mask):
        idx = mask.nonzero().squeeze(1)
        return (state.cur[idx].contiguous(), state.prev[idx].contiguous(),
                state.step[idx].contiguous(), idx)

    def scan_bytes(g, cur, prev, node2vec: bool):
        deg = degrees_of(g, cur).to(torch.float64)
        per_edge = 8.0 + (4.0 * probes(degrees_of(g, prev)) if node2vec
                          else 0.0)
        return float((56.0 + deg * per_edge).sum()), float(deg.sum())

    for eng in engines:
        g, cfg = eng.graph, eng.config
        state = mid_walk_state(eng, 8)
        ctx = eng.sampler_ctx
        keys_all = state.stream_keys()
        deg = degrees_of(g, state.cur)
        live = state.alive & (state.step < WALK_STEPS) & (deg > 0)
        part = eng.sampler.partition(ctx, state, live)
        params = ctx.params
        prog = eng.workload
        pname = prog.name.split("[")[0]
        is_n2v = pname == "node2vec"
        fb = torch.zeros_like(live)
        if bool(part.want_rjs.any()):
            cur, prev, step, idx = lanes_of(state, part.want_rjs)
            keys, bnd = keys_all[idx].contiguous(), \
                part.est.bound_max[idx].contiguous()
            run = lambda: erjs_select(g, prog, params, cur, prev, step, keys,
                                      bnd, trials=cfg.rjs_trials,
                                      rounds=cfg.rjs_max_rounds)
            got = run()
            ms = cuda_ms(run, reps)
            want = erjs_mod.erjs_step(g, prog, params, cur, prev, step, keys,
                                      bnd, cfg.rjs_trials, cfg.rjs_max_rounds)
            plain_ms = cuda_ms(lambda: erjs_mod.erjs_step(
                g, prog, params, cur, prev, step, keys, bnd, cfg.rjs_trials,
                cfg.rjs_max_rounds), 1)
            for x, y, what in zip(got, want, ("next", "fallback", "trials")):
                if not torch.equal(x, y):
                    fail(f"erjs_select [{pname}] at main-path shapes: "
                         f"{what} differs from erjs_step on "
                         f"{int((x != y).sum())} of {idx.numel()} lanes")
            fb[idx] = got[1]
            trials = got[2].to(torch.float64)
            nbytes = float((65.0 + trials * (8.0 + (4.0 * probes(
                degrees_of(g, prev)) if is_n2v else 0.0))).sum())
            ops = float(trials.sum()) * (4 * THREEFRY_OPS + 30)
            b_ms, b_by = bound(nbytes, ops)
            rows["erjs_select", pname] = dict(
                lanes=int(idx.numel()), ms=ms, plain_ms=plain_ms,
                max_abs_err=0, mismatches=0, bound_ms=b_ms, bound_by=b_by)
        rest = live & ~part.want_pre
        res_active = rest & (~part.want_rjs | fb)
        lo, hi = eng.sampler.reservoir_split(ctx, part, res_active)
        for jump, mask in ((False, lo), (True, hi)):
            name = "ervs_jump_select" if jump else "ervs_select"
            if not bool(mask.any()):
                continue
            cur, prev, step, idx = lanes_of(state, mask)
            keys = keys_all[idx].contiguous()
            plain = ervs_mod.ervs_jump_step if jump else ervs_mod.ervs_step
            run = lambda: ervs_select(g, prog, params, cur, prev, step, keys,
                                      tile=cfg.tile, jump=jump)
            got = run()
            ms = cuda_ms(run, reps)
            want = plain(g, prog, params, cur, prev, step, keys,
                         tile=cfg.tile)
            plain_ms = cuda_ms(lambda: plain(g, prog, params, cur, prev, step,
                                             keys, tile=cfg.tile), 1)
            n_bad, unexplained = k1_mismatches(g, prog, params, cur, prev,
                                               keys, got, want, cfg.tile,
                                               jump)
            if unexplained:
                fail(f"{name} [{pname}] at main-path shapes: {unexplained} "
                     f"differences from the plain version are not near-ties")
            nbytes, edges = scan_bytes(g, cur, prev, is_n2v)
            per_edge = (4 * THREEFRY_OPS + 80) if jump else THREEFRY_OPS + 40
            b_ms, b_by = bound(nbytes, edges * per_edge)
            rows[name, pname] = dict(
                lanes=int(idx.numel()), ms=ms, plain_ms=plain_ms,
                max_abs_err=int((got - want).abs().max()), mismatches=n_bad,
                bound_ms=b_ms, bound_by=b_by)
        if bool(part.want_pre.any()):
            cur, _, _, idx = lanes_of(state, part.want_pre)
            keys = keys_all[idx].contiguous()
            run = lambda: its_search(g, eng.precomp, cur, keys)
            got = run()
            ms = cuda_ms(run, reps)
            want = its_offsets(g, eng.precomp, cur, keys)
            plain_ms = cuda_ms(lambda: its_offsets(g, eng.precomp, cur, keys),
                               1)
            if not torch.equal(got, want):
                fail(f"its_search [{pname}] at main-path shapes: differs "
                     f"from its_offsets on {int((got != want).sum())} of "
                     f"{idx.numel()} lanes")
            pr = probes(degrees_of(g, cur))
            nbytes = float((44.0 + 4.0 * pr).sum())
            ops = float((THREEFRY_OPS + 10 + 3 * pr).sum())
            b_ms, b_by = bound(nbytes, ops)
            rows["its_search", pname] = dict(
                lanes=int(idx.numel()), ms=ms, plain_ms=plain_ms,
                max_abs_err=0, mismatches=0, bound_ms=b_ms, bound_by=b_by)
    for (name, pname), r in rows.items():
        log(f"time {name} [{pname}]: {r['lanes']} lanes, kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['mismatches']} "
            f"differences")
    return rows


def k4_work(eng, state0, emitted, flags, args: dict):
    """(bytes, operations) a K4 launch from ``state0`` must move and do on
    this run's data: each input read once and each output written once,
    plus per live step the degree, the step key and the regime's reads
    (scanned edges, eRJS trials, CDF probes, alias columns)."""
    import torch
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.core.types import StepStats as S
    from repro_torch.kernels.erjs import erjs_select
    from repro_torch.kernels.prng import fold_in

    g, kind = eng.graph, args["kind"]
    W, T = emitted.shape
    nbytes = W * (41.0 + 25.0 + 8.0 * T)
    ops = 0.0
    cur, prev, step = state0.cur, state0.prev, state0.step
    for t in range(T):
        f = flags[:, t]
        bit = lambda b: ((f >> b) & 1).bool()
        live = bit(S.LIVE)
        deg = degrees_of(g, cur).to(torch.float64)
        n_live = float(live.sum())
        nbytes += 8.0 * n_live
        ops += n_live * (THREEFRY_OPS + 20)
        scan = live if kind == "reservoir" else bit(S.FALLBACK) | bit(
            S.STALE)
        edges = float(deg[scan].sum())
        nbytes += 8.0 * edges
        ops += edges * (THREEFRY_OPS + 40)
        if kind == "rejection":
            idx = live.nonzero().squeeze(1)
            c = cur[idx]
            used = erjs_select(g, eng.workload, eng.sampler_ctx.params, c,
                               prev[idx], step[idx],
                               fold_in(state0.rng[idx], step[idx]),
                               args["bmax"][c], trials=args["rjs_trials"],
                               rounds=args["rjs_max_rounds"])[2]
            trials = float(used.sum())
            nbytes += 4.0 * n_live + 8.0 * trials
            ops += trials * (4 * THREEFRY_OPS + 30)
        elif kind.startswith("precomp"):
            pre = bit(S.PRECOMP)
            n_pre = float(pre.sum())
            nbytes += 5.0 * n_live + 4.0 * n_pre
            if kind == "precomp_its":
                pr = probes(degrees_of(g, cur[pre]))
                nbytes += 4.0 * float(pr.sum())
                ops += n_pre * (THREEFRY_OPS + 10) + 3.0 * float(pr.sum())
            else:
                nbytes += 8.0 * n_pre
                ops += n_pre * (THREEFRY_OPS + 10)
        moved = emitted[:, t] >= 0
        prev = torch.where(moved, cur, prev)
        cur = torch.where(moved, emitted[:, t].long(), cur)
        step = step + moved.long()
    return nbytes, ops


def time_fused(fused: dict) -> dict:
    """Phase 5b: one K4 launch of ``K4_EPOCH`` steps per regime from the
    state after 8 steps, and K5 at the step-8 lanes, each held against
    its plain version on the same state as in phase 3.  The reservoir
    regime is held against its plain version over
    ``K4_RESERVOIR_PLAIN_EPOCH`` steps of every walker, and its row reports
    that comparison (kernel, plain and bound alike); its ``K4_EPOCH``-step
    launch is timed beside it (``epoch16_ms``)."""
    import torch
    from repro_torch.core.precomp import alias_offsets
    from repro_torch.kernels import megastep
    from repro_torch.kernels.alias import alias_pick

    rows = {}
    for kind, eng in fused.items():
        g, cfg = eng.graph, eng.config
        p = eng.sampler_ctx.params
        state = mid_walk_state(eng, 8)
        args = dict(kind=kind, tile=cfg.tile, rjs_trials=cfg.rjs_trials,
                    rjs_max_rounds=cfg.rjs_max_rounds, epoch_len=K4_EPOCH,
                    num_steps=WALK_STEPS, bmax=eng._fused_bmax,
                    tables=eng.precomp)
        launch = lambda: megastep.fused_epoch(g, eng.workload, p, state,
                                              **args)
        # K4 already ran in phases 3 and 4: this launch is warm
        got, ms = cuda_once(launch)
        b_ms, b_by = bound(*k4_work(eng, state, got[1], got[2], args))
        extra = {}
        if kind == "reservoir":
            extra = dict(epoch16_ms=ms, epoch16_bound_ms=b_ms)
            args.update(epoch_len=K4_RESERVOIR_PLAIN_EPOCH)
            got, ms = cuda_once(launch)
            b_ms, b_by = bound(*k4_work(eng, state, got[1], got[2], args))
        want, plain_ms = cuda_once(lambda: megastep.fused_epoch_plain(
            g, eng.workload, p, state, **args))
        n_bad, unexplained = k4_mismatches(eng, state, got, want, cfg.tile)
        del got, want
        if unexplained:
            fail(f"fused_epoch_{kind} at main-path shapes: {unexplained} "
                 f"walkers differ from the plain version other than at a "
                 f"reservoir near-tie")
        rows[f"fused_epoch_{kind}", "deepwalk"] = dict(
            lanes=int(state.cur.numel()), steps=args["epoch_len"], ms=ms,
            plain_ms=plain_ms, max_abs_err=0, mismatches=n_bad,
            bound_ms=b_ms, bound_by=b_by, **extra)
        if kind == "precomp_alias":
            keys_all = state.stream_keys()
            live = state.alive & (state.step < WALK_STEPS)
            idx = live.nonzero().squeeze(1)
            cur, keys = state.cur[idx].contiguous(), keys_all[idx].contiguous()
            tables = eng.precomp
            run = lambda: alias_pick(g, tables, cur, keys)
            got = run()
            ms = cuda_ms(run, 5)
            want, plain_ms = cuda_once(lambda: alias_offsets(g, tables, cur,
                                                             keys))
            if not torch.equal(got, want):
                fail(f"alias_pick at main-path shapes: differs from "
                     f"alias_offsets on {int((got != want).sum())} of "
                     f"{idx.numel()} lanes")
            n = float(idx.numel())
            b_ms, b_by = bound(52.0 * n, n * (THREEFRY_OPS + 10))
            rows["alias_pick", "deepwalk"] = dict(
                lanes=int(n), ms=ms, plain_ms=plain_ms, max_abs_err=0,
                mismatches=0, bound_ms=b_ms, bound_by=b_by)
    for (name, pname), r in rows.items():
        steps = f" x {r['steps']} steps" if "steps" in r else ""
        extra = (f"; its {K4_EPOCH}-step launch {r['epoch16_ms']:.4f} ms, "
                 f"bound {r['epoch16_bound_ms']:.4f} ms"
                 if "epoch16_ms" in r else "")
        log(f"time {name} [{pname}]: {r['lanes']} lanes{steps}, kernel "
            f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['mismatches']} "
            f"walkers differ{extra}")
    return rows


SOURCES = {
    "ervs_select": ("src/repro_torch/kernels/csrc/ervs.cu",
                    "src/repro/kernels/megastep_kernel.py:185"),
    "ervs_jump_select": ("src/repro_torch/kernels/csrc/ervs.cu",
                         "src/repro/kernels/megastep_kernel.py:185"),
    "erjs_select": ("src/repro_torch/kernels/csrc/erjs.cu",
                    "src/repro/kernels/megastep_kernel.py:225"),
    "its_search": ("src/repro_torch/kernels/csrc/its.cu",
                   "src/repro/kernels/precomp_kernel.py:95"),
    "alias_pick": ("src/repro_torch/kernels/csrc/alias.cu",
                   "src/repro/kernels/precomp_kernel.py:154"),
    **{f"fused_epoch_{kind}": ("src/repro_torch/kernels/csrc/megastep.cu",
                               "src/repro/kernels/megastep_kernel.py:423")
       for kind in FUSED_METHODS},
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=LJ_NODES)
    ap.add_argument("--steps", type=int, default=WALK_STEPS)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed runs per kernel in phase 5")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs an NVIDIA GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import EngineConfig, WalkEngine
    from repro_torch.graphs import power_law_graph
    from repro_torch.kernels import build
    from repro_torch.walks import deepwalk, node2vec

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(build.SOURCES)} "
        f"sources")
    for f in sorted(build.build_dir().glob("*.log")):
        regs = [ln.strip() for ln in f.read_text().splitlines()
                if "registers" in ln]
        for ln in regs:
            log(f"ptxas {f.stem.split('-')[0]}: {ln}")

    # 2. graph, statistics, tables
    t0 = time.perf_counter()
    graph = power_law_graph(args.nodes, LJ_AVG_DEGREE,
                            weight_dist="uniform", seed=0).to("cuda")
    log(f"graph: V={graph.num_nodes} E={graph.num_edges} "
        f"maxdeg={graph.max_degree()} built in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = EngineConfig(method="adaptive", jump_threshold=JUMP_THRESHOLD)
    t0 = time.perf_counter()
    n2v = WalkEngine(graph, node2vec(), cfg)
    t1 = time.perf_counter()
    dw = WalkEngine(graph, deepwalk(), cfg)
    torch.cuda.synchronize()
    log(f"engines: node2vec {t1 - t0:.1f} s (node stats), deepwalk "
        f"{time.perf_counter() - t1:.1f} s (node stats + ITS tables)")
    fused = {}
    for kind, method in FUSED_METHODS.items():
        t0 = time.perf_counter()
        fused[kind] = WalkEngine(graph, deepwalk(), EngineConfig(
            method=method, step_exec="fused"))
        torch.cuda.synchronize()
        log(f"engine deepwalk/{method} (fused): "
            f"{time.perf_counter() - t0:.1f} s, step_exec resolved "
            f"{fused[kind].step_exec_resolved!r}")

    # 3. kernels against their plain versions
    check_kernels(graph, n2v, dw, seed=11)
    log("check: erjs_select and its_search bitwise equal to their plain "
        "versions")
    check_fused(graph, fused, seed=12)
    check_small_engine()

    # 4. the main path, one run per program, then each fused method
    launches = {}
    for eng, need in ((n2v, ("ervs_select", "ervs_jump_select",
                             "erjs_select")),
                      (dw, ("its_search", "ervs_select"))):
        counts = main_path(eng, args.steps, need)
        for name in need:
            launches[name, eng.workload.name.split("[")[0]] = counts[name]
    for kind, method in FUSED_METHODS.items():
        t0 = time.perf_counter()
        staged = WalkEngine(graph, deepwalk(), EngineConfig(
            method=method, step_exec="staged"))
        log(f"engine deepwalk/{method} (staged): "
            f"{time.perf_counter() - t0:.1f} s")
        n, staged_counts = fused_main_path(fused[kind], staged, args.steps)
        launches[f"fused_epoch_{kind}", "deepwalk"] = n
        if kind == "precomp_alias":
            launches["alias_pick", "deepwalk"] = staged_counts["alias_pick"]
        del staged

    # 5. kernel times at main-path shapes
    rows = time_kernels((n2v, dw), args.reps)
    rows.update(time_fused(fused))
    kernels = []
    for (name, pname), n in launches.items():
        if (name, pname) not in rows:
            fail(f"{name} [{pname}]: the main path launched it but step 8 "
                 f"gave it no lanes to time")
        r = rows[name, pname]
        src, replaces = SOURCES[name]
        kernels.append({
            "name": f"{name}/{pname}", "route": "cuda", "source": src,
            "replaces": replaces, "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "lanes": r["lanes"], "mismatches": r["mismatches"],
            **{k: r[k] for k in ("steps", "epoch16_ms", "epoch16_bound_ms")
               if k in r}})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
