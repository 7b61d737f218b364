#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU — the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build   — compile K1–K3 from ``src/repro_torch/kernels/csrc`` with nvcc
             (one process per source, in parallel).
2. graph   — ``power_law_graph`` at soc-LiveJournal1 scale (4,847,571
             nodes, average degree 14, uniform weights, seed 0), the node
             statistics and deepwalk's ITS tables.
3. check   — each kernel against its plain PyTorch version on the card, on
             a few thousand walkers of the full graph (hubs included):
             K2 and K3 bitwise; K1 bitwise or differing only at near-ties
             (two float32 keys within 2 ulp); then the whole engine on a
             small graph, kernels (cuda) against plain versions (cpu).
4. main    — ``WalkEngine(graph, program, EngineConfig(method="adaptive",
             jump_threshold=8)).run(np.arange(V), num_steps=80)`` for
             node2vec, then deepwalk, with the launch counts reset just
             before each run and read just after, and ``run()``'s own
             host-clock split (setup, admit, steps, harvest).  Every
             emitted step must be an edge and stopped lanes must emit -1.
5. timing  — each kernel and its plain version on the lanes one main-path
             step hands it (the state after 8 steps) under each program
             that launches it, with CUDA events; the kernel must agree
             with the plain version there as in phase 3.

``jump_threshold`` is lowered from the default 1024 to 8, the cost
model's ``min_rjs_degree``: at uniform weights Eq. 11 sends every hub to
eRJS, which resolves without fallbacks, so at 1024 the jump reservoir
would serve no lane at all.  At 8 it serves the reservoir lanes the cost
model could have sent to eRJS but did not, and plain eRVS the rows
shorter than eRJS's minimum.

The line before the last is a JSON object with one entry per kernel and
program (``"ervs_select/deepwalk"``, ...); the last line is ``{"ok": true, "device": {...}}``.
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


def check_small_engine() -> None:
    """Phase 3b: the whole engine on a small graph, kernels on the card
    against the plain versions on the CPU — paths and telemetry."""
    import numpy as np
    from repro_torch.core import EngineConfig, WalkEngine
    from repro_torch.graphs import power_law_graph
    from repro_torch.walks import make_workload

    g = power_law_graph(3000, 8, seed=5)
    starts = np.arange(g.num_nodes)
    for name in ("node2vec", "deepwalk"):
        res = {}
        for dev in ("cuda", "cpu"):
            eng = WalkEngine(g, make_workload(name), EngineConfig(
                method="adaptive", jump_threshold=JUMP_THRESHOLD, device=dev))
            res[dev] = eng.run(starts, num_steps=20, batch=1024, epoch_len=7)
        a, b = res["cuda"], res["cpu"]
        same = (a.paths == b.paths).all(axis=1)
        log(f"check engine [{name}] on V=3000: cuda paths equal cpu paths "
            f"on {same.mean():.6f} of queries; frac_rjs {a.frac_rjs:.4f} / "
            f"{b.frac_rjs:.4f}, frac_precomp {a.frac_precomp:.4f} / "
            f"{b.frac_precomp:.4f}")
        if not same.all() or (a.frac_rjs, a.frac_precomp, a.rjs_fallbacks) \
                != (b.frac_rjs, b.frac_precomp, b.rjs_fallbacks):
            fail(f"engine [{name}]: kernel run differs from the plain run")


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


SOURCES = {
    "ervs_select": ("src/repro_torch/kernels/csrc/ervs.cu",
                    "src/repro/kernels/megastep_kernel.py:185"),
    "ervs_jump_select": ("src/repro_torch/kernels/csrc/ervs.cu",
                         "src/repro/kernels/megastep_kernel.py:185"),
    "erjs_select": ("src/repro_torch/kernels/csrc/erjs.cu",
                    "src/repro/kernels/megastep_kernel.py:225"),
    "its_search": ("src/repro_torch/kernels/csrc/its.cu",
                   "src/repro/kernels/precomp_kernel.py:95"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=LJ_NODES)
    ap.add_argument("--steps", type=int, default=WALK_STEPS)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed runs per kernel in phase 5")
    args = ap.parse_args()

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

    # 3. kernels against their plain versions
    check_kernels(graph, n2v, dw, seed=11)
    log("check: erjs_select and its_search bitwise equal to their plain "
        "versions")
    check_small_engine()

    # 4. the main path, one run per program
    launches = {}
    for eng, need in ((n2v, ("ervs_select", "ervs_jump_select",
                             "erjs_select")),
                      (dw, ("its_search", "ervs_select"))):
        counts = main_path(eng, args.steps, need)
        for name in need:
            launches[name, eng.workload.name.split("[")[0]] = counts[name]

    # 5. kernel times at main-path shapes
    rows = time_kernels((n2v, dw), args.reps)
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
            "lanes": r["lanes"], "mismatches": r["mismatches"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
