#!/usr/bin/env python3
"""K6 (``ops.ervs_select``), K7 (``ops.erjs_select``) and the aligned
entries of K3 and K5 (``ops.its_search``, ``ops.alias_pick``) on the
walker sets of ``chip_smoke.py``'s phase 2b, on the card, beside the same
kernels built from other trees.

    PYTHONPATH=src python tools/time_block_ops.py [--nodes N] [--reps 3] \\
        [--other DIR ...] [--op ervs|erjs|its|alias ...] \\
        [--l2-fetch BYTES ...]

Builds the graph the smoke runs (soc-LiveJournal1 scale by default), the
aligned weight stream of the whole graph and the two walker sets of
``chip_smoke.ops_sets``: ``all_rows`` (one walker per node) and
``deepwalk_lanes`` (the adaptive deepwalk run's lanes after
``chip_smoke.MID_STEP`` steps).  On every walker of each set it runs K6
and K7 of this tree and of each ``--other`` tree (a checkout or a ``git
archive`` of another commit, built by that tree's own
``kernels/build.py``; repeatable), fails (after every cell ran) unless
every tree gives this tree's outputs bit for bit, and times them with
CUDA events in turns: the others, this tree twice, the others in reverse.
Each tree's kernels run through that tree's own ``kernels/ops.py``, so
trees whose kernels take other arguments compare alike.  K6's plan and
table pass is timed alone too, and a call's peak device memory is
printed (``chip_smoke.ervs_peak``); beside K7, torch's gather of the
weights its trials read (``ref.erjs_reads_ref``, in trial order): the
card's rate for the same random reads; with ``--l2-fetch``, K7 and the
gather again under each largest L2 fetch size (the context's
``CU_LIMIT_MAX_L2_FETCH_GRANULARITY``; the default is printed and
restored).  K3 and K5 run on both sets (the smoke drives them on
``all_rows``; ``deepwalk_lanes`` takes K3's rows of more than 16 entries),
on the aligned streams of the deepwalk tables (``build_tables``, alias
included); beside each, in the same turns, torch's gather of one entry of
each distinct 32 B sector their plain version reads
(``chip_smoke.aligned_draw_work``).  Each cell prints its bound
(``chip_smoke.ervs_block_work`` / ``erjs_block_work`` / ``its_work`` /
``alias_work``) and the card's name, power limit and SM clock come first.
Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
import chip_smoke  # noqa: E402  (the sets' one definition)
from time_reservoir import other_libs  # noqa: E402

#: the libraries the cells swap
SWAPPED = ("ervs_block", "erjs_block", "its", "alias")
#: (cell, tree) pairs whose outputs differed from this tree's
DIFFERED = []


def other_ops(tree: Path):
    """``tree``'s ``kernels/ops.py`` as a module of its own: its wrappers
    call their libraries with that tree's arguments (through this tree's
    ``build``, whose libraries ``running`` swaps)."""
    spec = importlib.util.spec_from_file_location(
        f"ops_{abs(hash(str(tree)))}",
        tree / "src/repro_torch/kernels/ops.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def running(libs):
    """This tree's wrappers launching ``libs``' kernels."""
    from repro_torch.kernels import build

    mine = {s: build._LIBS[s] for s in SWAPPED}
    if libs:
        build._LIBS.update({s: libs[s] for s in SWAPPED})
    try:
        yield
    finally:
        build._LIBS.update(mine)


def kernel_times(label, fn, reps) -> None:
    """Device milliseconds of each kernel (and memset) ``fn`` launches, a
    call's mean over ``reps`` calls (``torch.profiler``), and the call's
    time on CUDA events beside them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {e.key: e.self_device_time_total / 1e3 / reps
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0}
    text = ", ".join(f"{k.split('(')[0][-40:]} {v:.4f}"
                     for k, v in sorted(parts.items(), key=lambda x: -x[1]))
    print(f"[block] {label}: device ms a call {sum(parts.values()):.4f} "
          f"({text}); events {chip_smoke.cuda_ms(fn, reps):.4f} ms",
          flush=True)


def l2_fetch(size=None) -> int:
    """The current CUDA context's largest L2 fetch in bytes
    (``CU_LIMIT_MAX_L2_FETCH_GRANULARITY``), set to ``size`` first when
    one is given."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    limit = 0x05
    if size is not None and cu.cuCtxSetLimit(limit, ctypes.c_size_t(size)):
        raise SystemExit(f"cuCtxSetLimit(L2 fetch, {size}) failed")
    got = ctypes.c_size_t()
    if cu.cuCtxGetLimit(ctypes.byref(got), limit):
        raise SystemExit("cuCtxGetLimit(L2 fetch) failed")
    return got.value


def same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def cell(label, fns, reps, b_ms, b_by, beside=None) -> None:
    """Compare every ``fns`` entry (name -> callable) with the first, then
    time them in turns: the others, the first twice, the others in
    reverse; ``beside`` (name -> callable, not compared) is timed in the
    same turns, before the others and after them."""
    names = list(fns)
    want = fns[names[0]]()
    for name in names[1:]:
        if not same(fns[name](), want):
            DIFFERED.append((label, name))
            print(f"[block] {label}: {name} DIFFERS", flush=True)
    print(f"[block] {label}: {len(names)} runs compared on every walker, "
          f"{sum(c == label for c, _ in DIFFERED)} differ; bound "
          f"{b_ms:.4f} ms ({b_by})", flush=True)
    others = names[1:]
    fns = {**fns, **(beside or {})}
    extra = list(beside or {})
    for name in extra + others + [names[0]] * 2 + others[::-1] + extra:
        ms = chip_smoke.cuda_ms(fns[name], reps)
        print(f"[block] {label} {name}: {ms:.4f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=chip_smoke.LJ_NODES)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--other", type=Path, action="append", default=[])
    ap.add_argument("--op", choices=("ervs", "erjs", "its", "alias"),
                    action="append")
    ap.add_argument("--l2-fetch", type=int, action="append", default=[])
    args = ap.parse_args()
    ops_wanted = set(args.op or ("ervs", "erjs", "its", "alias"))

    import torch
    from repro_torch.core import EngineConfig, WalkEngine, build_tables
    from repro_torch.graphs import power_law_graph
    from repro_torch.kernels import build, ops, ref
    from repro_torch.walks import make_workload

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:  # every tree's nvcc runs at once
        built = [pool.submit(other_libs, tree) for tree in args.other]
        build.build_all()
        built = [(str(t), *b.result(), other_ops(t))
                 for t, b in zip(args.other, built)]
        trees = [(t, libs, mod) for t, libs, _, mod in built]
    print(f"[block] build: {time.perf_counter() - t0:.1f} s", flush=True)
    logs = [("this", {s: build._lib_path(f"{s}.cu") for s in SWAPPED})] \
        + [(t, paths) for t, _, paths, _ in built]
    for tree, paths in logs:
        for stem in SWAPPED:
            path = Path(paths[stem]) if stem in paths else None
            if path is None or not path.with_suffix(".log").exists():
                continue
            for name, what in chip_smoke.ptxas_lines(
                    path.with_suffix(".log").read_text()):
                print(f"[ptxas] {tree} {name[:40]}: {what}", flush=True)
    g = power_law_graph(args.nodes, chip_smoke.LJ_AVG_DEGREE,
                        weight_dist="uniform", seed=0).to("cuda")
    eng = WalkEngine(g, make_workload("deepwalk"), EngineConfig(
        method="adaptive", jump_threshold=chip_smoke.JUMP_THRESHOLD))
    w2d, row0, degs, sets = chip_smoke.ops_sets(g, eng)
    h_max = eng.sampler_ctx.stats.h_max
    del eng
    if ops_wanted & {"its", "alias"}:
        wl = make_workload("deepwalk")
        tables = build_tables(g, wl, wl.params())
        cdf2d, prob2d, alias2d, _, _ = ops.aligned_precomp_tables(
            tables, g.indptr)
    trials, rounds = chip_smoke.OPS_ERJS_BUDGET
    for label, (nodes, key) in sets.items():
        r0, dg, seeds = chip_smoke.ops_walkers(row0, degs, nodes, key)
        d = dg.double()
        print(f"[block] {label}: {r0.numel()} walkers, mean degree "
              f"{float(d.mean()):.2f}, {int(torch.unique(nodes).numel())} "
              f"distinct rows", flush=True)
        if "ervs" in ops_wanted:
            got = ops.ervs_select(w2d, r0, dg, seeds)
            b = chip_smoke.pipe_bound(*chip_smoke.ervs_block_work(
                nodes, dg, got[1], got[2]))
            print(f"[block] ervs/{label}: mean draws "
                  f"{float(got[1].double().mean()):.4f}, jumped "
                  f"{float(got[2].double().mean()):.4f}", flush=True)
            fns = {"this": lambda: ops.ervs_select(w2d, r0, dg, seeds)}

            def k6(libs, mod):
                with running(libs):
                    return mod.ervs_select(w2d, r0, dg, seeds)
            fns.update({t: (lambda libs=libs, mod=mod: k6(libs, mod))
                        for t, libs, mod in trees})
            cell(f"ervs/{label}", fns, args.reps, *b)
            kernel_times(f"ervs/{label}", lambda: ops.ervs_select(
                w2d, r0, dg, seeds), args.reps)
            ms = chip_smoke.cuda_ms(lambda: ops._ervs_tables(w2d, r0, dg),
                                    args.reps)
            t = ops._ervs_tables(w2d, r0, dg)
            peak = chip_smoke.ervs_peak(w2d, r0, dg, seeds)
            print(f"[block] ervs/{label}: plan and table pass {ms:.4f} ms "
                  f"({t.n_jobs} jobs, {t.n_tiles} tiles, {t.m_len} M "
                  f"entries); a call's peak device memory "
                  f"{peak / 2**20:.1f} MiB", flush=True)
        if "erjs" in ops_wanted:
            bnd = h_max[nodes].contiguous()
            got = ops.erjs_select(w2d, r0, dg, bnd, seeds, trials, rounds)
            sectors = chip_smoke.erjs_sectors(w2d, r0, dg, seeds, got[1])
            b = chip_smoke.pipe_bound(*chip_smoke.erjs_block_work(got[1],
                                                                  sectors))
            at = ref.erjs_reads_ref(w2d, r0, dg, seeds, got[1])
            flat = w2d.view(-1)
            gather_ms = chip_smoke.cuda_ms(lambda: flat[at], args.reps)
            default = l2_fetch()
            for size in args.l2_fetch:
                got_size = l2_fetch(size)
                ms = chip_smoke.cuda_ms(lambda: flat[at], args.reps)
                l2_fetch(default)
                print(f"[block] erjs/{label}: gather with the L2 fetch at "
                      f"{got_size} B (default {default} B): {ms:.4f} ms",
                      flush=True)
            print(f"[block] erjs/{label}: mean trials "
                  f"{float(got[1].double().mean()):.4f}, {at.numel()} reads "
                  f"in {sectors} distinct 32 B sectors; torch's gather of "
                  f"those weights {gather_ms:.4f} ms", flush=True)

            def k7(libs, mod):
                with running(libs):
                    return mod.erjs_select(w2d, r0, dg, bnd, seeds, trials,
                                           rounds)

            def at_fetch(size):
                l2_fetch(size)
                return k7(None, ops)
            fns = {"this": lambda: at_fetch(default)}
            fns.update({f"this/l2fetch{size}":
                        (lambda size=size: at_fetch(size))
                        for size in args.l2_fetch})
            fns.update({t: (lambda libs=libs, mod=mod: k7(libs, mod))
                        for t, libs, mod in trees})
            cell(f"erjs/{label}", fns, args.reps, *b)
            l2_fetch(default)
        for op in ("its", "alias"):
            if op not in ops_wanted:
                continue
            tot = tables.total[nodes].contiguous()
            streams = (cdf2d,) if op == "its" else (prob2d, alias2d)
            drawn = chip_smoke.aligned_draw_work(op, streams, r0, dg, tot,
                                                 seeds)
            n = r0.numel()
            b = chip_smoke.pipe_bound(*drawn.work)
            print(f"[block] {op}/{label}: {drawn.reads / n:.4f} reads and "
                  f"{drawn.sectors / n:.4f} distinct 32 B sectors a walker "
                  f"({drawn.sectors} sectors); rows of at most 8 / 16 "
                  f"entries "
                  f"{float((dg <= 8).double().mean()):.4f} / "
                  f"{float((dg <= 16).double().mean()):.4f}", flush=True)
            flats = [(st.view(-1), idx) for st, idx in drawn.firsts]

            def draw(mod, op=op, tot=tot):
                return (mod.its_search(cdf2d, r0, dg, tot, seeds),) \
                    if op == "its" else \
                    (mod.alias_pick(prob2d, alias2d, r0, dg, tot, seeds),)

            def k35(libs, mod, draw=draw):
                with running(libs):
                    return draw(mod)
            fns = {"this": lambda draw=draw: draw(ops)}
            fns.update({t: (lambda libs=libs, mod=mod, k35=k35:
                            k35(libs, mod)) for t, libs, mod in trees})
            cell(f"{op}/{label}", fns, args.reps, *b, beside={
                "gather": lambda flats=flats: [f[i] for f, i in flats]})
    if DIFFERED:
        raise SystemExit(f"[block] trees differ: {DIFFERED}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
