#!/usr/bin/env python3
"""The plain reservoir scan (K4's reservoir regime and plain K1), K4's
other regimes and K2 on the lanes the main path hands them, on the card,
beside the same kernels built from other trees.

    PYTHONPATH=src python tools/time_reservoir.py [--nodes N] [--reps 3] \
        [--other DIR ...] [--no-regimes] [--cell NAME ...] [--split]

Builds the graph ``chip_smoke.py`` runs (soc-LiveJournal1 scale by
default) and times, with CUDA events, on the cells of the smoke:

* ``k4_deepwalk_1`` / ``k4_deepwalk_16``: K4's reservoir regime on every
  deepwalk walker at its mid-walk state (``chip_smoke.MID_STEP``), one
  step and a 16-step launch;
* ``k4_ppr_nibble_16``: the hooked instance on ppr_nibble, 16 steps;
* ``k4_<program>_<regime>``: K4's other regimes on deepwalk and
  ppr_nibble, 16 steps, as the smoke times them (their scans are the
  eRJS fallbacks and stale rows);
* ``k1_staged_ervs``: plain K1 on the live lanes of the staged ``ervs``
  method on deepwalk; ``k1_random``: on the reservoir lanes of node2vec
  under the ``random`` selector; ``k1_adaptive_node2vec``: on adaptive
  node2vec's plain reservoir lanes (as ``chip_smoke.main_path_split``
  takes them);
* ``k2_<program>``: K2 on the eRJS lanes of the six programs that run it
  (``chip_smoke.main_path_split`` at ``chip_smoke.MID_STEP``), with what
  its trials did (walkers pending after round 0, fallbacks, mean
  proposals);
* ``k3_<program>``: K3 on the precomp lanes of adaptive deepwalk and
  ppr_nibble (``chip_smoke.main_path_split``); ``k5_<program>``: K5 on
  the live lanes of their fused ``alias_precomp`` engines at the same
  step, as ``chip_smoke.time_fused`` takes them.  Both warm (launches
  back to back) and cold (``chip_smoke.cold_ms``: L2 flushed before each
  launch).  With ``--split`` each also runs on the same walkers moved to
  the graph's shortest rows (``/short_rows``: what a walker costs beside
  its row's search) and sorted by row (``/by_row``: neighbouring walkers
  share their rows' sectors).

Each cell's bound is the smoke's (``chip_smoke.pipe_bound``).  With
``--other DIR`` (a checkout or a ``git archive`` of another commit;
repeatable) it builds that tree's kernels with that tree's own
``kernels/build.py`` and runs them on the same inputs through this tree's
wrappers, in turns (the others, this tree twice, the others in reverse),
and fails (after every cell ran) unless every tree gives the same next
nodes (K2: and fallbacks and proposals made), emitted nodes, flag words
and end state (program state included) on every walker.  Unless
``--no-regimes``, it also holds the trees' scans equal where K4's other
regimes run them, on deepwalk and ppr_nibble: the rejection regime with
every trial budget at 1 (the fallbacks) and both precomp regimes with
every third row stale, 16 steps each.  ``--cell`` (repeatable) times
only the cells named; ``--no-regimes`` skips those comparisons but not
the regime cells named.  Prints the card's name, power
limit and SM clock first, and each tree's scan edge loops from its SASS.
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
import chip_smoke  # noqa: E402  (the cells' one definition)

STEPS = 16


def other_libs(tree: Path) -> dict:
    """``tree``'s kernels, built by its own ``kernels/build.py``: its
    libraries by source stem, and their paths."""
    spec = importlib.util.spec_from_file_location(
        f"build_{abs(hash(str(tree)))}",
        tree / "src/repro_torch/kernels/build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_all(), {s: mod._lib_path(f"{s}.cu") for s in SWAPPED}


#: the libraries whose kernels the cells time
SWAPPED = ("ervs", "erjs", "megastep", "its", "alias")


class OneLaunchErjs:
    """The erjs library of a tree whose K2 took no scratch list, behind
    this tree's entry point: the list's pointer is dropped.  It exists for
    the trees from before K2's later rounds had a kernel of their own
    (their ``repro_erjs_select`` has no ``todo`` argument): the parents of
    the two-launch K2 that PERF.md's design steps were timed against.
    Trees with the list need no shim."""

    def __init__(self, lib):
        self.lib = lib

    def repro_erjs_select(self, *args):
        return self.lib.repro_erjs_select(*args[:-2], args[-1])


#: what the cells' tables hand the kernels, for trees that read the
#: tables another way: the pair table's address -> (keep probabilities,
#: alias offsets), the node records' address -> (indptr, total)
PAIRS, ROWS = {}, {}


def register_tables(graph, tables) -> None:
    """Note ``tables``' pair table and node records for the shims."""
    rows = tables.draw_rows(graph.indptr)
    ROWS[rows.data_ptr()] = (graph.indptr.data_ptr(),
                             tables.total.data_ptr())
    if tables.alias_off is not None:
        PAIRS[tables.alias_pair.data_ptr()] = (tables.alias_prob.data_ptr(),
                                               tables.alias_off.data_ptr())


class SplitTables:
    """The its, alias or megastep library of a tree from before the fence,
    pair and node-record tables, behind this tree's entry points: K3
    searches the CDF by indptr and total without the fence table, K5 and
    K4's alias instance read the keep probabilities and alias offsets
    (``ROWS``, ``PAIRS``).  It exists for the parents of that design,
    which PERF.md's design steps were timed against."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def repro_its_search(self, rows, cdf, fence, n_edges, *rest):
        indptr, total = ROWS[rows]
        return self.lib.repro_its_search(indptr, cdf, total, *rest)

    def repro_alias_pick(self, rows, pair, *rest):
        indptr, total = ROWS[rows]
        return self.lib.repro_alias_pick(indptr, *PAIRS[pair], total, *rest)

    def repro_fused_epoch(self, *args):
        # after the 16 arguments up to the bound table: cdf, fence, n_edges,
        # total, pair, invalid, where the parent took cdf, total, prob,
        # alias, invalid
        cdf, _, _, total, pair, invalid = args[16:22]
        prob, alias = PAIRS.get(pair, (None, None))
        return self.lib.repro_fused_epoch(*args[:16], cdf, total, prob, alias,
                                          invalid, *args[22:])


class CsrTables:
    """The its or alias library of a design tree with the fence and pair
    tables whose K3 and K5 read indptr and total instead of the node
    records (``ROWS``)."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def repro_its_search(self, rows, cdf, fence, *rest):
        indptr, total = ROWS[rows]
        return self.lib.repro_its_search(indptr, cdf, fence, total, *rest)

    def repro_alias_pick(self, rows, pair, *rest):
        indptr, total = ROWS[rows]
        return self.lib.repro_alias_pick(indptr, pair, total, *rest)


def as_this_tree(stem: str, lib):
    """``lib`` callable as this tree's wrappers call library ``stem``."""
    from repro_torch.kernels import build

    sig = lambda name: len(dict(build._SIGNATURES[stem])[name])
    if stem == "erjs" and len(lib.repro_erjs_select.argtypes) \
            == sig("repro_erjs_select") - 1:
        return OneLaunchErjs(lib)
    # arguments the other layouts take beside this tree's: (split, csr)
    other = {"its": ("repro_its_search", -1, 1),
             "alias": ("repro_alias_pick", 2, 1),
             "megastep": ("repro_fused_epoch", -1, None)}
    if stem in other:
        name, split, csr = other[stem]
        extra = len(getattr(lib, name).argtypes) - sig(name)
        if extra == split:
            return SplitTables(lib)
        if extra == csr:
            return CsrTables(lib)
    return lib


@contextlib.contextmanager
def running(libs: dict):
    """This tree's wrappers launching ``libs``' ervs, erjs and megastep."""
    from repro_torch.kernels import build

    mine = {s: build._LIBS[s] for s in SWAPPED}
    build._LIBS.update({s: as_this_tree(s, libs[s]) for s in mine})
    try:
        yield
    finally:
        build._LIBS.update(mine)


def same(a, b) -> bool:
    """Whether two results (a tensor, K2's (next, fallback, used), or K4's
    (state, emitted, flags)) are equal bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a[0], torch.Tensor):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    (s1, e1, f1), (s2, e2, f2) = a, b
    ok = torch.equal(e1, e2) and torch.equal(f1, f2)
    for f in ("cur", "prev", "step", "alive"):
        ok = ok and torch.equal(getattr(s1, f), getattr(s2, f))
    for x, y in zip(s1.wstate or (), s2.wstate or ()):
        ok = ok and torch.equal(x, y)
    return ok


#: (cell, tree) pairs that differed from this tree; the run fails at its
#: end if any did
DIFFERED = []


def compare(label: str, fn, trees) -> None:
    """Note every tree whose ``fn()`` differs from this tree's."""
    want = fn()
    for tree, libs in trees:
        with running(libs):
            got = fn()
        if not same(got, want):
            DIFFERED.append((label, tree))
            print(f"[reservoir] {label}: {tree} DIFFERS from this tree",
                  flush=True)
    print(f"[reservoir] {label}: {len(trees) + 1} trees compared on every "
          f"walker, {sum(c == label for c, _ in DIFFERED)} differ",
          flush=True)


#: the programs whose main path runs K2
K2_PROGRAMS = tuple(p for p, need in chip_smoke.ADAPTIVE_NEEDS.items()
                    if "erjs_select" in need)
CELLS = ("k4_deepwalk_1", "k4_deepwalk_16", "k4_ppr_nibble_16",
         "k1_staged_ervs", "k1_random", "k1_adaptive_node2vec",
         *(f"k4_{p}_{k}" for p in chip_smoke.FUSED_PROGRAMS
           for k in ("rejection", "precomp_its", "precomp_alias")),
         *(f"k2_{p}" for p in K2_PROGRAMS),
         *(f"k{k}_{p}" for k in (3, 5) for p in chip_smoke.FUSED_PROGRAMS))
#: the cells to time (``--cell``)
WANT = set(CELLS)


def timed(label: str, fn, trees, reps: int, b_ms: float, b_by: str,
          cold: bool = False) -> None:
    """``compare``, then time each tree's ``fn`` in turns (with ``cold``,
    also with the L2 flushed before each launch)."""
    if label.split("/")[0] not in WANT:
        return
    compare(label, fn, trees)
    print(f"[reservoir] {label}: bound {b_ms:.4f} ms ({b_by})", flush=True)
    order = trees + [("this", None)] * 2 + trees[::-1]
    for tree, libs in order:
        ctx = running(libs) if libs else contextlib.nullcontext()
        with ctx:
            ms = chip_smoke.cuda_ms(fn, reps)
            c_ms = chip_smoke.cold_ms(fn, reps) if cold else None
        print(f"[reservoir] {label} {tree}: {ms:.4f} ms"
              + (f", cold {c_ms:.4f} ms" if cold else ""), flush=True)


def k4_cells(g, eng, pname, trees, reps, regimes) -> None:
    """K4's reservoir regime of ``pname`` (its fused ervs engine) from its
    mid-walk state, and the scans of the other regimes."""
    from repro_torch.kernels import megastep

    p = eng["reservoir"].sampler_ctx.params
    prog = eng["reservoir"].workload
    state = chip_smoke.mid_walk_state(eng["reservoir"],
                                      chip_smoke.MID_STEP[pname])
    cfg = eng["reservoir"].config
    base = dict(tile=cfg.tile, rjs_trials=cfg.rjs_trials,
                rjs_max_rounds=cfg.rjs_max_rounds,
                num_steps=chip_smoke.WALK_STEPS)
    lengths = (1, STEPS) if pname == "deepwalk" else (STEPS,)
    for T in lengths:
        if f"k4_{pname}_{T}" not in WANT:
            continue
        fn = (lambda T=T: megastep.fused_epoch(
            g, prog, p, state, kind="reservoir", epoch_len=T, **base))
        got = fn()
        b_ms, b_by = chip_smoke.pipe_bound(*chip_smoke.k4_reservoir_work(
            eng["reservoir"], state, got[1], got[2]))
        # a 16-step launch on deepwalk takes seconds: time it once a turn
        timed(f"k4_{pname}_{T}", fn, trees, reps if T == 1 else 1, b_ms,
              b_by)
    for kind in ("rejection", "precomp_its", "precomp_alias"):
        if kind not in eng:
            continue
        e = eng[kind]
        if regimes:
            args = dict(base, kind=kind, epoch_len=STEPS, bmax=e._fused_bmax,
                        tables=e.precomp)
            if kind == "rejection":
                args.update(rjs_trials=1, rjs_max_rounds=1)
            else:
                args.update(tables=chip_smoke.stale_every_third(e.precomp))
                register_tables(g, args["tables"])
            what = ("every trial budget 1" if kind == "rejection"
                    else "every third row stale")
            t0 = time.perf_counter()
            compare(f"k4_{pname}_{kind} ({what})",
                    lambda: megastep.fused_epoch(g, prog, p, state, **args),
                    trees)
            print(f"[reservoir] k4_{pname}_{kind}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        if f"k4_{pname}_{kind}" not in WANT:
            continue
        # the regime as the smoke times it: its own budget and tables
        args = dict(base, kind=kind, epoch_len=STEPS, bmax=e._fused_bmax,
                    tables=e.precomp)
        register_tables(g, e.precomp)
        fn = lambda: megastep.fused_epoch(g, prog, p, state, **args)
        got = fn()
        stats = {}
        b_ms, b_by = chip_smoke.pipe_bound(*chip_smoke.k4_work(
            e, state, got[1], got[2], args, stats))
        if stats:
            print(f"[reservoir] k4_{pname}_{kind}: {STEPS} steps"
                  f"{chip_smoke.trials_text(stats)}", flush=True)
        timed(f"k4_{pname}_{kind}", fn, trees, reps, b_ms, b_by)


def k1_cell(label, pname, eng, mask_of, trees, reps) -> None:
    """Plain K1 on the lanes ``mask_of(eng)`` gives, (state, keys, mask),
    of registry program ``pname``."""
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.kernels.ervs import ervs_select, kernel_rule

    g, prog = eng.graph, eng.workload
    p = eng.sampler_ctx.params
    state, keys_all, mask = mask_of(eng)
    cur, prev, step, idx, ws = chip_smoke.lanes_of(state, mask)
    keys = keys_all[idx].contiguous()
    del state
    fn = lambda: ervs_select(g, prog, p, cur, prev, step, keys,
                             tile=eng.config.tile, wstate=ws)
    d = degrees_of(g, cur).double()
    b_ms, b_by = chip_smoke.pipe_bound(*chip_smoke.plain_scan_work(
        g, prev, d, pname, kernel_rule(prog, p).weighted,
        chip_smoke.ring_bytes(ws, pname), eng.config.tile))
    print(f"[reservoir] {label}: {idx.numel()} lanes, {float(d.sum()):.0f} "
          f"edges", flush=True)
    timed(label, fn, trees, reps, b_ms, b_by)


def k2_cell(pname, eng, trees, reps) -> None:
    """K2 on the eRJS lanes of ``pname``'s main-path state (its adaptive
    engine ``eng``)."""
    split = chip_smoke.main_path_split(eng, chip_smoke.MID_STEP[pname])
    rjs = split.rjs
    del split
    if rjs is None:
        raise SystemExit(f"[reservoir] k2_{pname}: no eRJS lanes")
    cur, prev, step, idx, ws = rjs.lanes
    w_pos = chip_smoke.weighted_proposals(eng, cur, prev, step, rjs.keys,
                                          rjs.got[2], ws)
    b_ms, b_by = chip_smoke.pipe_bound(*chip_smoke.k2_work(eng, rjs, pname,
                                                           w_pos))
    stats = chip_smoke.trial_stats(rjs.got[2], rjs.got[1],
                                   eng.config.rjs_trials, w_pos)
    print(f"[reservoir] k2_{pname}: {idx.numel()} lanes"
          f"{chip_smoke.trials_text(stats)}", flush=True)
    timed(f"k2_{pname}", rjs.run, trees, reps, b_ms, b_by)


def draw_cells(label, g, draw, cur, keys, work, trees, reps,
               split: bool) -> None:
    """K3 or K5 (``draw(cur, keys)``) on the walkers at ``cur`` with keys
    ``keys``, warm and cold; with ``split`` also on the same walkers moved
    to the graph's shortest rows and sorted by row.  ``work(cur, keys)``
    gives the bound's (bytes, ALU, instructions)."""
    import torch
    from repro_torch.core.ctxutil import degrees_of

    sets = [(label, cur, keys)]
    if split:
        deg = g.degrees()
        shortest = int(deg[deg > 0].min())
        rows = (deg == shortest).nonzero().squeeze(1)
        gen = torch.Generator(device=cur.device).manual_seed(0)
        pick = torch.randint(rows.numel(), (cur.numel(),), generator=gen,
                             device=cur.device)
        order = torch.argsort(cur, stable=True)
        sets += [(f"{label}/short_rows", rows[pick].contiguous(), keys),
                 (f"{label}/by_row", cur[order].contiguous(),
                  keys[order].contiguous())]
        print(f"[reservoir] {label}: short rows of degree {shortest} "
              f"({rows.numel()} of them)", flush=True)
    for name, c, k in sets:
        d = degrees_of(g, c).double()
        print(f"[reservoir] {name}: {c.numel()} walkers, mean degree "
              f"{float(d.mean()):.1f}, {int(torch.unique(c).numel())} "
              f"distinct rows", flush=True)
        b_ms, b_by = chip_smoke.pipe_bound(*work(c, k))
        timed(name, lambda c=c, k=k: draw(c, k), trees, reps, b_ms, b_by,
              cold=True)


def k3_cell(pname, eng, trees, reps, split) -> None:
    """K3 on the precomp lanes of ``pname``'s adaptive main-path state."""
    from repro_torch.kernels.its import its_search

    g = eng.graph
    register_tables(g, eng.precomp)
    split_ = chip_smoke.main_path_split(eng, chip_smoke.MID_STEP[pname])
    cur, _, _, idx, _ = chip_smoke.lanes_of(split_.state,
                                            split_.part.want_pre)
    keys = split_.keys[idx].contiguous()
    del split_
    draw_cells(f"k3_{pname}", g,
               lambda c, k: its_search(g, eng.precomp, c, k), cur, keys,
               lambda c, k: chip_smoke.engine_draw_work(
                   "its", g, eng.precomp, c, k),
               trees, reps, split)


def k5_cell(pname, eng, trees, reps, split) -> None:
    """K5 on the live lanes of ``pname``'s fused ``alias_precomp`` engine
    at its mid-walk state."""
    from repro_torch.kernels.alias import alias_pick

    g, tables = eng.graph, eng.precomp
    register_tables(g, tables)
    state = chip_smoke.mid_walk_state(eng, chip_smoke.MID_STEP[pname])
    idx = (state.alive & (state.step < chip_smoke.WALK_STEPS)).nonzero() \
        .squeeze(1)
    cur = state.cur[idx].contiguous()
    keys = state.stream_keys()[idx].contiguous()
    del state

    draw_cells(f"k5_{pname}", g, lambda c, k: alias_pick(g, tables, c, k),
               cur, keys, lambda c, k: chip_smoke.engine_draw_work(
                   "alias", g, tables, c, k), trees, reps, split)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=chip_smoke.LJ_NODES)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--other", type=Path, action="append", default=[])
    ap.add_argument("--no-regimes", action="store_true")
    ap.add_argument("--cell", action="append", choices=CELLS)
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    if args.cell:
        WANT.intersection_update(args.cell)

    import torch
    from repro_torch.core import EngineConfig, WalkEngine
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.graphs import power_law_graph
    from repro_torch.kernels import build
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
        built = [b.result() for b in built]
    print(f"[reservoir] build: {time.perf_counter() - t0:.1f} s", flush=True)
    trees = [(str(t), libs) for t, (libs, _) in zip(args.other, built)]
    mine = {s: build._lib_path(f"{s}.cu") for s in SWAPPED}
    for tree, paths in [(str(t), p) for t, (_, p) in zip(args.other, built)] \
            + [("this", mine)]:
        for stem, kernel in chip_smoke.SCAN_KERNELS:
            for label, c in chip_smoke.scan_sass(paths[stem], kernel).items():
                print(f"[sass] {tree} {kernel} {label}: {c}", flush=True)
        for stem, kernel in chip_smoke.TRIAL_KERNELS:
            if stem not in paths:  # a library these cells do not time
                continue
            for i, c in enumerate(chip_smoke.trial_sass(paths[stem], kernel)):
                print(f"[sass] {tree} {kernel} trial loop {i}: {c}",
                      flush=True)
        for stem in ("erjs", "megastep", "its", "alias"):
            for name, what in chip_smoke.ptxas_lines(
                    paths[stem].with_suffix(".log").read_text()):
                if "registers" in what and "scan_row" not in name:
                    print(f"[ptxas] {tree} {name[:48]}: {what}", flush=True)
    g = power_law_graph(args.nodes, chip_smoke.LJ_AVG_DEGREE,
                        weight_dist="uniform", seed=0).to("cuda")

    for pname in chip_smoke.FUSED_PROGRAMS:
        if f"k3_{pname}" in WANT:
            eng = WalkEngine(g, make_workload(pname), EngineConfig(
                method="adaptive", jump_threshold=chip_smoke.JUMP_THRESHOLD))
            k3_cell(pname, eng, trees, args.reps, args.split)
            del eng
        if f"k5_{pname}" in WANT:
            eng = WalkEngine(g, make_workload(pname), EngineConfig(
                method="alias_precomp", step_exec="fused"))
            k5_cell(pname, eng, trees, args.reps, args.split)
            del eng
    for pname in chip_smoke.FUSED_PROGRAMS:
        if args.no_regimes and not any(c.startswith(f"k4_{pname}_")
                                       for c in WANT):
            continue
        eng = {kind: WalkEngine(g, make_workload(pname), EngineConfig(
            method=method, step_exec="fused"))
            for kind, method in chip_smoke.FUSED_METHODS.items()
            if kind == "reservoir" or not args.no_regimes
            or f"k4_{pname}_{kind}" in WANT}
        k4_cells(g, eng, pname, trees, args.reps, not args.no_regimes)
        del eng

    def live_lanes(eng):
        state = chip_smoke.mid_walk_state(eng, chip_smoke.MID_STEP["deepwalk"])
        live = (state.alive & (state.step < chip_smoke.WALK_STEPS)
                & (degrees_of(eng.graph, state.cur) > 0))
        return state, state.stream_keys(), live

    def plain_lanes(eng):
        split = chip_smoke.main_path_split(eng,
                                           chip_smoke.MID_STEP["node2vec"])
        return split.state, split.keys, split.lo

    cells = (("k1_staged_ervs", "deepwalk", dict(method="ervs",
                                                 step_exec="staged"),
              live_lanes),
             ("k1_random", "node2vec", dict(method="random"), plain_lanes),
             ("k1_adaptive_node2vec", "node2vec",
              dict(method="adaptive",
                   jump_threshold=chip_smoke.JUMP_THRESHOLD), plain_lanes))
    for label, pname, cfg, mask_of in cells:
        if label not in WANT:
            continue
        eng = WalkEngine(g, make_workload(pname), EngineConfig(**cfg))
        k1_cell(label, pname, eng, mask_of, trees, args.reps)
        del eng
    for pname in K2_PROGRAMS:
        if f"k2_{pname}" not in WANT:
            continue
        eng = WalkEngine(g, make_workload(pname), EngineConfig(
            method="adaptive", jump_threshold=chip_smoke.JUMP_THRESHOLD))
        k2_cell(pname, eng, trees, args.reps)
        del eng
    if DIFFERED:
        raise SystemExit(f"[reservoir] trees differ: {DIFFERED}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
