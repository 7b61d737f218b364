#!/usr/bin/env python3
"""K1's jump instance on the lanes one main-path step hands it, on the card,
beside the same kernel built from other trees.

    PYTHONPATH=src python tools/time_jump.py [--nodes N] [--reps 5] \
        [--program 2ndpr ...] [--other DIR ...] [--no-prev]

Builds the graph ``chip_smoke.py`` runs (soc-LiveJournal1 scale by
default) and, for each ``--program`` (2ndpr when none is given), its
adaptive engine; walks every node ``chip_smoke.MID_STEP`` steps, takes the
lanes the sampler sends to the jump reservoir there (as the smoke's phase 5
takes them, ``chip_smoke.main_path_split``), and times K1 jump on
them with CUDA events, beside ``chip_smoke.jump_work``'s bound.  With
``--other DIR`` (a checkout or a ``git archive`` of another commit;
repeatable) it builds that tree's ``ervs.cu`` with that tree's own
``kernels/build.py`` and times it on the same lanes, in turns (the
others, this tree twice, the others in reverse), and fails unless every
tree chooses the same next nodes.  ``--no-prev`` sets every lane's
previous node to -1, so no dist(v', u) test runs, to show what the test
costs.  Prints the card's name and power limit first, and how long the
lanes' previous rows are.  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the cell's one definition)


def other_select(tree: Path):
    """K1 jump of ``tree``: ``fn(graph, rule, cur, prev, step, keys, tile,
    ring, out)`` launching that tree's ``repro_ervs_select``."""
    import torch

    spec = importlib.util.spec_from_file_location(
        "other_build", tree / "src/repro_torch/kernels/build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.library("ervs")
    # a tree whose jump instance lists its block walkers takes scratch
    lists = len(lib.repro_ervs_select.argtypes) > 15
    scratch = {}

    def select(g, rs, cur, prev, step, keys, tile, ring, out):
        extra = ()
        if lists:
            n = cur.numel()
            if n not in scratch:
                scratch[n] = torch.empty(n + 2, dtype=torch.int32,
                                         device=cur.device)
            extra = (scratch[n].data_ptr(),)
        err = lib.repro_ervs_select(
            g.indptr.data_ptr(), g.indices.data_ptr(), g.h.data_ptr(),
            g.labels.data_ptr(), ctypes.byref(rs), cur.data_ptr(),
            prev.data_ptr(), step.data_ptr(), ring, keys.data_ptr(),
            cur.numel(), tile, 1, out.data_ptr(), *extra,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{tree}: K1 jump launch failed ({err})")
        return out
    return select


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=chip_smoke.LJ_NODES)
    ap.add_argument("--program", action="append", default=[])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--other", type=Path, action="append", default=[])
    ap.add_argument("--no-prev", action="store_true")
    args = ap.parse_args()

    import torch
    from repro_torch.core import EngineConfig, WalkEngine
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.graphs import power_law_graph
    from repro_torch.kernels import build
    from repro_torch.kernels.ervs import ervs_select, kernel_rule, \
        walker_inputs
    from repro_torch.walks import make_workload

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_all()
    others = [(str(tree), other_select(tree)) for tree in args.other]
    g = power_law_graph(args.nodes, chip_smoke.LJ_AVG_DEGREE,
                        weight_dist="uniform", seed=0).to("cuda")
    for program in args.program or ["2ndpr"]:
        eng = WalkEngine(g, make_workload(program), EngineConfig(
            method="adaptive", jump_threshold=chip_smoke.JUMP_THRESHOLD))
        split = chip_smoke.main_path_split(eng, chip_smoke.MID_STEP[program])
        cur, prev, step, idx, ws = chip_smoke.lanes_of(split.state, split.hi)
        keys = split.keys[idx].contiguous()
        del split
        if args.no_prev:
            prev = torch.full_like(prev, -1)
        d = degrees_of(g, cur).to(torch.float64)
        dp = degrees_of(g, prev).to(torch.float64)
        print(f"[jump] {program}: previous rows: mean {float(dp.mean()):.0f}"
              f", median {float(dp.median()):.0f}, "
              f"{int((dp > 4096).sum())} lanes over 4,096; edge-weighted "
              f"mean {float((dp * d).sum() / d.sum()):.0f}", flush=True)
        prog, params, tile = eng.workload, eng.sampler_ctx.params, \
            eng.config.tile
        rule = kernel_rule(prog, params)
        ring = walker_inputs(g, rule, cur, prev, step, keys, ws, cur.device)
        mine = lambda: ervs_select(g, prog, params, cur, prev, step, keys,
                                   tile=tile, jump=True, wstate=ws)
        got = mine()
        b_ms, b_by = chip_smoke.bound(*chip_smoke.jump_work(
            g, prev, d, got, program, rule.weighted,
            chip_smoke.ring_bytes(ws, program)))
        print(f"[jump] {program}: {cur.numel()} lanes at step "
              f"{chip_smoke.MID_STEP[program]}, {float(d.sum()):.0f} edges, "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        rs = rule.as_struct()
        theirs = []
        for tree, select in others:
            out = torch.empty_like(got)
            fn = (lambda select=select, out=out: select(
                g, rs, cur, prev, step, keys, tile, ring, out))
            if not torch.equal(fn(), got):
                raise SystemExit(f"{tree} chose other nodes on "
                                 f"{int((fn() != got).sum())} lanes")
            theirs.append((tree, fn))
        for label, fn in theirs + [("this", mine)] * 2 + theirs[::-1]:
            ms = chip_smoke.cuda_ms(fn, args.reps)
            print(f"[jump] {program} {label}: {ms:.4f} ms", flush=True)
        del eng
    return 0


if __name__ == "__main__":
    sys.exit(main())
