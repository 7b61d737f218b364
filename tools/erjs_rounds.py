#!/usr/bin/env python3
"""Where K2's time goes by round: K2 on the eRJS lanes the main path hands
it, on the card, at round budgets 1, 2, 4 and the engine's own, beside
the row lengths of the walkers that reach the later rounds.

    PYTHONPATH=src python tools/erjs_rounds.py [--nodes N] [--reps 5] \
        [--program 2ndpr ...]

Builds the graph ``chip_smoke.py`` runs (soc-LiveJournal1 scale by
default) and, per program (2ndpr and metapath unless ``--program``),
takes the eRJS lanes of its adaptive main path at ``chip_smoke.MID_STEP``
(``chip_smoke.main_path_split``).  Times K2 there with CUDA events at
each round budget (a budget of R rounds makes the first R x trials
proposals of each walker, so the difference between two budgets is the
time of the rounds between them), and prints, for the walkers pending
after round 0 and for the fallbacks at the engine's budget, their count
and the mean and median degree of their current and previous nodes
(d(v), whose row the proposals gather from; d(v'), whose row the
second-order rules binary-search), beside the means over all lanes.
Prints the card's name and power limit first.  Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def degrees_text(what: str, mask, d_cur, d_prev) -> str:
    """Count and degree statistics of the lanes in ``mask``."""
    n = int(mask.sum())
    if not n:
        return f"{what}: 0"
    c, p = d_cur[mask], d_prev[mask]
    return (f"{what}: {n}; d(v) mean {float(c.mean()):.1f} median "
            f"{float(c.median()):.0f}; d(v') mean {float(p.mean()):.1f} "
            f"median {float(p.median()):.0f}")


def main() -> int:
    import chip_smoke

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=chip_smoke.LJ_NODES)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--program", action="append",
                    choices=sorted(chip_smoke.MID_STEP))
    args = ap.parse_args()

    import torch

    from repro_torch.core import EngineConfig, WalkEngine
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.graphs import power_law_graph
    from repro_torch.kernels import build
    from repro_torch.kernels.erjs import erjs_select
    from repro_torch.walks import make_workload

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(),
          flush=True)
    build.build_all()
    g = power_law_graph(args.nodes, chip_smoke.LJ_AVG_DEGREE,
                        weight_dist="uniform", seed=0).to("cuda")
    cfg = EngineConfig(method="adaptive",
                       jump_threshold=chip_smoke.JUMP_THRESHOLD)
    for pname in args.program or ("2ndpr", "metapath"):
        eng = WalkEngine(g, make_workload(pname), cfg)
        rjs = chip_smoke.main_path_split(eng, chip_smoke.MID_STEP[pname]).rjs
        if rjs is None:
            print(f"[rounds] {pname}: no eRJS lanes", flush=True)
            continue
        cur, prev, step, idx, ws = rjs.lanes
        p, K = eng.sampler_ctx.params, eng.config.rjs_trials
        R = eng.config.rjs_max_rounds
        for rounds in sorted({1, 2, 4, R}):
            fn = lambda: erjs_select(g, eng.workload, p, cur, prev, step,
                                     rjs.keys, rjs.bound, trials=K,
                                     rounds=rounds, wstate=ws)
            print(f"[rounds] {pname} rounds {rounds}: "
                  f"{chip_smoke.cuda_ms(fn, args.reps):.4f} ms", flush=True)
        _, fallback, used = rjs.got
        d_cur = degrees_of(g, cur).double()
        d_prev = degrees_of(g, prev).double()
        print(f"[rounds] {pname}: {idx.numel()} lanes, d(v) mean "
              f"{float(d_cur.mean()):.1f}, d(v') mean "
              f"{float(d_prev.mean()):.1f}; "
              + degrees_text("pending after round 0", used > K, d_cur, d_prev)
              + "; " + degrees_text("fallbacks", fallback, d_cur, d_prev),
              flush=True)
        del eng, rjs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
