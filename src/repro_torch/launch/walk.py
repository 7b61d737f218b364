"""Walk launcher of the port — the paper's primary entry point on the card.

    PYTHONPATH=src python -m repro_torch.launch.walk --workload node2vec \
        --nodes 20000 --avg-degree 12 --queries 2048 --steps 40 \
        --method adaptive --device cuda

``--device cpu`` runs the kernels' plain PyTorch versions instead;
``--method interleaved`` runs eRVS with the cross-step tile prefetch (K1's
interleaved entry); ``--precomp-exec aligned`` draws the table regimes
through the aligned entries of K3 / K5 on the tile-aligned streams;
``--step-exec fused`` runs each epoch as one fused launch where the
(method × workload) cell allows it (the summary prints which path ran).
``--workload module:factory`` imports ``module``, registers ``factory``
under that name at run time and runs it, e.g. ``--workload
repro_torch.walks.examples:degree_damped``: a user program that declares
nothing, analysed by the compiler (the flag line) and run on the card as
generated device code; the flag line's ``step_exec=`` is the path the
engine resolved, so ``--step-exec fused`` shows whether a user's hooked
program runs fused (K4 with its generated hooks).
"""
from __future__ import annotations

import argparse
import ast
import importlib
import time

import numpy as np

from repro_torch.core import (EngineConfig, WalkEngine, available_samplers,
                              flexi_compiler)
from repro_torch.core.runtime import STEP_EXEC_CHOICES
from repro_torch.core.samplers import (PRECOMP_EXEC_CHOICES,
                                       resolve_precomp_exec)
from repro_torch.device import DEVICES
from repro_torch.graphs import power_law_graph, random_graph
from repro_torch.kernels import build
from repro_torch.walks import WORKLOADS, make_workload, register_workload


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.walk")
    ap.add_argument("--workload", default="node2vec",
                    help=f"a registered workload "
                         f"({', '.join(sorted(WORKLOADS))}) or "
                         f"module:factory, registered at run time")
    ap.add_argument("--list-workloads", action="store_true",
                    help="print the registered workload names and exit")
    ap.add_argument("--workload-arg", action="append", default=[],
                    metavar="KEY=VALUE", dest="workload_arg",
                    help="factory keyword for the selected workload, e.g. "
                         "--workload-arg a=4.0 (repeatable)")
    ap.add_argument("--method", choices=available_samplers(),
                    default="adaptive")
    ap.add_argument("--batch", type=int, default=None,
                    help="walker slots (default: all queries at once)")
    ap.add_argument("--epoch-len", type=int, default=None,
                    help="steps between slot refills")
    ap.add_argument("--nodes", type=int, default=20_000)
    ap.add_argument("--avg-degree", type=int, default=12)
    ap.add_argument("--graph", choices=["random", "powerlaw"],
                    default="powerlaw")
    ap.add_argument("--weights", choices=["uniform", "pareto", "degree",
                                          "ones"], default="uniform")
    ap.add_argument("--alpha", type=float, default=2.0)
    ap.add_argument("--queries", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=list(DEVICES), default="cuda",
                    help="cuda runs the CUDA kernels; cpu their plain "
                         "PyTorch versions")
    ap.add_argument("--step-exec", choices=STEP_EXEC_CHOICES, default="auto",
                    help="fused: one launch per epoch where the cell has a "
                         "fused regime; staged: the step loop; auto: fused "
                         "on the card, staged on the CPU")
    ap.add_argument("--precomp-exec", choices=PRECOMP_EXEC_CHOICES,
                    default="auto",
                    help="execution path of the staged table draws: flat "
                         "(the engine entries of K3 / K5), aligned (their "
                         "aligned entries on the tile-aligned streams); "
                         "auto: flat.  The same bits either way")
    return ap


def parse_workload_args(pairs) -> dict:
    """``--workload-arg key=value`` pairs as factory kwargs (values parsed
    as Python literals, else kept as strings)."""
    kw = {}
    for pair in pairs:
        key, sep, value = pair.partition("=")
        if not sep or not key:
            raise SystemExit(f"--workload-arg expects KEY=VALUE, got {pair!r}")
        try:
            kw[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            kw[key] = value
    return kw


def resolve_workload(name: str) -> str:
    """``name`` itself when registered; a ``module:factory`` name is
    imported and registered under that name first."""
    if name in WORKLOADS:
        return name
    module, sep, attr = name.partition(":")
    if not sep:
        raise SystemExit(f"unknown workload {name!r}: registered are "
                         f"{', '.join(sorted(WORKLOADS))}, or give "
                         f"module:factory")
    register_workload(name, getattr(importlib.import_module(module), attr))
    return name


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.list_workloads:
        for name in sorted(WORKLOADS):
            print(name)
        return
    gen = power_law_graph if args.graph == "powerlaw" else random_graph
    graph = gen(args.nodes, args.avg_degree, weight_dist=args.weights,
                alpha=args.alpha, seed=args.seed)
    print(f"[walk] graph: V={graph.num_nodes} E={graph.num_edges} "
          f"maxdeg={graph.max_degree()}")
    wl = make_workload(resolve_workload(args.workload),
                       **parse_workload_args(args.workload_arg))
    eng = WalkEngine(graph, wl, EngineConfig(method=args.method,
                                             seed=args.seed,
                                             device=args.device,
                                             step_exec=args.step_exec,
                                             precomp_exec=args.precomp_exec))
    print(f"[walk] compiler flag: {eng.compiled.flag} "
          f"static={flexi_compiler.is_static(wl)} "
          f"fusable={eng.fuse.fusable} warnings={eng.compiled.warnings} "
          f"device={eng.device} step_exec={eng.step_exec_resolved} "
          f"precomp_exec={resolve_precomp_exec(args.precomp_exec)}")
    starts = np.arange(args.queries) % graph.num_nodes
    build.reset_launches()
    t0 = time.time()
    res = eng.run(starts, num_steps=args.steps, batch=args.batch,
                  epoch_len=args.epoch_len)
    dt = time.time() - t0
    total_steps = int((res.paths[:, 1:] >= 0).sum())
    print(f"[walk] {args.queries} queries × {res.steps} steps in {dt:.2f}s "
          f"({total_steps / dt:.0f} steps/s) frac_rjs={res.frac_rjs:.2f} "
          f"frac_precomp={res.frac_precomp:.2f} "
          f"frac_stale={res.frac_stale:.2f} "
          f"(over {res.live_steps} live steps) "
          f"fallbacks={res.rjs_fallbacks}")
    print(f"[walk] kernel launches: {dict(build.LAUNCHES)}")


if __name__ == "__main__":
    main()
