#!/usr/bin/env python3
"""Where one step of the port's walks spends its time on the card.

    PYTHONPATH=src python tools/profile_port_step.py [--nodes N] [--steps 4] \
        [--out-dir DIR] [--fused METHOD ...]

Builds the graph ``chip_smoke.py`` runs, with its constants and its
mid-walk state (soc-LiveJournal1 scale by default, every node a query,
8 warm-up steps), then traces
``--steps`` more steps of ``WalkEngine.step`` per program (the adaptive
node2vec and deepwalk engines) with ``torch.profiler`` (CPU + CUDA);
``--fused`` instead traces one fused epoch of ``--steps`` steps (one K4
launch) of deepwalk under each given method.  Prints, per engine: wall
milliseconds per step (host clock, synchronised), device-busy ms per step
(the sum of every device event's self time), the device idle share, and
the device kernels and host operators that take the most time; with
``--out-dir`` the full tables go to ``DIR/profile_<program>.txt``.  Needs
an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the cell's one definition)


def profile_program(eng, steps: int, out_dir=None) -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    V = eng.graph.num_nodes
    state = chip_smoke.mid_walk_state(eng, 8)
    torch.cuda.synchronize()
    fused = eng.step_exec_resolved == "fused"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if fused:
            eng.run_epoch_fn(state, epoch_len=steps,
                             num_steps=chip_smoke.WALK_STEPS)
        for _ in range(0 if fused else steps):
            state, _, _ = eng.step(state, chip_smoke.WALK_STEPS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
    events = prof.key_averages()
    # device rows are the kernels and copies themselves; an operator row's
    # device time repeats its kernels' and is not summed
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    name = eng.workload.name.split("[")[0]
    if fused:
        name += f"-{eng.config.method}-fused"
    print(f"[profile] {name}: {wall:.2f} ms/step wall, {busy:.2f} ms/step "
          f"device busy, device idle share {1 - busy / wall:.3f} "
          f"(torch.profiler, {steps} steps, {V} walkers)")
    by_dev = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in by_dev[:10]:
        print(f"[profile] {name} device: {e.key[:70]:70s} "
              f"{e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"x{e.count / steps:g}")
    by_cpu = sorted(events, key=lambda e: -e.self_cpu_time_total)
    for e in by_cpu[:8]:
        print(f"[profile] {name} host:   {e.key[:60]:60s} "
              f"{e.self_cpu_time_total / 1e3 / steps:8.3f} ms/step "
              f"x{e.count / steps:g}")
    if out_dir is None:
        return
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"profile_{name}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=40)
        + "\n" + events.table(sort_by="self_cpu_time_total", row_limit=40))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=chip_smoke.LJ_NODES)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out-dir", type=Path, default=None,
                    help="write the full profiler tables here")
    ap.add_argument("--fused", nargs="+", default=None, metavar="METHOD",
                    choices=tuple(chip_smoke.FUSED_METHODS.values()),
                    help="trace one fused epoch of deepwalk per method")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_port_step: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import EngineConfig, WalkEngine
    from repro_torch.graphs import power_law_graph
    from repro_torch.walks import deepwalk, node2vec

    graph = power_law_graph(args.nodes, chip_smoke.LJ_AVG_DEGREE,
                            weight_dist="uniform", seed=0).to("cuda")
    if args.fused:
        for method in args.fused:
            profile_program(WalkEngine(graph, deepwalk(), EngineConfig(
                method=method, step_exec="fused")), args.steps, args.out_dir)
        return 0
    cfg = EngineConfig(method="adaptive",
                       jump_threshold=chip_smoke.JUMP_THRESHOLD)
    for program in (node2vec(), deepwalk()):
        profile_program(WalkEngine(graph, program, cfg), args.steps,
                        args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
