#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU — the quickest proof that the port still starts on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build   — compile K1–K12 from ``src/repro_torch/kernels/csrc`` with nvcc
             (one process per source, in parallel); then lower phase 4b's
             and 4c's programs to generated device rules
             (``kernels/rulegen.py``: weights, state reads and hooks) and
             build their instances of K1, K2 and K4 (``ervs.cu``,
             ``erjs.cu``, ``megastep.cu`` against each generated header,
             all together), logging the seconds.
1b. lm     — LM serving at full width: ``qwen3-0.6b`` (28 layers, d_model
             1,024, vocab 151,936, bf16; random weights from
             ``init_params`` with a seeded ``torch.Generator``) serves 8
             requests of 16 prompt and 32 new tokens through
             ``repro_torch.serving.generate``, sampled at T = 0.8 twice
             and greedily once: each run must give [8, 48] int32 ids in
             the vocab with the prompts kept and launch K8
             (``token_sample``) once per decode step (47), and the second
             sampled run must equal the first.  Then K8 against its plain
             version, bitwise, at T = 0.8, T = 1.0 and greedy, on the last
             decode step's logits [8, V], seeded normal logits [128, V]
             (decode_32k's batch), the same 4 B past 16-byte alignment
             (K8's scalar loads), [5, V] and a ``seed0`` that wraps mod
             2^32; timed at [8, V] and [128, V] (greedy beside
             ``torch.argmax``), with CUDA events around the Python call
             and, device-only, with ``torch.profiler``; greedy at [128, V]
             also with the 16-byte loads and the scalar ones, in turns.
2. graph   — ``power_law_graph`` at soc-LiveJournal1 scale (4,847,571
             nodes, average degree 14, uniform weights, 5 uniform edge
             labels, seed 0); one adaptive engine per registry program
             (ITS tables for the static deepwalk and ppr_nibble); one
             engine per fused regime (methods ervs, erjs, its_precomp,
             alias_precomp, ``step_exec="fused"``) for deepwalk and for
             ppr_nibble (the hooked program).  Each engine builds its own
             tables (phase 4's staged engines take their fused twins',
             ``WalkEngine(..., precomp=...)``: the two alias builds took
             ~37 s), and on the card the layouts its CUDA draws read
             (node records, fence and pair tables); node statistics are
             computed once per label count (the graph keeps them).  The
             layouts' build is timed again on a copy of the deepwalk
             alias engine's tables and logged.
2b. ops    — the standalone kernel ops (``repro_torch.kernels.ops``) on
             the tile-aligned [R, 128] stream of the whole graph's weights
             (``graph_aligned_weights``, built on the host): K6
             ``ervs_select`` (block-jump eRVS) and K7 ``erjs_select``
             (bound-based eRJS, bound = the row's h_max, 8 trials x 16
             rounds) over (a) one walker per node at its own row and (b)
             the lanes of the adaptive deepwalk main run after
             ``MID_STEP`` steps (hub-heavy), and the aligned entries of K3
             and K5 over (a) on the deepwalk alias engine's tables.  Each
             drive is counted (counts reset just before, read just
             after); then each kernel is held bitwise against its plain
             version on the card — on every walker, except K6 on (b):
             4,096 walkers, one on each of the 64 largest distinct rows —
             and timed on all walkers.  K6's plan and table pass is held
             bitwise against its plain versions (``ref.ervs_leaders_ref``,
             ``ref.ervs_tile_tables_ref``) on every leader of both sets,
             timed alone beside the whole call, and a call's peak device
             memory is logged.  The aligned K3 and K5 rows' bounds count
             each distinct 32 B sector their plain versions read, once
             (``ref.its_reads_ref`` / ``alias_reads_ref``), and torch's
             gather of one entry of each of those sectors is timed beside
             them (``gather_ms``: the card's rate for the same random
             reads, not a library call for the draw; ``library_ms`` stays
             null).  Then Fig. 12a's RNG-draw inputs (128
             walkers on rows of 512 and 4,096 weights): K6's mean draws
             and jumped tiles, bitwise against the plain version.
3. check   — each kernel against its plain PyTorch version on the card, on
             a few thousand walkers of the full graph (hubs included):
             K2, K3, K5 and K1's jump instance bitwise; plain K1 bitwise
             or differing only at near-ties (two float32 keys within 2
             ulp); K1 and K2 under
             every program's device rule, on walkers 3 steps into their
             walks (so visited_avoiding's rings are not empty) on rows of
             at most 4,096 (phase 5 holds them on hubs); K4 for one
             epoch of 16 steps in each regime, hook-free (deepwalk) and
             hooked (ppr_nibble), with forced eRJS fallbacks
             (rjs_trials=1, rjs_max_rounds=1) and every third row stale:
             paths, end state (mass included) and flag words bitwise,
             except that a path may part at a reservoir near-tie; then
             (3d) K1, K1 jump and K2 under each generated rule on the
             walkers the hand rules were held on, against their plain
             versions and bitwise against the hand rules' launches, and
             K4 under stripped deepwalk's rule (rejection, precomp_its)
             likewise (visited_avoiding's twin: a generated rule that
             reads the ring, against the hand VISITED rule); (3e) K4's
             HOOK_GENERATED instances (ppr_nibble stripped of its hook
             rule) in the four regimes as in 3c, also bitwise against
             HOOK_PPR_NIBBLE's launch, and K4's reservoir under the
             quickstart program and non_backtracking (generated weight,
             state and hooks); then the whole engine on a small graph,
             kernels (cuda) against plain versions (cpu); (3f) the
             baselines' row kernels K9–K12 (``csrc/baselines.cu``) under
             each Table 2 program's rule, bitwise, on 2,048 walkers 3
             steps in on rows of at most 4,096 (plain versions and
             kernels at pad 4,096), K12 -> K2 -> K9 as ``rjs_maxreduce``
             composes them, then on walkers on the 2 largest rows at the
             engine's pad (plain versions on the host).
4. main    — ``WalkEngine(graph, make_workload(name), EngineConfig(
             method="adaptive", jump_threshold=8)).run(np.arange(V),
             num_steps=80)`` for every registry program (node2vec,
             deepwalk, node2vec_unweighted, metapath, metapath_unweighted,
             2ndpr, visited_avoiding, ppr_nibble; 2ndpr over
             ``MAIN_STEPS`` = 16 steps, cut from 80 to keep the smoke
             inside its time limit: its hub fallbacks took 140 s over 80);
             the Fig. 13 selector cells, node2vec with ``method="random"``
             and ``"degree"`` (``SELECTOR_STEPS``: random over 16 steps,
             cut from 80, degree over 80), which must launch K1 and K2;
             then each fused method
             with ``step_exec="fused"`` and again ``"staged"``, for
             deepwalk and ppr_nibble over ``PAIR_STEPS`` (16, cut from
             80 to keep the smoke inside its time limit; 4c's
             generated-hooks runs follow): the fused run must resolve "fused",
             launch K4 and give the staged run's paths and telemetry bit
             for bit.  Launch counts are reset just before each run and
             read just after; ``run()`` reports its own host-clock split
             (setup, admit, steps, harvest).  Every emitted step must be
             an edge and stopped lanes must emit -1.
4b. compiler — node2vec and metapath stripped of their declarations and
             device rules (``walks.examples.stripped``: the engine
             analyses the traced weight, the kernels run generated
             rules) run adaptive over 80 steps and must give the declared
             programs' phase-4 paths, regime fractions and fallbacks bit
             for bit; stripped deepwalk runs fused under erjs and
             its_precomp over 16 steps, must resolve "fused", launch K4
             and equal the declared fused runs; the reference's
             quickstart program (``walks.examples.degree_damped``, hooks
             staged in torch) runs adaptive over 80 steps, must be
             PER_STEP and not static, and must launch K1 and K2.  Each
             twin's steps phase is logged beside its declared program's.
             Stripped visited_avoiding (a generated weight reading the
             ring) runs with them, against its phase-4 run.
4c. state and hooks — ppr_nibble stripped of its hook rule too runs
             fused under ervs / erjs / its_precomp / alias_precomp at the
             declared pairs' depth: each must resolve "fused", launch K4's
             HOOK_GENERATED instance and give the declared fused run's
             paths, telemetry and end state (mass included) bit for bit;
             the quickstart program (80 steps) and non_backtracking
             (``NONBACKTRACKING_STEPS``, 8) run fused under ervs (K4 with
             a generated weight, state and hooks) and must equal their
             staged ervs runs likewise.
4d. baselines — Table 2's five workloads (node2vec_unweighted,
             node2vec, metapath_unweighted, metapath, 2ndpr) under
             ``its`` (K9), ``als`` (K11), ``rvs_prefix`` (K10),
             ``rjs_maxreduce`` (K12, then K2 with the exact row maximum,
             then K9 on its fallbacks) and ``adaptive``, each with the
             default ``EngineConfig`` on the full graph: the same
             ``BASELINE_QUERIES`` start nodes (``default_rng(0)``, without
             replacement) over 8 steps.  Each run must launch its kernels
             and emit only edges, and logs ``run()``'s split, its live
             walker-steps/s and its peak device memory.
4e. interleaved, scheduler, aligned draws — deepwalk under
             ``interleaved`` (K1's interleaved entry, a [V, 256] prefetch
             carry) over every node and ``PAIR_STEPS`` must launch it,
             never plain K1, and give phase 4's staged ``ervs`` run's paths
             and telemetry bit for bit; ``scheduler()`` over node2vec
             adaptive's queries in ``run()``'s order (one slot a query, 16
             steps an epoch), every 97th query id killed before the second
             epoch: the other paths equal phase 4's ``run()``, the killed
             ones are prefixes of it, and the epochs' ``walker_steps`` sum
             to the live total; ``walk_batch`` of every node on deepwalk
             ``its_precomp``, fused and staged, equal (paths, per-step
             counters) and equal to ``run()``; staged deepwalk
             ``its_precomp`` / ``alias_precomp`` engines under
             ``precomp_exec="aligned"``, built on the flat staged engines'
             tables (``WalkEngine(..., precomp=...)``: no second Vose
             build), must launch the aligned entries of K3 / K5 and give the
             flat runs' paths and telemetry; each entry is then timed at
             the engine's lanes after 8 steps and held bitwise against its
             plain version there (rows ``its_search_aligned/deepwalk``,
             ``alias_pick_aligned/deepwalk``).
5. timing  — each kernel and its plain version on the lanes one main-path
             step hands it (the state after ``MID_STEP`` steps: 8, or 4
             for the short MetaPath and PPR-Nibble walks) under each
             program whose main-path run launched it, with CUDA events;
             the kernel must agree with the plain version there as in
             phase 3 (2ndpr's K1 jump lanes: on 256 of them, one on each
             of the 64 largest distinct rows and the rest drawn at
             random, ``JUMP_PLAIN_SUBSET``, cut from 4,096 when phase 4d
             came in; the plain scan of all of them took 223 s).  Before
             the timing, K1 jump is held bitwise against its plain
             version at tiles 2, 64 and 1,024 (``JUMP_TILES``) under
             node2vec, 2ndpr and visited_avoiding, on 1,024 walkers (cut
             from 2,048 when phase 4d came in) 3 steps in (at a tile,
             those whose lanes hold at most 256 items), some with no
             previous node and some whose previous
             node has the largest row.  A kernel that gets no lane at
             that step is timed at the first later step that gives it
             lanes (its row's ``step``); none at all fails.  K4: one
             timed launch of 16 steps per regime from the state after 8
             steps (deepwalk) or 4 steps (ppr_nibble, whose lanes are
             still alive there), held against its plain version on the
             same state; for the reservoir regime, whose torch row scans
             take minutes per step here (~10^11 edges for deepwalk), the
             kernel runs one step of every walker from that state, its
             rows of up to ``K4_RESERVOIR_PLAIN_LANES`` walkers (hubs and
             random ones) are held
             against the plain version on them, and the 16-step launch is
             timed beside it.  The generated rules' kernels are timed and
             held the same way on phase 4b's and 4c's engines (rows
             ``.../gen:<program>``, ``.../gen-hooks:ppr_nibble``).
             K3, K5, their aligned entries (phase 2b) and K4's table
             regimes are also timed cold, with L2 flushed before each
             launch (``cold_ms``), as the main path meets them between
             other kernels.  The build phase logs the SASS of K4's
             reservoir edge loops by pipe (``scan_sass``) and of K3's and
             K5's kernels (``draw_sass``).  K9–K12 on the live lanes of
             phase 4d's queries after 4 steps under each Table 2 program
             (rows ``its_row/<program>`` ...), bounded by each lane's row
             read once (indices, h, labels; for the dist tests the
             previous node's row, or a 32 B sector a neighbour where the
             lane's row is shorter) and, for K10, a Threefry per
             neighbour; each is held bitwise against its plain version at
             the engine's pad on a subset of the timed lanes (the [n, pad]
             block of every lane would not fit on the card): up to one
             lane on each of the 64 largest rows among them and random
             lanes, 1,024 in all (ALS: the largest row and 3 random
             lanes), and its plain ms are on that subset.  K1's
             interleaved entry on the plain reservoir lanes of node2vec
             (the dist test), metapath (labels), visited_avoiding (the
             ring) and the quickstart program (a generated rule) after
             ``MID_STEP`` steps, every other lane hitting a carry built
             for the check: the same choices as its plain version and as
             plain K1, and the same carry rows below ``min(deg, 256)``;
             then on deepwalk's interleaved main-path state after 8 steps
             (its own carry, restored before each timed launch), timed on
             every walker beside plain K1, held against plain K1 on all
             and against its plain version on 4,096 of them (one on each
             of the 64 largest rows, the rest at random).

``jump_threshold`` is lowered from the default 1024 to 8, the cost
model's ``min_rjs_degree``: at uniform weights Eq. 11 sends every hub to
eRJS, which resolves without fallbacks, so at 1024 the jump reservoir
would serve no lane at all.  At 8 it serves the reservoir lanes the cost
model could have sent to eRJS but did not, and plain eRVS the rows
shorter than eRJS's minimum.

The line before the last is a JSON object with one entry per kernel and
program (``"ervs_select/metapath"``, ``"fused_epoch_reservoir/ppr_nibble"``,
...), walker set of the ops (``"ervs_block_select/deepwalk_lanes"``,
...) or K8 mode and logits shape (``"token_sample/sampled_b8"``, ...);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
LJ_NODES = 4_847_571  # soc-LiveJournal1
LJ_AVG_DEGREE = 14
WALK_STEPS = 80
# the cost model's min_rjs_degree; see the module docstring
JUMP_THRESHOLD = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
PEAK_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
# integer operations of one Threefry-2x32 (20 rounds of add, rotate as two
# shifts and an or, xor; five key injections), counted at the float32 rate
# above.  On the H100 that count is right only by coincidence: 67e12
# counts an FMA as two operations at 128 lanes an SM, so 122 / 67e12 is
# ~61 instructions at the issue rate, near the SASS's 68 (THREEFRY_INSTR)
# because a rotate is one SHF; but 41 of those run only on the integer
# ALU, at half the lanes, which takes 34% longer.  Every bound but K1
# jump's counts by pipe (pipe_bound); K1 jump keeps this count until it
# is recounted.
THREEFRY_OPS = 122
# the pipe counts, from the SASS of the scan's edge loop
# (scan_row_call<kScanH, true> in K4; every run logs the loop): one
# Threefry-2x32 and the bits' xor is 68 instructions (20 SHF, 21 LOP3,
# 9 IADD3, 18 IMAD.IADD), 41 of which (the SHF rotates and the LOP3 xors)
# only the integer ALU runs, an add can issue as IMAD on the FMA pipe; the
# key's parity k0 ^ k1 ^ 0x1BD11BDA (one LOP3) depends on the key alone,
# so the function needs it once a key: once a tile for the edges' draws
# (the loop's SASS takes it every edge, ptxas did not hoist it, which is
# this kernel's cost, not the function's); the uniform's map (one LEA.HI,
# four float operations); the compare of an edge's key against the
# running best; the exact key of an edge that may become a thread's new
# best (logf and __fdiv_rn, 42 instructions, 3 of them integer)
THREEFRY_INSTR, THREEFRY_ALU = 68, 41
PARITY_INSTR, PARITY_ALU = 1, 1
UNIFORM_INSTR, UNIFORM_ALU = 5, 1
KEY_COMPARE_INSTR = 1
EXACT_KEY_INSTR, EXACT_KEY_ALU = 42, 3
# the table draws' own work beside their Threefry, parity and uniforms:
# per CDF probe of K3's search the compare and the bounds' update (the
# midpoint's add and shift, a select); per K3 walker the row's degree,
# the target's multiply, the clip and the empty-row test; per K5 walker
# the degree, the column (a conversion, a multiply, a conversion back,
# a min), the compare and the select
PROBE_INSTR, PROBE_ALU = 4, 3
ITS_DRAW_INSTR, ITS_DRAW_ALU = 6, 3
ALIAS_DRAW_INSTR, ALIAS_DRAW_ALU = 8, 3
# XLA's float32 exp and log as the kernels run them (xla_math.cuh), an
# IEEE float32 divide (__fdiv_rn: a reciprocal, its Newton step, FCHK and
# the quotient's two corrections; its slow path is a call, taken only at
# extreme exponents) and the rest of an eRVS draw's update (the product,
# the clamps, the fused multiply-add, the loop's compare and counters),
# counted in the SASS of K6's walk kernel (ervs_walk_kernel, CUDA 12.8);
# K7's trial loop as a whole (a Threefry, two uniforms, the candidate,
# its clipped address, the test), counted in erjs_block_kernel's SASS; a
# K6 tile's retirement (its compare and subtract) and a table entry of
# its table pass (a sum's add, per position of a crossing tile the scan's
# two adds and the running maximum); a K8 token (the key's fused
# multiply-add and the compare)
XLA_EXP_INSTR, XLA_EXP_ALU = 21, 1
XLA_LOG_INSTR, XLA_LOG_ALU = 40, 3
FDIV_INSTR, FDIV_ALU = 10, 0
ERVS_UPDATE_INSTR, ERVS_UPDATE_ALU = 16, 0
ERJS_TRIAL_INSTR, ERJS_TRIAL_ALU = 101, 69
TILE_RETIRE_INSTR = 2
TABLE_SUM_INSTR, TABLE_SCAN_INSTR = 1, 3
TOKEN_KEY_INSTR = 2
# bytes a random 4 B read moves from device memory: one 32 B sector
SECTOR_BYTES = 32.0
# lanes an SM a clock on the H100: the integer ALU's, and the issue's
INT_ALU_LANES = 64
ISSUE_LANES = 128
# the integer-ALU opcodes of the SASS (the rest issue elsewhere: IMAD and
# the float operations on the FMA pipe, MUFU, loads, shuffles, branches)
SASS_ALU = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA", "PRMT", "IMNMX",
            "PLOP3", "FLO", "POPC", "BMSK", "SGXT", "IABS")
# near-tie differences from the plain version that plain K1 and K4's
# reservoir regime may show on the smoke's lanes: the unfiltered scan's
# count there, 0 on every row
SCAN_NEAR_TIES = 0
# kernels each program's adaptive main-path run must launch
ADAPTIVE_NEEDS = {
    "node2vec": ("ervs_select", "ervs_jump_select", "erjs_select"),
    "deepwalk": ("its_search", "ervs_select"),
    "node2vec_unweighted": ("ervs_select", "erjs_select"),
    "metapath": ("ervs_select", "ervs_jump_select", "erjs_select"),
    "metapath_unweighted": ("ervs_select", "ervs_jump_select",
                            "erjs_select"),
    "2ndpr": ("ervs_select", "ervs_jump_select", "erjs_select"),
    "visited_avoiding": ("ervs_select", "ervs_jump_select", "erjs_select"),
    "ppr_nibble": ("its_search", "ervs_select"),
}
# programs whose weight binary-searches the previous node's row per edge
SECOND_ORDER = ("node2vec", "node2vec_unweighted", "2ndpr",
                "visited_avoiding")
# steps before the main-path state phase 5 times a program's kernels at:
# MetaPath walks dead-end and PPR-Nibble walks stop early
MID_STEP = {name: 4 if name.startswith("metapath") or name == "ppr_nibble"
            else 8 for name in ADAPTIVE_NEEDS}


def base_program(pname: str) -> str:
    """The registry program a row's program label stands for: a stripped
    twin ``gen:<name>`` or ``gen-hooks:<name>`` is ``<name>``."""
    for prefix in (GEN, GEN_HOOKS):
        if pname.startswith(prefix):
            return pname[len(prefix):]
    return pname



def mid_step(pname: str) -> int:
    return MID_STEP.get(base_program(pname), 8)


# the fused regimes and the method that runs each
FUSED_METHODS = {"reservoir": "ervs", "rejection": "erjs",
                 "precomp_its": "its_precomp",
                 "precomp_alias": "alias_precomp"}
# the programs run fused against staged: the hook-free deepwalk and the
# hooked ppr_nibble
FUSED_PROGRAMS = ("deepwalk", "ppr_nibble")
# depth of the fused / staged pairs: 16 of the 80 steps, to keep the
# smoke inside its time limit (ppr_nibble's, and so phase 4c's
# generated-hooks runs, since phase 4d came in)
PAIR_STEPS = 16
# kernels each staged fused-method run must launch
STAGED_NEEDS = {"ervs": ("ervs_select",), "erjs": ("erjs_select",),
                "its_precomp": ("its_search",),
                "alias_precomp": ("alias_pick",)}
# steps of the K4 launches checked (phase 3) and timed (phase 5)
K4_EPOCH = 16
# cold K4 launches of the table regimes timed in phase 5
K4_COLD_REPS = 3
# bytes a table draw's walker streams in and out beside its random reads:
# the engine's entries (cur and the result int64, the step key) and the
# aligned entries (row start, degree, total, the seeds, the int32 result)
ENGINE_STREAM_BYTES, ALIGNED_DRAW_BYTES = 32.0, 32.0
# the CDF block K3's engine entry and K4's ITS instance read whole after
# their fence search: 16 float32 entries
ITS_BLOCK_BYTES = 64.0
# steps over which phase 5 holds K4's reservoir regime against its plain
# version (~10^11 edges a step for deepwalk's every walker), and the
# walkers it holds there: up to K4_RESERVOIR_PLAIN_PER_ROW on each of the
# OPS_HUB_LANES largest rows, the rest at random (every walker took ~190
# s of the smoke's 1,200; the kernel's step is timed on every walker; cut
# from 65,536 when phase 4e came in)
K4_RESERVOIR_PLAIN_EPOCH = 1
K4_RESERVOIR_PLAIN_LANES = 16384
K4_RESERVOIR_PLAIN_PER_ROW = 16
K4_RESERVOIR_PLAIN_SEED = 17
# phase 4b, the compiler: registry programs stripped of their declarations
# and device rules (walks.examples.stripped), run adaptive on generated
# device rules against the declared programs' phase-4 runs; stripped
# deepwalk fused in these regimes against the declared fused runs; and
# the quickstart program (walks.examples.degree_damped) adaptive
COMPILER_ADAPTIVE = ("node2vec", "metapath")
COMPILER_FUSED = ("rejection", "precomp_its")
QUICKSTART = "degree_damped"
GEN = "gen:"
# phase 4c, state and hooks: visited_avoiding stripped of its hand rule (a
# generated weight that reads the ring) adaptive against the declared
# program's phase-4 run; ppr_nibble stripped of its hook rule too (K4's
# HOOK_GENERATED instances), label GEN_HOOKS + name, fused under every
# method against the declared fused runs; the quickstart program and
# non_backtracking (walks.examples) fused under ervs against their staged
# runs, non_backtracking over NONBACKTRACKING_STEPS (8; 16 before phase
# 4d came in)
STATE_ADAPTIVE = ("visited_avoiding",)
GEN_HOOKS = "gen-hooks:"
HOOKED_FUSED = "ppr_nibble"
NONBACKTRACKING = "non_backtracking"
NONBACKTRACKING_STEPS = 8
USER_FUSED = (QUICKSTART, NONBACKTRACKING)
# main-path depth of the adaptive programs cut below WALK_STEPS to keep the
# smoke inside its time limit (2ndpr: 140 s at 80 steps)
MAIN_STEPS = {"2ndpr": 16}
# the Fig. 13 selector cells: node2vec under each method, and their depth
SELECTOR_METHODS = ("random", "degree")
SELECTOR_STEPS = {"random": 16, "degree": 80}
# phase 4d, the Table 2 baselines (``benchmarks/table2.py:12-18``): C-SAW's
# ITS, Skywalker's ALS, FlowWalker's prefix reservoir and NextDoor's
# max-reduce rejection (K9-K12) and adaptive on the same queries; their
# full-row work grows with the walkers' rows, so the phase cuts queries
# (``BASELINE_QUERIES`` start nodes of ``default_rng(BASELINE_SEED)``),
# not width: at 65,536 the phase takes ~30 s on an H100, well inside the
# ~150 s it may take, so no halving was needed
TABLE2_PROGRAMS = ("node2vec_unweighted", "node2vec", "metapath_unweighted",
                   "metapath", "2ndpr")
BASELINE_METHODS = ("its", "als", "rvs_prefix", "rjs_maxreduce")
BASELINE_NEEDS = {"its": ("its_row",), "als": ("als_row",),
                  "rvs_prefix": ("rvs_prefix_row",),
                  "rjs_maxreduce": ("row_max", "erjs_select")}
BASELINE_QUERIES = 65_536
BASELINE_STEPS = 8
BASELINE_SEED = 0
# phase 3f: walkers on rows of at most this many entries, the plain
# versions at this pad; then walkers on the largest rows at the engine's
# pad
BASELINE_CHECK_PAD = 4096
BASELINE_CHECK_WALKERS = 2048
BASELINE_HUB_WALKERS = 2
# phase 5: the step of the phase-4d queries K9-K12 are timed at; their
# plain versions at the engine's pad on a subset of those lanes (up to one
# lane on each of the OPS_HUB_LANES largest distinct rows among them, the
# rest drawn with BASELINE_PLAIN_SEED), BASELINE_PLAIN_CHUNK lanes a call
# ([chunk, pad] blocks on the card); ALS's plain Vose loop on the lane of
# the largest row and BASELINE_ALS_PLAIN_LANES - 1 more (drawn with the
# same seed), which it finishes on the host
BASELINE_TIMED_STEP = 4
BASELINE_PLAIN_LANES = 1024
BASELINE_PLAIN_CHUNK = 64
BASELINE_ALS_PLAIN_LANES = 4
BASELINE_PLAIN_SEED = 16
# phase 2b, the standalone ops: K7's (trials, rounds), K6's plain check
# on the hub-heavy set (walkers, distinct largest rows among them,
# sampling seed) and its timed launches there
OPS_ERJS_BUDGET = (8, 16)
OPS_PLAIN_LANES = 4096
OPS_HUB_LANES = 64
OPS_SEED = 14
# phase 1b, LM serving: the model served at full width, its requests
# (batch, prompt tokens, new tokens, temperature), the generator seed of
# the weights and prompts, the sampler's key, and the seed of K8's checks
LM_ARCH = "qwen3-0.6b"
LM_BATCH, LM_PROMPT, LM_NEW = 8, 16, 32
LM_TEMPERATURE = 0.8
LM_SEED = 0
LM_KEY = 2
LM_CHECK_SEED = (11, 22)
# decode steps traced with torch.profiler (device activity only: with the
# host's too, the trace of 4 steps took ~18 s) for the card's busy time
LM_PROFILED = 2
# operations of one of XLA's float32 CPU logs (Cephes: frexp, a degree-8
# polynomial in fused multiply-adds, the exponent term, the edge cases)
XLA_LOG_OPS = 30
# what a K1 difference from its plain version may be: plain eRVS may part
# at a near-tie (torch's and the device's logf differ by an ulp), the jump
# instance runs its plain version's arithmetic and must be bitwise
K1_RULE = {False: "all near-ties", True: "none (bitwise)"}
# phase 5: programs whose K1 jump lanes phase 5 holds against the plain
# version on a subset (up to JUMP_PLAIN_PER_ROW lanes on each of the
# OPS_HUB_LANES largest distinct rows, the rest drawn with
# JUMP_PLAIN_SEED), because the plain scan of all of 2ndpr's hub lanes
# took 223 s (~10^11 edges); K1 itself still runs and is timed on all
# lanes
JUMP_PLAIN_SUBSET = {"2ndpr": 256}
JUMP_PLAIN_PER_ROW = 1
JUMP_PLAIN_SEED = 15
# phase 5: K1 jump against its plain version at these tiles (one thread
# holds 1, 2 and 32 lanes; 1,024 is the largest one-pass tile) under the
# rules with a dist(v', u) test, on JUMP_TILE_WALKERS walkers 3 steps in
# (rows of at most 4,096), every tenth with no previous node and every
# tenth one step later with the graph's largest row as its previous node,
# so the kernel's cursor gallops through a long row.  At a tile, only the
# walkers whose lanes hold at most JUMP_TILE_ITEMS items are checked: the
# plain version takes a step of torch operations per tile of the longest
# row (~26 ms each on the card), and at tile 2 rows of 4,096 took ~55 s a
# program
JUMP_TILES = (2, 64, 1024)
JUMP_TILE_PROGRAMS = ("node2vec", "2ndpr", "visited_avoiding")
JUMP_TILE_WALKERS = 1024
JUMP_TILE_ITEMS = 256
# operations of one edge of the jump scan that takes nothing: the rule's
# weight (at most ~6 float operations and the dist test's compare), the
# running sum and the crossing test
JUMP_EDGE_OPS = 12
# K8 and torch.argmax: timed runs per measurement (microseconds each)
LM_TIMING_REPS = 50


def fail(msg: str) -> None:
    print(f"[smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[smoke {time.perf_counter() - _START:7.1f}s] {msg}", flush=True)


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


# bytes written before each cold launch: over five times the H100's 50 MB
# L2, so the launch finds none of its inputs there
L2_FLUSH_BYTES = 256 << 20


def cold_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card with its L2 flushed
    before each run (a write of ``L2_FLUSH_BYTES`` outside the timed
    window), after one warm-up run: what a kernel takes on the main path,
    where other kernels run between two of its launches."""
    import torch

    fn()
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda")
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / reps


def cold_text(r: dict) -> str:
    """A row's cold time, for its log line ('' without one)."""
    return f" (cold {r['cold_ms']:.4f} ms)" if "cold_ms" in r else ""


def device_ms(fn, reps: int):
    """Mean device milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up run: the time of the kernels it launched on the card, from
    ``torch.profiler`` (device activity only), without the host's gaps
    between them; None when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / 1e3 / reps if total > 0 else None


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_SM = {}


def sm_rate():
    """(SMs, SM clock in Hz) of card 0, the clock nvidia-smi's
    clocks.max.sm; read once."""
    if not _SM:
        import torch

        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True)
        try:
            mhz = float(out.stdout.strip().splitlines()[0])
        except (ValueError, IndexError):
            fail(f"nvidia-smi gave no clocks.max.sm: {out.stdout!r} "
                 f"{out.stderr!r}")
        _SM.update(sms=torch.cuda.get_device_properties(0)
                   .multi_processor_count, hz=mhz * 1e6)
    return _SM["sms"], _SM["hz"]


def pipe_bound(nbytes: float, alu: float, instr: float):
    """(ms, what bounds it) for work counted by pipe: bytes at the
    memory rate, integer-ALU instructions at INT_ALU_LANES and every
    instruction at ISSUE_LANES lanes an SM a clock (``sm_rate``)."""
    sms, hz = sm_rate()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(alu / INT_ALU_LANES, instr / ISSUE_LANES) / (sms * hz) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pipe_note(per_edge_bytes: float) -> str:
    """How a pipe bound of the plain scan was counted, for its row."""
    sms, hz = sm_rate()
    return (f"per scanned edge {per_edge_bytes:g} B and "
            f"{THREEFRY_ALU + UNIFORM_ALU} integer-ALU of "
            f"{THREEFRY_INSTR + UNIFORM_INSTR + KEY_COMPARE_INSTR} "
            f"instructions (Threefry from the SASS, the uniform, the "
            f"compare); per tile of a row the tile key's fold and parity "
            f"({THREEFRY_ALU + PARITY_ALU} integer-ALU); per walker step its "
            f"inputs, the step key's parity, the winner's neighbour "
            f"and the expected exact keys ({EXACT_KEY_INSTR} instructions "
            f"each, H(m) for a thread of m edges); the ALU at "
            f"{INT_ALU_LANES} and the issue at {ISSUE_LANES} lanes an SM a "
            f"clock, {sms} SMs at {hz / 1e6:.0f} MHz (nvidia-smi "
            f"clocks.max.sm)")


def fence_probes(start, deg):
    """Reads of the fence search of K3's engine entry and K4's ITS
    instance over rows [start, start + deg): a lower-bound binary search
    of the fences of the row's blocks but its last (``probes`` less one,
    no read where the row lies in one block)."""
    import torch

    from repro_torch.core.precomp import FENCE_BLOCK

    s, d = start.to(torch.int64), deg.to(torch.int64)
    fences = torch.where(d > 0, (s + d - 1) // FENCE_BLOCK - s // FENCE_BLOCK,
                         0)
    return (probes(fences) - 1).clamp_min(0)


def its_work(n: int, n_probes: float, walker_bytes: float, sector_bytes:
             float):
    """(bytes, integer-ALU instructions, instructions) of the ITS draw of
    ``n`` walkers: per walker ``walker_bytes`` streamed (inputs, result),
    one Threefry, its key's parity, the uniform and the draw's own work;
    ``sector_bytes`` of random reads in all; per probe of a binary search
    (``n_probes`` in all) its compare and update."""
    return (n * walker_bytes + sector_bytes,
            n * (THREEFRY_ALU + PARITY_ALU + UNIFORM_ALU + ITS_DRAW_ALU)
            + n_probes * PROBE_ALU,
            n * (THREEFRY_INSTR + PARITY_INSTR + UNIFORM_INSTR
                 + ITS_DRAW_INSTR) + n_probes * PROBE_INSTR)


def alias_columns(seeds, deg):
    """Per walker: the column the alias draw reads (``seeds`` [n, 2] the
    draw's keys, ``deg`` the rows' degrees)."""
    import torch
    from repro_torch.core.precomp import ALIAS_SALT
    from repro_torch.kernels.prng import uniform_pair_01

    u1, _ = uniform_pair_01(seeds[:, 0], seeds[:, 1], 0, ALIAS_SALT)
    d = deg.to(torch.int64)
    return torch.minimum((u1 * d.to(torch.float32)).to(torch.int64),
                         (d - 1).clamp_min(0))


def alias_rejected(seeds, deg, off):
    """Per walker: did the alias draw reject its column (and so need the
    column's alias offset)?  ``seeds`` [n, 2] the draw's keys, ``deg``
    the rows' degrees, ``off`` the offsets the draw picked."""
    return (off >= 0) & (off != alias_columns(seeds, deg))


def alias_work(n: int, walker_bytes: float, sector_bytes: float):
    """(bytes, integer-ALU instructions, instructions) of the alias draw
    of ``n`` walkers: per walker ``walker_bytes`` streamed (inputs,
    result), one Threefry, its key's parity, two uniforms and the draw's
    own work; ``sector_bytes`` of random reads in all."""
    return (n * walker_bytes + sector_bytes,
            n * (THREEFRY_ALU + PARITY_ALU + 2 * UNIFORM_ALU
                 + ALIAS_DRAW_ALU),
            n * (THREEFRY_INSTR + PARITY_INSTR + 2 * UNIFORM_INSTR
                 + ALIAS_DRAW_INSTR))


def table_draw_reads(kind: str, g, tables, cur, keys):
    """What the table draws at nodes ``cur`` with step keys ``keys`` read
    past their row's bounds and total, for the walkers that draw (degree
    and total above 0): (those walkers' nodes, the table, its flat
    indices read).  ``its``: both 32 B halves of the 64 B CDF block that
    holds the picked offset (``its_offsets``, the plain version's);
    ``alias``: the first word of the column's 8 B pair."""
    import torch
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.core.precomp import FENCE_BLOCK, its_offsets

    deg = degrees_of(g, cur)
    draw = (deg > 0) & (tables.total[cur] > 0)
    v, k = cur[draw], keys[draw]
    start = g.indptr[v].to(torch.int64)
    if kind == "its":
        pos = start + its_offsets(g, tables, v, k)
        blk = pos - pos % FENCE_BLOCK
        at = torch.stack((blk, blk + FENCE_BLOCK // 2), 1).view(-1)
        return v, tables.cdf, at.clamp_max(tables.cdf.numel() - 1)
    return v, tables.alias_pair, 2 * (start + alias_columns(k, deg[draw]))


def engine_draw_work(kind: str, g, tables, cur, keys):
    """(bytes, integer-ALU instructions, instructions) of K3's (``its``)
    or K5's (``alias``) engine entry on walkers at ``cur`` with step keys
    ``keys``: per walker 32 B streamed (``ENGINE_STREAM_BYTES``); each
    distinct 32 B sector of the 16 B node records, once; of the walkers
    that draw, each distinct sector of K3's 64 B CDF blocks (after a fence
    search that stays in L2: no DRAM bytes, its probes' instructions kept)
    or of K5's 8 B pair words, once (``table_draw_reads``)."""
    from repro_torch.core.ctxutil import degrees_of

    n = cur.numel()
    rec, _ = distinct_sectors(tables.draw_rows(g.indptr), 4 * cur)
    v, table, at = table_draw_reads(kind, g, tables, cur, keys)
    sectors = SECTOR_BYTES * (rec + distinct_sectors(table, at)[0])
    if kind == "its":
        n_probes = float(fence_probes(g.indptr[v], degrees_of(g, v)).sum())
        return its_work(n, n_probes, ENGINE_STREAM_BYTES, sectors)
    return alias_work(n, ENGINE_STREAM_BYTES, sectors)


def draw_note(kind: str, entry: str) -> str:
    """How a pipe bound of a table draw (``entry``: "engine" or
    "aligned") was counted, for its row."""
    sms, hz = sm_rate()
    if kind == "its":
        alu = THREEFRY_ALU + PARITY_ALU + UNIFORM_ALU + ITS_DRAW_ALU
        instr = THREEFRY_INSTR + PARITY_INSTR + UNIFORM_INSTR + ITS_DRAW_INSTR
        probe = "fence probe" if entry == "engine" else \
            "probe of the plain binary search"
        ops = (f"{alu} integer-ALU of {instr} instructions (Threefry from "
               f"the SASS, the parity, the uniform, the target and the "
               f"clip); per {probe} {PROBE_ALU} integer-ALU of "
               f"{PROBE_INSTR} instructions")
    else:
        alu = THREEFRY_ALU + PARITY_ALU + 2 * UNIFORM_ALU + ALIAS_DRAW_ALU
        instr = (THREEFRY_INSTR + PARITY_INSTR + 2 * UNIFORM_INSTR
                 + ALIAS_DRAW_INSTR)
        ops = (f"{alu} integer-ALU of {instr} instructions (Threefry from "
               f"the SASS, the parity, two uniforms, the column, the "
               f"compare)")
    sector = f"{SECTOR_BYTES:g} B sector"
    reads = {
        ("its", "engine"): f"each distinct {sector} of the 16 B node "
                           f"records, once; each distinct {sector} of the "
                           f"drawing walkers' {ITS_BLOCK_BYTES:g} B CDF "
                           f"blocks, once (the fence search stays in L2: no "
                           f"DRAM bytes)",
        ("alias", "engine"): f"each distinct {sector} of the 16 B node "
                             f"records, once; each distinct {sector} of the "
                             f"drawing walkers' 8 B pair words, once",
        ("its", "aligned"): f"each distinct {sector} the plain binary "
                            f"search reads, once (ref.its_reads_ref)",
        ("alias", "aligned"): f"each distinct {sector} of the column's keep "
                              f"probability, and of its alias offset where "
                              f"the column is rejected, once "
                              f"(ref.alias_reads_ref)"}[kind, entry]
    walker = ENGINE_STREAM_BYTES if entry == "engine" else ALIGNED_DRAW_BYTES
    return (f"per walker {walker:g} B of inputs and result streamed and "
            f"{ops}; {reads}; the ALU at {INT_ALU_LANES} and the issue at "
            f"{ISSUE_LANES} lanes an SM a clock, {sms} SMs at "
            f"{hz / 1e6:.0f} MHz")


def scan_ops(d, tile: int):
    """(integer-ALU instructions, instructions) the plain scan's
    function needs on rows of ``d`` edges (a float64 tensor, one row a
    walker step) at logical tile ``tile``: per edge a Threefry, the
    uniform and the compare; per tile of a row the tile key (a Threefry
    of the step key) and its parity; per row the step key's parity and
    the exact keys.  A warp's thread holds m of a row's edges, and over m
    keys in random order the running best changes H(m) times on average,
    H(m) = digamma(m + 1) + Euler's constant."""
    import torch

    q = torch.floor(d / 32)
    rem = d - 32 * q
    harmonic = lambda m: torch.special.digamma(m + 1) + 0.5772156649015329
    exact = float((rem * harmonic(q + 1) + (32 - rem) * harmonic(q)).sum())
    edges = float(d.sum())
    tiles = float(torch.ceil(d / tile).sum())
    rows = float((d > 0).sum())
    return (edges * (THREEFRY_ALU + UNIFORM_ALU)
            + tiles * (THREEFRY_ALU + PARITY_ALU) + rows * PARITY_ALU
            + exact * EXACT_KEY_ALU,
            edges * (THREEFRY_INSTR + UNIFORM_INSTR + KEY_COMPARE_INSTR)
            + tiles * (THREEFRY_INSTR + PARITY_INSTR) + rows * PARITY_INSTR
            + exact * EXACT_KEY_INSTR)




def trial_ops(proposals: float, weighted: float):
    """(integer-ALU instructions, instructions) of ``proposals`` eRJS
    proposals (erjs.cuh), ``weighted`` of which had w > 0: per proposal
    the offset's uniform (a fold of the step key and the folded key's
    bits: two Threefry, the folded key's parity, the uniform's map) and
    the test of w; per proposal with w > 0 the acceptance uniform, as
    many again, and its compare.  A proposal with w <= 0 cannot accept
    whatever its acceptance uniform, so the function needs none."""
    alu = 2 * THREEFRY_ALU + PARITY_ALU + UNIFORM_ALU
    instr = 2 * THREEFRY_INSTR + PARITY_INSTR + UNIFORM_INSTR \
        + KEY_COMPARE_INSTR
    return (proposals + weighted) * alu, (proposals + weighted) * instr


def weighted_proposals(eng, cur, prev, step, keys, used, wstate=None):
    """[W] int64: how many of the ``used`` proposals each walker made had
    w > 0 (walkers at ``cur``, ``prev``, ``step`` with step keys ``keys``
    under ``eng``'s program), trial t re-made as ``erjs_step`` makes it:
    offset min(int(u * deg), deg - 1) with u from counter 2t."""
    import torch
    from repro_torch.core.ctxutil import degrees_of, single_edge_ctx
    from repro_torch.core.types import wstate_rows
    from repro_torch.kernels.prng import fold_in, uniform

    g, prog, params = eng.graph, eng.workload, eng.sampler_ctx.params
    u = used.long()
    deg = degrees_of(g, cur)
    out = torch.zeros_like(u)
    for t in range(int(u.max()) if u.numel() else 0):
        i = (u > t).nonzero().squeeze(1)  # made trial t, so deg > 0
        d = deg[i]
        off = torch.minimum(
            (uniform(fold_in(keys[i], 2 * t)) * d.to(torch.float32))
            .to(torch.int64), d - 1)
        ctx, valid = single_edge_ctx(g, prog, cur[i], prev[i], step[i], off)
        w = prog.get_weight(ctx, params, wstate_rows(wstate, i))
        out[i] += (valid & (w > 0)).long()
    return out


def trial_bytes(g, prev, used, weighted, pname: str, reads_h: bool):
    """[W] float64 bytes the eRJS proposals of walkers with ``used``
    proposals, ``weighted`` of them with w > 0, need: per proposal its
    neighbour (4 B), h where the rule reads it (MetaPath: where the label
    matches, w > 0), MetaPath's label, and for the second-order rules a
    binary search of the previous node's row (4 B a probe)."""
    import torch
    from repro_torch.core.ctxutil import degrees_of

    u = used.to(torch.float64)
    per = 4.0 + (4.0 if pname.startswith("metapath") else 0.0)
    if reads_h and not pname.startswith("metapath"):
        per += 4.0
    if pname in SECOND_ORDER:
        per = per + 4.0 * probes(degrees_of(g, prev))
    h = 4.0 * weighted.to(torch.float64) \
        if reads_h and pname.startswith("metapath") else 0.0
    return u * per + h


def trial_note(pname: str) -> str:
    """How a pipe bound of eRJS trials was counted, for its row."""
    sms, hz = sm_rate()
    alu, instr = trial_ops(1.0, 0.0)
    h = ("4 B of label, h where the label matches"
         if pname.startswith("metapath") else "h where the rule reads it")
    probe = (", 4 B a probe of the previous node's row's binary search"
             if pname in SECOND_ORDER else "")
    return (f"per proposal made (the kernel's used) its neighbour (4 B), "
            f"{h}{probe}, {alu:g} integer-ALU of {instr:g} instructions "
            f"(two Threefry from the SASS, the folded key's parity, the "
            f"uniform, the test of w), as much again per proposal with "
            f"w > 0 (the acceptance uniform; counted by re-making each "
            f"proposal); per walker step its inputs and the step key's "
            f"parity; the ALU at {INT_ALU_LANES} and the issue at "
            f"{ISSUE_LANES} lanes an SM a clock, {sms} SMs at "
            f"{hz / 1e6:.0f} MHz (nvidia-smi clocks.max.sm)")


def k2_work(eng, rjs, pname: str, weighted):
    """(bytes, integer-ALU instructions, instructions) K2's function
    needs on the eRJS lanes ``rjs`` of ``eng``'s main path (``rjs.got``:
    K2's results there; ``weighted``: ``weighted_proposals`` there): each
    walker's inputs and results (73 B) and its ring's bytes,
    ``trial_bytes`` of its proposals, the operations of ``trial_ops`` and
    the step key's parity a walker."""
    from repro_torch.kernels.ervs import kernel_rule

    _, prev, _, _, ws = rjs.lanes
    used = rjs.got[2]
    reads_h = kernel_rule(eng.workload, eng.sampler_ctx.params).weighted
    nbytes = float((73.0 + ring_bytes(ws, pname) + trial_bytes(
        eng.graph, prev, used, weighted, pname, reads_h)).sum())
    alu, instr = trial_ops(float(used.sum()), float(weighted.sum()))
    n = float(used.numel())
    return nbytes, alu + n * PARITY_ALU, instr + n * PARITY_INSTR


def trial_stats(used, fallback, trials: int, weighted) -> dict:
    """What the eRJS trials did on walkers with ``used`` proposals,
    ``weighted`` of them with w > 0, and ``fallback`` flags: those pending
    after round 0 (more proposals than ``trials``), the fallbacks, the
    mean proposals and proposals with w > 0 a walker."""
    n = max(used.numel(), 1)
    return dict(pending=int((used > trials).sum()),
                fallbacks=int(fallback.sum()),
                mean_used=float(used.double().sum()) / n,
                mean_weighted=float(weighted.double().sum()) / n)



def trials_text(r: dict) -> str:
    """``trial_stats`` of a row, for its log line ('' without them)."""
    if "pending" not in r:
        return ""
    return (f"; trials: {r['pending']} walkers pending after round 0, "
            f"{r['fallbacks']} fallbacks, {r['mean_used']:.4f} proposals "
            f"a walker, {r['mean_weighted']:.4f} of them with w > 0")


# ------------------------------------------------------------------ SASS
SCAN_RULES = {"0": "H", "1": "MetaPath", "2": "Dist", "3": "Visited"}
# (library, kernel) whose scan loops the build phase logs: K4's reservoir
# instance without hooks (plain K1 inlines its eight loops)
SCAN_KERNELS = (("megastep", "fused_epoch_kernelILi0EE"),)
# (library, kernel) whose Threefry loops the build phase logs: K2's round
# 0 and later rounds, K4's rejection instance without hooks, K6's
# crossing loop (a draw, its search and its update) and K7's trial loop
# (whose count is ERJS_TRIAL_*)
TRIAL_KERNELS = (("erjs", "erjs_round0_kernel"),
                 ("erjs", "erjs_rounds_kernel"),
                 ("megastep", "fused_epoch_lanesILi1ELi0E"),
                 ("ervs_block", "ervs_walk_kernel"),
                 ("erjs_block", "erjs_block_kernel"))
# the table draws' kernels whose code phase 1 logs: K3 and K5 on the CSR,
# and their aligned entries (K3's instance for 16 B aligned streams)
DRAW_KERNELS = (("its", "its_kernel"), ("alias", "alias_kernel"),
                ("its", "its_aligned_kernelILb1E"),
                ("alias", "alias_aligned_kernel"))


def _cuobjdump(lib, what: str) -> str:
    import os
    import shutil

    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/cuobjdump")
    out = subprocess.run([tool, what, str(lib)], capture_output=True,
                         text=True)
    if out.returncode:
        fail(f"cuobjdump {what} {lib} failed: {out.stderr[-2000:]}")
    return out.stdout


def sass_functions(lib, kernel: str) -> dict:
    """{function: [(address, instruction), ...]} of the SASS of the first
    kernel of the shared library ``lib`` whose name holds ``kernel``
    (``cuobjdump -sass``): the kernel's own code under its name, and each
    non-inlined function it calls under that function's name (its offset
    and size from the kernel's ELF symbols, ``cuobjdump -elf``)."""
    code, name = {}, None
    for ln in _cuobjdump(lib, "-sass").splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            code[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m and name:
            code[name].append((int(m.group(1), 16), m.group(2)))
    names = [n for n in code if kernel in n]
    if not names:
        return {}
    out = {names[0]: code[names[0]]}
    sym = re.compile(r"\s(0x[0-9a-f]+|\d+)\s+(0x[0-9a-f]+|\d+)\s+\S+\s+\S+"
                     r"\s+\S+\s+\$" + re.escape(names[0]) + r"\$(\w+)")
    for m in sym.finditer(_cuobjdump(lib, "-elf")):
        lo, size = int(m.group(1), 0), int(m.group(2), 0)
        out[m.group(3)] = [(a, i) for a, i in code[names[0]]
                           if lo <= a < lo + size]
    return out


def threefry_loops(code) -> list:
    """Opcode counts of each innermost loop (a backward branch's target to
    the branch) of ``code`` that holds a Threefry (>= 20 SHF), in address
    order: a loop that holds another such loop is left out.  The blocks
    laid out inside a loop that run rarely (a new tile's key, the exact
    key, a rule's own code) count with it."""
    from collections import Counter

    ops = [(a, re.sub(r"^@!?U?P\w+\s+", "", ins)) for a, ins in code]
    # the stubs after the last RET or EXIT (a divergent warp's shuffles and
    # votes) branch back into the body: they close no loop
    ends = [a for a, ins in ops if ins.startswith(("RET", "EXIT"))]
    last = ends[-1] if ends else float("inf")
    found = []
    for i, (a, ins) in enumerate(ops):
        m = re.match(r"BRA\S*\s.*?(0x[0-9a-f]+)\s*$", ins)
        if not m or int(m.group(1), 16) >= a or a > last:
            continue
        lo = int(m.group(1), 16)
        body = [x for b, x in ops[:i + 1] if b >= lo]
        fam = Counter(x.split()[0].split(".")[0] for x in body)
        if fam["SHF"] >= 20:
            found.append((lo, a, len(body), fam))
    inner = [f for f in found if not any(
        f[0] <= o[0] and o[1] <= f[1] and o[:2] != f[:2] for o in found)]
    return [dict(instructions=n, alu=sum(fam[k] for k in SASS_ALU),
                 imad=fam["IMAD"] + fam["VIADD"],
                 float=sum(fam[k] for k in ("FFMA", "FADD", "FMUL", "FSETP",
                                            "FMNMX", "FSEL")),
                 mufu=fam["MUFU"],
                 loads=sum(fam[k] for k in ("LDG", "LD", "LDL", "LDS")),
                 warp=sum(fam[k] for k in ("SHFL", "VOTE", "WARPSYNC")),
                 branch=sum(fam[k] for k in ("BRA", "BSSY", "BSYNC", "CALL",
                                             "RET")),
                 shf=fam["SHF"], lop3=fam["LOP3"], iadd3=fam["IADD3"])
            for _, _, n, fam in sorted(inner)]


def hot_loop(code) -> dict:
    """The smallest of ``threefry_loops``: the scan's edge loop.  {} when
    there is none."""
    loops = threefry_loops(code)
    return min(loops, key=lambda c: c["instructions"]) if loops else {}


def scan_sass(lib, kernel: str) -> dict:
    """{label: hot_loop counts} of the plain scan's edge loops as the
    first kernel of ``lib`` named with ``kernel`` runs them: one per
    ``scan_row_call<RC, W>`` instance, labelled by rule class and weighting; a
    kernel whose scan is inlined, under its own name."""
    funcs = sass_functions(lib, kernel)
    scans = {n: c for n, c in funcs.items() if "scan_row_call" in n}
    out = {}
    for name, code in (scans or funcs).items():
        m = re.search(r"scan_row_callILi(\d)ELb([01])E", name)
        label = (f"scan_row<{SCAN_RULES[m.group(1)]}, "
                 f"{'weighted' if m.group(2) == '1' else 'unweighted'}>"
                 if m else name[:40])
        loop = hot_loop(code)
        if loop:
            out[label] = loop
    return out


def opcode_counts(body) -> dict:
    """Instructions of ``body`` ([(address, instruction), ...]) by pipe
    and kind, as ``threefry_loops`` counts them, and the 16 B loads."""
    from collections import Counter

    fam = Counter(re.sub(r"^@!?U?P\w+\s+", "", x).split()[0].split(".")[0]
                  for _, x in body)
    return dict(instructions=len(body), alu=sum(fam[k] for k in SASS_ALU),
                imad=fam["IMAD"] + fam["VIADD"],
                float=sum(fam[k] for k in ("FFMA", "FADD", "FMUL", "FSETP",
                                           "FMNMX", "FSEL")),
                loads=sum(fam[k] for k in ("LDG", "LD", "LDL", "LDS")),
                loads_128=sum(1 for _, x in body
                              if re.search(r"\bLDG\S*\.128\b", x)),
                branch=sum(fam[k] for k in ("BRA", "BSSY", "BSYNC", "CALL",
                                            "RET")))


def draw_sass(lib, kernel: str) -> dict:
    """Opcode counts (``opcode_counts``) of the first kernel of ``lib``
    named with ``kernel``: all its code, and each of its loops (a backward
    branch's target to the branch; K3's search is one)."""
    funcs = sass_functions(lib, kernel)
    if not funcs:
        return {}
    code = next(iter(funcs.values()))
    out = {"kernel": opcode_counts(code)}
    for i, (a, ins) in enumerate(code):
        m = re.match(r"(?:@!?U?P\w+\s+)?BRA\S*\s.*?(0x[0-9a-f]+)\s*$", ins)
        if m and int(m.group(1), 16) < a:
            lo = int(m.group(1), 16)
            out[f"loop {lo:#x}"] = opcode_counts(
                [(b, x) for b, x in code[:i + 1] if b >= lo])
    return out


def trial_sass(lib, kernel: str) -> list:
    """``threefry_loops`` of the first kernel of ``lib`` named with
    ``kernel``: the eRJS trial loops (round 0 on a lane, then the warp's
    passes) with the code inlined in them."""
    funcs = sass_functions(lib, kernel)
    return threefry_loops(next(iter(funcs.values()))) if funcs else []


def ptxas_lines(log_text: str):
    """(function, registers or spill line) pairs of a ptxas -v log."""
    name = ""
    for ln in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", ln)
        if m:
            name = m.group(1)
        elif "registers" in ln or "spill" in ln:
            yield name, ln.split(":", 1)[-1].strip()


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
                  tile: int, jump: bool, step=None, wstate=None):
    """(mismatches, unexplained): walkers where the kernel and the plain
    version chose differently, and those of them that are not near-ties
    (``step`` defaults to 0; ``wstate`` is the walkers' program state).
    The jump instance runs its plain version's arithmetic (XLA's exp, log
    and multiply-add), so every jump mismatch is unexplained."""
    import torch
    from repro_torch.core import ervs as ervs_mod
    from repro_torch.core.types import wstate_rows

    bad = (got != want).nonzero().squeeze(1)
    if not bad.numel() or jump:
        return int(bad.numel()), int(bad.numel())
    step = torch.zeros_like(cur) if step is None else step
    c, p, k, t = cur[bad], prev[bad], keys[bad], step[bad]
    ws = wstate_rows(wstate, bad)
    dev = cur.device
    oa = torch.tensor(node_offsets(graph, c, got[bad]), device=dev)
    ob = torch.tensor(node_offsets(graph, c, want[bad]), device=dev)
    ka = ervs_mod.offset_keys_f64(graph, program, params, c, p, t, k, oa,
                                  tile, ws)
    kb = ervs_mod.offset_keys_f64(graph, program, params, c, p, t, k, ob,
                                  tile, ws)
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
                f"{n_bad} differ from the plain version, {K1_RULE[jump]}: "
                f"{unexplained == 0}")
            if unexplained:
                fail(f"{name} [{eng.workload.name}]: {unexplained} "
                     f"differences break the rule: {K1_RULE[jump]}")


def program_walkers(eng, n: int, seed: int, steps: int = 3,
                    max_deg: int = 4096):
    """n check walkers of ``eng``'s program (hubs and random nodes),
    ``steps`` staged steps into their walks, the lanes still live there on
    rows of at most ``max_deg`` (the plain versions scan tile by tile;
    phase 5 holds the kernels on hub rows at main-path shapes):
    (cur, prev, step, per-step keys, program state, bound)."""
    import torch
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.core.types import WalkerState, wstate_rows
    from repro_torch.kernels.prng import key_data

    cur, _, _ = walkers(eng.graph, n, seed, max_deg=4096)
    ids = torch.arange(n, device=cur.device)
    state = WalkerState.create(cur, key_data(seed),
                               wstate=eng.workload.init_wstate_batch(ids))
    for _ in range(steps):
        state, _, _ = eng.step(state, WALK_STEPS)
    deg = degrees_of(eng.graph, state.cur)
    idx = (state.alive & (deg > 0) & (deg <= max_deg)).nonzero().squeeze(1)
    bnd = eng.sampler_ctx.estimates(state).bound_max
    return (state.cur[idx], state.prev[idx], state.step[idx],
            state.stream_keys()[idx], wstate_rows(state.wstate, idx),
            bnd[idx].contiguous())


def check_rules(adaptive: dict, seed: int) -> None:
    """Phase 3a: K1 (plain and jump) and K2 under each program's device
    rule against their plain versions, on walkers 3 steps in (rows of at
    most 4,096)."""
    import torch
    from repro_torch.core import erjs as erjs_mod
    from repro_torch.core import ervs as ervs_mod
    from repro_torch.kernels.erjs import erjs_select
    from repro_torch.kernels.ervs import ervs_select

    for name, eng in adaptive.items():
        if name in ("node2vec", "deepwalk"):
            continue  # check_kernels holds them
        g, cfg, prog = eng.graph, eng.config, eng.workload
        p = eng.sampler_ctx.params
        cur, prev, step, keys, ws, bnd = program_walkers(eng, 4096, seed)
        for jump in (False, True):
            kname = "ervs_jump_select" if jump else "ervs_select"
            plain = ervs_mod.ervs_jump_step if jump else ervs_mod.ervs_step
            got = ervs_select(g, prog, p, cur, prev, step, keys,
                              tile=cfg.tile, jump=jump, wstate=ws)
            want = plain(g, prog, p, cur, prev, step, keys, tile=cfg.tile,
                         wstate=ws)
            n_bad, unexplained = k1_mismatches(
                g, prog, p, cur, prev, keys, got, want, cfg.tile, jump,
                step, ws)
            log(f"check {kname} [{name}]: {cur.numel()} walkers 3 steps "
                f"in, {n_bad} differ from the plain version, "
                f"{K1_RULE[jump]}: {unexplained == 0}")
            if unexplained:
                fail(f"{kname} [{name}]: {unexplained} differences break "
                     f"the rule: {K1_RULE[jump]}")
        got = erjs_select(g, prog, p, cur, prev, step, keys, bnd,
                          trials=cfg.rjs_trials, rounds=cfg.rjs_max_rounds,
                          wstate=ws)
        want = erjs_mod.erjs_step(g, prog, p, cur, prev, step, keys, bnd,
                                  cfg.rjs_trials, cfg.rjs_max_rounds,
                                  wstate=ws)
        for a, b, what in zip(got, want, ("next", "fallback", "trials")):
            if not torch.equal(a, b):
                fail(f"erjs_select [{name}]: {what} differs from erjs_step "
                     f"on {int((a != b).sum())} of {cur.numel()} walkers")
        log(f"check erjs_select [{name}]: {cur.numel()} walkers, bitwise "
            f"equal to erjs_step ({int(got[0].ge(0).sum())} accepted)")


def stale_every_third(tables):
    """The same tables with every third row marked stale."""
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
    for a, b in zip(s1.wstate or (), s2.wstate or ()):
        same_end &= (a == b).reshape(a.shape[0], -1).all(dim=1)
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


def check_fused(graph, fused: dict, pname: str, seed: int,
                hand: dict = None) -> None:
    """Phase 3c: K5 (where ``fused`` has the alias regime) and every K4
    instance of program ``pname`` (``fused``: its engine per regime)
    against their plain versions on the card, on check walkers of the
    full graph (hubs included); with ``hand`` (the declared program's
    engine per regime), also bitwise against the hand rules' launch."""
    import torch
    from repro_torch.core.precomp import alias_offsets
    from repro_torch.core.types import WalkerState
    from repro_torch.kernels import megastep
    from repro_torch.kernels.alias import alias_pick

    cur, prev, keys = walkers(graph, 4096, seed)
    if "precomp_alias" in fused:
        tables = fused["precomp_alias"].precomp
        got = alias_pick(graph, tables, cur, keys)
        want = alias_offsets(graph, tables, cur, keys)
        if not torch.equal(got, want):
            fail(f"alias_pick differs from alias_offsets on "
                 f"{int((got != want).sum())} of {cur.numel()} walkers")
        log(f"check alias_pick [{pname}]: {cur.numel()} walkers, bitwise "
            f"equal to alias_offsets")
    W = cur.numel()
    step = torch.zeros_like(cur)
    step[::7] = WALK_STEPS - 5  # these stop inside the epoch
    alive = torch.ones_like(cur, dtype=torch.bool)
    alive[::11] = False
    state0 = WalkerState(
        cur=cur, prev=prev, step=step, alive=alive, rng=keys,
        wstate=fused["reservoir"].workload.init_wstate_batch(
            torch.arange(W, device=cur.device)))
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
        stopped = int((state0.alive & ~want[0].alive).sum())
        same = ""
        if hand is not None:
            twin = hand[kind]
            ref = megastep.fused_epoch(graph, twin.workload,
                                       twin.sampler_ctx.params, state0,
                                       **args)
            if not same_epoch(got, ref):
                fail(f"fused_epoch_{kind} [{pname}]: the generated hooks' "
                     f"epoch differs from the hand hook rule's")
            same = "; bitwise equal to the hand hook rule's launch"
        log(f"check fused_epoch_{kind} [{pname}] ({what}; hook rule "
            f"{megastep.kernel_hooks(eng.workload, p).kind}): {W} walkers x "
            f"{K4_EPOCH} steps, kernel {ms:.4f} ms (first launch), plain "
            f"{plain_ms:.4f} ms, flag bits {counts}, {stopped} walkers "
            f"stopped; {n_bad} walkers differ from the plain version, all "
            f"at reservoir near-ties: {unexplained == 0}{same}")
        if unexplained:
            fail(f"fused_epoch_{kind} [{pname}]: {unexplained} walkers "
                 f"differ from the plain version other than at a reservoir "
                 f"near-tie")
        if kind == "rejection" and not counts["fallback"]:
            fail("the forced-fallback check of fused_epoch_rejection made "
                 "no fallback")
        if kind.startswith("precomp") and not counts["stale"]:
            fail(f"the stale-row check of fused_epoch_{kind} served no "
                 f"stale row")
        if eng.workload.should_stop is not None and not stopped:
            fail(f"fused_epoch_{kind} [{pname}]: no walker stopped, so the "
                 f"hook branch was not exercised")


def same_state(a, b) -> bool:
    """Whether two walker states are equal bit for bit, program state
    included."""
    import torch

    return (all(torch.equal(getattr(a, f), getattr(b, f))
                for f in ("cur", "prev", "step", "alive"))
            and all(torch.equal(x, y) for x, y in zip(a.wstate or (),
                                                      b.wstate or ())))


def same_epoch(a, b) -> bool:
    """Whether two K4 epochs give the same emitted nodes, flag words and
    end state, bit for bit."""
    import torch

    (sa, ea, fa), (sb, eb, fb) = a, b
    return torch.equal(ea, eb) and torch.equal(fa, fb) and same_state(sa,
                                                                      sb)


def gen_programs() -> dict:
    """Phase 4b's and 4c's programs by label: the stripped twins
    ``gen:<name>`` of ``COMPILER_ADAPTIVE``, ``STATE_ADAPTIVE`` and
    deepwalk, ppr_nibble stripped of its hook rule too
    (``gen-hooks:ppr_nibble``), the quickstart program and
    non_backtracking."""
    from repro_torch.walks import make_workload
    from repro_torch.walks.examples import (degree_damped, non_backtracking,
                                            stripped)

    progs = {GEN + n: stripped(make_workload(n))
             for n in COMPILER_ADAPTIVE + STATE_ADAPTIVE + ("deepwalk",)}
    progs[GEN_HOOKS + HOOKED_FUSED] = stripped(make_workload(HOOKED_FUSED),
                                               hooks=True)
    progs[GEN + QUICKSTART] = degree_damped()
    progs[GEN + NONBACKTRACKING] = non_backtracking()
    return progs


def build_generated(progs: dict) -> None:
    """Phase 1: each program's weight lowered to a generated rule, and the
    rules' instances of K1, K2 and K4 built, all together."""
    from repro_torch.kernels import build
    from repro_torch.kernels.ervs import kernel_rule

    t0 = time.perf_counter()
    headers = [kernel_rule(p, p.params()).header for p in progs.values()]
    t1 = time.perf_counter()
    build.build_all(tuple(headers))
    log(f"build: generated rules of {', '.join(progs)} lowered in "
        f"{t1 - t0:.2f} s; their {len(headers) * len(build.GENERATED_SOURCES)}"
        f" libraries ({', '.join(build.GENERATED_SOURCES)} each) built in "
        f"{time.perf_counter() - t1:.1f} s")


def check_generated(graph, adaptive: dict, gen_adaptive: dict,
                    fused: dict, gen_fused: dict, seed: int) -> None:
    """Phase 3d: K1 (plain and jump) and K2 under each generated rule
    against their plain versions, on the walkers check_rules gives the
    hand rules (those of the declared twin; the quickstart program's own),
    and bitwise against the hand rule's launch on them; K4 under stripped
    deepwalk's rule in the ``COMPILER_FUSED`` regimes against its plain
    version as in phase 3c, and bitwise against the declared program's."""
    import torch
    from repro_torch.core import erjs as erjs_mod
    from repro_torch.core import ervs as ervs_mod
    from repro_torch.core.types import WalkerState
    from repro_torch.kernels import megastep
    from repro_torch.kernels.erjs import erjs_select
    from repro_torch.kernels.ervs import ervs_select

    for label, eng in gen_adaptive.items():
        twin = adaptive.get(base_program(label))
        g, cfg, prog = eng.graph, eng.config, eng.workload
        p = eng.sampler_ctx.params
        cur, prev, step, keys, ws, bnd = program_walkers(twin or eng, 4096,
                                                         seed)
        for jump in (False, True):
            kname = "ervs_jump_select" if jump else "ervs_select"
            plain = ervs_mod.ervs_jump_step if jump else ervs_mod.ervs_step
            got = ervs_select(g, prog, p, cur, prev, step, keys,
                              tile=cfg.tile, jump=jump, wstate=ws)
            want = plain(g, prog, p, cur, prev, step, keys, tile=cfg.tile,
                         wstate=ws)
            n_bad, unexplained = k1_mismatches(
                g, prog, p, cur, prev, keys, got, want, cfg.tile, jump,
                step, ws)
            same = ""
            if twin is not None:
                hand = ervs_select(g, twin.workload, twin.sampler_ctx.params,
                                   cur, prev, step, keys, tile=cfg.tile,
                                   jump=jump, wstate=ws)
                if not torch.equal(hand, got):
                    fail(f"{kname} [{label}]: the generated rule chose "
                         f"otherwise than the hand rule on "
                         f"{int((hand != got).sum())} walkers")
                same = ", bitwise equal to the hand rule's launch"
            log(f"check {kname} [{label}]: {cur.numel()} walkers 3 steps "
                f"in, {n_bad} differ from the plain version, "
                f"{K1_RULE[jump]}: {unexplained == 0}{same}")
            if unexplained:
                fail(f"{kname} [{label}]: {unexplained} differences break "
                     f"the rule: {K1_RULE[jump]}")
        budget = dict(trials=cfg.rjs_trials, rounds=cfg.rjs_max_rounds,
                      wstate=ws)
        got = erjs_select(g, prog, p, cur, prev, step, keys, bnd, **budget)
        want = erjs_mod.erjs_step(g, prog, p, cur, prev, step, keys, bnd,
                                  cfg.rjs_trials, cfg.rjs_max_rounds,
                                  wstate=ws)
        hand = want if twin is None else erjs_select(
            g, twin.workload, twin.sampler_ctx.params, cur, prev, step, keys,
            bnd, **budget)
        for a, b, c, what in zip(got, want, hand,
                                 ("next", "fallback", "trials")):
            if not (torch.equal(a, b) and torch.equal(a, c)):
                fail(f"erjs_select [{label}]: {what} differs from erjs_step "
                     f"or the hand rule's launch on "
                     f"{int(((a != b) | (a != c)).sum())} of {cur.numel()} "
                     f"walkers")
        log(f"check erjs_select [{label}]: {cur.numel()} walkers, bitwise "
            f"equal to erjs_step" + (" and the hand rule's launch"
                                     if twin is not None else ""))
    cur, prev, keys = walkers(graph, 4096, seed)
    step = torch.zeros_like(cur)
    step[::7] = WALK_STEPS - 5
    alive = torch.ones_like(cur, dtype=torch.bool)
    alive[::11] = False
    state0 = WalkerState(cur=cur, prev=prev, step=step, alive=alive,
                         rng=keys)
    for kind, eng in gen_fused.items():
        cfg = eng.config
        args = dict(kind=kind, tile=cfg.tile, rjs_trials=1,
                    rjs_max_rounds=1, epoch_len=K4_EPOCH,
                    num_steps=WALK_STEPS, bmax=eng._fused_bmax,
                    tables=(stale_every_third(eng.precomp)
                            if kind.startswith("precomp") else None))
        twin = fused["deepwalk"][kind]
        got = megastep.fused_epoch(graph, eng.workload,
                                   eng.sampler_ctx.params, state0, **args)
        want = megastep.fused_epoch_plain(graph, eng.workload,
                                          eng.sampler_ctx.params, state0,
                                          **args)
        hand = megastep.fused_epoch(graph, twin.workload,
                                    twin.sampler_ctx.params, state0, **args)
        n_bad, unexplained = k4_mismatches(eng, state0, got, want, cfg.tile)
        for x, y in zip((got[0].cur, got[0].alive, got[1], got[2]),
                        (hand[0].cur, hand[0].alive, hand[1], hand[2])):
            if not torch.equal(x, y):
                fail(f"fused_epoch_{kind} [{GEN}deepwalk]: the generated "
                     f"rule's epoch differs from the hand rule's")
        log(f"check fused_epoch_{kind} [{GEN}deepwalk] (rjs_trials=1, "
            f"rjs_max_rounds=1; every third row stale): {cur.numel()} "
            f"walkers x {K4_EPOCH} steps, {n_bad} differ from the plain "
            f"version, all at reservoir near-ties: {unexplained == 0}; "
            f"bitwise equal to the hand rule's launch")
        if unexplained:
            fail(f"fused_epoch_{kind} [{GEN}deepwalk]: {unexplained} walkers "
                 f"differ from the plain version other than at a reservoir "
                 f"near-tie")


def compiler_main(args, declared: dict, gen_adaptive: dict,
                  gen_fused: dict):
    """Phase 4b: the stripped twins and the quickstart program on the main
    path.  Each stripped adaptive twin must give its declared program's
    phase-4 paths, regime fractions and fallbacks bit for bit, stripped
    deepwalk's fused runs the declared fused runs'; the quickstart
    program must be PER_STEP, not static, and launch K1 and K2.  Returns
    (launches by (kernel, label), kernel names launched by label)."""
    import numpy as np
    import torch
    from repro_torch.core import flexi_compiler
    from repro_torch.kernels import build

    launches, launched = {}, {}
    tele = ("frac_rjs", "frac_precomp", "rjs_fallbacks", "live_steps")

    def same_run(label, res, ref, what):
        if not np.array_equal(res.paths, ref.paths) or any(
                getattr(res, f) != getattr(ref, f) for f in tele):
            fail(f"{label}: the stripped program's run differs from the "
                 f"declared program's {what}")
        log(f"compiler [{label}]: paths and {', '.join(tele)} equal the "
            f"declared program's {what}; steps phase "
            f"{res.seconds['steps']:.3f} s against its "
            f"{ref.seconds['steps']:.3f} s (host clock)")

    for label, eng in gen_adaptive.items():
        base = base_program(label)
        steps = min(args.steps, MAIN_STEPS.get(base, WALK_STEPS))
        need = ADAPTIVE_NEEDS.get(base, ("erjs_select",))
        counts, res = main_path(eng, label, steps, need)
        if base == QUICKSTART:
            static = flexi_compiler.is_static(eng.workload)
            log(f"compiler [{label}]: flag {eng.compiled.flag}, static "
                f"{static}, fuse report {eng.fuse}")
            if eng.compiled.flag != "PER_STEP" or static \
                    or eng.precomp is not None:
                fail(f"{label}: analysed {eng.compiled.flag}, static "
                     f"{static}; the reference finds PER_STEP, not static")
            if counts["ervs_select"] + counts["ervs_jump_select"] <= 0:
                fail(f"main path [{label}] never launched K1")
        else:
            same_run(label, res, declared[base], "phase-4 run")
        launched[label] = [k for k, n in counts.items() if n]
        launches.update({(k, label): counts[k] for k in launched[label]})
        del res
    steps = min(args.steps, PAIR_STEPS)
    for kind, eng in gen_fused.items():
        label, name = GEN + "deepwalk", f"fused_epoch_{kind}"
        if eng.step_exec_resolved != "fused":
            fail(f"{label}/{eng.config.method} resolved "
                 f"{eng.step_exec_resolved!r}, not 'fused'")
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        res = eng.run(np.arange(eng.graph.num_nodes), num_steps=steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = build.LAUNCHES[name]
        log(f"main [{label}/{eng.config.method}, fused]: "
            f"{eng.graph.num_nodes} walkers x {steps} steps in {dt:.2f} s, "
            f"{res.live_steps} live walker-steps, {n} {name} launches")
        if n <= 0:
            fail(f"{label}/{eng.config.method} fused never launched {name}")
        same_run(f"{label}/{eng.config.method}", res, declared[kind],
                 "fused run")
        launches[name, label] = n
    return launches, launched


def hooks_main(args, declared: dict, hook_fused: dict,
               user_fused: dict) -> dict:
    """Phase 4c: ppr_nibble stripped of its hook rule fused under every
    method (``hook_fused``: its engine per regime) must resolve "fused",
    run K4's HOOK_GENERATED instance and give the declared program's fused
    run (``declared``: (result, end state) per regime) bit for bit:
    paths, telemetry and end state, mass included; the quickstart program
    and non_backtracking (``user_fused``: label -> fused ervs engine) fused
    must equal their staged ervs runs likewise.  Returns the launches by
    (kernel, label)."""
    import numpy as np
    import torch
    from repro_torch.core import EngineConfig, WalkEngine
    from repro_torch.kernels import build, megastep
    from repro_torch.kernels.rules import HOOK_GENERATED

    launches = {}
    tele = ("frac_rjs", "frac_precomp", "frac_stale", "rjs_fallbacks",
            "live_steps")
    label = GEN_HOOKS + HOOKED_FUSED
    for kind, eng in hook_fused.items():
        method, name = eng.config.method, f"fused_epoch_{kind}"
        hook = megastep.kernel_hooks(eng.workload, eng.sampler_ctx.params)
        if eng.step_exec_resolved != "fused" or hook.kind != HOOK_GENERATED:
            fail(f"{label}/{method} resolved {eng.step_exec_resolved!r} "
                 f"with hook rule {hook.kind}, not 'fused' with "
                 f"HOOK_GENERATED")
        ref, ref_end = declared[HOOKED_FUSED, kind]
        steps = ref.steps
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        res = eng.run(np.arange(eng.graph.num_nodes), num_steps=steps)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = build.LAUNCHES[name]
        log(f"main [{label}/{method}, fused]: {eng.graph.num_nodes} walkers "
            f"x {steps} steps in {dt:.2f} s, {res.live_steps} live "
            f"walker-steps, {n} {name} launches (HOOK_GENERATED); steps "
            f"phase {res.seconds['steps']:.3f} s against the hand hook "
            f"rule's {ref.seconds['steps']:.3f} s (host clock)")
        if n <= 0:
            fail(f"{label}/{method} fused never launched {name}")
        if not np.array_equal(res.paths, ref.paths) or any(
                getattr(res, f) != getattr(ref, f) for f in tele):
            fail(f"{label}/{method}: the generated hooks' run differs from "
                 f"the declared program's fused run")
        end = mid_walk_state(eng, steps, steps)
        if not same_state(end, ref_end):
            fail(f"{label}/{method}: the end state (mass included) differs "
                 f"from the declared program's fused run")
        log(f"main [{label}/{method}]: paths, {', '.join(tele)} and the end "
            f"state (mass included) equal the declared program's fused run")
        launches[name, label] = n
        del res, end
    for label, eng in user_fused.items():
        steps = (args.steps if base_program(label) == QUICKSTART
                 else min(args.steps, NONBACKTRACKING_STEPS))
        staged = WalkEngine(eng.graph, eng.workload, EngineConfig(
            method=eng.config.method, step_exec="staged"))
        n, _, res, _ = fused_main_path(eng, staged, label, steps)
        launches["fused_epoch_reservoir", label] = n
        del staged, res
    return launches


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
             for name in ADAPTIVE_NEEDS]
    cells += [(name, dict(method=m, step_exec="fused"))
              for name in FUSED_PROGRAMS for m in FUSED_METHODS.values()]
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
def main_path(eng, pname: str, steps: int, need: tuple):
    """Phase 4a: one adaptive ``run()`` of program ``pname`` at full
    width; returns its launch counts and its ``WalkResult``."""
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
    emitted = int((res.paths[:, 1:] >= 0).sum())
    log(f"main [{pname}]: {V} walkers x {steps} steps in "
        f"{dt:.2f} s, {live} live walker-steps ({emitted} emitted), "
        f"{live / dt:.4g} walker-steps/s; frac_rjs={res.frac_rjs:.4f} "
        f"frac_precomp={res.frac_precomp:.4f} "
        f"frac_reservoir={1 - res.frac_rjs - res.frac_precomp:.4f} "
        f"fallbacks={res.rjs_fallbacks}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {counts}")
    split = ", ".join(f"{k} {v:.3f} s" for k, v in res.seconds.items())
    log(f"main [{pname}]: run() phases (host clock): {split}; "
        f"{res.seconds['steps'] / steps * 1e3:.2f} ms per step")
    for name in need:
        if counts[name] <= 0:
            fail(f"main path [{pname}] never launched {name}")
    check_paths(eng.graph, res.paths)
    log(f"main [{pname}]: every emitted step is an edge, stopped lanes "
        f"emit -1")
    return counts, res


def fused_main_path(fused_eng, staged_eng, pname: str, steps: int):
    """Phase 4: one fused run and one staged run of a method; returns
    (the fused run's K4 launches, the staged run's launch counts, the fused
    run's ``WalkResult``, its end state or None).  For a program with
    hooks, the end state of both (a scheduler epoch of the whole walk, as
    ``run()`` drives it) must match too, and is returned."""
    import numpy as np
    import torch
    from repro_torch.kernels import build

    kind = fused_eng._fused_kind
    method = fused_eng.config.method
    if fused_eng.step_exec_resolved != "fused":
        fail(f"{pname}/{method} with step_exec='fused' resolved "
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
        log(f"main [{pname}/{method}, {ex}]: {V} walkers x {steps} steps "
            f"in {dt:.2f} s, {r.live_steps} live walker-steps, "
            f"{r.live_steps / dt:.4g} walker-steps/s; "
            f"frac_rjs={r.frac_rjs:.4f} frac_precomp={r.frac_precomp:.4f} "
            f"frac_stale={r.frac_stale:.4f} fallbacks={r.rjs_fallbacks}; "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches {counts[ex]}; run() phases (host clock): {split}")
    a, b = res["fused"], res["staged"]
    name = f"fused_epoch_{kind}"
    if counts["fused"].get(name, 0) <= 0:
        fail(f"{pname}/{method} fused never launched {name}")
    for k in STAGED_NEEDS[method]:
        if counts["staged"].get(k, 0) <= 0:
            fail(f"{pname}/{method} staged never launched {k}")
    same = (a.paths == b.paths).all(axis=1)
    tele = ("frac_rjs", "frac_precomp", "frac_stale", "rjs_fallbacks",
            "live_steps")
    log(f"main [{pname}/{method}]: fused paths equal staged paths on "
        f"{same.mean():.6f} of queries; telemetry "
        f"{[getattr(a, f) for f in tele]} / {[getattr(b, f) for f in tele]}")
    if not same.all() or any(getattr(a, f) != getattr(b, f) for f in tele):
        fail(f"{pname}/{method}: the fused run differs from the staged run")
    ends = [None]
    if fused_eng.workload.has_hooks:
        ends = [mid_walk_state(e, steps, steps)
                for e in (fused_eng, staged_eng)]
        for f in ("cur", "prev", "step", "alive"):
            if not torch.equal(getattr(ends[0], f), getattr(ends[1], f)):
                fail(f"{pname}/{method}: fused end state {f} differs")
        for x, y in zip(ends[0].wstate, ends[1].wstate):
            if not torch.equal(x, y):
                fail(f"{pname}/{method}: fused end program state differs")
        log(f"main [{pname}/{method}]: fused end state (program state "
            f"included) equals staged; "
            f"{int((~ends[0].alive).sum())} walkers stopped early")
    check_paths(fused_eng.graph, a.paths)
    log(f"main [{pname}/{method}]: every emitted step is an edge, stopped "
        f"lanes emit -1")
    return counts["fused"][name], counts["staged"], a, ends[0]


def check_jump_tiles(adaptive: dict, seed: int) -> None:
    """Phase 5: K1 jump against its plain version, bitwise, at each of
    ``JUMP_TILES`` under each rule of ``JUMP_TILE_PROGRAMS`` (the rules
    that test dist(v', u)), on walkers 3 steps in, some with no previous
    node and some whose previous node has the graph's largest row; at a
    tile, on the walkers whose rows give a lane at most
    ``JUMP_TILE_ITEMS`` items."""
    import torch
    from repro_torch.core import ervs as ervs_mod
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.core.types import wstate_rows
    from repro_torch.kernels.ervs import ervs_select

    for name in JUMP_TILE_PROGRAMS:
        eng = adaptive[name]
        g, prog, p = eng.graph, eng.workload, eng.sampler_ctx.params
        cur, prev, step, keys, ws, _ = program_walkers(eng,
                                                       JUMP_TILE_WALKERS,
                                                       seed)
        prev = prev.clone()
        prev[::10] = -1
        prev[1::10] = int(torch.argmax(g.degrees()))
        deg = degrees_of(g, cur)
        for tile in JUMP_TILES:
            t0 = time.perf_counter()
            sel = (deg <= JUMP_TILE_ITEMS * tile).nonzero().squeeze(1)
            c, pv, st, k = (x[sel].contiguous()
                            for x in (cur, prev, step, keys))
            w = wstate_rows(ws, sel)
            got = ervs_select(g, prog, p, c, pv, st, k, tile=tile,
                              jump=True, wstate=w)
            want = ervs_mod.ervs_jump_step(g, prog, p, c, pv, st, k,
                                           tile=tile, wstate=w)
            n_bad = int((got != want).sum())
            log(f"check ervs_jump_select [{name}] at tile {tile}: "
                f"{sel.numel()} walkers (rows up to "
                f"{int(deg[sel].max()) if sel.numel() else 0}, "
                f"{int((pv < 0).sum())} with no previous node, "
                f"{int((degrees_of(g, pv) > 4096).sum())} whose previous "
                f"row is longer than 4,096), {n_bad} differ from the plain "
                f"version ({time.perf_counter() - t0:.1f} s)")
            if n_bad:
                fail(f"ervs_jump_select [{name}] at tile {tile}: {n_bad} "
                     f"walkers differ from the plain version (must be "
                     f"bitwise)")


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


def lanes_of(state, mask):
    """(cur, prev, step, lane indices, program state) of ``state``'s lanes
    in ``mask``."""
    from repro_torch.core.types import wstate_rows

    idx = mask.nonzero().squeeze(1)
    return (state.cur[idx].contiguous(), state.prev[idx].contiguous(),
            state.step[idx].contiguous(), idx, wstate_rows(state.wstate, idx))


def ring_bytes(ws, pname: str) -> float:
    """Bytes a lane reads beside its cur, prev, step and key: the
    visited-avoiding ring, once (the other rules read no state)."""
    if pname != "visited_avoiding":
        return 0.0
    return float(ws[0][0].numel() * ws[0].element_size())


def main_path_split(eng, step_at: int) -> SimpleNamespace:
    """How ``eng``'s sampler splits the live lanes of its main-path state
    after ``step_at`` steps: ``state``, the lanes' ``keys``, the
    partition ``part``; ``rjs``, the eRJS lanes (``lanes`` as
    ``lanes_of`` gives them, their ``keys`` and ``bound``, ``run`` calling
    K2 on them and ``got``, its result) or None when there are none; and
    the reservoir's plain and jump masks ``lo`` and ``hi``, which include
    eRJS's fallbacks."""
    import torch
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.kernels.erjs import erjs_select

    g, ctx, cfg = eng.graph, eng.sampler_ctx, eng.config
    state = mid_walk_state(eng, step_at)
    keys = state.stream_keys()
    live = (state.alive & (state.step < WALK_STEPS)
            & (degrees_of(g, state.cur) > 0))
    part = eng.sampler.partition(ctx, state, live, keys)
    fb = torch.zeros_like(live)
    rjs = None
    if bool(part.want_rjs.any()):
        lanes = lanes_of(state, part.want_rjs)
        cur, prev, step, idx, ws = lanes
        k, bnd = keys[idx].contiguous(), part.est.bound_max[idx].contiguous()
        run = lambda: erjs_select(g, eng.workload, ctx.params, cur, prev,
                                  step, k, bnd, trials=cfg.rjs_trials,
                                  rounds=cfg.rjs_max_rounds, wstate=ws)
        got = run()
        fb[idx] = got[1]
        rjs = SimpleNamespace(lanes=lanes, keys=k, bound=bnd, run=run,
                              got=got)
    res = live & ~part.want_pre & (~part.want_rjs | fb)
    lo, hi = eng.sampler.reservoir_split(ctx, part, res)
    return SimpleNamespace(state=state, keys=keys, part=part, rjs=rjs,
                           lo=lo, hi=hi)


def jump_work(g, prev, d, got, pname: str, weighted: bool,
              ring: float):
    """(bytes, operations) the jump reservoir's function needs on these
    walkers, whatever runs it: each walker's cur, prev, step, key and
    result (64 B) and its ``ring`` bytes; each scanned edge's neighbour
    once, its h only when the rule is ``weighted``, and MetaPath's label;
    for the second-order rules the previous row once per walker, or one
    entry of it per edge where the row is longer; ``JUMP_EDGE_OPS`` per
    edge, and for each walker that returns a neighbour the one take it
    needs at least: u0 and u1 (two Threefry), the key's and the
    threshold's logs and the tile's two keys (two Threefry).  u0 and u1
    of an edge no lane takes change nothing, and a search of the previous
    row per edge is one design's work, so neither is counted."""
    import torch
    from repro_torch.core.ctxutil import degrees_of

    per_edge = (4.0 + (4.0 if weighted else 0.0)
                + (4.0 if pname.startswith("metapath") else 0.0))
    prev_row = (4.0 * torch.minimum(degrees_of(g, prev).to(torch.float64), d)
                if pname in SECOND_ORDER else 0.0)
    nbytes = float((64.0 + ring + d * per_edge + prev_row).sum())
    walkers_taking = float((got >= 0).sum())
    ops = (float(d.sum()) * JUMP_EDGE_OPS
           + walkers_taking * (4 * THREEFRY_OPS + 2 * XLA_LOG_OPS + 10))
    return nbytes, ops


def scan_edge_bytes(pname: str, weighted: bool) -> float:
    """Bytes one edge of the plain scan reads: h when the rule is
    ``weighted``, MetaPath's label, and the neighbour for the rules whose
    weight tests dist(v', u)."""
    return ((4.0 if weighted else 0.0)
            + (4.0 if pname.startswith("metapath") else 0.0)
            + (4.0 if pname in SECOND_ORDER else 0.0))


def plain_scan_work(g, prev, d, pname: str, weighted: bool, ring: float,
                    tile: int):
    """(bytes, integer-ALU instructions, instructions) plain K1's
    function needs on walkers with rows of ``d`` edges at logical tile
    ``tile``, whatever runs it:
    each walker's inputs and result (64 B), its ``ring`` bytes and its
    winner's neighbour; ``scan_edge_bytes`` an edge, and for the rules that
    test dist(v', u) the previous row once a walker (one entry an edge
    where that row is longer); the operations of ``scan_ops``."""
    import torch
    from repro_torch.core.ctxutil import degrees_of

    prev_row = (4.0 * torch.minimum(degrees_of(g, prev).to(torch.float64), d)
                if pname in SECOND_ORDER else 0.0)
    nbytes = float((68.0 + ring + d * scan_edge_bytes(pname, weighted)
                    + prev_row).sum())
    return (nbytes, *scan_ops(d, tile))


def time_kernels(engines: dict, launched: dict, reps: int) -> dict:
    """Phase 5: each kernel at the shapes one main-path step gives it
    (the state after ``MID_STEP`` steps), per program of ``engines``
    (registry name -> adaptive engine) and kernel its main path launched
    (``launched``: registry name -> kernel names), held against its plain
    version on the same lanes: K2 and K3 bitwise, K1 bitwise or differing
    only at near-ties.  A kernel with no lane at that step is taken at the
    next step that gives it lanes; one with none fails.  Rows are keyed
    by (kernel, program)."""
    import torch
    from repro_torch.core import erjs as erjs_mod
    from repro_torch.core import ervs as ervs_mod
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.core.precomp import its_offsets
    from repro_torch.core.types import wstate_rows
    from repro_torch.kernels.ervs import ervs_select, kernel_rule
    from repro_torch.kernels.its import its_search

    rows = {}

    def time_at(pname, eng, step_at: int, names) -> None:
        """Time the kernels in ``names`` on the lanes of ``pname``'s
        main-path state after ``step_at`` steps (those with lanes)."""
        g, cfg = eng.graph, eng.config
        split = main_path_split(eng, step_at)
        state, keys_all, part = split.state, split.keys, split.part
        params = eng.sampler_ctx.params
        prog = eng.workload
        base = base_program(pname)
        if split.rjs is not None and "erjs_select" in names:
            rjs = split.rjs
            cur, prev, step, idx, ws = rjs.lanes
            keys, bnd, got = rjs.keys, rjs.bound, rjs.got
            ms = cuda_ms(rjs.run, reps)
            want, plain_ms = cuda_once(lambda: erjs_mod.erjs_step(
                g, prog, params, cur, prev, step, keys, bnd, cfg.rjs_trials,
                cfg.rjs_max_rounds, wstate=ws))
            for x, y, what in zip(got, want, ("next", "fallback", "trials")):
                if not torch.equal(x, y):
                    fail(f"erjs_select [{pname}] at main-path shapes: "
                         f"{what} differs from erjs_step on "
                         f"{int((x != y).sum())} of {idx.numel()} lanes")
            w_pos = weighted_proposals(eng, cur, prev, step, keys, got[2], ws)
            b_ms, b_by = pipe_bound(*k2_work(eng, rjs, base, w_pos))
            rows["erjs_select", pname] = dict(
                lanes=int(idx.numel()), step=step_at, ms=ms,
                plain_ms=plain_ms, max_abs_err=0, mismatches=0,
                bound_ms=b_ms, bound_by=b_by, bound_note=trial_note(base),
                **trial_stats(got[2], got[1], cfg.rjs_trials, w_pos))
        for jump, mask in ((False, split.lo), (True, split.hi)):
            name = "ervs_jump_select" if jump else "ervs_select"
            if name not in names or not bool(mask.any()):
                continue
            cur, prev, step, idx, ws = lanes_of(state, mask)
            keys = keys_all[idx].contiguous()
            plain_fn = ervs_mod.ervs_jump_step if jump else ervs_mod.ervs_step
            run = lambda: ervs_select(g, prog, params, cur, prev, step, keys,
                                      tile=cfg.tile, jump=jump, wstate=ws)
            got = run()
            ms = cuda_ms(run, reps)
            d = degrees_of(g, cur).to(torch.float64)
            chk = torch.arange(idx.numel(), device=idx.device)
            hub_all = None
            if jump and base in JUMP_PLAIN_SUBSET:
                chk = hub_and_random_walkers(cur, d, JUMP_PLAIN_SUBSET[base],
                                             JUMP_PLAIN_SEED,
                                             JUMP_PLAIN_PER_ROW)
                hub_all = on_hub_rows(cur, d)[0]
            c_cur, c_prev, c_step, c_keys = (
                x[chk].contiguous() for x in (cur, prev, step, keys))
            c_ws = wstate_rows(ws, chk)
            want, plain_ms = cuda_once(lambda: plain_fn(
                g, prog, params, c_cur, c_prev, c_step, c_keys,
                tile=cfg.tile, wstate=c_ws))
            n_bad, unexplained = k1_mismatches(g, prog, params, c_cur,
                                               c_prev, c_keys, got[chk],
                                               want, cfg.tile, jump, c_step,
                                               c_ws)
            if unexplained:
                fail(f"{name} [{pname}] at main-path shapes: {unexplained} "
                     f"differences from the plain version break the rule: "
                     f"{K1_RULE[jump]}")
            weighted = kernel_rule(prog, params).weighted
            note = {}
            if jump:
                b_ms, b_by = bound(*jump_work(
                    g, prev, d, got, base, weighted, ring_bytes(ws, base)))
            else:
                if n_bad > SCAN_NEAR_TIES:
                    fail(f"{name} [{pname}] at main-path shapes: {n_bad} "
                         f"near-tie differences from the plain version, "
                         f"above the unfiltered scan's {SCAN_NEAR_TIES}")
                b_ms, b_by = pipe_bound(*plain_scan_work(
                    g, prev, d, base, weighted, ring_bytes(ws, base),
                    cfg.tile))
                note = dict(bound_note=pipe_note(
                    scan_edge_bytes(base, weighted)))
            rows[name, pname] = dict(
                lanes=int(idx.numel()), step=step_at, ms=ms,
                plain_ms=plain_ms,
                max_abs_err=int((got[chk] - want).abs().max()),
                mismatches=n_bad, bound_ms=b_ms, bound_by=b_by,
                checked=int(chk.numel()), **note)
            if hub_all is not None:
                # what checking every lane on the largest rows would take,
                # at the plain version's rate per edge on the checked set
                hub_edges = float(d[hub_all].sum())
                chk_edges = float(d[chk].sum())
                n_hub_chk = int(torch.isin(chk, hub_all).sum())
                log(f"check {name} [{pname}]: plain version on "
                    f"{chk.numel()} of {idx.numel()} lanes ({n_hub_chk} on "
                    f"the {OPS_HUB_LANES} largest rows, up to "
                    f"{JUMP_PLAIN_PER_ROW} each), {chk_edges:.0f} edges in "
                    f"{plain_ms / 1e3:.1f} s; every lane on those rows would "
                    f"be {hub_all.numel()} lanes, {hub_edges:.0f} edges, "
                    f"about {plain_ms / 1e3 * hub_edges / chk_edges:.0f} s "
                    f"at that rate (estimate)")
        if "its_search" in names and bool(part.want_pre.any()):
            cur, _, _, idx, _ = lanes_of(state, part.want_pre)
            keys = keys_all[idx].contiguous()
            run = lambda: its_search(g, eng.precomp, cur, keys)
            got = run()
            ms = cuda_ms(run, reps)
            want, plain_ms = cuda_once(lambda: its_offsets(
                g, eng.precomp, cur, keys))
            if not torch.equal(got, want):
                fail(f"its_search [{pname}] at main-path shapes: differs "
                     f"from its_offsets on {int((got != want).sum())} of "
                     f"{idx.numel()} lanes")
            b_ms, b_by = pipe_bound(*engine_draw_work("its", g, eng.precomp,
                                                      cur, keys))
            rows["its_search", pname] = dict(
                lanes=int(idx.numel()), step=step_at, ms=ms,
                cold_ms=cold_ms(run, reps), plain_ms=plain_ms,
                max_abs_err=0, mismatches=0, bound_ms=b_ms, bound_by=b_by,
                bound_note=draw_note("its", "engine"))
        del state, split

    for pname, eng in engines.items():
        step_at = mid_step(pname)
        missing = set(launched[pname])
        while missing:
            if step_at >= WALK_STEPS:
                fail(f"{sorted(missing)} [{pname}]: launched on the main "
                     f"path, but no step gives them lanes to time")
            time_at(pname, eng, step_at, missing)
            missing -= {name for name, p in rows if p == pname}
            if missing:
                log(f"time {sorted(missing)} [{pname}]: no lanes at step "
                    f"{step_at}, trying step {step_at + 1}")
            step_at += 1
    for (name, pname), r in rows.items():
        log(f"time {name} [{pname}]: {r['lanes']} lanes at step "
            f"{r['step']}, kernel {r['ms']:.4f} ms{cold_text(r)}, plain "
            f"{r['plain_ms']:.4f} ms (on {r.get('checked', r['lanes'])} "
            f"lanes), bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['mismatches']} differences" + trials_text(r)
            + (f"; bound counted: {r['bound_note']}" if "bound_note" in r
               else ""))
    return rows


def k4_work(eng, state0, emitted, flags, args: dict, stats=None):
    """(bytes, integer-ALU instructions, instructions) a K4 launch of a
    scalar regime from ``state0`` needs on this run's data: each input
    read once and each output written once, plus per live step the
    degree and the step key (a Threefry and ~20 instructions, 4 more for
    hooks; the parity of its key, the walker's seed, once a walker) and
    the regime's work: eRJS proposals (``trial_ops``, ``trial_bytes``; 4 B
    of bound), a table draw's uniform, its ``fence_probes`` and each
    distinct 32 B sector, over the launch, of the row totals and of the
    CDF blocks or pair words the draws read (``table_draw_reads``), once,
    and the least work of the row scans of fallbacks and stale rows
    (``scan_ops``, 8 B an edge); a hooked program's state comes in and
    goes out once (4 B per lane each way).  With a ``stats`` dict, the
    rejection regime adds there what its trials did (``trial_stats``,
    summed over the steps; the mean over live walker steps)."""
    import torch
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.core.types import StepStats as S
    from repro_torch.kernels.erjs import erjs_select
    from repro_torch.kernels.ervs import kernel_rule
    from repro_torch.kernels.prng import fold_in

    g, kind = eng.graph, args["kind"]
    reads_h = kernel_rule(eng.workload, eng.sampler_ctx.params).weighted
    W, T = emitted.shape
    hooked = eng.workload.has_hooks
    nbytes = W * (41.0 + 25.0 + 8.0 * T + (state_bytes(state0) if hooked
                                            else 0.0))
    alu = instr = 0.0
    tally = dict(pending=0, fallbacks=0, used=0.0, weighted=0.0, steps=0)
    cur, prev, step = state0.cur, state0.prev, state0.step
    stepped = torch.zeros(W, dtype=torch.bool, device=cur.device)
    drawn, table_at = [], []
    for t in range(T):
        f = flags[:, t]
        bit = lambda b: ((f >> b) & 1).bool()
        live = bit(S.LIVE)
        stepped |= live
        deg = degrees_of(g, cur).to(torch.float64)
        n_live = float(live.sum())
        nbytes += 8.0 * n_live
        alu += n_live * THREEFRY_ALU
        instr += n_live * (THREEFRY_INSTR + 20 + (4 if hooked else 0))
        scan = bit(S.FALLBACK) | bit(S.STALE)
        nbytes += 8.0 * float(deg[scan].sum())
        e_alu, e_instr = scan_ops(deg[scan], eng.config.tile)
        alu += e_alu
        instr += e_instr
        if kind == "rejection":
            idx = live.nonzero().squeeze(1)
            c = cur[idx]
            keys = fold_in(state0.rng[idx], step[idx])
            _, fb, used = erjs_select(
                g, eng.workload, eng.sampler_ctx.params, c, prev[idx],
                step[idx], keys, args["bmax"][c], trials=args["rjs_trials"],
                rounds=args["rjs_max_rounds"])
            w_pos = weighted_proposals(eng, c, prev[idx], step[idx],
                                       keys, used)
            p_alu, p_instr = trial_ops(float(used.sum()), float(w_pos.sum()))
            nbytes += 4.0 * n_live + float(trial_bytes(
                g, prev[idx], used, w_pos, eng.workload.name, reads_h).sum())
            alu += p_alu
            instr += p_instr
            st = trial_stats(used, fb, args["rjs_trials"], w_pos)
            tally["pending"] += st["pending"]
            tally["fallbacks"] += st["fallbacks"]
            tally["used"] += float(used.double().sum())
            tally["weighted"] += float(w_pos.double().sum())
            tally["steps"] += int(used.numel())
        else:
            pre = bit(S.PRECOMP)
            n_pre = float(pre.sum())
            nbytes += 5.0 * n_live
            # the rows' totals and the blocks or pair words, gathered for
            # their distinct sectors over the launch
            v, table, at = table_draw_reads(
                "its" if kind == "precomp_its" else "alias", g,
                args["tables"], cur[pre], fold_in(state0.rng[pre],
                                                  step[pre]))
            drawn.append(v)
            table_at.append(at)
            if kind == "precomp_its":  # uniform_01, the fences, one block
                pr = float(fence_probes(g.indptr[v],
                                        degrees_of(g, v)).sum())
                alu += n_pre * (THREEFRY_ALU + PARITY_ALU + UNIFORM_ALU
                                + ITS_DRAW_ALU) + PROBE_ALU * pr
                instr += n_pre * (THREEFRY_INSTR + PARITY_INSTR
                                  + UNIFORM_INSTR + ITS_DRAW_INSTR) \
                    + PROBE_INSTR * pr
            else:  # uniform_pair_01, the column's 8 B pair word
                alu += n_pre * (THREEFRY_ALU + PARITY_ALU + 2 * UNIFORM_ALU
                                + ALIAS_DRAW_ALU)
                instr += n_pre * (THREEFRY_INSTR + PARITY_INSTR
                                  + 2 * UNIFORM_INSTR + ALIAS_DRAW_INSTR)
        moved = emitted[:, t] >= 0
        prev = torch.where(moved, cur, prev)
        cur = torch.where(moved, emitted[:, t].long(), cur)
        step = step + moved.long()
    if drawn:
        tables = args["tables"]
        nbytes += SECTOR_BYTES * (
            distinct_sectors(tables.total, torch.cat(drawn))[0]
            + distinct_sectors(table, torch.cat(table_at))[0])
    if stats is not None and kind == "rejection":
        n = max(tally["steps"], 1)
        stats.update(pending=tally["pending"], fallbacks=tally["fallbacks"],
                     mean_used=tally["used"] / n,
                     mean_weighted=tally["weighted"] / n)
    n_walkers = float(stepped.sum())
    return (nbytes, alu + n_walkers * PARITY_ALU,
            instr + n_walkers * PARITY_INSTR)


def k4_note(kind: str) -> str:
    """How a pipe bound of a K4 scalar regime was counted, for its row."""
    sms, hz = sm_rate()
    alu, instr = trial_ops(1.0, 0.0)
    what = {"rejection": f"per proposal made (K2's used on the same steps) "
                         f"its neighbour and h where the rule reads it, "
                         f"{alu:g} integer-ALU of {instr:g} instructions, "
                         f"as much again per proposal with w > 0, as K2's "
                         f"bound counts them",
            "precomp_its": f"per table draw one Threefry, a parity, the "
                           f"uniform and the draw's own work, per fence "
                           f"probe (in L2: no DRAM bytes) {PROBE_ALU} "
                           f"integer-ALU of {PROBE_INSTR} instructions; "
                           f"each distinct {SECTOR_BYTES:g} B sector, over "
                           f"the launch, of the row totals and of the "
                           f"{ITS_BLOCK_BYTES:g} B CDF blocks the draws "
                           f"read, once",
            "precomp_alias": f"per table draw one Threefry, a parity, two "
                             f"uniforms and the column; each distinct "
                             f"{SECTOR_BYTES:g} B sector, over the launch, "
                             f"of the row totals and of the 8 B pair words "
                             f"the draws read, once"}
    return (f"per live step 8 B, the step key (a Threefry and ~20 "
            f"instructions); {what[kind]}; the scans of fallbacks and stale "
            f"rows as the plain scan's ({THREEFRY_ALU + UNIFORM_ALU} "
            f"integer-ALU an edge); the ALU at {INT_ALU_LANES} and the issue "
            f"at {ISSUE_LANES} lanes an SM a clock, {sms} SMs at "
            f"{hz / 1e6:.0f} MHz")


def k4_reservoir_work(eng, state0, emitted, flags):
    """(bytes, integer-ALU instructions, instructions) a K4 launch of the
    reservoir regime from ``state0`` needs on this run's data: each input
    read once and each output written once as ``k4_work`` counts them;
    per live step the row's bounds, the winner's neighbour (12 B) and the
    step key (a Threefry and ~20 instructions, 4 more for hooks; the
    parity of its key, the walker's seed, once a walker); per scanned
    edge h when the rule is weighted, and ``scan_ops``."""
    import torch
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.core.types import StepStats as S
    from repro_torch.kernels.ervs import kernel_rule

    g = eng.graph
    W, T = emitted.shape
    hooked = eng.workload.has_hooks
    weighted = kernel_rule(eng.workload, eng.sampler_ctx.params).weighted
    nbytes = W * (41.0 + 25.0 + 8.0 * T + (state_bytes(state0) if hooked
                                            else 0.0))
    alu = instr = 0.0
    cur, prev = state0.cur, state0.prev
    stepped = torch.zeros(W, dtype=torch.bool, device=cur.device)
    for t in range(T):
        live = ((flags[:, t] >> S.LIVE) & 1).bool()
        stepped |= live
        d = degrees_of(g, cur[live]).to(torch.float64)
        n_live = float(live.sum())
        nbytes += n_live * 12.0 + float(d.sum()) * (4.0 if weighted else 0.0)
        e_alu, e_instr = scan_ops(d, eng.config.tile)
        alu += n_live * THREEFRY_ALU + e_alu
        instr += n_live * (THREEFRY_INSTR + 20 + (4 if hooked else 0)) \
            + e_instr
        moved = emitted[:, t] >= 0
        prev = torch.where(moved, cur, prev)
        cur = torch.where(moved, emitted[:, t].long(), cur)
    n_walkers = float(stepped.sum())
    return (nbytes, alu + n_walkers * PARITY_ALU,
            instr + n_walkers * PARITY_INSTR)


def state_bytes(state) -> float:
    """The bytes of one walker's program state read and written once (a
    hooked program's leaves come in and go out of K4: PPR-Nibble's and
    the quickstart program's mass, 8 B)."""
    return 2.0 * sum(float(leaf[0].numel() * leaf.element_size())
                     for leaf in state.wstate or ())


def walker_rows(state, idx):
    """The WalkerState of ``state``'s walkers ``idx``."""
    from repro_torch.core.types import WalkerState, wstate_rows

    return WalkerState(cur=state.cur[idx], prev=state.prev[idx],
                       step=state.step[idx], alive=state.alive[idx],
                       rng=state.rng[idx],
                       wstate=wstate_rows(state.wstate, idx))


def time_fused(fused: dict, pname: str) -> dict:
    """Phase 5b: one K4 launch of ``K4_EPOCH`` steps per regime of program
    ``pname`` from the state after ``MID_STEP`` steps, and K5 at that
    state's live lanes, each held against its plain version on the same
    state as in phase 3.  The reservoir regime, whose plain row scans take
    minutes, runs ``K4_RESERVOIR_PLAIN_EPOCH`` steps of every walker, its
    rows of ``K4_RESERVOIR_PLAIN_LANES`` walkers (hubs and random ones) are
    held against its plain version on those walkers, and its row reports
    that step (the kernel's time and bound on every walker, the plain
    version's on the subset); its ``K4_EPOCH``-step launch is timed beside
    it (``epoch16_ms``)."""
    import torch
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.core.precomp import alias_offsets
    from repro_torch.kernels import megastep
    from repro_torch.kernels.alias import alias_pick
    from repro_torch.kernels.ervs import kernel_rule

    rows = {}
    step_at = mid_step(pname)
    for kind, eng in fused.items():
        g, cfg = eng.graph, eng.config
        p = eng.sampler_ctx.params
        state = mid_walk_state(eng, step_at)
        n_live = int((state.alive & (state.step < WALK_STEPS)).sum())
        args = dict(kind=kind, tile=cfg.tile, rjs_trials=cfg.rjs_trials,
                    rjs_max_rounds=cfg.rjs_max_rounds, epoch_len=K4_EPOCH,
                    num_steps=WALK_STEPS, bmax=eng._fused_bmax,
                    tables=eng.precomp)
        launch = lambda: megastep.fused_epoch(g, eng.workload, p, state,
                                              **args)
        # K4 already ran in phases 3 and 4: this launch is warm
        got, ms = cuda_once(launch)
        extra = {}
        if kind == "reservoir":
            b_ms, b_by = pipe_bound(*k4_reservoir_work(eng, state, got[1],
                                                       got[2]))
            extra = dict(epoch16_ms=ms, epoch16_bound_ms=b_ms,
                         bound_note=pipe_note(4.0 if kernel_rule(
                             eng.workload, p).weighted else 0.0))
            args.update(epoch_len=K4_RESERVOIR_PLAIN_EPOCH)
            got, ms = cuda_once(launch)
            b_ms, b_by = pipe_bound(*k4_reservoir_work(eng, state, got[1],
                                                       got[2]))
            # the plain version on a subset: the kernel's rows of those
            # walkers (walkers are independent) against it
            chk = hub_and_random_walkers(
                state.cur, degrees_of(g, state.cur).to(torch.float64),
                K4_RESERVOIR_PLAIN_LANES, K4_RESERVOIR_PLAIN_SEED,
                K4_RESERVOIR_PLAIN_PER_ROW)
            state, got = walker_rows(state, chk), (
                walker_rows(got[0], chk), got[1][chk], got[2][chk])
            extra["checked"] = int(chk.numel())
        else:
            stats = {}
            b_ms, b_by = pipe_bound(*k4_work(eng, state, got[1], got[2], args,
                                             stats))
            extra = dict(bound_note=k4_note(kind), **stats)
            if kind.startswith("precomp"):
                extra.update(cold_ms=cold_ms(launch, K4_COLD_REPS))
        want, plain_ms = cuda_once(lambda: megastep.fused_epoch_plain(
            g, eng.workload, p, state, **args))
        n_bad, unexplained = k4_mismatches(eng, state, got, want, cfg.tile)
        del got, want
        if unexplained:
            fail(f"fused_epoch_{kind} [{pname}] at main-path shapes: "
                 f"{unexplained} walkers differ from the plain version other "
                 f"than at a reservoir near-tie")
        if kind == "reservoir" and n_bad > SCAN_NEAR_TIES:
            fail(f"fused_epoch_reservoir [{pname}] at main-path shapes: "
                 f"{n_bad} walkers part from the plain version at near-ties, "
                 f"above the unfiltered scan's {SCAN_NEAR_TIES}")
        rows[f"fused_epoch_{kind}", pname] = dict(
            lanes=n_live, step=step_at, steps=args["epoch_len"], ms=ms,
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
                fail(f"alias_pick [{pname}] at main-path shapes: differs "
                     f"from alias_offsets on {int((got != want).sum())} of "
                     f"{idx.numel()} lanes")
            rejected = int(alias_rejected(keys, degrees_of(g, cur), got).sum())
            b_ms, b_by = pipe_bound(*engine_draw_work("alias", g, tables,
                                                      cur, keys))
            rows["alias_pick", pname] = dict(
                lanes=int(idx.numel()), step=step_at, ms=ms,
                cold_ms=cold_ms(run, 5), plain_ms=plain_ms, max_abs_err=0,
                mismatches=0, bound_ms=b_ms, bound_by=b_by,
                bound_note=draw_note("alias", "engine"),
                rejected=rejected)
        del state
    for (name, pname), r in rows.items():
        steps = f" x {r['steps']} steps" if "steps" in r else ""
        extra = (f"; its {K4_EPOCH}-step launch {r['epoch16_ms']:.4f} ms, "
                 f"bound {r['epoch16_bound_ms']:.4f} ms"
                 if "epoch16_ms" in r else "")
        log(f"time {name} [{pname}]: {r['lanes']} live lanes at step "
            f"{r['step']}{steps}, kernel "
            f"{r['ms']:.4f} ms{cold_text(r)}, plain {r['plain_ms']:.4f} ms"
            + (f" (on {r['checked']} walkers)" if "checked" in r else "")
            + f", bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['mismatches']} "
            f"walkers differ{extra}" + trials_text(r)
            + (f"; bound counted: {r['bound_note']}" if "bound_note" in r
               else ""))
    return rows


# ------------------------------------------------------ LM serving
def token_sample_work(rows: int, vocab: int, greedy: bool):
    """(bytes, integer-ALU instructions, instructions) of K8 on [rows,
    vocab] logits: each logit read once, the seed read and the ids
    written; per token a compare, and when sampling a Threefry, the
    uniform's map, two of XLA's logs and the key's multiply-add; per row
    its key's parity."""
    n = float(rows) * vocab
    nbytes = 4.0 * n + 16.0 + 4.0 * rows
    if greedy:
        return nbytes, 0.0, n * KEY_COMPARE_INSTR
    return (nbytes,
            n * (THREEFRY_ALU + UNIFORM_ALU + 2 * XLA_LOG_ALU)
            + rows * PARITY_ALU,
            n * (THREEFRY_INSTR + UNIFORM_INSTR + 2 * XLA_LOG_INSTR
                 + TOKEN_KEY_INSTR) + rows * PARITY_INSTR)


def token_note(greedy: bool) -> str:
    """How a pipe bound of K8 was counted, for its row."""
    sms, hz = sm_rate()
    alu = THREEFRY_ALU + UNIFORM_ALU + 2 * XLA_LOG_ALU
    instr = THREEFRY_INSTR + UNIFORM_INSTR + 2 * XLA_LOG_INSTR \
        + TOKEN_KEY_INSTR
    per = (f"a compare ({KEY_COMPARE_INSTR} instruction)" if greedy else
           f"{alu} integer-ALU of {instr} instructions (Threefry and "
           f"XLA's log from the SASS: the uniform, two logs, the key's "
           f"multiply-add and compare)")
    return (f"per logit 4 B and {per}; per row the seed, the id and the "
            f"key's parity; the ALU at {INT_ALU_LANES} and the issue at "
            f"{ISSUE_LANES} lanes an SM a clock, {sms} SMs at "
            f"{hz / 1e6:.0f} MHz")


def lm_phase(dev, reps: int) -> dict:
    """Phase 1b: serve ``LM_ARCH`` at full width on the card — random
    weights from ``init_params`` with a seeded generator, ``LM_BATCH``
    requests of ``LM_PROMPT`` prompt tokens and ``LM_NEW`` new tokens
    through ``repro_torch.serving.generate``, sampled at
    ``LM_TEMPERATURE`` twice and greedily once, the K8 launches counted
    for each run; then K8 against its plain version, bitwise, and timed
    over ``reps`` runs beside ``torch.argmax``: host-inclusive (CUDA events
    around the Python call) and device-only (``torch.profiler``).
    Returns the kernel rows keyed by (kernel, label), each with the
    launches of its mode's main-path run."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.prng import fold_in, key_data
    from repro_torch.models import decode_step, init_cache, init_params
    from repro_torch.serving import GenerateConfig, generate

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(LM_SEED),
                         dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"lm: {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s: {n_params} parameters "
        f"(param_count() {cfg.param_count()}), {w_bytes / 2**30:.3f} GiB of "
        f"weights + {params.head_f32.numel() * 4 / 2**30:.3f} GiB float32 "
        f"head; device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    if n_params != cfg.param_count():
        fail(f"lm: {n_params} parameters, param_count() says "
             f"{cfg.param_count()}")
    B, S0, new = LM_BATCH, LM_PROMPT, LM_NEW
    total, steps = S0 + new, S0 + new - 1
    prompts = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, (B, S0), dtype=np.int32)).to(dev)
    key = key_data(LM_KEY)
    runs, launches, step_ms = {}, {}, {}
    for label, gcfg in (
            ("sampled", GenerateConfig(new, temperature=LM_TEMPERATURE)),
            ("sampled_again", GenerateConfig(new,
                                             temperature=LM_TEMPERATURE)),
            ("greedy", GenerateConfig(new, greedy=True))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launches()
        t0 = time.perf_counter()
        out = generate(params, cfg, prompts, gcfg, key=key)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: n for k, n in build.LAUNCHES.items() if n}
        peak = torch.cuda.max_memory_allocated()
        log(f"lm [{label}]: {B} requests x ({S0} prompt + {new} new "
            f"tokens) in {dt:.3f} s: {steps} decode steps, "
            f"{dt / steps * 1e3:.2f} ms per step, {B * new / dt:.1f} new "
            f"tokens/s ({B * steps / dt:.1f} decoded tokens/s); peak device "
            f"memory {peak / 2**30:.3f} GiB; launches {counts}")
        if tuple(out.shape) != (B, total) or out.dtype != torch.int32:
            fail(f"lm [{label}]: output {tuple(out.shape)} {out.dtype}, "
                 f"expected ({B}, {total}) int32")
        if not torch.equal(out[:, :S0], prompts):
            fail(f"lm [{label}]: the prompts were not kept")
        if not bool(((out >= 0) & (out < cfg.vocab_size)).all()):
            fail(f"lm [{label}]: a token id lies outside [0, "
                 f"{cfg.vocab_size})")
        if counts != {"token_sample": steps}:
            fail(f"lm [{label}]: launches {counts}, expected token_sample "
                 f"once per decode step ({steps})")
        runs[label] = out
        launches[label] = counts["token_sample"]
        step_ms[label] = dt / steps * 1e3
    if not torch.equal(runs["sampled"], runs["sampled_again"]):
        fail("lm: a second sampled run gave other tokens")
    log(f"lm: the second sampled run equals the first; request 0 sampled "
        f"{runs['sampled'][0, S0:].tolist()}, greedy "
        f"{runs['greedy'][0, S0:].tolist()}")
    # the logits of the sampled run's last decode step, recomputed by
    # feeding its tokens through decode_step; the last LM_PROFILED steps
    # under torch.profiler give the card's busy time per step
    caches = init_cache(cfg, B, total, device=dev)
    tokens = runs["sampled"].long()
    for i in range(steps - LM_PROFILED):
        last, caches = decode_step(params, cfg, tokens[:, i:i + 1], caches, i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps - LM_PROFILED, steps):
            last, caches = decode_step(params, cfg, tokens[:, i:i + 1],
                                       caches, i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / LM_PROFILED
    n_kern = sum(e.count for e in kernels) / LM_PROFILED
    warm = step_ms["sampled_again"]
    if busy > 0:
        log(f"lm: a decode step runs {n_kern:.0f} device kernels, "
            f"{busy:.3f} ms busy on the card (torch.profiler, "
            f"{LM_PROFILED} steps); against the warm run's {warm:.2f} ms "
            f"per step the card idles {1 - busy / warm:.3f} of it")
    else:
        log("lm: torch.profiler saw no device time; the card's busy time "
            "per decode step is not measured")
    del caches, params
    torch.cuda.empty_cache()
    seed_last = ops.make_seeds(fold_in(key, steps - 1), 1)[0].to(dev)
    if not torch.equal(ops.token_sample(last, seed_last, LM_TEMPERATURE),
                       runs["sampled"][:, -1]):
        fail("lm: K8 on the recomputed last decode step's logits does not "
             "give the sampled run's last tokens: the recomputation is not "
             "the served run's (decode_step or its cache differs)")
    log("lm: the last decode step's logits recomputed; K8 on them gives "
        "the sampled run's last tokens")
    gen = torch.Generator(dev).manual_seed(LM_SEED + 1)
    decode_rows = SHAPES["decode_32k"].global_batch
    wide = torch.randn((decode_rows, cfg.vocab_size), generator=gen,
                       device=dev) * 2.0
    seed = torch.tensor(LM_CHECK_SEED, dtype=torch.int64, device=dev)
    wrap = torch.tensor((2**32 - 3, LM_CHECK_SEED[1]), dtype=torch.int64,
                        device=dev)
    # the same logits 4 B past 16-byte alignment: K8 reads them with
    # scalar loads, the aligned ones with 16-byte loads
    shifted = torch.empty(wide.numel() + 1, device=dev)[1:].view(wide.shape)
    shifted.copy_(wide)
    sets = {f"last_step_b{B}": (last, seed_last),
            f"normal_b{decode_rows}": (wide, seed),
            f"normal_b{decode_rows}_unaligned": (shifted, seed),
            "normal_b5": (wide[:5].contiguous(), seed),
            "normal_b8_wrapping_seed": (wide[:8].contiguous(), wrap)}
    modes = {"sampled": dict(temperature=LM_TEMPERATURE),
             "sampled_t1": dict(temperature=1.0),
             "greedy": dict(greedy=True)}
    for label, (lg, sd) in sets.items():
        for mode, kw in modes.items():
            got = ops.token_sample(lg, sd, **kw)
            want = ref.token_sample_ref(lg, sd, **kw)
            if not torch.equal(got, want):
                fail(f"token_sample [{label}, {mode}]: differs from its plain "
                     f"version on {int((got != want).sum())} of "
                     f"{lg.shape[0]} rows")
    log(f"check token_sample: bitwise equal to its plain version on "
        f"{list(sets)} x {list(modes)}")
    rows = {}
    for label, (lg, sd) in ((f"b{B}", (last, seed_last)),
                            (f"b{decode_rows}", (wide, seed))):
        for mode in ("sampled", "greedy"):
            kw = modes[mode]
            run = lambda: ops.token_sample(lg, sd, **kw)
            ms = cuda_ms(run, reps)
            dev_ms = device_ms(run, reps)
            want, plain_ms = cuda_once(
                lambda: ref.token_sample_ref(lg, sd, **kw))
            lib_ms = lib_dev_ms = None
            if mode == "greedy":
                lib = lambda: torch.argmax(lg, 1)
                lib_ms = cuda_ms(lib, reps)
                lib_dev_ms = device_ms(lib, reps)
            b_ms, b_by = pipe_bound(*token_sample_work(*lg.shape,
                                                       mode == "greedy"))
            rows["token_sample", f"{mode}_{label}"] = dict(
                lanes=int(lg.shape[0]), vocab=int(lg.shape[1]), ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by,
                bound_note=token_note(mode == "greedy"), mismatches=0,
                launches=launches[mode])
    shown = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    # 16-byte against scalar loads: greedy at [decode_rows, V], in turns
    times = {"16-byte": [], "scalar": []}
    for loads in ("16-byte", "scalar", "scalar", "16-byte"):
        lg = wide if loads == "16-byte" else shifted
        run = lambda: ops.token_sample(lg, seed, greedy=True)
        times[loads].append(f"{cuda_ms(run, reps):.4f} ms (device "
                            f"{shown(device_ms(run, reps))})")
    log(f"time token_sample [greedy_b{decode_rows}]: 16-byte loads "
        f"{' / '.join(times['16-byte'])}, scalar loads (rows 4 B past "
        f"16-byte alignment) {' / '.join(times['scalar'])}")
    for (name, label), r in rows.items():
        lib = "" if r["library_ms"] is None else \
            (f", torch.argmax {r['library_ms']:.4f} ms (device "
             f"{shown(r['library_device_ms'])})")
        log(f"time {name} [{label}]: [{r['lanes']}, {r['vocab']}] logits, "
            f"kernel {r['ms']:.4f} ms (device {shown(r['device_ms'])}), "
            f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}){lib}; bound counted: {r['bound_note']}")
    return rows


# ------------------------------------------------- the standalone ops
def ops_walkers(row0, degs, nodes, key: int):
    """(row0, degs, seeds) of walkers at ``nodes`` of the aligned stream;
    seeds from ``make_seeds(key_data(key), n)``."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.prng import key_data

    return (row0[nodes].contiguous(), degs[nodes].contiguous(),
            ops.make_seeds(key_data(key).to(nodes.device), nodes.numel()))


def drive_ops(label: str, fn) -> dict:
    """Launch counts of one drive of the ops path: every count is set to 0
    just before ``fn()`` and read just after."""
    import torch
    from repro_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: n for k, n in build.LAUNCHES.items() if n}
    log(f"ops [{label}]: launches {counts}")
    return out, counts


def ervs_block_work(nodes, degs, draws, jumped):
    """(bytes, integer-ALU instructions, instructions) of K6 on walkers at
    ``nodes``.  A tile's sum and prefix sums depend on its row alone, so
    they are counted once per distinct row: each weight read once (4 B)
    and added once, and per position of the row's crossing tiles (a row
    has at least as many as its walker with the most) the scan's two adds
    and the running maximum.  Per walker: row0, deg, seed in and three
    outputs out (36 B), its key's parity, a compare and a subtract per
    tile; per draw a Threefry, two uniforms, an exp, two logs, two divides
    and the update (from the SASS), and a binary search over the crossing
    tile's positions (``probes``, PROBE_* a probe)."""
    import torch
    from repro_torch.kernels.ref import TILE

    tiles = torch.div(degs + TILE - 1, TILE, rounding_mode="floor")
    crossing = (tiles - jumped).to(torch.int64)
    rows, inv = torch.unique(nodes, return_inverse=True)
    row_deg = torch.zeros(rows.numel(), dtype=torch.float64,
                          device=degs.device).scatter_(
        0, inv, degs.to(torch.float64))
    row_cross = torch.zeros(rows.numel(), dtype=torch.int64,
                            device=degs.device).scatter_reduce_(
        0, inv, crossing, "amax")
    prefix = float(torch.minimum(row_cross.to(torch.float64) * TILE,
                                 row_deg).sum())
    d = draws.to(torch.float64)
    n_draws = float(d.sum())
    n_probes = float((d * probes(degs.clamp(max=TILE))).sum())
    n = float(degs.numel())
    n_tiles = float(tiles.to(torch.float64).sum())
    draw_alu = (THREEFRY_ALU + 2 * UNIFORM_ALU + XLA_EXP_ALU
                + 2 * XLA_LOG_ALU + 2 * FDIV_ALU + ERVS_UPDATE_ALU)
    draw_instr = (THREEFRY_INSTR + 2 * UNIFORM_INSTR + XLA_EXP_INSTR
                  + 2 * XLA_LOG_INSTR + 2 * FDIV_INSTR + ERVS_UPDATE_INSTR)
    nbytes = 4.0 * float(row_deg.sum()) + 36.0 * n
    alu = n * PARITY_ALU + n_draws * draw_alu + n_probes * PROBE_ALU
    instr = (TABLE_SUM_INSTR * float(row_deg.sum())
             + TABLE_SCAN_INSTR * prefix + n * PARITY_INSTR
             + TILE_RETIRE_INSTR * n_tiles + n_draws * draw_instr
             + n_probes * PROBE_INSTR)
    return nbytes, alu, instr


def ervs_block_note() -> str:
    """How K6's pipe bound was counted, for its rows."""
    sms, hz = sm_rate()
    alu = (THREEFRY_ALU + 2 * UNIFORM_ALU + XLA_EXP_ALU + 2 * XLA_LOG_ALU
           + 2 * FDIV_ALU + ERVS_UPDATE_ALU)
    instr = (THREEFRY_INSTR + 2 * UNIFORM_INSTR + XLA_EXP_INSTR
             + 2 * XLA_LOG_INSTR + 2 * FDIV_INSTR + ERVS_UPDATE_INSTR)
    return (f"each distinct row's weights once (4 B, {TABLE_SUM_INSTR} "
            f"add), {TABLE_SCAN_INSTR} instructions a position of its "
            f"crossing tiles; per walker 36 B and {TILE_RETIRE_INSTR} "
            f"instructions a tile; per draw {alu} integer-ALU of {instr} "
            f"instructions (Threefry, exp {XLA_EXP_INSTR}, log "
            f"{XLA_LOG_INSTR}, divide {FDIV_INSTR}, from the SASS) and a "
            f"binary search of its tile ({PROBE_ALU} integer-ALU of "
            f"{PROBE_INSTR} a probe); the ALU at {INT_ALU_LANES} and the "
            f"issue at {ISSUE_LANES} lanes an SM a clock, {sms} SMs at "
            f"{hz / 1e6:.0f} MHz")


def distinct_sectors(stream, at):
    """(the number of distinct 32 B sectors of ``stream`` that its flat
    indices ``at`` read, counted on the stream's own addresses; one index
    in each of them, the first read of it, in read order)."""
    import torch

    sec = torch.div(stream.data_ptr() % int(SECTOR_BYTES) + 4 * at,
                    int(SECTOR_BYTES), rounding_mode="floor")
    uniq, inv = torch.unique(sec, return_inverse=True)
    first = torch.full((uniq.numel(),), at.numel(), dtype=torch.int64,
                       device=at.device).scatter_reduce_(
        0, inv, torch.arange(at.numel(), device=at.device), "amin")
    return uniq.numel(), at[first.sort().values]


def erjs_sectors(w2d, r0, dg, seeds, trials) -> int:
    """The distinct 32 B sectors of the stream that K7's trials read
    (``ref.erjs_reads_ref``: the plain version's candidates, ``trials``
    a walker), counted on the stream's own addresses."""
    from repro_torch.kernels import ref

    return distinct_sectors(w2d, ref.erjs_reads_ref(w2d, r0, dg, seeds,
                                                    trials))[0]


def aligned_draw_work(kind: str, streams, r0, dg, tot, seeds):
    """What the plain version of K3's (``its``) or K5's (``alias``)
    aligned entry reads, and its bound's work: a namespace of ``reads``
    (the probes or columns read), ``sectors`` (the distinct 32 B sectors
    of the CDF, or of the prob and alias streams, in all), ``firsts``
    ([(stream, one index in each distinct sector it reads, in read
    order), ...]) and ``work`` (``its_work`` / ``alias_work``: 32 B
    streamed a walker and each distinct sector once)."""
    from repro_torch.kernels import ref

    if kind == "its":
        reads = [(streams[0], ref.its_reads_ref(streams[0], r0, dg, tot,
                                                seeds))]
    else:
        reads = list(zip(streams, ref.alias_reads_ref(streams[0], r0, dg,
                                                      tot, seeds)))
    per = [(st, *distinct_sectors(st, at)) for st, at in reads]
    n, n_reads = r0.numel(), sum(at.numel() for _, at in reads)
    sectors = sum(count for _, count, _ in per)
    work = its_work(n, n_reads, ALIGNED_DRAW_BYTES, SECTOR_BYTES * sectors) \
        if kind == "its" else alias_work(n, ALIGNED_DRAW_BYTES,
                                         SECTOR_BYTES * sectors)
    return SimpleNamespace(reads=n_reads, sectors=sectors, work=work,
                           firsts=[(st, first) for st, _, first in per])


def erjs_block_work(trials, sectors: int):
    """(bytes, integer-ALU instructions, instructions) of K7: per walker
    row0, deg, bound, seed in and two outputs out (36 B) and its key's
    parity; each distinct sector its trials read once (``sectors``, of
    SECTOR_BYTES: a random 4 B read moves one, and trials on one row or
    of walkers that share a row may share it); per trial the trial loop's
    instructions (ERJS_TRIAL_*, from the SASS)."""
    import torch

    t = float(trials.to(torch.float64).sum())
    n = float(trials.numel())
    return (36.0 * n + SECTOR_BYTES * sectors,
            n * PARITY_ALU + t * ERJS_TRIAL_ALU,
            n * PARITY_INSTR + t * ERJS_TRIAL_INSTR)


def erjs_block_note() -> str:
    """How K7's pipe bound was counted, for its rows."""
    sms, hz = sm_rate()
    return (f"per walker 36 B of inputs and outputs; each distinct "
            f"{SECTOR_BYTES:g} B sector the trials read, once (the plain "
            f"version's candidates); per trial {ERJS_TRIAL_ALU} integer-ALU "
            f"of {ERJS_TRIAL_INSTR} instructions (the trial loop in the "
            f"SASS: Threefry, two uniforms, the candidate, its address, the "
            f"test); the ALU at {INT_ALU_LANES} and the issue at "
            f"{ISSUE_LANES} lanes an SM a clock, {sms} SMs at "
            f"{hz / 1e6:.0f} MHz")


def on_hub_rows(nodes, degs):
    """(lanes on the ``OPS_HUB_LANES`` largest distinct rows, each with its
    rank among the row's lanes): both [n] tensors, ranks 0-based."""
    import torch

    by_node = torch.argsort(nodes)
    order = by_node[torch.argsort(degs[by_node], descending=True,
                                  stable=True)]
    s = nodes[order]
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    row = torch.cumsum(first.to(torch.int64), 0) - 1
    pos = torch.arange(s.numel(), device=s.device)
    start = torch.zeros_like(pos)
    start[first] = pos[first]
    start = torch.cummax(start, 0).values
    on_hub = row < OPS_HUB_LANES
    return order[on_hub], (pos - start)[on_hub]


def hub_and_random_walkers(nodes, degs, lanes: int = OPS_PLAIN_LANES,
                           seed: int = OPS_SEED, per_row: int = 1):
    """At most ``lanes`` walkers: up to ``per_row`` on each of the
    ``OPS_HUB_LANES`` largest distinct rows, the rest drawn at random
    (``seed``)."""
    import numpy as np
    import torch

    hub_lanes, rank = on_hub_rows(nodes, degs)
    hubs = hub_lanes[rank < per_row]
    rng = np.random.default_rng(seed)
    rest = torch.from_numpy(rng.choice(
        nodes.numel(), min(lanes - hubs.numel(), nodes.numel()),
        replace=False)).to(nodes.device)
    idx = torch.unique(torch.cat([hubs, rest]))
    return idx


def check_equal(name: str, got, want, n: int) -> None:
    import torch

    for g, w in zip(got, want):
        if not torch.equal(g, w):
            fail(f"{name}: differs from its plain version on "
                 f"{int((g != w).sum())} of {n} walkers")


def ops_sets(graph, deepwalk):
    """(w2d, row0, degs, sets): the aligned weight stream of the whole
    graph (built on the host) and the ops' walker sets, ``{label: (nodes,
    key)}``: (a) ``all_rows``, one walker per node at its own row, and (b)
    ``deepwalk_lanes``, the lanes of the adaptive deepwalk main run
    ``deepwalk`` after ``MID_STEP`` steps (hub-heavy)."""
    import torch
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    w2d, row0, degs = ops.graph_aligned_weights(graph)
    torch.cuda.synchronize()
    log(f"ops: aligned weight stream R={w2d.shape[0]} rows x 128 "
        f"({w2d.numel() * 4 / 2**30:.3f} GiB) built on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    state = mid_walk_state(deepwalk, MID_STEP["deepwalk"])
    lanes = state.alive & (degrees_of(graph, state.cur) > 0)
    nodes_b = state.cur[lanes].contiguous()
    nodes_a = torch.arange(graph.num_nodes, device=graph.device)
    return w2d, row0, degs, {"all_rows": (nodes_a, 1),
                             "deepwalk_lanes": (nodes_b, 2)}


def check_ervs_tables(w2d, r0, dg, label: str) -> dict:
    """K6's plan and tables on a walker set against their plain versions
    (``ref.ervs_leaders_ref``, ``ref.ervs_tile_tables_ref``), bitwise:
    the leaders, every tile sum, first counted position and M entry.
    Returns the tables' sizes and the plain versions' time."""
    import torch
    from repro_torch.kernels import ops, ref

    got = ops.ervs_tile_tables(w2d, r0, dg)
    lead, ms_a = cuda_once(lambda: ref.ervs_leaders_ref(
        r0, dg, w2d.shape[0]))
    if not torch.equal(got[0], lead):
        fail(f"ervs_block_select [{label}]: {got[0].numel()} leaders, the "
             f"plain plan has {lead.numel()}")
    want, ms_b = cuda_once(lambda: ref.ervs_tile_tables_ref(
        w2d, r0[lead].contiguous(), dg[lead].contiguous()))
    for name, a, b in zip(("tile sums", "first positions", "M"), got[1:],
                          want):
        if not torch.equal(a, b):
            fail(f"ervs_block_select [{label}]: the table pass's {name} "
                 f"differ from the plain version's at "
                 f"{int((a != b).sum())} of {b.numel()} entries")
    return dict(jobs=int(lead.numel()), tiles=int(want[0].numel()),
                m_entries=int(want[2].numel()), tables_plain_ms=ms_a + ms_b)


def ervs_peak(w2d, r0, dg, seeds) -> float:
    """Device memory one K6 call takes at its peak beyond its inputs and
    outputs, in bytes: its scratch dropped first, so the call allocates
    it again."""
    import torch
    from repro_torch.kernels import build, ops

    build.drop_scratch("ervs_block.")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = ops.ervs_select(w2d, r0, dg, seeds)
    torch.cuda.synchronize()
    return float(torch.cuda.max_memory_allocated() - before
                 - sum(o.numel() * o.element_size() for o in out))


def ops_phase(graph, deepwalk, tables, reps: int) -> tuple:
    """Phase 2b: the standalone ops on the tile-aligned stream of the whole
    graph — K6 and K7 over the sets of ``ops_sets``, and K3's and K5's
    aligned entries over (a).  Each drive is counted; then every kernel is
    held bitwise against its plain version on the card (K6 on (b): at
    most ``OPS_PLAIN_LANES`` walkers, the ``OPS_HUB_LANES`` largest rows
    among them; K6's tables on every leader of both sets) and timed.
    Returns (rows, launches) keyed by (kernel, walker set)."""
    import torch
    from repro_torch.kernels import ops, ref

    dev = graph.device
    t_phase = time.perf_counter()
    w2d, row0, degs, sets = ops_sets(graph, deepwalk)
    t0 = time.perf_counter()
    cdf2d, prob2d, alias2d, _, _ = ops.aligned_precomp_tables(
        tables, graph.indptr)
    torch.cuda.synchronize()
    log(f"ops: aligned CDF, prob and alias streams built in "
        f"{time.perf_counter() - t0:.1f} s")
    h_max = deepwalk.sampler_ctx.stats.h_max
    rows, launches, res = {}, {}, {}
    for label, (nodes, key) in sets.items():
        r0, dg, seeds = ops_walkers(row0, degs, nodes, key)
        bnd = h_max[nodes].contiguous()
        tot = tables.total[nodes].contiguous()
        trials, rounds = OPS_ERJS_BUDGET

        def drive():
            out = {"ervs_block_select": ops.ervs_select(w2d, r0, dg, seeds),
                   "erjs_block_select": ops.erjs_select(
                       w2d, r0, dg, bnd, seeds, trials, rounds)}
            if label == "all_rows":
                out["its_search_aligned"] = (ops.its_search(
                    cdf2d, r0, dg, tot, seeds),)
                out["alias_pick_aligned"] = (ops.alias_pick(
                    prob2d, alias2d, r0, dg, tot, seeds),)
            return out

        out, counts = drive_ops(label, drive)
        for name in out:
            if counts.get(name, 0) <= 0:
                fail(f"ops [{label}] never launched {name}")
            launches[name, label] = counts[name]
        res[label] = (r0, dg, seeds, bnd, tot, out)
    spent = dict.fromkeys(("K7", "aligned K3/K5", "their sectors",
                           "their gathers", "plain K6", "K6 tables",
                           "K6 times and peak"), 0.0)
    for label, (r0, dg, seeds, bnd, tot, out) in res.items():
        n = r0.numel()
        trials, rounds = OPS_ERJS_BUDGET
        # K7, K3 and K5 on every walker of the set
        t0 = time.perf_counter()
        want, plain_ms = cuda_once(lambda: ref.erjs_select_ref(
            w2d, r0, dg, bnd, seeds, trials, rounds))
        check_equal(f"erjs_block_select [{label}]",
                    out["erjs_block_select"], want, n)
        ms = cuda_ms(lambda: ops.erjs_select(w2d, r0, dg, bnd, seeds, trials,
                                             rounds), reps)
        sectors = erjs_sectors(w2d, r0, dg, seeds, want[1])
        b_ms, b_by = pipe_bound(*erjs_block_work(want[1], sectors))
        rows["erjs_block_select", label] = dict(
            lanes=n, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            checked=n, accepted=int((want[0] >= 0).sum()),
            mean_trials=float(want[1].double().mean()),
            sectors_per_walker=sectors / n, bound_note=erjs_block_note())
        t1 = time.perf_counter()
        spent["K7"] += t1 - t0
        if label == "all_rows":
            for name, kind, streams, run, plain in (
                    ("its_search_aligned", "its", (cdf2d,),
                     lambda: ops.its_search(cdf2d, r0, dg, tot, seeds),
                     lambda: ref.its_search_ref(cdf2d, r0, dg, tot, seeds)),
                    ("alias_pick_aligned", "alias", (prob2d, alias2d),
                     lambda: ops.alias_pick(prob2d, alias2d, r0, dg, tot,
                                            seeds),
                     lambda: ref.alias_pick_ref(prob2d, alias2d, r0, dg, tot,
                                                seeds))):
                t2 = time.perf_counter()
                want, plain_ms = cuda_once(plain)
                check_equal(f"{name} [{label}]", out[name], (want,), n)
                ms, cold = cuda_ms(run, reps), cold_ms(run, reps)
                t3 = time.perf_counter()
                drawn = aligned_draw_work(kind, streams, r0, dg, tot, seeds)
                b_ms, b_by = pipe_bound(*drawn.work)
                t4 = time.perf_counter()
                flats = [(st.view(-1), idx) for st, idx in drawn.firsts]
                gather_ms = cuda_ms(lambda: [f[i] for f, i in flats], reps)
                spent["aligned K3/K5"] += t3 - t2
                spent["their sectors"] += t4 - t3
                spent["their gathers"] += time.perf_counter() - t4
                rows[name, label] = dict(
                    lanes=n, ms=ms, cold_ms=cold, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, checked=n,
                    reads_per_walker=drawn.reads / n,
                    sectors_per_walker=drawn.sectors / n,
                    gather_ms=gather_ms,
                    bound_note=draw_note(kind, "aligned"))
        t0 = time.perf_counter()
        # K6: every walker of (a); the largest rows and others of (b); its
        # tables on every leader of both
        got = out["ervs_block_select"]
        if label == "all_rows":
            idx = torch.arange(n, device=dev)
        else:
            idx = hub_and_random_walkers(sets[label][0], dg)
        want, plain_ms = cuda_once(lambda: ref.ervs_select_ref(
            w2d, r0[idx].contiguous(), dg[idx].contiguous(),
            seeds[idx].contiguous()))
        check_equal(f"ervs_block_select [{label}]",
                    tuple(x[idx] for x in got), want, idx.numel())
        t1 = time.perf_counter()
        tabs = check_ervs_tables(w2d, r0, dg, label)
        t2 = time.perf_counter()
        spent["plain K6"] += t1 - t0
        spent["K6 tables"] += t2 - t1
        run = lambda: ops.ervs_select(w2d, r0, dg, seeds)
        ms = cuda_ms(run, reps)
        table_ms = cuda_ms(lambda: ops._ervs_tables(w2d, r0, dg), reps)
        b_ms, b_by = pipe_bound(*ervs_block_work(sets[label][0], dg, got[1],
                                                 got[2]))
        rows["ervs_block_select", label] = dict(
            lanes=n, ms=ms, cold_ms=cold_ms(run, reps), table_ms=table_ms,
            peak_mib=ervs_peak(w2d, r0, dg, seeds) / 2**20,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            checked=int(idx.numel()),
            mean_draws=float(got[1].double().mean()),
            mean_jumped=float(got[2].double().mean()),
            mean_deg=float(dg.double().mean()), **tabs,
            bound_note=ervs_block_note())
        spent["K6 times and peak"] += time.perf_counter() - t2
    for (name, label), r in rows.items():
        extra = "".join(f", {k} {r[k]:.4f}" for k in (
            "mean_deg", "mean_draws", "mean_jumped", "mean_trials",
            "reads_per_walker", "sectors_per_walker")
            if k in r)
        if "gather_ms" in r:
            extra += (f"; torch's gather of one entry of each distinct "
                      f"sector its plain version reads {r['gather_ms']:.4f} "
                      f"ms")
        if "table_ms" in r:
            extra += (f"; plan and table pass {r['table_ms']:.4f} ms of the "
                      f"call ({r['jobs']} distinct rows, {r['tiles']} tiles, "
                      f"{r['m_entries']} M entries, bitwise equal to the "
                      f"plain tables, {r['tables_plain_ms']:.1f} ms), peak "
                      f"device memory of a call {r['peak_mib']:.1f} MiB")
        log(f"time {name} [{label}]: {r['lanes']} walkers, kernel "
            f"{r['ms']:.4f} ms{cold_text(r)}, plain {r['plain_ms']:.4f} ms "
            f"(on {r['checked']} walkers, bitwise equal), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}){extra}"
            + (f"; bound counted: {r['bound_note']}" if "bound_note" in r
               else ""))
    fig12a_on_card(dev)
    log(f"ops: phase 2b took {time.perf_counter() - t_phase:.1f} s, of "
        f"which " + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()))
    return rows, launches


def fig12a_on_card(dev) -> None:
    """Fig. 12a's RNG-draw inputs (benchmarks/fig12_kernel_ablation.py):
    128 walkers on one row of uniform(0.5, 5.0) weights from
    ``default_rng(0)``, ``make_seeds(key(1), 128)``; K6 on the card, held
    bitwise against its plain version."""
    import numpy as np
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.prng import key_data
    from repro_torch.kernels.ref import TILE

    for deg in (512, 4096):
        vals = np.random.default_rng(0).uniform(0.5, 5.0, deg).astype(
            np.float32)
        w2d, row0, dg = ops.align_rows(vals, np.array([0, deg]), device=dev)
        r0, d = row0.repeat(128), dg.repeat(128)
        seeds = ops.make_seeds(key_data(1).to(dev), 128)
        got = ops.ervs_select(w2d, r0, d, seeds)
        check_equal(f"fig12a deg {deg}", got,
                    ref.ervs_select_ref(w2d, r0, d, seeds), 128)
        log(f"fig12a deg {deg}: 128 walkers, mean draws "
            f"{float(got[1].double().mean()):.4f} (a draw per weight: "
            f"{deg}), mean jumped tiles {float(got[2].double().mean()):.4f}"
            f" of {(deg + TILE - 1) // TILE}")


# ---------------------------------------------------- phase 4d, baselines
def baseline_fns():
    """kernel name -> (wrapper, plain version), called as
    ``kernel(graph, program, params, cur, prev, step, keys, pad=,
    wstate=)`` and ``plain(graph, ..., keys, pad, wstate=)``."""
    from repro_torch.core import baselines as plain
    from repro_torch.kernels import baselines as kb

    return {
        "its_row": (kb.its_select, plain.its_step),
        "rvs_prefix_row": (kb.rvs_prefix_select, plain.rvs_prefix_step),
        "als_row": (kb.als_select, plain.als_step),
        # K12 takes no keys
        "row_max": (lambda *a, pad, wstate: kb.row_max(
            *a[:6], pad=pad, wstate=wstate),
            lambda *a, wstate: plain.row_max(*a[:6], a[7], wstate=wstate)),
    }


def same_bits(got, want) -> int:
    """Entries where two results differ bit for bit (floats by bits)."""
    import torch

    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return int((got.cpu() != want.cpu()).sum())


def check_baselines(graph, adaptive: dict, seed: int) -> dict:
    """Phase 3f: K9-K12 against their plain versions, bitwise: under each
    Table 2 program's rule on ``BASELINE_CHECK_WALKERS`` walkers 3 steps
    into their walks on rows of at most ``BASELINE_CHECK_PAD`` (both at
    that pad), K12 -> K2 -> K9 as ``rjs_maxreduce`` composes them; then on
    the ``BASELINE_HUB_WALKERS`` largest rows at the engine's pad, the
    plain versions on the host.  Returns the plain versions' and the
    kernels' ms on the check walkers, by (kernel, program)."""
    import torch
    from repro_torch.core import baselines as plain
    from repro_torch.kernels import baselines as kb

    fns = baseline_fns()
    times = {}
    pad = BASELINE_CHECK_PAD
    for pname in TABLE2_PROGRAMS:
        eng = adaptive[pname]
        prog, params, cfg = eng.workload, eng.sampler_ctx.params, eng.config
        cur, prev, step, keys, ws, _ = program_walkers(
            eng, BASELINE_CHECK_WALKERS, seed, max_deg=pad)
        args = (graph, prog, params, cur, prev, step, keys)
        for name, (kernel, ref_fn) in fns.items():
            got, ms = cuda_once(lambda: kernel(*args, pad=pad, wstate=ws))
            want, plain_ms = cuda_once(lambda: ref_fn(*args, pad,
                                                      wstate=ws))
            bad = same_bits(got, want)
            if bad:
                fail(f"{name} [{pname}]: {bad} of {cur.shape[0]} walkers "
                     f"differ from the plain version at pad {pad}")
            times[name, pname] = dict(plain_ms=plain_ms, check_ms=ms,
                                      checked=cur.shape[0])
        trials, rounds = cfg.rjs_trials, 4 * cfg.rjs_max_rounds
        got = kb.rjs_maxreduce_select(*args, pad=pad,
                                      trials_per_round=trials,
                                      max_rounds=rounds, wstate=ws)
        want = plain.rjs_maxreduce_step(*args, pad, trials_per_round=trials,
                                        max_rounds=rounds, wstate=ws)
        if same_bits(got, want):
            fail(f"rjs_maxreduce [{pname}]: K12 -> K2 -> K9 differs from "
                 f"the plain version")
        log(f"check [{pname}]: its_row, rvs_prefix_row, als_row, row_max "
            f"and rjs_maxreduce bitwise equal to their plain versions on "
            f"{cur.shape[0]} walkers at pad {pad} (plain / kernel ms: "
            + ", ".join(f"{n} {times[n, pname]['plain_ms']:.2f} / "
                        f"{times[n, pname]['check_ms']:.3f}" for n in fns)
            + ")")
    # the largest rows at the engine's pad, the plain versions on the host
    t0 = time.perf_counter()
    host = graph.to("cpu")
    for pname in TABLE2_PROGRAMS:
        eng = adaptive[pname]
        prog, params = eng.workload, eng.sampler_ctx.params
        cur, prev, keys = walkers(graph, 32, seed)
        n = BASELINE_HUB_WALKERS
        step = torch.full((n,), 3, dtype=torch.int64, device=cur.device)
        args = (graph, prog, params, cur[:n], prev[:n], step, keys[:n])
        cpu_args = (host, prog, params) + tuple(a.cpu() for a in args[3:])
        for name, (kernel, ref_fn) in fns.items():
            got = kernel(*args, pad=eng.pad, wstate=None)
            want = ref_fn(*cpu_args, eng.pad, wstate=None)
            if same_bits(got, want):
                fail(f"{name} [{pname}]: differs from the plain version on "
                     f"the largest rows at pad {eng.pad}")
    deg = graph.degrees()[cur[:n]].tolist()
    log(f"check: K9-K12 bitwise equal to their plain versions on the "
        f"{n} largest rows (degrees {deg}) at pad {adaptive['node2vec'].pad}"
        f" under {', '.join(TABLE2_PROGRAMS)}, plain versions on the host, "
        f"in {time.perf_counter() - t0:.1f} s")
    del host
    return times


def baseline_starts(V: int, queries: int):
    import numpy as np

    return np.random.default_rng(BASELINE_SEED).choice(
        V, size=min(queries, V), replace=False)


def baselines_main(graph, queries: int, steps: int) -> dict:
    """Phase 4d: Table 2's five workloads under the four baselines and
    adaptive, on the same ``queries`` start nodes over ``steps`` steps.
    Each run must launch its kernels and emit only edges.  Returns the
    baselines' launch counts by (kernel, program) and the start nodes."""
    import torch
    from repro_torch.core import EngineConfig, WalkEngine
    from repro_torch.kernels import build
    from repro_torch.walks import make_workload

    starts = baseline_starts(graph.num_nodes, queries)
    launches = {}
    t_phase = time.perf_counter()
    for pname in TABLE2_PROGRAMS:
        for method in BASELINE_METHODS + ("adaptive",):
            eng = WalkEngine(graph, make_workload(pname),
                             EngineConfig(method=method))
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            build.reset_launches()
            t0 = time.perf_counter()
            res = eng.run(starts, num_steps=steps)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = {k: n for k, n in build.LAUNCHES.items() if n}
            split = ", ".join(f"{k} {v:.3f} s"
                              for k, v in res.seconds.items())
            log(f"baselines [{pname}/{method}]: {starts.size} queries x "
                f"{steps} steps in {dt:.2f} s, {res.live_steps} live "
                f"walker-steps, {res.live_steps / dt:.4g} walker-steps/s; "
                f"peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                f"launches {counts}; run() phases (host clock): {split}")
            for name in BASELINE_NEEDS.get(method, ()):
                if not counts.get(name):
                    fail(f"baselines [{pname}/{method}] never launched "
                         f"{name}")
            check_paths(graph, res.paths)
            if method == "rjs_maxreduce":
                launches["row_max", pname] = counts["row_max"]
                launches["its_row", pname, "fallback"] = counts.get(
                    "its_row", 0)
            elif method != "adaptive":
                name = BASELINE_NEEDS[method][0]
                launches[name, pname] = counts[name]
            del eng, res
    log(f"baselines: every run emitted only edges; phase 4d in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, starts


def baseline_lanes(graph, pname: str, starts, steps_before: int):
    """The live lanes of the phase-4d queries of ``pname`` after
    ``steps_before`` steps under ``its``: (engine, cur, prev, step, keys,
    program state)."""
    import torch
    from repro_torch.core import EngineConfig, WalkEngine
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.core.runtime import EpochScheduler
    from repro_torch.kernels.prng import key_data
    from repro_torch.walks import make_workload

    eng = WalkEngine(graph, make_workload(pname), EngineConfig(method="its"))
    Q = starts.size
    sched = EpochScheduler(eng, num_steps=BASELINE_STEPS,
                           key=key_data(eng.config.seed), slots=Q,
                           epoch_len=steps_before, capacity=Q)
    sched.admit(torch.arange(Q).numpy(), starts)
    sched.run_epoch()
    s = sched.state
    live = s.alive & (s.step < BASELINE_STEPS) & (degrees_of(graph, s.cur)
                                                   > 0)
    cur, prev, step, idx, ws = lanes_of(s, live)
    return eng, cur, prev, step, s.stream_keys()[idx].contiguous(), ws


def baseline_work(graph, program, cur, prev, name: str):
    """(bytes, integer-ALU, instructions) the kernel ``name`` must spend on
    these lanes: each lane's row of indices, h (weighted programs) and
    labels (MetaPath) read once, in whole 32 B sectors (a row starts
    anywhere); for the dist tests (Node2Vec, 2nd-order PageRank) the
    previous node's row read once in sectors, or one 32 B sector a
    neighbour's probe where the lane's own row is shorter; the node
    records of cur and prev (a sector each); the lane's inputs (cur, prev,
    step and, but for K12, its key) and its output; for K10 one Threefry
    and uniform per neighbour."""
    import torch
    from repro_torch.core.ctxutil import degrees_of

    in_sectors = lambda d: torch.ceil(d * 4.0 / SECTOR_BYTES) * SECTOR_BYTES
    d = degrees_of(graph, cur).double()
    arrays = 1 + int(program.weighted) + int(program.needs_labels)
    n = cur.shape[0]
    per_lane = (24.0 + 4.0 if name == "row_max" else 40.0 + 8.0) \
        + 2 * SECTOR_BYTES
    nbytes = float(in_sectors(d).sum()) * arrays + n * per_lane
    if program.needs_dist:
        d_prev = degrees_of(graph, prev).double()
        nbytes += float(torch.minimum(in_sectors(d_prev),
                                      d * SECTOR_BYTES).sum())
    edges = float(d.sum())
    if name == "rvs_prefix_row":
        return (nbytes, edges * (THREEFRY_ALU + UNIFORM_ALU),
                edges * (THREEFRY_INSTR + UNIFORM_INSTR))
    return nbytes, 0.0, 0.0


def baseline_plain_lanes(cur, d):
    """(lanes of K9, K10 and K12's plain check, lanes of ALS's): see
    ``BASELINE_PLAIN_LANES``."""
    import numpy as np
    import torch

    chk = hub_and_random_walkers(cur, d, BASELINE_PLAIN_LANES,
                                 BASELINE_PLAIN_SEED)
    rng = np.random.default_rng(BASELINE_PLAIN_SEED)
    more = torch.from_numpy(rng.choice(
        cur.numel(), min(BASELINE_ALS_PLAIN_LANES - 1, cur.numel()),
        replace=False)).to(cur.device)
    return chk, torch.unique(torch.cat([d.argmax().view(1), more]))


def plain_in_chunks(plain_fn, args, chk, pad: int, ws):
    """(result on the lanes ``chk`` of ``args``, ms on the card) of a plain
    version at ``pad``, ``BASELINE_PLAIN_CHUNK`` lanes a call."""
    import torch
    from repro_torch.core.types import wstate_rows

    graph, prog, params, *lanes = args
    outs, total = [], 0.0
    for a in range(0, chk.numel(), BASELINE_PLAIN_CHUNK):
        idx = chk[a:a + BASELINE_PLAIN_CHUNK]
        sub = tuple(x[idx].contiguous() for x in lanes)
        out, ms = cuda_once(lambda: plain_fn(graph, prog, params, *sub, pad,
                                             wstate=wstate_rows(ws, idx)))
        outs.append(out)
        total += ms
    return torch.cat(outs), total


def time_baselines(graph, starts, launches: dict, checks: dict,
                   reps: int) -> dict:
    """Phase 5, K9-K12: each kernel on the lanes of one phase-4d step (the
    queries' state after ``BASELINE_TIMED_STEP`` steps) under each Table 2
    program, with CUDA events, and held bitwise against its plain version
    at the engine's pad on a subset of those lanes
    (``baseline_plain_lanes``: at that pad every lane would take over
    10^10 entries of [n, pad] blocks)."""
    from repro_torch.core.ctxutil import degrees_of

    fns = baseline_fns()
    rows = {}
    for pname in TABLE2_PROGRAMS:
        eng, cur, prev, step, keys, ws = baseline_lanes(
            graph, pname, starts, BASELINE_TIMED_STEP)
        args = (graph, eng.workload, eng.sampler_ctx.params, cur, prev,
                step, keys)
        d = degrees_of(graph, cur)
        chk_rows, chk_als = baseline_plain_lanes(cur, d)
        for name, (kernel, plain_fn) in fns.items():
            run = lambda: kernel(*args, pad=eng.pad, wstate=ws)
            got = run()
            ms = cuda_ms(run, reps)
            chk = chk_als if name == "als_row" else chk_rows
            want, plain_ms = plain_in_chunks(plain_fn, args, chk, eng.pad, ws)
            bad = same_bits(got[chk], want)
            if bad:
                fail(f"{name} [{pname}] at phase-4d shapes: {bad} of "
                     f"{chk.numel()} checked lanes differ from the plain "
                     f"version at pad {eng.pad}")
            nbytes, alu, instr = baseline_work(graph, eng.workload, cur,
                                               prev, name)
            b, by = pipe_bound(nbytes, alu, instr)
            c = checks[name, pname]
            rows[name, pname] = dict(
                max_abs_err=float((got[chk].double() - want.double())
                                  .abs().max()),
                ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                lanes=cur.shape[0], step=BASELINE_TIMED_STEP,
                mismatches=bad, checked=int(chk.numel()),
                bound_note=(f"plain_ms on {chk.numel()} of the lanes at pad "
                            f"{eng.pad} (largest row {int(d[chk].max())}); "
                            f"phase 3f: plain {c['plain_ms']:.4f} ms, kernel"
                            f" {c['check_ms']:.4f} ms on {c['checked']} "
                            f"walkers at pad {BASELINE_CHECK_PAD}"))
            extra = ""
            if name == "its_row":
                rows[name, pname]["fallback_launches"] = launches.get(
                    ("its_row", pname, "fallback"), 0)
                extra = (f", {rows[name, pname]['fallback_launches']} more "
                         f"as rjs_maxreduce's fallback")
            log(f"time {name} [{pname}]: {cur.shape[0]} lanes at step "
                f"{BASELINE_TIMED_STEP}: {ms:.4f} ms (bound {b:.4f} ms by "
                f"{by}); plain {plain_ms:.2f} ms on {chk.numel()} of them "
                f"at pad {eng.pad} (largest row {int(d[chk].max())}), "
                f"{bad} differences{extra}")
        del eng
    return rows


# ----------------------- phase 4e: interleaved, scheduler, aligned draws
# the interleaved sampler at full width (deepwalk over PAIR_STEPS, against
# the staged ervs run of phase 4); the scheduler's surface on node2vec
# adaptive (queries killed every KILL_EVERY-th id at the second epoch);
# walk_batch fused and staged on deepwalk its_precomp; staged deepwalk
# its_precomp / alias_precomp under precomp_exec="aligned" (the flat
# engines' tables reused) against the flat runs
INTERLEAVED_PROGRAM = "deepwalk"
KILL_EVERY = 97
SCHEDULER_PROGRAM = "node2vec"
WALK_BATCH_KIND = "precomp_its"
ALIGNED_KINDS = {"precomp_its": ("its", "its_search_aligned"),
                 "precomp_alias": ("alias", "alias_pick_aligned")}
# phase 5: K1 interleaved against its plain version on the plain reservoir
# lanes of these programs' main-path state (a dist test, labels, a wstate
# read, a generated rule), every other lane hitting the carry; on
# deepwalk's interleaved main-path state, timed on every live walker and
# held on up to INTERLEAVED_PLAIN_LANES of them (one on each of the
# OPS_HUB_LANES largest rows, the rest drawn with INTERLEAVED_PLAIN_SEED)
INTERLEAVED_CHECK = ("node2vec", "metapath", "visited_avoiding",
                     GEN + QUICKSTART)
INTERLEAVED_PLAIN_LANES = 4096
INTERLEAVED_PLAIN_SEED = 18


def interleaved_main(graph, ervs_res, steps: int):
    """Phase 4e: deepwalk under ``interleaved`` at full width; its paths
    and telemetry must equal phase 4's staged ``ervs`` run (``ervs_res``),
    and it must launch K1's interleaved entry and never plain K1.
    Returns (the engine, its K1 interleaved launches)."""
    from repro_torch.core import EngineConfig, WalkEngine
    from repro_torch.walks import make_workload

    eng = WalkEngine(graph, make_workload(INTERLEAVED_PROGRAM),
                     EngineConfig(method="interleaved"))
    V, tile = graph.num_nodes, eng.config.tile
    log(f"main [{INTERLEAVED_PROGRAM}/interleaved]: the carry of {V} slots "
        f"x {tile} entries is {V * tile * 12 / 1e9:.2f} GB (nbr, h, label) "
        f"and {V * 8 / 1e6:.1f} MB of tags")
    counts, res = main_path(eng, f"{INTERLEAVED_PROGRAM}/interleaved", steps,
                            ("ervs_interleaved_select",))
    if counts["ervs_select"] or counts["ervs_jump_select"]:
        fail("interleaved launched plain K1")
    tele = ("frac_rjs", "frac_precomp", "frac_stale", "rjs_fallbacks",
            "live_steps")
    same = (res.paths == ervs_res.paths).all(axis=1)
    log(f"main [{INTERLEAVED_PROGRAM}/interleaved]: paths equal the staged "
        f"ervs run's on {same.mean():.6f} of queries; telemetry "
        f"{[getattr(res, f) for f in tele]} / "
        f"{[getattr(ervs_res, f) for f in tele]}")
    if not same.all() or any(getattr(res, f) != getattr(ervs_res, f)
                             for f in tele):
        fail("interleaved differs from the staged ervs run")
    return eng, counts["ervs_interleaved_select"]


def scheduler_main(eng, run_res, steps: int) -> None:
    """Phase 4e: ``eng.scheduler()`` over every query in ``run()``'s order
    (start-degree, one slot a query, the default epoch length), killing
    every ``KILL_EVERY``-th query id before the second epoch: the other
    paths must equal ``run_res`` (phase 4's ``run()``), the killed ones
    must be prefixes of it, and the epochs' ``walker_steps`` must sum to
    the scheduler's live total."""
    import numpy as np
    import torch

    V = eng.graph.num_nodes
    starts = np.arange(V)
    deg = eng.graph.degrees().cpu().numpy()
    queue = np.argsort(deg[starts], kind="stable")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = eng.scheduler(num_steps=steps, slots=V, capacity=V)
    s.admit(queue, starts[queue])
    killed, walker_steps, epochs = np.zeros(0, np.int64), 0, 0
    while s.busy:
        if epochs == 1:
            before = s.occupancy
            killed = s.kill(np.arange(0, V, KILL_EVERY))
            if s.occupancy != before - killed.size:
                fail("scheduler: kill freed the wrong slots")
        rep = s.run_epoch()
        walker_steps += rep.walker_steps
        epochs += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    keep = np.ones(V, bool)
    keep[killed] = False
    if not (s.paths[keep] == run_res.paths[keep]).all():
        fail("scheduler: an unkilled path differs from run()'s")
    p, r = s.paths[killed], run_res.paths[killed]
    valid = p >= 0
    if not ((p == r) | ~valid).all() or (np.diff(
            valid.astype(np.int8), axis=1) > 0).any() \
            or (valid.sum(axis=1) > 1 + s.T).any():
        fail("scheduler: a killed path is not a prefix of run()'s")
    if walker_steps != s.totals["live"] or s.occupancy or s.in_flight().size:
        fail(f"scheduler: walker_steps sum {walker_steps} against live "
             f"{s.totals['live']}, occupancy {s.occupancy} at the end")
    log(f"scheduler [{SCHEDULER_PROGRAM}/adaptive]: {V} queries in run()'s "
        f"order, {epochs} epochs of {s.T} steps in {dt:.2f} s; killed "
        f"{killed.size} of {len(range(0, V, KILL_EVERY))} ids (every "
        f"{KILL_EVERY}th; the rest had finished) before the second epoch: "
        f"their paths are prefixes of run()'s ({int(valid.sum())} entries), "
        f"the other {int(keep.sum())} equal run()'s; sum of walker_steps "
        f"{walker_steps} = the live total (run(): {run_res.live_steps})")


def walk_batch_check(fused_eng, staged_eng, steps: int, res) -> None:
    """Phase 4e: ``walk_batch`` of every node, fused and staged: the same
    paths and per-step counters, and the paths of phase 4's ``run()``
    (``res``: query i starts at node i, as walker i does)."""
    import numpy as np
    import torch
    from repro_torch.kernels.prng import key_data

    V = fused_eng.graph.num_nodes
    out = {}
    for eng in (fused_eng, staged_eng):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[eng.step_exec_resolved] = eng.walk_batch(
            np.arange(V), key_data(eng.config.seed), steps)
        torch.cuda.synchronize()
        log(f"walk_batch [deepwalk/{eng.config.method}, "
            f"{eng.step_exec_resolved}]: {V} walkers x {steps} steps in "
            f"{time.perf_counter() - t0:.2f} s")
    (pf, sf), (ps, ss) = out["fused"], out["staged"]
    same_stats = all(torch.equal(getattr(sf, f), getattr(ss, f))
                     for f in ("live", "rjs_served", "fallbacks",
                               "precomp_served", "stale_served"))
    if not torch.equal(pf, ps) or not same_stats:
        fail("walk_batch: fused differs from staged")
    if not np.array_equal(pf.cpu().numpy(), res.paths[:, 1:]):
        fail("walk_batch: paths differ from run()'s")
    log(f"walk_batch [deepwalk/{fused_eng.config.method}]: fused equals "
        f"staged (paths and per-step counters, {int(sf.live.sum())} live "
        f"steps) and run()'s paths")


def aligned_main(graph, pname: str, kind: str, flat_eng, flat_res,
                 steps: int, reps: int):
    """Phase 4e: a staged engine under ``precomp_exec="aligned"`` that
    reuses ``flat_eng``'s tables (its setter's path lays out the aligned
    streams); its paths and telemetry must equal the flat staged run
    (``flat_res``) and it must launch the aligned entry.  Then the entry
    is timed and held bitwise against its plain version on the engine's
    lanes after ``MID_STEP`` steps.  Returns (launches, the row)."""
    import torch
    from repro_torch.core import EngineConfig, WalkEngine
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.kernels import build, ops, ref
    from repro_torch.walks import make_workload

    draw, name = ALIGNED_KINDS[kind]
    t0 = time.perf_counter()
    eng = WalkEngine(graph, make_workload(pname), EngineConfig(
        method=flat_eng.config.method, step_exec="staged",
        precomp_exec="aligned"), precomp=flat_eng.precomp)
    torch.cuda.synchronize()
    log(f"engine {pname}/{eng.config.method} (staged, aligned draws): "
        f"{time.perf_counter() - t0:.1f} s with the flat engine's tables "
        f"and the aligned streams laid out")
    counts, res = main_path(eng, f"{pname}/{eng.config.method}/aligned",
                            steps, (name,))
    tele = ("frac_rjs", "frac_precomp", "frac_stale", "rjs_fallbacks",
            "live_steps")
    if not (res.paths == flat_res.paths).all() or any(
            getattr(res, f) != getattr(flat_res, f) for f in tele):
        fail(f"{pname}/{eng.config.method}: aligned draws differ from flat")
    log(f"main [{pname}/{eng.config.method}]: aligned draws equal the flat "
        f"staged run, paths and telemetry")
    t = eng.precomp
    state = mid_walk_state(eng, MID_STEP.get(pname, 8))
    keys = state.stream_keys()
    live = (state.alive & (state.step < WALK_STEPS)
            & (degrees_of(eng.graph, state.cur) > 0) & t.row_valid(state.cur))
    idx = live.nonzero().squeeze(1)
    cur = state.cur[idx]
    r0, tot = t.arow0[cur].contiguous(), t.total[cur].contiguous()
    dg = degrees_of(eng.graph, cur).to(torch.int32)
    seeds = keys[idx].contiguous()
    if draw == "its":
        streams = (t.cdf2d,)
        run = lambda: ops.its_search(t.cdf2d, r0, dg, tot, seeds)
        plain = lambda: ref.its_search_ref(t.cdf2d, r0, dg, tot, seeds)
    else:
        streams = (t.prob2d, t.alias2d)
        run = lambda: ops.alias_pick(t.prob2d, t.alias2d, r0, dg, tot, seeds)
        plain = lambda: ref.alias_pick_ref(t.prob2d, t.alias2d, r0, dg, tot,
                                           seeds)
    got = run()
    want, plain_ms = cuda_once(plain)
    if not torch.equal(got, want):
        fail(f"{name} [{pname}] at main-path shapes: differs from its plain "
             f"version on {int((got != want).sum())} of {idx.numel()} lanes")
    ms, cold = cuda_ms(run, reps), cold_ms(run, reps)
    drawn = aligned_draw_work(draw, streams, r0, dg, tot, seeds)
    b_ms, b_by = pipe_bound(*drawn.work)
    row = dict(lanes=int(idx.numel()), step=MID_STEP.get(pname, 8), ms=ms,
               cold_ms=cold, plain_ms=plain_ms, max_abs_err=0, mismatches=0,
               bound_ms=b_ms, bound_by=b_by, checked=int(idx.numel()),
               bound_note=draw_note(draw, "aligned"))
    log(f"time {name} [{pname}]: {idx.numel()} lanes of the engine at step "
        f"{row['step']}, kernel {ms:.4f} ms (cold {cold:.4f} ms), plain "
        f"{plain_ms:.4f} ms (on every lane, bitwise equal), bound "
        f"{b_ms:.4f} ms ({b_by}), {drawn.sectors / idx.numel():.4f} "
        f"sectors a walker")
    del state, eng
    build.reset_launches()
    return counts[name], row


def interleaved_lanes(graph, prog, cur, tile: int):
    """A carry over the walkers at ``cur`` (slot i = walker i) one step
    behind: every other walker's tag is its node with the node's first
    tile (a hit), the others' is the next node (a miss)."""
    import torch
    from repro_torch.core import ervs as ervs_mod
    from repro_torch.core.samplers import PrefetchTile

    n, dev = cur.numel(), cur.device
    carry = PrefetchTile(
        node=torch.empty(n, dtype=torch.int64, device=dev),
        nbr=torch.empty((n, tile), dtype=torch.int32, device=dev),
        h=torch.empty((n, tile), dtype=torch.float32, device=dev),
        label=torch.empty((n, tile), dtype=torch.int32, device=dev))
    hit = torch.arange(n, device=dev) % 2 == 0
    tag = torch.where(hit, cur, (cur + 1) % graph.num_nodes)
    ervs_mod.fill_tile0(carry, graph, prog, torch.arange(n, device=dev), tag,
                        tile)
    return carry


def copy_carry(c):
    from repro_torch.core.samplers import PrefetchTile

    return PrefetchTile(node=c.node.clone(), nbr=c.nbr.clone(),
                        h=c.h.clone(), label=c.label.clone())


def restore_carry(dst, src) -> None:
    for f in ("node", "nbr", "h", "label"):
        getattr(dst, f).copy_(getattr(src, f))


def carry_rows_differ(graph, prog, carry, slots, chosen, tile: int) -> int:
    """Carry rows ``slots`` whose tag is not ``chosen`` or whose first
    ``min(deg, tile)`` entries differ from the chosen node's first tile as
    the plain version fills it (offsets past that are unspecified on the
    card), in blocks of 2^16 rows."""
    import torch
    from repro_torch.core import ervs as ervs_mod

    bad = 0
    for part in torch.arange(slots.numel(), device=slots.device).split(
            1 << 16):
        rows, node = slots[part], chosen[part]
        nbr, h, label, mask = ervs_mod.tile0_payload(graph, prog, node, tile)
        wrong = carry.node[rows] != node
        for leaf, want in ((carry.nbr, nbr), (carry.h, h),
                           (carry.label, label)):
            row = leaf[rows]
            wrong |= (mask & (row != want.to(row.dtype))).any(dim=1)
        bad += int(wrong.sum())
    return bad


def timed_with_carry(launch, carry, saved, reps: int):
    """(result, mean ms) of ``launch()`` over ``reps`` runs after one
    warm-up run, ``carry`` restored from ``saved`` before each (outside
    the CUDA events around the launch): K1 interleaved rewrites it."""
    import torch

    marks, out = [], None
    for _ in range(reps + 1):
        restore_carry(carry, saved)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return out, sum(s.elapsed_time(e) for s, e in marks[1:]) / reps


def interleaved_work(g, prev, d, nxt, pname: str, weighted: bool,
                     needs_labels: bool, ring: float, tile: int):
    """(bytes, integer-ALU instructions, instructions) of K1's interleaved
    entry: plain K1's work (``plain_scan_work``: tile 0's entries are read
    from the carry on a hit, the same bytes as from the row) and per
    walker its slot, its tag read and written (24 B) and the chosen
    node's first ``min(deg, tile)`` entries read from the graph (the
    neighbour, h when weighted, the label when the program reads labels)
    and written into the carry (12 B an entry)."""
    import torch
    from repro_torch.core.ctxutil import degrees_of

    nbytes, alu, instr = plain_scan_work(g, prev, d, pname, weighted, ring,
                                         tile)
    copied = float(torch.clamp(degrees_of(g, nxt), max=tile).sum())
    per_entry = (4.0 + (4.0 if weighted else 0.0)
                 + (4.0 if needs_labels else 0.0) + 12.0)
    return nbytes + 24.0 * d.numel() + copied * per_entry, alu, instr


def interleaved_note(tile: int) -> str:
    return (f"plain K1's count (tile 0's entries from the carry on a hit, "
            f"the same bytes) and per walker its slot and tag (24 B) and "
            f"the chosen node's first min(deg, {tile}) entries read from "
            f"the graph and written into the carry (12 B an entry); "
            + pipe_note(4.0))


def check_interleaved_lanes(adaptive: dict, gen_adaptive: dict,
                            reps: int) -> None:
    """Phase 5: K1's interleaved entry against its plain version
    (``core.ervs.interleaved_step`` on the card) on the plain reservoir
    lanes of each program of ``INTERLEAVED_CHECK`` after ``MID_STEP``
    steps, every other lane hitting the carry: the same choices (near-ties
    excepted, of which ``SCAN_NEAR_TIES`` are allowed) and the same carry
    rows below ``min(deg, tile)``; and both against plain K1
    (``ervs_select``), bitwise."""
    import torch
    from repro_torch.core import ervs as ervs_mod
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.kernels.ervs import (ervs_interleaved_select,
                                          ervs_select)

    for pname in INTERLEAVED_CHECK:
        eng = (gen_adaptive if pname.startswith(GEN) else adaptive)[pname]
        g, prog, params = eng.graph, eng.workload, eng.sampler_ctx.params
        tile = eng.config.tile
        split = main_path_split(eng, mid_step(pname))
        cur, prev, step, idx, ws = lanes_of(split.state, split.lo)
        keys = split.keys[idx].contiguous()
        n = idx.numel()
        slots = torch.arange(n, device=cur.device)
        carry = interleaved_lanes(g, prog, cur, tile)
        saved = copy_carry(carry)
        got, ms = timed_with_carry(lambda: ervs_interleaved_select(
            g, prog, params, cur, prev, step, keys, carry, slots, tile=tile,
            wstate=ws), carry, saved, reps)
        k1 = ervs_select(g, prog, params, cur, prev, step, keys, tile=tile,
                         wstate=ws)
        plain_carry = copy_carry(saved)
        want, plain_ms = cuda_once(lambda: ervs_mod.interleaved_step(
            g, prog, params, cur, prev, step, keys, plain_carry, slots,
            tile=tile, wstate=ws))
        n_bad, unexplained = k1_mismatches(g, prog, params, cur, prev, keys,
                                           got, want, tile, False, step, ws)
        rows_bad = carry_rows_differ(g, prog, carry, slots, got, tile)
        hits = int((saved.node == cur).sum())
        if not torch.equal(got, k1):
            fail(f"ervs_interleaved_select [{pname}]: differs from plain K1 "
                 f"on {int((got != k1).sum())} of {n} lanes")
        if unexplained or n_bad > SCAN_NEAR_TIES or rows_bad:
            fail(f"ervs_interleaved_select [{pname}]: {n_bad} differences "
                 f"from the plain version ({unexplained} not near-ties), "
                 f"{rows_bad} carry rows differ")
        k1_ms = cuda_ms(lambda: ervs_select(g, prog, params, cur, prev,
                                            step, keys, tile=tile,
                                            wstate=ws), reps)
        edges = float(degrees_of(g, cur).sum())
        log(f"check ervs_interleaved_select [{pname}]: {n} lanes at step "
            f"{mid_step(pname)} ({hits} hit the carry), {edges:.0f} edges: "
            f"0 differences from the plain version and from plain K1, carry "
            f"rows equal below min(deg, {tile}); kernel {ms:.4f} ms, plain "
            f"K1 {k1_ms:.4f} ms, plain {plain_ms:.4f} ms")
        del carry, saved, plain_carry, split


def time_interleaved_main(eng, reps: int) -> dict:
    """Phase 5: K1's interleaved entry on deepwalk's interleaved main-path
    state after ``MID_STEP`` steps (its own carry), timed on every live
    walker with the carry restored before each launch, held against its
    plain version on up to ``INTERLEAVED_PLAIN_LANES`` of them (hubs and
    random) and against plain K1 on all; its row."""
    import torch
    from repro_torch.core import ervs as ervs_mod
    from repro_torch.core.ctxutil import degrees_of
    from repro_torch.core.samplers import PrefetchTile
    from repro_torch.kernels.ervs import (ervs_interleaved_select,
                                          ervs_select, kernel_rule)

    g, prog, params = eng.graph, eng.workload, eng.sampler_ctx.params
    tile = eng.config.tile
    pname = INTERLEAVED_PROGRAM
    step_at = mid_step(pname)
    state = mid_walk_state(eng, step_at, PAIR_STEPS)
    live = (state.alive & (state.step < PAIR_STEPS)
            & (degrees_of(g, state.cur) > 0))
    cur, prev, step, idx, ws = lanes_of(state, live)
    keys = state.stream_keys()[idx].contiguous()
    carry = state.carry
    saved = copy_carry(carry)
    got, ms = timed_with_carry(lambda: ervs_interleaved_select(
        g, prog, params, cur, prev, step, keys, carry, idx, tile=tile,
        wstate=ws), carry, saved, reps)
    k1 = ervs_select(g, prog, params, cur, prev, step, keys, tile=tile,
                     wstate=ws)
    k1_ms = cuda_ms(lambda: ervs_select(g, prog, params, cur, prev, step,
                                        keys, tile=tile, wstate=ws), reps)
    if not torch.equal(got, k1):
        fail(f"ervs_interleaved_select [{pname}] at main-path shapes: "
             f"differs from plain K1 on {int((got != k1).sum())} lanes")
    d = degrees_of(g, cur).to(torch.float64)
    chk = hub_and_random_walkers(cur, d, INTERLEAVED_PLAIN_LANES,
                                 INTERLEAVED_PLAIN_SEED)
    slots = idx[chk]
    sub = PrefetchTile(node=saved.node[slots], nbr=saved.nbr[slots],
                       h=saved.h[slots], label=saved.label[slots])
    c_cur, c_prev, c_step, c_keys = (x[chk].contiguous()
                                     for x in (cur, prev, step, keys))
    want, plain_ms = cuda_once(lambda: ervs_mod.interleaved_step(
        g, prog, params, c_cur, c_prev, c_step, c_keys, sub,
        torch.arange(chk.numel(), device=chk.device), tile=tile))
    n_bad, unexplained = k1_mismatches(g, prog, params, c_cur, c_prev,
                                       c_keys, got[chk], want, tile, False,
                                       c_step)
    rows_bad = carry_rows_differ(g, prog, carry, slots, got[chk], tile)
    if unexplained or n_bad > SCAN_NEAR_TIES or rows_bad:
        fail(f"ervs_interleaved_select [{pname}] at main-path shapes: "
             f"{n_bad} differences from the plain version ({unexplained} "
             f"not near-ties), {rows_bad} carry rows differ")
    hits = int((saved.node[idx] == cur).sum())
    weighted = kernel_rule(prog, params).weighted
    b_ms, b_by = pipe_bound(*interleaved_work(
        g, prev, d, got, pname, weighted, prog.needs_labels, 0.0, tile))
    log(f"time ervs_interleaved_select [{pname}]: {idx.numel()} lanes at "
        f"step {step_at} ({hits} hit the carry), kernel {ms:.4f} ms (carry "
        f"restored before each launch), plain K1 on the same lanes "
        f"{k1_ms:.4f} ms, plain {plain_ms:.4f} ms (on {chk.numel()} lanes), "
        f"bound {b_ms:.4f} ms ({b_by}); 0 differences from plain K1, "
        f"{n_bad} from the plain version, carry rows equal")
    row = dict(lanes=int(idx.numel()), step=step_at, ms=ms,
               plain_ms=plain_ms, max_abs_err=0, mismatches=n_bad,
               bound_ms=b_ms, bound_by=b_by, checked=int(chk.numel()),
               hits=hits, k1_ms=k1_ms, bound_note=interleaved_note(tile))
    del state, carry, saved, sub
    return row


SOURCES = {
    "ervs_block_select": ("src/repro_torch/kernels/csrc/ervs_block.cu",
                          "src/repro/kernels/ervs_kernel.py:109"),
    "erjs_block_select": ("src/repro_torch/kernels/csrc/erjs_block.cu",
                          "src/repro/kernels/erjs_kernel.py:73"),
    "its_search_aligned": ("src/repro_torch/kernels/csrc/its.cu",
                           "src/repro/kernels/precomp_kernel.py:95"),
    "alias_pick_aligned": ("src/repro_torch/kernels/csrc/alias.cu",
                           "src/repro/kernels/precomp_kernel.py:154"),
    "ervs_select": ("src/repro_torch/kernels/csrc/ervs.cu",
                    "src/repro/kernels/megastep_kernel.py:185"),
    "ervs_jump_select": ("src/repro_torch/kernels/csrc/ervs.cu",
                         "src/repro/kernels/megastep_kernel.py:185"),
    # no TPU kernel: the reference's interleaved sampler is jnp
    "ervs_interleaved_select": ("src/repro_torch/kernels/csrc/ervs.cu",
                                "src/repro/core/samplers.py:620"),
    "erjs_select": ("src/repro_torch/kernels/csrc/erjs.cu",
                    "src/repro/kernels/megastep_kernel.py:225"),
    "its_search": ("src/repro_torch/kernels/csrc/its.cu",
                   "src/repro/kernels/precomp_kernel.py:95"),
    "alias_pick": ("src/repro_torch/kernels/csrc/alias.cu",
                   "src/repro/kernels/precomp_kernel.py:154"),
    **{f"fused_epoch_{kind}": ("src/repro_torch/kernels/csrc/megastep.cu",
                               "src/repro/kernels/megastep_kernel.py:423")
       for kind in FUSED_METHODS},
    "token_sample": ("src/repro_torch/kernels/csrc/token_sample.cu",
                     "src/repro/kernels/token_sampler.py:68"),
    # no TPU kernel: the reference's baselines are jnp step functions
    "its_row": ("src/repro_torch/kernels/csrc/baselines.cu",
                "src/repro/core/baselines.py:51"),
    "rvs_prefix_row": ("src/repro_torch/kernels/csrc/baselines.cu",
                       "src/repro/core/baselines.py:69"),
    "row_max": ("src/repro_torch/kernels/csrc/baselines.cu",
                "src/repro/core/baselines.py:89"),
    "als_row": ("src/repro_torch/kernels/csrc/baselines.cu",
                "src/repro/core/baselines.py:108"),
}
# what K4 replaces when it runs a hooked program: the hook branch
HOOK_BRANCH = "src/repro/kernels/megastep_kernel.py:347"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=LJ_NODES)
    ap.add_argument("--steps", type=int, default=WALK_STEPS)
    ap.add_argument("--reps", type=int, default=5,
                    help="timed runs per kernel in phase 5")
    ap.add_argument("--baseline-queries", type=int, default=BASELINE_QUERIES,
                    help="start nodes of phase 4d's runs")
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
    from repro_torch.walks import make_workload

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    # 1. build, then the generated rules' instances
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(build.SOURCES)} "
        f"sources")
    progs = gen_programs()
    build_generated(progs)
    for f in sorted(build.build_dir().glob("*.log")):
        # per kernel instance and non-inlined function (its mangled name
        # carries the template arguments, e.g. fused_epoch_lanesILi2ELi1E
        # = KIND 2, HOOK 1; scan_row_callILi0ELb1E = rule class 0, weighted):
        # registers, and the spill line of its function properties
        for name, what in ptxas_lines(f.read_text()):
            log(f"ptxas {f.stem.rsplit('-', 1)[0]} {name[:56]}: {what}")
    # the plain scan's edge loops as built, by pipe: K4's reservoir
    # instance (deepwalk runs scan_row<H, weighted>)
    for stem, kernel in SCAN_KERNELS:
        for label, c in scan_sass(build._lib_path(f"{stem}.cu"),
                                  kernel).items():
            log(f"sass {kernel} {label}: edge loop {c}")
    for stem, kernel in TRIAL_KERNELS:
        for i, c in enumerate(trial_sass(build._lib_path(f"{stem}.cu"),
                                         kernel)):
            log(f"sass {kernel}: trial loop {i} {c}")
    for stem, kernel in DRAW_KERNELS:
        for label, c in draw_sass(build._lib_path(f"{stem}.cu"),
                                  kernel).items():
            log(f"sass {kernel}: {label} {c}")

    # 1b. LM serving at full width
    lm_rows = lm_phase(torch.device("cuda"), LM_TIMING_REPS)

    # 2. graph and engines
    t0 = time.perf_counter()
    graph = power_law_graph(args.nodes, LJ_AVG_DEGREE,
                            weight_dist="uniform", seed=0).to("cuda")
    log(f"graph: V={graph.num_nodes} E={graph.num_edges} "
        f"maxdeg={graph.max_degree()} built in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = EngineConfig(method="adaptive", jump_threshold=JUMP_THRESHOLD)
    adaptive = {}
    for pname in ADAPTIVE_NEEDS:
        t0 = time.perf_counter()
        adaptive[pname] = WalkEngine(graph, make_workload(pname), cfg)
        torch.cuda.synchronize()
        log(f"engine {pname}/adaptive: {time.perf_counter() - t0:.1f} s"
            f"{' (ITS tables)' if adaptive[pname].precomp else ''}")
    fused = {}
    for pname in FUSED_PROGRAMS:
        fused[pname] = {}
        for kind, method in FUSED_METHODS.items():
            t0 = time.perf_counter()
            fused[pname][kind] = WalkEngine(
                graph, make_workload(pname),
                EngineConfig(method=method, step_exec="fused"))
            torch.cuda.synchronize()
            log(f"engine {pname}/{method} (fused): "
                f"{time.perf_counter() - t0:.1f} s, step_exec resolved "
                f"{fused[pname][kind].step_exec_resolved!r}")

    # phase 4b's engines: the stripped twins and the quickstart program
    # (and 4c's gen:visited_avoiding)
    gen_adaptive = {GEN + n: WalkEngine(graph, progs[GEN + n], cfg)
                    for n in COMPILER_ADAPTIVE + STATE_ADAPTIVE
                    + (QUICKSTART,)}
    gen_fused = {kind: WalkEngine(graph, progs[GEN + "deepwalk"],
                                  EngineConfig(method=FUSED_METHODS[kind],
                                               step_exec="fused"))
                 for kind in COMPILER_FUSED}
    torch.cuda.synchronize()
    log(f"engines of phase 4b: {', '.join(gen_adaptive)} adaptive, "
        f"{GEN}deepwalk fused in {', '.join(COMPILER_FUSED)}: flags "
        f"{[e.compiled.flag for e in gen_adaptive.values()]}")
    # phase 4c's fused engines: generated hooks in every regime, and the
    # user programs under ervs
    hook_fused = {kind: WalkEngine(graph, progs[GEN_HOOKS + HOOKED_FUSED],
                                   EngineConfig(method=method,
                                                step_exec="fused"))
                  for kind, method in FUSED_METHODS.items()}
    user_fused = {GEN + n: WalkEngine(graph, progs[GEN + n], EngineConfig(
        method="ervs", step_exec="fused")) for n in USER_FUSED}
    torch.cuda.synchronize()
    log(f"engines of phase 4c: {GEN_HOOKS}{HOOKED_FUSED} fused in "
        f"{', '.join(hook_fused)}, {', '.join(user_fused)} fused in ervs: "
        f"step_exec resolved "
        f"{[e.step_exec_resolved for e in hook_fused.values()]}, "
        f"{[e.step_exec_resolved for e in user_fused.values()]}")

    # the table layouts the CUDA draws read (each engine builds its own in
    # its set-up), built again on a copy of the deepwalk alias engine's
    # tables to time them
    fresh = dataclasses.replace(fused["deepwalk"]["precomp_alias"].precomp)
    t0 = time.perf_counter()
    fence = fresh.its_fence
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pair = fresh.alias_pair
    torch.cuda.synchronize()
    log(f"draw layouts: fence table {fence.numel()} floats "
        f"({fence.numel() * 4 / 1e6:.1f} MB) in {t1 - t0:.4f} s, pair table "
        f"[{pair.shape[0]}, 2] int32 ({pair.numel() * 4 / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t1:.4f} s")
    del fresh, fence, pair

    # 2b. the standalone ops on the aligned stream of the whole graph
    ops_rows, ops_launches = ops_phase(
        graph, adaptive["deepwalk"], fused["deepwalk"]["precomp_alias"]
        .precomp, args.reps)

    # 3. kernels against their plain versions
    check_kernels(graph, adaptive["node2vec"], adaptive["deepwalk"], seed=11)
    log("check: erjs_select and its_search bitwise equal to their plain "
        "versions")
    check_rules(adaptive, seed=13)
    for pname in FUSED_PROGRAMS:
        check_fused(graph, fused[pname], pname, seed=12)
    check_generated(graph, adaptive, gen_adaptive, fused, gen_fused,
                    seed=13)
    # 3e. state and hooks: K4's HOOK_GENERATED instances against their
    # plain versions and the hand hook rule's, and K4's reservoir under
    # the user programs' generated weights and hooks
    check_fused(graph, hook_fused, GEN_HOOKS + HOOKED_FUSED, seed=12,
                hand=fused[HOOKED_FUSED])
    for label, eng in user_fused.items():
        check_fused(graph, {"reservoir": eng}, label, seed=12)
    check_small_engine()
    # 3f. the baselines' row kernels K9-K12
    baseline_checks = check_baselines(graph, adaptive, seed=17)

    # 4. the main path, one adaptive run per program, then each fused
    # method against staged
    launches, launched, declared = {}, {}, {}
    for pname, eng in adaptive.items():
        counts, res = main_path(eng, pname, min(args.steps, MAIN_STEPS.get(
            pname, WALK_STEPS)), ADAPTIVE_NEEDS[pname])
        if pname in COMPILER_ADAPTIVE + STATE_ADAPTIVE:
            declared[pname] = res  # phase 4b's twins must equal it
        del res
        launched[pname] = [name for name, n in counts.items() if n]
        for name in launched[pname]:
            launches[name, pname] = counts[name]
    # the Fig. 13 selector baselines on node2vec: eRJS or plain eRVS per
    # lane, by a coin flip or by degree (K2 and K1's plain instance)
    for method in SELECTOR_METHODS:
        eng = WalkEngine(graph, make_workload("node2vec"),
                         EngineConfig(method=method))
        main_path(eng, f"node2vec/{method}", min(
            args.steps, SELECTOR_STEPS[method]),
            ("ervs_select", "erjs_select"))
        del eng
    slice_rows, ervs_res = {}, None
    for pname in FUSED_PROGRAMS:
        steps = min(args.steps, PAIR_STEPS)
        for kind, method in FUSED_METHODS.items():
            t0 = time.perf_counter()
            staged = WalkEngine(graph, make_workload(pname), EngineConfig(
                method=method, step_exec="staged"),
                precomp=fused[pname][kind].precomp)
            torch.cuda.synchronize()
            log(f"engine {pname}/{method} (staged): "
                f"{time.perf_counter() - t0:.1f} s (the fused engine's "
                f"tables)")
            n, staged_counts, res, end = fused_main_path(
                fused[pname][kind], staged, pname, steps)
            if pname == INTERLEAVED_PROGRAM and kind == "reservoir":
                ervs_res = res  # phase 4e's interleaved run must equal it
            if pname == "deepwalk" and kind == WALK_BATCH_KIND:
                walk_batch_check(fused[pname][kind], staged, steps, res)
            if pname == "deepwalk" and kind in ALIGNED_KINDS:
                name = ALIGNED_KINDS[kind][1]
                launches[name, pname], slice_rows[name, pname] = \
                    aligned_main(graph, pname, kind, staged, res, steps,
                                 args.reps)
            if pname == "deepwalk" and kind in COMPILER_FUSED:
                declared[kind] = res
            if pname == HOOKED_FUSED:
                declared[pname, kind] = (res, end)  # phase 4c's must equal
            del end
            del res
            launches[f"fused_epoch_{kind}", pname] = n
            if kind == "precomp_alias":
                launches["alias_pick", pname] = staged_counts["alias_pick"]
            del staged

    # 4e. the interleaved sampler at full width against the staged ervs
    # run, then the scheduler's surface against node2vec's run()
    inter_eng, n = interleaved_main(graph, ervs_res,
                                    min(args.steps, PAIR_STEPS))
    launches["ervs_interleaved_select", INTERLEAVED_PROGRAM] = n
    del ervs_res
    scheduler_main(adaptive[SCHEDULER_PROGRAM], declared[SCHEDULER_PROGRAM],
                   min(args.steps, WALK_STEPS))

    # 4b. the compiler: stripped twins and the quickstart program
    gen_launches, gen_launched = compiler_main(args, declared, gen_adaptive,
                                               gen_fused)
    launches.update(gen_launches)
    # 4c. state and hooks: generated hooks against the hand hook rule's
    # runs, user programs fused against staged
    launches.update(hooks_main(args, declared, hook_fused, user_fused))
    del declared
    # 4d. the Table 2 baselines and adaptive on the same queries
    baseline_launches, baseline_q = baselines_main(
        graph, args.baseline_queries, min(args.steps, BASELINE_STEPS))

    # 5. K1 jump across tiles and K1 interleaved on four programs' lanes,
    # then kernel times at main-path shapes
    check_jump_tiles(adaptive, seed=16)
    check_interleaved_lanes(adaptive, gen_adaptive, args.reps)
    rows = time_kernels(adaptive, launched, args.reps)
    rows["ervs_interleaved_select", INTERLEAVED_PROGRAM] = \
        time_interleaved_main(inter_eng, args.reps)
    del inter_eng
    rows.update(slice_rows)
    for pname in FUSED_PROGRAMS:
        rows.update(time_fused(fused[pname], pname))
    rows.update(time_kernels(gen_adaptive, gen_launched, args.reps))
    rows.update(time_fused(gen_fused, GEN + "deepwalk"))
    rows.update(time_fused(hook_fused, GEN_HOOKS + HOOKED_FUSED))
    for label, eng in user_fused.items():
        rows.update(time_fused({"reservoir": eng}, label))
    rows.update(time_baselines(graph, baseline_q, baseline_launches,
                               baseline_checks, max(1, args.reps // 2)))
    launches.update({k: n for k, n in baseline_launches.items()
                     if len(k) == 2})
    hooked = {p for p, e in fused.items()
              if e["reservoir"].workload.has_hooks} | {
        GEN_HOOKS + HOOKED_FUSED} | set(user_fused)
    kernels = []
    for (name, pname), n in launches.items():
        if (name, pname) not in rows:
            fail(f"{name} [{pname}]: launched on the main path but not "
                 f"timed")
        r = rows[name, pname]
        src, replaces = SOURCES[name]
        if name.startswith("fused_epoch") and pname in hooked:
            replaces = HOOK_BRANCH
        kernels.append({
            "name": f"{name}/{pname}", "route": "cuda", "source": src,
            "rule": ("generated" if pname.startswith((GEN, GEN_HOOKS))
                     else "hand"),
            "replaces": replaces, "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "lanes": r["lanes"], "step": r["step"],
            "mismatches": r["mismatches"],
            **{k: r[k] for k in ("steps", "epoch16_ms", "epoch16_bound_ms",
                                 "cold_ms", "checked", "bound_note",
                                 "rejected", "pending", "fallbacks",
                                 "mean_used", "fallback_launches", "hits",
                                 "k1_ms")
               if k in r}})
    for (name, label), n in ops_launches.items():
        r = ops_rows[name, label]
        src, replaces = SOURCES[name]
        kernels.append({
            "name": f"{name}/{label}", "route": "cuda", "source": src,
            "replaces": replaces, "launches": n, "max_abs_err": 0,
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "lanes": r["lanes"],
            "checked": r["checked"], "mismatches": 0,
            **{k: r[k] for k in ("cold_ms", "bound_note", "table_ms",
                                 "peak_mib", "reads_per_walker",
                                 "sectors_per_walker", "gather_ms")
               if k in r}})
    for (name, label), r in lm_rows.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": f"{name}/{label}", "route": "cuda", "source": src,
            "replaces": replaces, "launches": r["launches"],
            "max_abs_err": 0, "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"],
            "bound_note": r["bound_note"],
            "lanes": r["lanes"], "vocab": r["vocab"], "mismatches": 0})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
