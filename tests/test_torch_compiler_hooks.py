"""Hooks through the compiler and the generated device rules, on the CPU.

* The repair: a hooked program resolves the step path the reference
  resolves under ``step_exec="fused"`` — the quickstart program under
  ``ervs`` / ``erjs`` / ``its_precomp``, ppr_nibble without its hook rule
  as with it — with no hand hook rule; ``fuse_report`` agrees in both
  packages.
* ``rulegen``'s lowered ``on_step`` / ``should_stop`` equal the programs'
  torch hooks bitwise (ppr_nibble, visited_avoiding at windows 16 and 5,
  the quickstart program, non_backtracking) on seeded transitions and
  states, ``should_stop`` on ``on_step``'s new state.
* ``run()`` fused (K4's plain version) equals the staged run on the CPU in
  paths, regime fractions and the scheduler's end state (every leaf):
  the quickstart program and non_backtracking under ``ervs``, ppr_nibble
  stripped of its hooks under the four fused methods.
* The header: ``generated_on_step`` computes every new value before it
  commits one, a vector leaf's slots are written by the ``writer`` lane;
  a hand weight rule beside generated hooks gets a header of its own.

K4's ``HOOK_GENERATED`` instances run only on the card
(``test_torch_compiler_card.py``, ``chip_smoke.py`` phase 4c).
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import drive, one_torch_thread, to_port_graph  # noqa: F401
from test_torch_compiler import _ref_quickstart
from test_torch_compiler_user import _nonbacktracking_programs
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.core import flexi_compiler as ref_fc
from repro.graphs import power_law_graph as ref_power_law
from repro.walks import make_workload as ref_make_workload
from repro_torch.core import EngineConfig, WalkEngine
from repro_torch.core import flexi_compiler as fc
from repro_torch.core.ctxutil import degrees_of, transition_ctx
from repro_torch.core.runtime import EpochScheduler
from repro_torch.kernels import megastep, rulegen
from repro_torch.kernels.prng import key_data
from repro_torch.kernels.rules import HOOK_GENERATED
from repro_torch.walks import make_workload
from repro_torch.walks.examples import (degree_damped, non_backtracking,
                                        stripped)

V, STEPS, BATCH, EPOCH, TILE = 300, 12, 128, 5, 32
FUSED_METHODS = ["ervs", "erjs", "its_precomp", "alias_precomp"]


@pytest.fixture(scope="module")
def graphs():
    g = ref_power_law(V, 8, seed=3)
    return g, to_port_graph(g)


def _no_hook_rule():
    return dataclasses.replace(make_workload("ppr_nibble"), hook_rule=None)


# (reference program, port program, methods) of the repair's rows
REPAIR = {
    "quickstart": (_ref_quickstart, degree_damped,
                   ("ervs", "erjs", "its_precomp")),
    "ppr_nibble_no_hook_rule": (lambda: ref_make_workload("ppr_nibble"),
                                _no_hook_rule,
                                ("ervs", "erjs", "its_precomp")),
    "non_backtracking": (lambda: _nonbacktracking_programs()[0],
                         non_backtracking, ("ervs", "erjs")),
}


@pytest.mark.parametrize("name", sorted(REPAIR))
def test_hooked_programs_resolve_the_reference_step_path(graphs, name):
    g, pg = graphs
    make_ref, make_port, methods = REPAIR[name]
    ref, port = make_ref(), make_port()
    want, got = ref_fc.fuse_report(ref), fc.fuse_report(port)
    for f in ("weight_fusable", "hooks_fusable", "bound_node_local",
              "fusable"):
        assert getattr(got, f) == getattr(want, f), f
    for method in methods:
        r = RefEngine(g, ref, RefConfig(method=method, step_exec="fused"))
        p = WalkEngine(pg, port, EngineConfig(method=method,
                                              step_exec="fused",
                                              device="cpu"))
        assert p.step_exec_resolved == r.step_exec_resolved, method
    if name == "quickstart":  # the reference fuses it where no bound is baked
        assert [WalkEngine(pg, port, EngineConfig(
            method=m, step_exec="fused", device="cpu")).step_exec_resolved
            for m in methods] == ["fused", "staged", "fused"]
    if name == "ppr_nibble_no_hook_rule":  # as with its hook rule
        for method in methods:
            assert WalkEngine(pg, make_workload("ppr_nibble"), EngineConfig(
                method=method, step_exec="fused",
                device="cpu")).step_exec_resolved == "fused"


HOOKED = {"ppr_nibble": lambda: make_workload("ppr_nibble"),
          "visited-16": lambda: make_workload("visited_avoiding"),
          "visited-5": lambda: make_workload("visited_avoiding", window=5),
          "quickstart": degree_damped,
          "non_backtracking": non_backtracking}


def _transitions(pg, prog, n, seed):
    """A transition ctx of n walkers (cur, prev, step, the node moved to)
    and seeded state."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.asarray(x, np.int64))
    cur = t(rng.integers(0, V, n))
    prev = t(rng.integers(-1, V, n))
    step = t(rng.integers(0, 80, n))
    nxt = t(rng.integers(0, V, n))
    tctx = transition_ctx(pg, cur, prev, step, nxt, degrees_of(pg, cur))
    leaves = []
    for leaf in prog.init_wstate_batch(torch.arange(n)):
        if leaf.dtype == torch.float32:  # masses about the stop line
            leaves.append(torch.from_numpy(
                rng.uniform(0.0, 0.6, tuple(leaf.shape)).astype(np.float32)))
        else:
            leaves.append(torch.from_numpy(rng.integers(
                -1, V, tuple(leaf.shape))).to(leaf.dtype))
    return tctx, tuple(leaves)


@pytest.mark.parametrize("name", sorted(HOOKED))
def test_lowered_hooks_equal_the_torch_hooks(graphs, name):
    _, pg = graphs
    prog = HOOKED[name]()
    p = prog.params()
    low = rulegen.lower_hooks(prog)
    tctx, ws = _transitions(pg, prog, 500, 7)
    new = ws
    if prog.on_step is not None:
        new = rulegen.evaluate(low.on_step, tctx, ws)
        want = prog.on_step(tctx, p, ws)
        for a, b in zip(new, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a, b.view(torch.int32)
                               if b.is_floating_point() else b)
    else:
        assert low.on_step is None
    if prog.should_stop is not None:
        stop = rulegen.evaluate(low.should_stop, tctx, new)
        want = prog.should_stop(tctx, p, new)
        assert torch.equal(stop, want) and 0 < int(want.sum()) < 500
    else:
        assert low.should_stop is None


def _end_state(eng, pg):
    return drive(EpochScheduler(eng, num_steps=STEPS, key=key_data(0),
                                slots=BATCH, epoch_len=EPOCH, capacity=V),
                 np.arange(V), np.diff(pg.indptr.numpy())).state


FUSED_CELLS = [("quickstart", "ervs"), ("non_backtracking", "ervs")] + [
    ("ppr_nibble_stripped", m) for m in FUSED_METHODS]
CELL_PROGRAMS = {"quickstart": degree_damped,
                 "non_backtracking": non_backtracking,
                 "ppr_nibble_stripped": lambda: stripped(
                     make_workload("ppr_nibble"), hooks=True)}


@pytest.mark.parametrize("name,method", FUSED_CELLS,
                         ids=[f"{n}-{m}" for n, m in FUSED_CELLS])
def test_fused_equals_staged_with_generated_hooks(graphs, name, method):
    _, pg = graphs
    prog = CELL_PROGRAMS[name]()
    runs = []
    for sx in ("fused", "staged"):
        eng = WalkEngine(pg, prog, EngineConfig(
            method=method, step_exec=sx, tile=TILE, device="cpu"))
        assert eng.step_exec_resolved == sx, eng.fuse.reasons
        runs.append((eng.run(np.arange(V), num_steps=STEPS, batch=BATCH,
                             epoch_len=EPOCH), _end_state(eng, pg)))
    (fused, f_end), (staged, s_end) = runs
    assert np.array_equal(fused.paths, staged.paths)
    for f in ("frac_rjs", "frac_precomp", "frac_stale", "rjs_fallbacks",
              "live_steps"):
        assert getattr(fused, f) == getattr(staged, f), f
    for f in ("cur", "prev", "step", "alive"):
        assert torch.equal(getattr(f_end, f), getattr(s_end, f)), f
    for a, b in zip(f_end.wstate, s_end.wstate):
        assert torch.equal(a, b)
    assert (fused.paths[:, 1:] >= 0).sum() == fused.live_steps


def test_hooks_header():
    prog = stripped(make_workload("visited_avoiding"), hooks=True)
    src = rulegen.generated_rule(prog, prog.params()).header
    assert "constexpr bool kGenHooks = true;" in src
    body = src[src.index("generated_on_step("):
               src.index("generated_should_stop(")]
    assert body.index("s.l0[15] = ") > body.rindex("const ")  # computed first
    assert "if (writer) {" in body
    src = rulegen.cuda_source(rulegen.lower(degree_damped()), "dd",
                              rulegen.lower_hooks(degree_damped()))
    assert "s.l0 = v" in src and "__fmul_rn(v0, v1)" in src
    assert "kGenHooksReadDegPrev = false" in src
    # no hooks: stubs; a hand weight rule beside generated hooks
    src = rulegen.cuda_source(rulegen.lower(make_workload("node2vec")))
    assert "kGenHooks = false" in src and "return false;" in src
    hand = dataclasses.replace(make_workload("ppr_nibble"), hook_rule=None)
    params = hand.params()
    hooks = megastep.kernel_hooks(hand, params)
    assert hooks.kind == HOOK_GENERATED and "return h;" in hooks.header
    assert megastep.kernel_hooks(hand, params) is hooks  # built once
