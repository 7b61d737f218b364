"""Generated device rules on the card (``cuda`` marker: skipped without
one; run on the chip with ``JAX_PLATFORMS=cpu PYTHONPATH=src python -m
pytest -q -m cuda tests/test_torch_compiler_card.py``).

* K1 (plain and jump), K2 and K4 under the generated rules of stripped
  node2vec, metapath and deepwalk choose bit for bit as under the hand
  rules, and K1 / K2 under the quickstart program's rule agree with
  their plain versions.
* The quickstart program runs adaptive on the card and launches K1 and
  K2; a program whose weight rulegen cannot lower (a sort, also a sort
  over a ``wstate`` leaf) raises there, naming the op.
* State reads and hooks: K1 (plain and jump) and K2 under visited_avoiding
  stripped of its hand rule (a generated weight reading the ring) choose
  bit for bit as under the hand VISITED rule; K4's ``HOOK_GENERATED``
  instances (ppr_nibble stripped of its hook rule) give the
  ``HOOK_PPR_NIBBLE`` instances' paths, flags and end state bit for bit in
  all four regimes; the quickstart program and non_backtracking run fused
  (K4 with generated hooks) as they run staged, end state included.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import cuda_device, one_torch_thread  # noqa: F401
from repro_torch.core import EngineConfig, WalkEngine
from repro_torch.core import erjs as erjs_mod
from repro_torch.core.types import WalkerState, WalkProgram
from repro_torch.graphs import power_law_graph
from repro_torch.kernels import build, megastep
from repro_torch.kernels.erjs import erjs_select
from repro_torch.kernels.ervs import ervs_select
from repro_torch.kernels.prng import key_data
from repro_torch.walks import make_workload
from repro_torch.walks.examples import (degree_damped, non_backtracking,
                                        stripped)

#: fused regime -> the method that runs it
FUSED_METHODS = {"reservoir": "ervs", "rejection": "erjs",
                 "precomp_its": "its_precomp",
                 "precomp_alias": "alias_precomp"}


def _walkers(graph, n, seed):
    rng = np.random.default_rng(seed)
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    deg = np.diff(indptr)
    cur = rng.choice(np.nonzero(deg > 0)[0], n)
    off = (rng.random(n) * deg[cur]).astype(np.int64)
    prev = graph.indices.cpu().numpy()[indptr[cur] + off].astype(np.int64)
    prev[::7] = -1
    t = lambda x: torch.from_numpy(np.asarray(x, np.int64)).to(
        graph.indptr.device)
    keys = t(rng.integers(0, 1 << 32, (n, 2)))
    return t(cur), t(prev), t(rng.integers(0, 5, n)), keys


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["node2vec", "metapath", "deepwalk"])
def test_generated_kernels_choose_as_the_hand_rules(cuda_device, name):
    graph = power_law_graph(4000, 10, seed=1).to(cuda_device)
    hand = make_workload(name)
    gen = stripped(hand)
    cur, prev, step, keys = _walkers(graph, 4096, 2)
    for jump in (False, True):
        a, b = (ervs_select(graph, p, p.params(), cur, prev, step, keys,
                            tile=256, jump=jump) for p in (hand, gen))
        assert torch.equal(a, b), (name, jump)
    bound = torch.full(cur.shape, 2.0, device=cuda_device)
    outs = [erjs_select(graph, p, p.params(), cur, prev, step, keys, bound)
            for p in (hand, gen)]
    for a, b in zip(*outs):
        assert torch.equal(a, b), name
    if name == "deepwalk":
        eng = WalkEngine(graph, gen, EngineConfig(method="erjs",
                                                  step_exec="fused"))
        state = WalkerState.create(cur, key_data(3))
        args = dict(kind="rejection", tile=256, rjs_trials=8,
                    rjs_max_rounds=16, epoch_len=8, num_steps=80,
                    bmax=eng._fused_bmax)
        a = megastep.fused_epoch(graph, hand, (), state, **args)
        b = megastep.fused_epoch(graph, gen, (), state, **args)
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


@pytest.mark.cuda
def test_quickstart_program_runs_adaptive_on_the_card(cuda_device):
    graph = power_law_graph(4000, 10, seed=1).to(cuda_device)
    prog = degree_damped()
    eng = WalkEngine(graph, prog, EngineConfig(method="adaptive",
                                               jump_threshold=8))
    assert eng.compiled.flag == "PER_STEP" and eng.precomp is None
    build.reset_launches()
    res = eng.run(np.arange(4000), num_steps=12)
    assert build.LAUNCHES["erjs_select"] > 0
    assert build.LAUNCHES["ervs_select"] + build.LAUNCHES[
        "ervs_jump_select"] > 0
    assert (res.paths[:, 1:] >= 0).sum(axis=1).max() == 9
    cur, prev, step, keys = _walkers(graph, 4096, 4)
    ws = prog.init_wstate_batch(torch.arange(4096, device=cuda_device))
    bound = eng.sampler_ctx.estimates(WalkerState(
        cur=cur, prev=prev, step=step, alive=torch.ones_like(
            cur, dtype=torch.bool), rng=keys, wstate=ws)).bound_max
    got = erjs_select(graph, prog, (), cur, prev, step, keys, bound)
    want = erjs_mod.erjs_step(graph, prog, (), cur, prev, step, keys, bound)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_unlowerable_weights_raise_on_the_card(cuda_device):
    graph = power_law_graph(500, 6, seed=1).to(cuda_device)
    sort = WalkProgram(
        name="sorted", init=lambda: (),
        get_weight=lambda c, p, ws: torch.sort(
            torch.stack([c.h, c.h * 2], dim=-1), dim=-1).values[..., 0])
    eng = WalkEngine(graph, sort, EngineConfig(method="adaptive"))
    assert eng.compiled.flag == "FALLBACK"
    with pytest.raises(ValueError, match="sort"):
        eng.run(np.arange(50), num_steps=3)
    visited = make_workload("visited_avoiding")

    def sorted_ring(c, p, ws):
        first = ws[0].sort(dim=-1).values[:, 0]
        first = first.reshape(first.shape + (1,) * (c.nbr.dim() - 1))
        return torch.where(first == c.nbr, 0.0, c.h)

    eng = WalkEngine(graph, stripped(dataclasses.replace(
        visited, get_weight=sorted_ring)), EngineConfig(method="ervs"))
    with pytest.raises(ValueError, match="sort.*wstate leaf 0"):
        eng.run(np.arange(50), num_steps=3)


def _rings(graph, cur, window, seed):
    """[n, window] int32 rings holding some of each walker's neighbours,
    the rest -1 (empty) or other nodes."""
    rng = np.random.default_rng(seed)
    indptr = graph.indptr.cpu().numpy().astype(np.int64)
    indices = graph.indices.cpu().numpy()
    c = cur.cpu().numpy()
    deg = np.diff(indptr)[c]
    slot = (rng.random((c.size, window)) * deg[:, None]).astype(np.int64)
    ring = indices[indptr[c][:, None] + slot].astype(np.int32)
    other = rng.integers(0, graph.num_nodes, ring.shape).astype(np.int32)
    pick = rng.random(ring.shape)
    ring = np.where(pick < 0.25, -1, np.where(pick < 0.4, other, ring))
    return torch.from_numpy(ring).to(cur.device)


@pytest.mark.cuda
def test_generated_state_reads_choose_as_the_hand_visited_rule(cuda_device):
    graph = power_law_graph(4000, 10, seed=1).to(cuda_device)
    hand = make_workload("visited_avoiding")
    gen = stripped(hand)
    cur, prev, step, keys = _walkers(graph, 4096, 6)
    ws = (_rings(graph, cur, 16, 7),)
    for jump in (False, True):
        a, b = (ervs_select(graph, p, p.params(), cur, prev, step, keys,
                            tile=256, jump=jump, wstate=ws)
                for p in (hand, gen))
        assert torch.equal(a, b), jump
    bound = torch.full(cur.shape, 2.0, device=cuda_device)
    outs = [erjs_select(graph, p, p.params(), cur, prev, step, keys, bound,
                        wstate=ws) for p in (hand, gen)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    want = erjs_mod.erjs_step(graph, gen, gen.params(), cur, prev, step,
                              keys, bound, wstate=ws)
    for a, b in zip(outs[1], want):
        assert torch.equal(a, b)


def _same_epoch(a, b):
    (sa, ea, fa), (sb, eb, fb) = a, b
    assert torch.equal(ea, eb) and torch.equal(fa, fb)
    for f in ("cur", "prev", "step", "alive"):
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    for x, y in zip(sa.wstate, sb.wstate):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(FUSED_METHODS))
def test_generated_hooks_equal_the_hand_hook_rule(cuda_device, kind):
    graph = power_law_graph(4000, 10, seed=1).to(cuda_device)
    hand = make_workload("ppr_nibble")
    gen = stripped(hand, hooks=True)
    eng = WalkEngine(graph, gen, EngineConfig(
        method=FUSED_METHODS[kind], step_exec="fused"))
    assert eng.step_exec_resolved == "fused"
    cur, _, _, _ = _walkers(graph, 4096, 8)
    mass = torch.from_numpy(np.random.default_rng(9).uniform(
        0.05, 1.0, 4096).astype(np.float32)).to(cuda_device)
    state = WalkerState.create(cur, key_data(3), wstate=(mass,))
    args = dict(kind=kind, tile=256, rjs_trials=1, rjs_max_rounds=1,
                epoch_len=16, num_steps=80, bmax=eng._fused_bmax,
                tables=eng.precomp)
    build.reset_launches()
    got = megastep.fused_epoch(graph, gen, gen.params(), state, **args)
    assert build.LAUNCHES[f"fused_epoch_{kind}"] == 1
    _same_epoch(got, megastep.fused_epoch(graph, hand, hand.params(), state,
                                          **args))
    assert torch.equal(state.wstate[0], mass)  # the input stays


@pytest.mark.cuda
@pytest.mark.parametrize("make", [degree_damped, non_backtracking])
def test_hooked_user_programs_run_fused_as_staged(cuda_device, make):
    graph = power_law_graph(4000, 10, seed=1).to(cuda_device)
    prog = make()
    engs = [WalkEngine(graph, prog, EngineConfig(method="ervs",
                                                 step_exec=sx))
            for sx in ("fused", "staged")]
    assert engs[0].step_exec_resolved == "fused"
    starts = torch.arange(4000, device=cuda_device)
    state = WalkerState.create(starts, key_data(5),
                               wstate=prog.init_wstate_batch(starts))
    (sa, ea, ta), (sb, eb, tb) = (
        e.run_epoch_fn(state, epoch_len=12, num_steps=12) for e in engs)
    assert torch.equal(ea, eb) and ta == tb  # paths and telemetry
    for f in ("cur", "prev", "step", "alive"):
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert torch.equal(sa.wstate[0], sb.wstate[0])
    res = [e.run(np.arange(4000), num_steps=12) for e in engs]
    assert np.array_equal(res[0].paths, res[1].paths)
