"""Port parity, part 8: per-walker program state and the hooks.

* ``ppr_nibble`` under the four fused methods (``ervs``, ``erjs``,
  ``its_precomp``, ``alias_precomp``): the port's fused path (K4's plain
  version, hook branch included) gives the port's staged path and the
  reference's staged path — paths, telemetry and the scheduler's end
  state, residual mass included — bit for bit (the reference's own fused
  ervs/erjs cells are red on jax 0.9.0, ROADMAP queue 3);
* a ``should_stop`` hook caps every path, for any slot count;
* a one-step chi-square of ``visited_avoiding`` with a non-empty ring
  against ``exact_probs(..., wstate)``;
* ``_bake_bmax`` evaluates the bound at ``wstate_template()``: for a
  hooked program it equals every walker's bound, and the reference's;
* the fused plan is the reference's (hooks that keep their shapes never
  keep a program staged); what K4 lacks raises instead: a declared hook
  rule of an unknown kind, or hooks ``rulegen`` cannot lower.

The kernels themselves run only on the card (``cuda`` marker): K1 and K2
under every device rule, and K4's hooked instances, against their plain
versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_port import (chi2_vs_exact, cuda_device, drive,  # noqa: F401
                         one_torch_thread)
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.graphs import power_law_graph as ref_power_law
from repro.walks import make_workload as ref_make_workload
from repro_torch.core import EngineConfig, WalkEngine, exact_probs
from repro_torch.core import erjs as erjs_mod
from repro_torch.core import ervs as ervs_mod
from repro_torch.core.runtime import EpochScheduler
from repro_torch.core.types import WalkerState
from repro_torch.graphs import power_law_graph
from repro_torch.kernels import build, megastep
from repro_torch.kernels.erjs import erjs_select
from repro_torch.kernels.ervs import ervs_select
from repro_torch.kernels.prng import fold_in, key_data
from repro_torch.kernels.rules import HookRule
from repro_torch.walks import make_workload

V, STEPS, BATCH, EPOCH, TILE = 300, 12, 128, 5, 32
FUSED_METHODS = ["ervs", "erjs", "its_precomp", "alias_precomp"]
TELEMETRY = ("frac_rjs", "frac_precomp", "frac_stale", "rjs_fallbacks",
             "live_steps")


@pytest.fixture(scope="module")
def graphs():
    g = ref_power_law(V, 8, seed=3)
    pg = power_law_graph(V, 8, seed=3)
    assert np.array_equal(np.asarray(g.indices), pg.indices.numpy())
    return g, pg


def _port_run(pg, name, method, step_exec, **kw):
    """(result, scheduler end state) of the port on the CPU."""
    eng = WalkEngine(pg, make_workload(name), EngineConfig(
        method=method, step_exec=step_exec, tile=TILE, device="cpu", **kw))
    assert eng.step_exec_resolved == step_exec, eng.fuse.reasons
    res = eng.run(np.arange(V), num_steps=STEPS, batch=BATCH,
                  epoch_len=EPOCH)
    end = drive(EpochScheduler(eng, num_steps=STEPS, key=key_data(0),
                                slots=BATCH, epoch_len=EPOCH, capacity=V),
                 np.arange(V), np.diff(pg.indptr.numpy())).state
    return res, end


def _assert_same_end(ref_state, state):
    for f in ("cur", "prev", "step", "alive"):
        assert np.array_equal(np.asarray(getattr(ref_state, f)),
                              getattr(state, f).numpy()), f
    (mass,) = state.wstate
    assert np.array_equal(np.asarray(ref_state.wstate).view(np.uint32),
                          mass.numpy().view(np.uint32))


@pytest.mark.parametrize("method", FUSED_METHODS)
def test_ppr_nibble_fused_equals_staged(graphs, method):
    g, pg = graphs
    ref_eng = RefEngine(g, ref_make_workload("ppr_nibble"), RefConfig(
        method=method, step_exec="staged", tile=TILE))
    ref = ref_eng.run(np.arange(V), num_steps=STEPS, batch=BATCH,
                      epoch_len=EPOCH)
    ref_end = drive(ref_eng.scheduler(num_steps=STEPS, slots=BATCH,
                                       epoch_len=EPOCH, capacity=V),
                     np.arange(V), np.diff(pg.indptr.numpy())).state
    fused, fused_end = _port_run(pg, "ppr_nibble", method, "fused")
    staged, staged_end = _port_run(pg, "ppr_nibble", method, "staged")
    for got, end in ((fused, fused_end), (staged, staged_end)):
        assert np.array_equal(ref.paths, got.paths)
        for f in TELEMETRY:
            assert getattr(got, f) == getattr(ref, f), f
        _assert_same_end(ref_end, end)
    emitted = (fused.paths[:, 1:] >= 0).sum(axis=1)
    assert fused.live_steps == int(emitted.sum())
    assert 0 < emitted.mean() < STEPS  # walks stop early, not at once


def test_forced_fallbacks_with_hooks(graphs):
    """K4's rejection regime with eRJS starved, the hooks running on
    fallback lanes too: fused equals staged."""
    _, pg = graphs
    kw = dict(rjs_trials=1, rjs_max_rounds=1)
    fused, fused_end = _port_run(pg, "ppr_nibble", "erjs", "fused", **kw)
    staged, staged_end = _port_run(pg, "ppr_nibble", "erjs", "staged", **kw)
    assert np.array_equal(fused.paths, staged.paths)
    assert fused.rjs_fallbacks == staged.rjs_fallbacks > 0
    assert torch.equal(fused_end.wstate[0], staged_end.wstate[0])


def _counter_program(cap: int):
    """DeepWalk with a per-walker step counter that stops at ``cap``."""
    return dataclasses.replace(
        make_workload("deepwalk"), name="capped",
        init_walker_state=lambda q: (torch.zeros(q.shape[0],
                                                 dtype=torch.int64),),
        on_step=lambda c, p, ws: (ws[0] + 1,),
        should_stop=lambda c, p, ws: ws[0] >= cap)


def test_should_stop_caps_paths(graphs):
    _, pg = graphs
    eng = WalkEngine(pg, _counter_program(4),
                     EngineConfig(method="adaptive", device="cpu"))
    assert eng.step_exec_resolved == "staged"
    # its hooks keep their shapes, and K4 runs them as generated code
    assert eng.fuse.hooks_fusable and megastep.runs_hooks(eng.workload)
    full = eng.run(np.arange(V), num_steps=STEPS)
    emitted = (full.paths[:, 1:] >= 0).sum(axis=1)
    assert emitted.max() == 4 and (emitted == 4).mean() > 0.9
    assert full.live_steps == int(emitted.sum())
    part = eng.run(np.arange(V), num_steps=STEPS, batch=37, epoch_len=3)
    assert np.array_equal(part.paths, full.paths)


def test_visited_chi_square_with_a_ring(graphs):
    """4000 walkers at one node with the same non-empty ring (half the
    node's neighbours and its previous node), one step: no ring node is
    drawn and the draws fit exact_probs(..., wstate)."""
    _, pg = graphs
    eng = WalkEngine(pg, make_workload("visited_avoiding"), EngineConfig(
        method="adaptive", tile=16, jump_threshold=4, device="cpu"))
    deg = pg.degrees().numpy()
    v = int(np.argsort(deg)[-3])
    row = pg.indices[pg.indptr[v]:pg.indptr[v + 1]].numpy()
    prev = int(row[0])
    members = np.concatenate([[prev], row[1::2]])[:16]
    ring = np.full(16, -1, np.int32)
    ring[:members.size] = members
    n = 4000
    state = WalkerState.create(
        torch.full((n,), v), key_data(7),
        wstate=(torch.from_numpy(np.tile(ring, (n, 1))),))
    state = dataclasses.replace(state, prev=torch.full((n,), prev),
                                step=torch.full((n,), 3))
    nxt, out, _ = eng.step(state, STEPS)
    draws = out.numpy()
    assert not np.isin(draws, ring[ring >= 0]).any()
    p, nbr = exact_probs(eng.graph, eng.workload, eng.sampler_ctx.params, v,
                         prev, 3, eng.pad, wstate=(torch.from_numpy(ring),))
    chi2, crit = chi2_vs_exact(draws, p, nbr)
    assert chi2 < crit, f"chi2={chi2:.1f} >= {crit:.1f}"
    # the step pushed the drawn node into slot step % window
    assert np.array_equal(nxt.wstate[0][:, 3].numpy(), draws)


def test_bake_bmax_at_the_wstate_template(graphs):
    """A hooked program's baked per-node bound (at ``wstate_template()``)
    equals every walker's own bound, whatever its mass, and the
    reference's baked table."""
    g, pg = graphs
    eng = WalkEngine(pg, make_workload("ppr_nibble"), EngineConfig(
        method="erjs", step_exec="fused", tile=TILE, device="cpu"))
    bmax = eng._bake_bmax()
    n = 2000
    rng = np.random.default_rng(1)
    state = WalkerState(
        cur=torch.from_numpy(rng.integers(0, V, n)),
        prev=torch.from_numpy(rng.integers(-1, V, n)),
        step=torch.from_numpy(rng.integers(0, STEPS, n)),
        alive=torch.ones(n, dtype=torch.bool),
        rng=torch.zeros((n, 2), dtype=torch.int64),
        wstate=(torch.from_numpy(rng.random(n).astype(np.float32)),))
    per_walker = eng.sampler_ctx.estimates(state).bound_max
    assert torch.equal(per_walker, bmax[state.cur])
    ref = RefEngine(g, ref_make_workload("ppr_nibble"), RefConfig(
        method="erjs", step_exec="staged", tile=TILE))
    assert np.array_equal(np.asarray(ref._bake_bmax()).view(np.uint32),
                          bmax.numpy().view(np.uint32))


def test_fused_plan_stays_staged_for_hooks_the_kernel_lacks(graphs):
    """No program stays staged for its hooks any more: the plan is the
    reference's (fusable, the sampler's fused kind, a node-local bound for
    rejection), and K4 runs a declared hook rule or generated hooks.  What
    the kernel lacks raises: K4's check refuses a declared hook rule of an
    unknown kind, and ``kernel_hooks`` hooks that rulegen cannot lower,
    naming the op."""
    _, pg = graphs
    capped = _counter_program(4)
    foreign = dataclasses.replace(capped,
                                  hook_rule=lambda p: HookRule(kind=7))
    sorted_hooks = dataclasses.replace(
        capped, should_stop=lambda c, p, ws: torch.sort(ws[0]).values >= 4)
    for prog in (capped, foreign, sorted_hooks):
        eng = WalkEngine(pg, prog, EngineConfig(
            method="ervs", step_exec="fused", tile=TILE, device="cpu"))
        assert eng.step_exec_resolved == "fused"
    assert megastep.runs_hooks(make_workload("ppr_nibble"))
    assert megastep.runs_hooks(capped)
    assert not megastep.runs_hooks(foreign)
    assert not megastep.runs_hooks(sorted_hooks)
    with pytest.raises(ValueError, match="should_stop.*sort"):
        megastep.kernel_hooks(sorted_hooks, ())
    W = 4
    state = WalkerState.create(torch.arange(W), key_data(0),
                               wstate=(torch.zeros(W, dtype=torch.int64),))
    with pytest.raises(ValueError, match="hook"):
        megastep.fused_epoch(pg, foreign, (), state, kind="reservoir",
                             tile=TILE, rjs_trials=8, rjs_max_rounds=16,
                             epoch_len=2, num_steps=4)


def test_create_installs_the_program_state():
    prog = make_workload("ppr_nibble")
    ws = prog.init_wstate_batch(torch.arange(3))
    s = WalkerState.create(torch.tensor([4, 5, 6]), key_data(0), wstate=ws)
    assert s.wstate[0].tolist() == [1.0, 1.0, 1.0]
    assert s.prev.tolist() == [-1, -1, -1] and bool(s.alive.all())
    (tmpl,) = prog.wstate_template()
    assert tmpl.shape == () and tmpl.dtype == torch.float32


# --------------------------------------------------------------- the card
RULE_CASES = ["metapath", "metapath_unweighted", "2ndpr",
              "visited_avoiding", "ppr_nibble", "node2vec_unweighted"]


@pytest.mark.cuda
def test_k1_k2_match_plain_under_every_rule(cuda_device):
    """K1 (plain and jump) and K2 against their plain versions on the
    card, for the device rules of this slice; visited_avoiding with rings
    a few steps in."""
    pg = power_law_graph(3000, 10, seed=7).to(cuda_device)
    n = 2048
    rng = np.random.default_rng(2)
    deg = pg.degrees().cpu().numpy()
    cur = rng.choice(np.nonzero(deg > 0)[0], n)
    indptr = pg.indptr.cpu().numpy().astype(np.int64)
    prev = pg.indices.cpu().numpy()[indptr[cur] + (rng.random(n) * deg[
        cur]).astype(np.int64)].astype(np.int64)
    prev[::9] = -1
    t = lambda a: torch.from_numpy(np.asarray(a)).to(cuda_device)
    cur, prev, step = t(cur), t(prev), t(rng.integers(0, 80, n))
    keys = t(rng.integers(0, 1 << 32, (n, 2)))
    for name in RULE_CASES:
        prog = make_workload(name)
        p = prog.params()
        ws = prog.init_wstate_batch(torch.arange(n, device=cuda_device))
        if name == "visited_avoiding":
            ws = (t(rng.choice(pg.num_nodes, (n, 16)).astype(np.int32)),)
            ws[0][:, 10:] = -1
        for jump in (False, True):
            plain = ervs_mod.ervs_jump_step if jump else ervs_mod.ervs_step
            got = ervs_select(pg, prog, p, cur, prev, step, keys, tile=64,
                              jump=jump, wstate=ws)
            want = plain(pg, prog, p, cur, prev, step, keys, tile=64,
                         wstate=ws)
            assert torch.equal(got, want), (name, jump)
        bnd = torch.full((n,), 4.0, device=cuda_device)
        got = erjs_select(pg, prog, p, cur, prev, step, keys, bnd, wstate=ws)
        want = erjs_mod.erjs_step(pg, prog, p, cur, prev, step, keys, bnd,
                                  wstate=ws)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_k4_hooked_matches_plain(cuda_device):
    """K4's PPR-Nibble instances in all four regimes against the plain
    version, with every third row stale and eRJS starved."""
    g = power_law_graph(3000, 10, seed=7)
    W = 4096
    for method, kw in (("ervs", {}), ("erjs", dict(rjs_trials=1,
                                                   rjs_max_rounds=1)),
                       ("its_precomp", {}), ("alias_precomp", {})):
        eng = WalkEngine(g, make_workload("ppr_nibble"), EngineConfig(
            method=method, step_exec="fused", **kw))
        assert eng.step_exec_resolved == "fused"
        tables = eng.precomp
        if tables is not None:
            inv = torch.zeros_like(tables.invalid)
            inv[::3] = True
            eng.precomp = dataclasses.replace(tables, invalid=inv)
        dev = eng.device
        state = WalkerState(
            cur=torch.randint(0, g.num_nodes, (W,), device=dev),
            prev=torch.full((W,), -1, device=dev),
            step=torch.zeros(W, dtype=torch.int64, device=dev),
            alive=torch.ones(W, dtype=torch.bool, device=dev),
            rng=fold_in(key_data(0).to(dev).expand(W, 2),
                        torch.arange(W, device=dev)),
            wstate=(torch.rand(W, device=dev) + 0.2,))
        args = dict(kind=eng._fused_kind, tile=eng.config.tile,
                    rjs_trials=eng.config.rjs_trials,
                    rjs_max_rounds=eng.config.rjs_max_rounds, epoch_len=16,
                    num_steps=80, bmax=eng._fused_bmax, tables=eng.precomp)
        p = eng.sampler_ctx.params
        build.reset_launches()
        got = megastep.fused_epoch(eng.graph, eng.workload, p, state, **args)
        want = megastep.fused_epoch_plain(eng.graph, eng.workload, p, state,
                                          **args)
        torch.cuda.synchronize()
        assert build.LAUNCHES[f"fused_epoch_{eng._fused_kind}"] == 1
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a, b), method
        for f in ("cur", "prev", "step", "alive"):
            assert torch.equal(getattr(got[0], f), getattr(want[0], f))
        assert torch.equal(got[0].wstate[0], want[0].wstate[0])
        assert not bool(got[0].alive.all())  # some walkers stopped
