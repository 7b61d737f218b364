"""Port parity, part 7: the whole program registry on the adaptive path.

For the eight registry programs (node2vec, node2vec_unweighted, metapath,
metapath_unweighted, 2ndpr, deepwalk, visited_avoiding, ppr_nibble),
against the reference on the same inputs:

* the declared bound and Eq. 12 sum equal the reference compiler's
  ``bound_fn`` / ``sum_fn`` bit for bit on random ``BoundInputs`` —
  weighted and unweighted, with random non-empty rings for
  visited_avoiding and random masses for ppr_nibble — and the flag and
  the static proof agree;
* ``fuse_report`` and ``is_static`` agree;
* ``WalkEngine.run`` (method ``adaptive``, a small tile and a lowered
  ``jump_threshold`` so every regime is taken, fewer slots than queries so
  refills install ``init_walker_state``) gives the reference's paths and
  telemetry, and the scheduler's end state — program state included —
  bit for bit, under the eRVS near-tie contract (a path may part from the
  reference's only at an eRVS near-tie; the exact-match rate is printed);
* one port epoch from the reference's own mid-walk state, program state
  handed over through ``interop.wstate_from_arrays``, equals the
  reference's next epoch.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (cuda_device, drive, node_offsets,  # noqa: F401
                         one_torch_thread, step_keys)
from repro.core import BoundInputs as RefBoundInputs
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.core import analyze as ref_analyze
from repro.core import flexi_compiler as ref_fc
from repro.core import is_static as ref_is_static
from repro.core import precomp as ref_precomp
from repro.graphs import node_stats as ref_node_stats
from repro.graphs import power_law_graph as ref_power_law
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core import (BoundInputs, EngineConfig, WalkEngine, analyze,
                              is_static)
from repro_torch.core import ervs as ervs_mod
from repro_torch.core import flexi_compiler as fc
from repro_torch.core.runtime import EpochScheduler
from repro_torch.core.types import WalkerState
from repro_torch.graphs import power_law_graph
from repro_torch.kernels.prng import key_data
from repro_torch.walks import WORKLOADS, make_workload, register_workload

REGISTRY = ["node2vec", "node2vec_unweighted", "metapath",
            "metapath_unweighted", "2ndpr", "deepwalk", "visited_avoiding",
            "ppr_nibble"]
V, STEPS, TILE, JUMP = 300, 10, 16, 4
SLOTS, EPOCH = 128, 3  # refills, and an epoch length that does not divide
TELEMETRY = ("frac_rjs", "frac_precomp", "rjs_fallbacks", "live_steps")
# (registry name, factory keywords): every program weighted and
# unweighted, and a second MetaPath schema and PPR-Nibble constants
BOUND_CASES = [(n, {}) for n in REGISTRY] + [
    ("metapath", dict(weighted=False)), ("2ndpr", dict(weighted=False)),
    ("visited_avoiding", dict(weighted=False)),
    ("ppr_nibble", dict(weighted=False)),
    ("metapath", dict(schema=(2, 0, 2))),
    ("2ndpr", dict(gamma=0.35)),
    ("visited_avoiding", dict(a=0.3, b=3.0, window=5)),
]
BOUND_IDS = [n + "".join(f"-{k}={v}" for k, v in kw.items())
             for n, kw in BOUND_CASES]


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _random_wstate(name, kw, n, rng):
    """(reference, port) per-walker state of n walkers: rings with empty
    slots, node 0 (the Eq. 12 enumeration's nbr) and other nodes for
    visited_avoiding; masses for ppr_nibble; None otherwise."""
    if name == "visited_avoiding":
        ring = rng.integers(-1, 50, (n, kw.get("window", 16))).astype(
            np.int32)
        ring[::5] = -1
        ring[1::7, 0] = 0
        return jnp.asarray(ring), interop.wstate_from_arrays(ring)
    if name == "ppr_nibble":
        mass = rng.random(n).astype(np.float32)
        return jnp.asarray(mass), interop.wstate_from_arrays(mass)
    return None, None


@pytest.mark.parametrize("name,kw", BOUND_CASES, ids=BOUND_IDS)
def test_declared_bound_and_sum_match_compiler(name, kw):
    """Declared bound and Eq. 12 sum against the reference compiler's
    synthesised ``bound_fn`` (hi endpoint) and ``sum_fn``, bit for bit;
    the flag and the static proof agree."""
    import jax

    wl, pw = ref_make_workload(name, **kw), make_workload(name, **kw)
    rc, pc = ref_analyze(wl), analyze(pw)
    assert (pc.flag, is_static(pw)) == (rc.flag, ref_is_static(wl))
    n = 1024
    rng = np.random.default_rng(4)
    lo = rng.uniform(0.0, 3.0, n).astype(np.float32)
    hi = (lo + rng.pareto(1.0, n)).astype(np.float32)
    mean = (lo + rng.random(n) * (hi - lo)).astype(np.float32)
    ints = [rng.integers(0, 5000, n), rng.integers(0, 5000, n),
            rng.integers(0, 10**6, n), rng.integers(-1, 10**6, n),
            rng.integers(0, 80, n)]
    ws_ref, ws_port = _random_wstate(name, kw, n, rng)
    rb = RefBoundInputs(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(mean),
                        *(jnp.asarray(x, jnp.int32) for x in ints),
                        wstate=ws_ref)
    pb = BoundInputs(torch.from_numpy(lo), torch.from_numpy(hi),
                     torch.from_numpy(mean),
                     *(torch.from_numpy(np.asarray(x, np.int64))
                       for x in ints), wstate=ws_port)
    _, want_hi = jax.vmap(rc.bound_fn)(rb)
    want_sum = jax.vmap(rc.sum_fn)(rb)
    assert np.array_equal(_bits(want_hi), _bits(pc.bound_fn(pb).numpy()))
    assert np.array_equal(_bits(want_sum), _bits(pc.sum_fn(pb).numpy()))


@pytest.mark.cuda
def test_declared_bound_and_sum_on_the_card(cuda_device):
    """The declared estimators give the same bits on the card as on the
    CPU (a float32 divide by a Python number runs as a multiply by its
    reciprocal on the card, so the Eq. 12 mean divides by a tensor)."""
    n = 1 << 16
    rng = np.random.default_rng(9)
    lo = rng.uniform(0.0, 3.0, n).astype(np.float32)
    cols = [lo, (lo + rng.pareto(1.0, n)).astype(np.float32),
            (lo + rng.random(n)).astype(np.float32)]
    ints = [rng.integers(0, 5000, n), rng.integers(0, 5000, n),
            rng.integers(0, 10**6, n), rng.integers(-1, 10**6, n),
            rng.integers(0, 80, n)]
    for name, kw in BOUND_CASES:
        _, ws = _random_wstate(name, kw, n, rng)
        pc = analyze(make_workload(name, **kw))
        bi = [BoundInputs(*(torch.from_numpy(np.asarray(x)) for x in cols),
                          *(torch.from_numpy(np.asarray(x, np.int64))
                            for x in ints), wstate=ws)]
        bi.append(BoundInputs(**{
            f: (None if v is None else tuple(x.to(cuda_device) for x in v)
                if f == "wstate" else v.to(cuda_device))
            for f, v in vars(bi[0]).items()}))
        for fn in (pc.bound_fn, pc.sum_fn):
            cpu, card = fn(bi[0]), fn(bi[1]).cpu()
            assert np.array_equal(_bits(cpu.numpy()), _bits(card.numpy())), \
                name


@pytest.mark.parametrize("name", REGISTRY)
def test_fuse_report_and_static_match_reference(name):
    want = ref_fc.fuse_report(ref_make_workload(name))
    got = fc.fuse_report(make_workload(name))
    assert (got.weight_fusable, got.hooks_fusable, got.bound_node_local,
            got.fusable) == (want.weight_fusable, want.hooks_fusable,
                             want.bound_node_local, want.fusable)
    assert bool(got.reasons) == bool(want.reasons)
    assert is_static(make_workload(name)) == \
        ref_is_static(ref_make_workload(name))


def test_registry_matches_reference():
    from repro.walks import WORKLOADS as REF_WORKLOADS

    assert sorted(WORKLOADS) == sorted(REF_WORKLOADS) == sorted(REGISTRY)
    for name in REGISTRY:
        ref, port = ref_make_workload(name), make_workload(name)
        assert (port.name, port.walk_len, port.num_labels, port.weighted,
                port.needs_dist, port.needs_labels, port.has_hooks) == (
            ref.name, ref.walk_len, ref.num_labels, ref.weighted,
            ref.needs_dist, ref.needs_labels, ref.has_hooks), name


def test_register_workload():
    with pytest.raises(ValueError, match="already registered"):
        register_workload("deepwalk", make_workload)
    register_workload("dw_copy", lambda **kw: make_workload("deepwalk", **kw))
    try:
        assert make_workload("dw_copy").name == "deepwalk[w]"
    finally:
        del WORKLOADS["dw_copy"]


def test_metapath_schema_longer_than_the_device_rule_raises():
    from repro_torch.kernels.ervs import kernel_rule

    prog = make_workload("metapath", schema=tuple(range(9)))
    with pytest.raises(ValueError, match="schema"):
        kernel_rule(prog, prog.params())
    rule = kernel_rule(make_workload("metapath"),
                       make_workload("metapath").params())
    assert rule.schema == (0, 1, 2, 3, 4)


# ------------------------------------------------------------ adaptive run
@pytest.fixture(scope="module")
def runs():
    """Per program: (reference result, reference end state, port engine,
    port result, port end state, reference engine)."""
    g = ref_power_law(V, 8, seed=3)
    pg = power_law_graph(V, 8, seed=3)
    assert np.array_equal(np.asarray(g.indices), pg.indices.numpy())
    deg = np.diff(pg.indptr.numpy())
    starts = np.arange(V)
    kw = dict(method="adaptive", tile=TILE, jump_threshold=JUMP)
    out = {}

    def get(name):
        if name not in out:
            ref_eng = RefEngine(g, ref_make_workload(name), RefConfig(**kw))
            ref = ref_eng.run(starts, num_steps=STEPS, batch=SLOTS,
                              epoch_len=EPOCH)
            ref_end = drive(ref_eng.scheduler(
                num_steps=STEPS, slots=SLOTS, epoch_len=EPOCH,
                capacity=V), starts, deg).state
            eng = WalkEngine(pg, make_workload(name),
                             EngineConfig(device="cpu", **kw))
            got = eng.run(starts, num_steps=STEPS, batch=SLOTS,
                          epoch_len=EPOCH)
            end = drive(EpochScheduler(
                eng, num_steps=STEPS, key=key_data(0), slots=SLOTS,
                epoch_len=EPOCH, capacity=V), starts, deg).state
            out[name] = (ref, ref_end, eng, got, end, ref_eng)
        return out[name]
    return get


def _ring_before(path, t: int, window: int) -> np.ndarray:
    """A visited-avoiding walker's ring before step t of ``path``."""
    ring = np.full(window, -1, np.int32)
    for s in range(t):
        ring[s % window] = path[s + 1]
    return ring


def _first_divergence_is_near_tie(eng, ref_paths, got_paths, q) -> bool:
    """The first step where query q's paths part is an eRVS near-tie (the
    two choices' float64 keys within 2 float32 ulps, or the top two A-ExpJ
    lane keys for a hub)."""
    t = int(np.nonzero(ref_paths[q] != got_paths[q])[0][0]) - 1
    cur = int(ref_paths[q, t])
    prev = int(ref_paths[q, t - 1]) if t > 0 else -1
    one = lambda x: torch.tensor([x], dtype=torch.int64)
    ws = None
    if eng.workload.wstate_template() is not None:
        if eng.workload.name.startswith("visited"):
            window = eng.sampler_ctx.params.window
            ws = (torch.from_numpy(_ring_before(ref_paths[q], t, window))[
                None],)
        elif eng.workload.name == "non-backtracking":  # the node it left
            ws = (torch.tensor([prev], dtype=torch.int32),)
        else:  # the mass: the weights do not read it
            ws = tuple(x[None] for x in eng.workload.wstate_template())
    state = WalkerState(cur=one(cur), prev=one(prev), step=one(t),
                        alive=torch.ones(1, dtype=torch.bool),
                        rng=torch.zeros((1, 2), dtype=torch.int64),
                        wstate=ws)
    ctx = eng.sampler_ctx
    part = eng.sampler.partition(ctx, state, state.alive,
                                 state.stream_keys())
    if bool(part.want_pre | part.want_rjs):
        return False  # ITS and eRJS decisions are bitwise: a port fault
    keys = interop.keys_from_arrays(step_keys(0, np.array([q]),
                                              np.array([t])))
    p = ctx.params
    if bool(part.deg[0] >= ctx.config.jump_threshold):
        lk, _ = ervs_mod.jump_lanes(ctx.graph, eng.workload, p, one(cur),
                                    one(prev), one(t), keys, TILE,
                                    state.alive, ws)
        top = lk.topk(2, dim=1).values
        return bool(ervs_mod.within_ulps(top[:, 0], top[:, 1]))
    idx = (ctx.graph.indptr.numpy(), ctx.graph.indices.numpy())
    k = [ervs_mod.offset_keys_f64(
        ctx.graph, eng.workload, p, one(cur), one(prev), one(t), keys,
        torch.from_numpy(node_offsets(*idx, [cur], [nxt[q, t + 1]])), TILE,
        ws) for nxt in (ref_paths, got_paths)]
    return bool(ervs_mod.within_ulps(k[0], k[1]))


@pytest.mark.parametrize("name", REGISTRY)
def test_adaptive_run_matches_reference(runs, name):
    ref, ref_end, eng, got, end, _ = runs(name)
    same = (ref.paths == got.paths).all(axis=1)
    print(f"{name}: {same.mean():.4f} of {V} paths equal; frac_rjs="
          f"{got.frac_rjs:.4f} frac_precomp={got.frac_precomp:.4f} "
          f"fallbacks={got.rjs_fallbacks} live_steps={got.live_steps}")
    for q in np.nonzero(~same)[0]:
        assert _first_divergence_is_near_tie(eng, ref.paths, got.paths, q), \
            f"query {q}: first divergence is not an eRVS near-tie"
    if not same.all():
        return  # telemetry and end state follow the near-tie's path
    for f in TELEMETRY:
        assert getattr(got, f) == getattr(ref, f), f
    # the scheduler's end state, program state included, slot by slot
    for field in ("cur", "prev", "step", "alive"):
        assert np.array_equal(np.asarray(getattr(ref_end, field)),
                              getattr(end, field).numpy()), field
    ref_leaves = ([] if ref_end.wstate is None
                  else [np.asarray(ref_end.wstate)])
    got_leaves = [] if end.wstate is None else [x.numpy() for x in
                                                end.wstate]
    assert len(ref_leaves) == len(got_leaves)
    for a, b in zip(ref_leaves, got_leaves):
        assert a.dtype == b.dtype
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_regimes_each_program_takes(runs):
    """Where the lanes went: the dynamic programs take eRJS and eRVS, the
    static ones the ITS tables, MetaPath dead-ends, PPR-Nibble stops."""
    for name in REGISTRY:
        _, _, _, got, _, _ = runs(name)
        emitted = (got.paths[:, 1:] >= 0).sum(axis=1)
        if name in ("deepwalk", "ppr_nibble"):
            assert got.frac_precomp > 0
        else:
            assert got.frac_rjs > 0 and got.frac_precomp == 0
        if name == "ppr_nibble":  # stops count as steps taken
            assert got.live_steps == int(emitted.sum())
            assert emitted.mean() < STEPS
        elif name.startswith("metapath"):  # a dead end is a live step
            assert got.live_steps > int(emitted.sum())
        else:
            assert (emitted == STEPS).mean() > 0.9


def test_visited_avoiding_never_revisits_within_its_window(runs):
    _, _, eng, got, _, _ = runs("visited_avoiding")
    window = eng.sampler_ctx.params.window
    for path in got.paths:
        steps = path[1:][path[1:] >= 0]
        for t in range(1, steps.size):
            assert steps[t] not in steps[max(0, t - window):t]


@pytest.mark.parametrize("name", ["visited_avoiding", "ppr_nibble"])
def test_epoch_from_the_references_own_state(runs, name):
    """The reference's slot state after one epoch, program state included,
    handed over through ``interop``: the port's next epoch gives the
    reference's next epoch — emitted nodes, state, program state and
    telemetry."""
    _, _, eng, _, _, ref_eng = runs(name)
    sched = ref_eng.scheduler(num_steps=STEPS, slots=SLOTS, epoch_len=EPOCH,
                              capacity=V)
    sched.admit(np.arange(SLOTS), np.arange(SLOTS))
    sched.run_epoch()
    s = sched.state
    port = dataclasses.replace(
        interop.state_from_arrays(s.cur, s.prev, s.step, s.alive, s.rng),
        wstate=interop.wstate_from_arrays(np.asarray(s.wstate)))
    report = sched.run_epoch()
    after = sched.state
    nxt, emitted, totals = eng.run_epoch_fn(port, epoch_len=EPOCH,
                                            num_steps=STEPS)
    rows = np.arange(SLOTS)
    assert np.array_equal(sched.paths[rows, EPOCH + 1:2 * EPOCH + 1],
                          emitted.numpy())
    for field in ("cur", "prev", "step", "alive"):
        assert np.array_equal(np.asarray(getattr(after, field)),
                              getattr(nxt, field).numpy()), field
    assert np.array_equal(np.asarray(after.wstate).view(np.uint8),
                          nxt.wstate[0].numpy().view(np.uint8))
    assert report.stats == totals
    if name == "ppr_nibble":  # some walkers stopped in this epoch
        assert bool((np.asarray(s.alive) & ~np.asarray(after.alive)).any())


def test_wstate_from_arrays_keeps_leaves():
    ring = np.arange(12, dtype=np.int32).reshape(3, 4)
    (got,) = interop.wstate_from_arrays(ring)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), ring)
    assert interop.wstate_from_arrays(None) is None
    a, b = interop.wstate_from_arrays([np.ones(2, np.float32), ring])
    assert a.dtype == torch.float32 and b.shape == (3, 4)


def test_cli_runs_metapath_on_cpu(capsys):
    from repro_torch.launch import walk as walk_cli

    walk_cli.main(["--nodes", "300", "--queries", "40", "--steps", "6",
                   "--device", "cpu", "--workload", "metapath",
                   "--batch", "16", "--epoch-len", "2"])
    out = capsys.readouterr().out
    assert "frac_rjs=" in out and "kernel launches" in out


@pytest.mark.parametrize("method", ["its_precomp", "alias_precomp"])
def test_ppr_nibble_engines_build_their_own_tables(method):
    """Each table engine of ppr_nibble builds its own tables, bitwise the
    reference's build for ppr_nibble (the alias half only when the
    sampler draws from it)."""
    g = ref_power_law(V, 8, seed=3)
    want = ref_precomp.build_tables(g, ref_make_workload("ppr_nibble"),
                                    ref_make_workload("ppr_nibble").params(),
                                    aligned=False)
    pw = make_workload("ppr_nibble")
    eng = WalkEngine(power_law_graph(V, 8, seed=3), pw, EngineConfig(
        method=method, tile=32, device="cpu"))
    got = eng.precomp
    bits = lambda x: np.asarray(x).view(np.uint32)
    assert np.array_equal(bits(want.cdf), bits(got.cdf.numpy()))
    assert np.array_equal(bits(want.total), bits(got.total.numpy()))
    if method == "alias_precomp":
        assert np.array_equal(np.asarray(want.alias_off),
                              got.alias_off.numpy())
        assert np.array_equal(bits(want.alias_prob),
                              bits(got.alias_prob.numpy()))
    else:
        assert got.alias_off is None


def test_engines_on_one_graph_compute_node_stats_once():
    """Engines on one graph take its node statistics from the graph: one
    computation per label count, bitwise the reference's."""
    pg = power_law_graph(V, 8, seed=3)
    g = ref_power_law(V, 8, seed=3)
    cfg = EngineConfig(method="adaptive", tile=32, device="cpu")
    dw = WalkEngine(pg, make_workload("deepwalk"), cfg)
    ppr = WalkEngine(pg, make_workload("ppr_nibble"), cfg)
    mp = WalkEngine(pg, make_workload("metapath"), cfg)
    assert ppr.stats is dw.stats and mp.stats is not dw.stats
    for eng in (dw, mp):
        labels = max(eng.workload.num_labels, 1)
        want = ref_node_stats(g, num_labels=labels)
        for f in dataclasses.fields(want):
            w = np.asarray(getattr(want, f.name))
            got = getattr(eng.stats, f.name).numpy()
            assert got.shape == w.shape, f.name
            assert np.array_equal(got.view(np.uint8), w.view(np.uint8)), \
                f.name


def test_graph_to_its_own_device_is_the_graph():
    pg = power_law_graph(50, 4, seed=1)
    assert pg.to("cpu") is pg and pg.to(torch.device("cpu")) is pg


@pytest.mark.cuda
def test_graph_to_cuda_is_the_graph_on_the_card(cuda_device):
    """``"cuda"`` names the current card: a graph already there is kept,
    with what it cached (edge keys, node statistics)."""
    g = power_law_graph(50, 4, seed=1).to(cuda_device)
    assert g.device.index is not None
    assert g.to("cuda") is g and g.to(torch.device("cuda")) is g
    assert g.to(g.device) is g
