"""The ``interleaved`` sampler in the port (``tests/test_precomp.py``'s
``TestInterleaved`` and ``tests/test_programs.py``'s stateful case):

* paths and telemetry equal the port's ``ervs`` and the reference's
  ``interleaved`` under node2vec and deepwalk at tile 64 and tile 8
  (rows past the prefetched tile), with refills (``batch=4,
  epoch_len=2``), under ``visited_avoiding(window=16)`` (a weight that
  reads ``wstate``), and for the quickstart program (the reference's
  within the eRVS near-tie contract);
* the carry after each step of a refilling scheduler equals the
  reference's ``PrefetchTile``, miss lanes of refilled slots included;
* ``reset_sampler_carry`` between epochs changes no bit;
* the fused path carries a carry through untouched, and ``select``
  without a carry (all lanes miss) chooses as with one.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_port import drive, one_torch_thread, to_port_graph  # noqa: F401
from test_torch_compiler import _ref_quickstart
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.graphs import random_graph as ref_random_graph
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core import EngineConfig, PrefetchTile, WalkEngine
from repro_torch.core import ervs as ervs_mod
from repro_torch.core.types import WalkerState
from repro_torch.kernels import megastep
from repro_torch.kernels.prng import key_data
from repro_torch.walks import make_workload
from repro_torch.walks.examples import degree_damped

TELEMETRY = ("live_steps", "frac_rjs", "frac_precomp", "frac_stale",
             "rjs_fallbacks")


@pytest.fixture(scope="module")
def graphs():
    g = ref_random_graph(200, 8, seed=1)
    return g, to_port_graph(g)


def _port(pg, program, method, tile, starts, steps, key, **run_kw):
    eng = WalkEngine(pg, program, EngineConfig(method=method, tile=tile,
                                               device="cpu"))
    return eng.run(starts, num_steps=steps, key=key_data(key), **run_kw)


def _assert_same(a, b, what):
    np.testing.assert_array_equal(a.paths, b.paths, err_msg=what)
    for f in TELEMETRY:
        assert getattr(a, f) == getattr(b, f), (what, f)


CASES = {
    # name: (reference program, port program, tile, queries, run keywords)
    "node2vec-t64": ("node2vec", {}, 64, 48, {}),
    "node2vec-t8": ("node2vec", {}, 8, 48, {}),
    "deepwalk-t64": ("deepwalk", {}, 64, 48, {}),
    "deepwalk-t8": ("deepwalk", {}, 8, 48, {}),
    "node2vec-refills": ("node2vec", {}, 64, 13,
                         dict(batch=4, epoch_len=2)),
    "visited_avoiding": ("visited_avoiding", dict(window=16), 64, 16, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_interleaved_equals_ervs_and_reference(graphs, case):
    """The port's interleaved == its ervs == the reference's interleaved,
    paths and telemetry."""
    g, pg = graphs
    name, kw, tile, nq, run_kw = CASES[case]
    starts = np.arange(nq)
    ref = RefEngine(g, ref_make_workload(name, **kw), RefConfig(
        method="interleaved", tile=tile)).run(
        starts, num_steps=9, key=jax.random.key(3), **run_kw)
    inter = _port(pg, make_workload(name, **kw), "interleaved", tile,
                  starts, 9, 3, **run_kw)
    ervs = _port(pg, make_workload(name, **kw), "ervs", tile, starts, 9, 3,
                 **run_kw)
    _assert_same(inter, ervs, f"{case}: interleaved vs ervs")
    _assert_same(ref, inter, f"{case}: reference vs port")
    assert inter.live_steps > 0


def _near_tie(eng, ref_paths, got_paths, q, key: int) -> bool:
    """Query q's paths first part at an eRVS near-tie: the two choices'
    float64 keys lie within 2 float32 ulps."""
    t = int(np.nonzero(ref_paths[q] != got_paths[q])[0][0]) - 1
    cur, prev = int(ref_paths[q, t]), int(ref_paths[q, t - 1]) if t else -1
    one = lambda x: torch.tensor([x], dtype=torch.int64)
    keys = WalkerState.stream_key_data(key_data(key), one(q))
    keys = WalkerState(cur=one(cur), prev=one(prev), step=one(t),
                       alive=one(1).bool(), rng=keys).stream_keys()
    g = eng.graph
    row = g.indices[g.indptr[cur]:g.indptr[cur + 1]].numpy()
    ctx = eng.sampler_ctx
    ws = tuple(x[None] for x in eng.workload.wstate_template())
    k = [ervs_mod.offset_keys_f64(
        g, eng.workload, ctx.params, one(cur), one(prev), one(t), keys,
        one(int(np.searchsorted(row, p[q, t + 1]))), ctx.config.tile, ws)
        for p in (ref_paths, got_paths)]
    return bool(ervs_mod.within_ulps(k[0], k[1]))


def test_quickstart_program(graphs):
    """The quickstart program (weight and hooks; on the card a generated
    rule): the port's interleaved == its ervs bitwise, and == the
    reference's interleaved up to eRVS near-ties."""
    g, pg = graphs
    starts = np.arange(48)
    ref = RefEngine(g, _ref_quickstart(), RefConfig(
        method="interleaved", tile=16)).run(starts, num_steps=10,
                                            key=jax.random.key(4), batch=16,
                                            epoch_len=3)
    eng = WalkEngine(pg, degree_damped(), EngineConfig(
        method="interleaved", tile=16, device="cpu"))
    got = eng.run(starts, num_steps=10, key=key_data(4), batch=16,
                  epoch_len=3)
    ervs = _port(pg, degree_damped(), "ervs", 16, starts, 10, 4, batch=16,
                 epoch_len=3)
    _assert_same(got, ervs, "quickstart: interleaved vs ervs")
    same = (ref.paths == got.paths).all(axis=1)
    for q in np.nonzero(~same)[0]:
        assert _near_tie(eng, ref.paths, got.paths, q, 4), q
    if same.all():
        for f in TELEMETRY:
            assert getattr(ref, f) == getattr(got, f), f
    assert (got.paths[:, 1:] >= 0).sum(axis=1).max() == 9  # mass < 0.25


@pytest.mark.parametrize("name", ["node2vec", "metapath"])
def test_carry_after_each_step_equals_reference(graphs, name):
    """Schedulers of both packages driven alike (4 slots for 13 queries,
    one step an epoch): after every epoch the carry equals the
    reference's ``PrefetchTile``, leaf by leaf, refilled slots' misses
    included."""
    g, pg = graphs
    tile, steps = 8, 6
    ref_eng = RefEngine(g, ref_make_workload(name), RefConfig(
        method="interleaved", tile=tile))
    eng = WalkEngine(pg, make_workload(name), EngineConfig(
        method="interleaved", tile=tile, device="cpu"))
    ref_s = ref_eng.scheduler(num_steps=steps, key=jax.random.key(6),
                              slots=4, epoch_len=1, capacity=13)
    port_s = eng.scheduler(num_steps=steps, key=key_data(6), slots=4,
                           epoch_len=1, capacity=13)
    starts = np.arange(13) * 7 % 200
    deg = np.diff(np.asarray(g.indptr))
    queue = np.argsort(deg[starts], kind="stable")
    heads = [0, 0]
    epochs = misses = 0
    while heads[0] < 13 or ref_s.busy:
        for i, s in enumerate((ref_s, port_s)):
            free = s.free_slots()
            if heads[i] < 13 and free.size:
                qs = queue[heads[i]:heads[i] + free.size]
                heads[i] += qs.size
                s.admit(qs, starts[qs])
        st = port_s.state  # lanes that read the graph this step
        misses += int(((st.carry.node != st.cur) & st.alive).sum())
        ref_s.run_epoch()
        port_s.run_epoch()
        pf = ref_s.state.carry
        want = interop.carry_from_arrays(*(np.asarray(x) for x in (
            pf.node, pf.nbr, pf.h, pf.label)))
        got = port_s.state.carry
        for f in ("node", "nbr", "h", "label"):
            assert torch.equal(getattr(got, f), getattr(want, f)), \
                (name, epochs, f)
        epochs += 1
        assert port_s.busy == ref_s.busy
    np.testing.assert_array_equal(ref_s.paths, port_s.paths)
    assert ref_s.totals == port_s.totals
    assert epochs > steps and misses > 0


def test_reset_sampler_carry_is_bit_neutral(graphs):
    """Resetting the carry between epochs (every lane misses next step)
    changes no path bit and no counter."""
    g, pg = graphs
    eng = WalkEngine(pg, make_workload("node2vec"), EngineConfig(
        method="interleaved", tile=8, device="cpu"))
    starts = np.arange(13) * 5 % 200
    deg = pg.degrees().numpy()
    plain = drive(eng.scheduler(num_steps=7, key=key_data(2), slots=4,
                                epoch_len=2, capacity=13), starts, deg)

    class Resetting:
        def __init__(self, s):
            self.s = s

        def __getattr__(self, name):
            return getattr(self.s, name)

        def run_epoch(self):
            self.s.reset_sampler_carry()
            assert bool((self.s.state.carry.node == -1).all())
            return self.s.run_epoch()

    reset = drive(Resetting(eng.scheduler(num_steps=7, key=key_data(2),
                                          slots=4, epoch_len=2,
                                          capacity=13)), starts, deg)
    np.testing.assert_array_equal(plain.paths, reset.paths)
    assert plain.totals == reset.totals


def test_select_without_a_carry_misses_everywhere(graphs):
    """A state with no carry (None) gives the same choice as an initial
    one, and ``select`` returns a new carry tagged with the moves."""
    _, pg = graphs
    eng = WalkEngine(pg, make_workload("deepwalk"), EngineConfig(
        method="interleaved", tile=8, device="cpu"))
    W = 20
    state = WalkerState.create(torch.arange(W) * 3, key_data(1))
    keys = state.stream_keys()
    live = torch.ones(W, dtype=torch.bool)
    a = eng.sampler.select(eng.sampler_ctx, state, keys, active=live)
    init = eng.sampler.init_carry(eng.sampler_ctx, W)
    state = interop.state_from_arrays(
        *(x.numpy() for x in (state.cur, state.prev, state.step,
                              state.alive)),
        state.rng.numpy().astype(np.uint32), carry=init)
    assert state.carry is init
    b = eng.sampler.select(eng.sampler_ctx, state, keys, active=live)
    assert torch.equal(a.next_nodes, b.next_nodes)
    assert isinstance(a.carry, PrefetchTile)
    assert torch.equal(a.carry.node, a.next_nodes)
    for f in ("nbr", "h", "label"):
        assert torch.equal(getattr(a.carry, f), getattr(b.carry, f))


def test_fused_epoch_passes_the_carry_through(graphs):
    """K4's plain version (the fused path of ``ervs``) hands the state's
    carry back untouched."""
    _, pg = graphs
    eng = WalkEngine(pg, make_workload("deepwalk"), EngineConfig(
        method="ervs", tile=8, device="cpu"))
    state = WalkerState.create(torch.arange(6), key_data(1))
    state.carry = object()
    out, _, _ = megastep.fused_epoch_plain(
        eng.graph, eng.workload, eng.sampler_ctx.params, state,
        kind="reservoir", tile=8, rjs_trials=8, rjs_max_rounds=16,
        epoch_len=2, num_steps=4)
    assert out.carry is state.carry
