"""Port parity, part 3: the three regimes of the adaptive step.

Against the reference on the reference's own walker states (every state a
reference walk passed through, with its per-step key):

* ``build_tables`` CDF and totals, bitwise;
* the ITS draw (K3's plain version), bitwise against ``its_select`` and
  the reference's Pallas ``its_search`` in interpret mode;
* the eRJS choices and fallback masks (K2's plain version), bitwise;
* eRVS, plain and jump (K1's plain versions), step by step: the same next
  node except where the decision compares two float32 keys within 2 ulp
  of each other (checked in float64); the exact-match rate is printed.

The wrappers' CPU dispatch and input checks are covered here too; the
kernels themselves run only on the card (``cuda`` marker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (cuda_device, node_offsets, one_torch_thread,  # noqa: F401
                         step_keys, to_port_graph, walk_states)
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.core import analyze as ref_analyze
from repro.core import BoundInputs as RefBoundInputs
from repro.core import precomp as ref_precomp
from repro.core.erjs import erjs_step as ref_erjs_step
from repro.core.ervs import ervs_jump_step as ref_ervs_jump_step
from repro.core.ervs import ervs_step as ref_ervs_step
from repro.graphs import node_stats as ref_node_stats
from repro.graphs import power_law_graph as ref_power_law
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core import build_tables
from repro_torch.core import ervs as ervs_mod
from repro_torch.core.erjs import erjs_step
from repro_torch.core.precomp import its_offsets, its_select
from repro_torch.kernels import build
from repro_torch.kernels.erjs import erjs_select
from repro_torch.kernels.ervs import ervs_select
from repro_torch.kernels.its import its_search
from repro_torch.walks import make_workload

TILE = 16  # small logical tile so rows span several tiles


@pytest.fixture(scope="module")
def world():
    """A power-law graph and the states of a reference adaptive node2vec
    walk over it (4 steps from every node)."""
    g = ref_power_law(400, 10, seed=4)
    wl = ref_make_workload("node2vec")
    res = RefEngine(g, wl, RefConfig(method="adaptive", jump_threshold=4,
                                     tile=TILE)).run(np.arange(400),
                                                     num_steps=4)
    q, cur, prev, step = walk_states(res.paths)
    kd = step_keys(0, q, step)
    return dict(g=g, pg=to_port_graph(g), cur=cur, prev=prev, step=step,
                kd=kd, stats=ref_node_stats(g, num_labels=1))


def _j(a):
    return jnp.asarray(a, jnp.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _ref_keys(kd):
    return jax.random.wrap_key_data(jnp.asarray(kd))


@pytest.mark.parametrize("dist,weighted", [("uniform", True),
                                           ("pareto", False)])
def test_build_tables_bitwise(dist, weighted):
    g = ref_power_law(500, 9, weight_dist=dist, seed=6)
    want = ref_precomp.build_tables(g, ref_make_workload(
        "deepwalk", weighted=weighted), (), aligned=False)
    pw = make_workload("deepwalk", weighted=weighted)
    got = build_tables(to_port_graph(g), pw, pw.params())
    assert np.array_equal(np.asarray(want.cdf).view(np.uint32),
                          got.cdf.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(want.total).view(np.uint32),
                          got.total.numpy().view(np.uint32))
    assert not got.invalid.any()


def test_its_draw_bitwise(world):
    g, pg = world["g"], world["pg"]
    wl = ref_make_workload("deepwalk")
    tables = ref_precomp.build_tables(g, wl, (), aligned=True)
    cur, kd = world["cur"], world["kd"]
    depth = ref_precomp.search_depth(int(g.max_degree()))
    active = np.arange(cur.size) % 9 != 0
    want = ref_precomp.its_select(g, tables, _j(cur), _ref_keys(kd),
                                  active=jnp.asarray(active), depth=depth)
    ptab = interop.tables_from_arrays(tables.cdf, tables.total,
                                      tables.invalid)
    got = its_select(pg, ptab, _t(cur), interop.keys_from_arrays(kd),
                     active=torch.from_numpy(active), depth=depth)
    assert np.array_equal(np.asarray(want), got.numpy())
    # the reference's Pallas kernel itself, in interpret mode, on a slice
    from repro.kernels import ops as ref_ops
    n = 16
    vs = _j(cur[:n])
    deg = g.indptr[vs + 1] - g.indptr[vs]
    seeds = ref_precomp.threefry_seeds(_ref_keys(kd[:n]))
    off = ref_ops.its_search(tables.cdf2d, tables.arow0[vs], deg,
                             tables.total[vs], seeds, interpret=True)
    got_off = its_search(pg, ptab, _t(cur[:n]),
                         interop.keys_from_arrays(kd[:n]))
    assert np.array_equal(np.asarray(off), got_off.numpy())


def _bounds(world, wl):
    stats = world["stats"]
    cur, prev = world["cur"], world["prev"]
    deg = np.diff(np.asarray(world["g"].indptr))
    dprev = np.where(prev >= 0, deg[np.maximum(prev, 0)], 0)
    bi = RefBoundInputs(stats.h_min[_j(cur)], stats.h_max[_j(cur)],
                        stats.h_mean[_j(cur)], _j(deg[cur]), _j(dprev),
                        _j(cur), _j(prev), _j(world["step"]))
    _, hi = jax.vmap(ref_analyze(wl).bound_fn)(bi)
    return hi


@pytest.mark.parametrize("trials,rounds", [(8, 16), (2, 1)])
def test_erjs_choices_and_fallbacks_bitwise(world, trials, rounds):
    """Same accepted neighbour and the same fallback mask, including the
    bound-starved (2 trials, 1 round) setting where many walkers fall
    back."""
    g, pg = world["g"], world["pg"]
    wl, pw = ref_make_workload("node2vec"), make_workload("node2vec")
    cur, prev, step, kd = (world[k] for k in ("cur", "prev", "step", "kd"))
    bound = _bounds(world, wl)
    active = np.arange(cur.size) % 5 != 0
    want_n, want_fb, _ = ref_erjs_step(
        g, wl, wl.params(), _j(cur), _j(prev), _j(step), _ref_keys(kd),
        bound, trials_per_round=trials, max_rounds=rounds,
        active=jnp.asarray(active))
    got_n, got_fb, used = erjs_step(
        pg, pw, pw.params(), _t(cur), _t(prev), _t(step),
        interop.keys_from_arrays(kd), torch.from_numpy(np.array(bound)),
        trials, rounds, active=torch.from_numpy(active))
    assert np.array_equal(np.asarray(want_n), got_n.numpy())
    assert np.array_equal(np.asarray(want_fb), got_fb.numpy())
    assert int(used.max()) <= trials * rounds
    if rounds == 1:
        assert np.asarray(want_fb).sum() > 0


def near_tie_explains(world, pw, jump, cur, prev, step, kd, got, want):
    """Boolean per divergent walker: is the divergence a near-tie — the two
    candidates' keys (plain: float64 keys of the two chosen offsets; jump:
    the port's two best final lane keys) within 2 float32 ulps?"""
    pg = world["pg"]
    keys = interop.keys_from_arrays(kd)
    if jump:
        lk, _ = ervs_mod.jump_lanes(pg, pw, pw.params(), _t(cur), _t(prev),
                                    _t(step), keys, TILE,
                                    torch.ones(cur.size, dtype=torch.bool))
        top = lk.topk(2, dim=1).values
        return ervs_mod.within_ulps(top[:, 0], top[:, 1]).numpy()
    idx = (pg.indptr.numpy(), pg.indices.numpy())
    ka = ervs_mod.offset_keys_f64(pg, pw, pw.params(), _t(cur), _t(prev),
                                  _t(step), keys,
                                  _t(node_offsets(*idx, cur, got)), TILE)
    kb = ervs_mod.offset_keys_f64(pg, pw, pw.params(), _t(cur), _t(prev),
                                  _t(step), keys,
                                  _t(node_offsets(*idx, cur, want)), TILE)
    return ervs_mod.within_ulps(ka, kb).numpy()


@pytest.mark.parametrize("program", ["node2vec", "deepwalk"])
@pytest.mark.parametrize("jump", [False, True], ids=["plain", "jump"])
def test_ervs_step_by_step_near_tie_contract(world, program, jump):
    g, pg = world["g"], world["pg"]
    wl, pw = ref_make_workload(program), make_workload(program)
    cur, prev, step, kd = (world[k] for k in ("cur", "prev", "step", "kd"))
    active = np.arange(cur.size) % 7 != 0
    ref_fn = ref_ervs_jump_step if jump else ref_ervs_step
    want = ref_fn(g, wl, wl.params(), _j(cur), _j(prev), _j(step),
                  _ref_keys(kd), tile=TILE, active=jnp.asarray(active))
    want = np.asarray(want[0] if jump else want)
    plain = ervs_mod.ervs_jump_step if jump else ervs_mod.ervs_step
    got = plain(pg, pw, pw.params(), _t(cur), _t(prev), _t(step),
                interop.keys_from_arrays(kd), tile=TILE,
                active=torch.from_numpy(active)).numpy()
    same = got == want
    print(f"eRVS[{program}, {'jump' if jump else 'plain'}]: exact-match "
          f"rate {same.mean():.6f} over {same.size} walker states")
    bad = np.nonzero(~same)[0]
    if bad.size:
        near = near_tie_explains(world, pw, jump, cur[bad], prev[bad],
                                 step[bad], kd[bad], got[bad], want[bad])
        assert near.all(), f"divergences beyond the near-tie contract at " \
                           f"states {bad[~near].tolist()}"
    assert (want >= 0).sum() > 0.5 * active.sum()


def test_near_tie_helpers(world):
    """within_ulps counts float32 ulps; offset_keys_f64 reproduces the key
    order eRVS chose by (the chosen offset holds the largest key)."""
    a = torch.tensor([1.0, -3.5e-7, 2.0])
    b = torch.nextafter(torch.nextafter(a, a * 2), a * 2)
    assert ervs_mod.within_ulps(a, b).all()
    assert not ervs_mod.within_ulps(a, torch.nextafter(b, b * 2)).any()
    pg = world["pg"]
    pw = make_workload("node2vec")
    deg = np.diff(pg.indptr.numpy().astype(np.int64))
    sel = np.nonzero(deg[world["cur"]] <= 2 * TILE)[0][:200]
    cur, prev, step, kd = (world[k][sel] for k in ("cur", "prev", "step",
                                                  "kd"))
    keys = interop.keys_from_arrays(kd)
    got = ervs_mod.ervs_step(pg, pw, pw.params(), _t(cur), _t(prev),
                             _t(step), keys, tile=TILE).numpy()
    width = int(deg[cur].max())
    k64 = torch.stack([ervs_mod.offset_keys_f64(
        pg, pw, pw.params(), _t(cur), _t(prev), _t(step), keys,
        torch.full((cur.size,), j, dtype=torch.int64).minimum(
            _t(deg[cur] - 1)), TILE) for j in range(width)], dim=1)
    best = k64.argmax(dim=1).numpy()
    want = node_offsets(pg.indptr.numpy(), pg.indices.numpy(), cur, got)
    assert np.array_equal(best, want)


def test_cpu_wrappers_run_the_plain_versions(world):
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    pg = world["pg"]
    pw = make_workload("node2vec")
    cur, prev, step = _t(world["cur"]), _t(world["prev"]), _t(world["step"])
    keys = interop.keys_from_arrays(world["kd"])
    p = pw.params()
    build.reset_launches()
    for jump in (False, True):
        plain = ervs_mod.ervs_jump_step if jump else ervs_mod.ervs_step
        assert torch.equal(
            ervs_select(pg, pw, p, cur, prev, step, keys, tile=TILE,
                        jump=jump),
            plain(pg, pw, p, cur, prev, step, keys, tile=TILE))
    bnd = torch.full(cur.shape, 8.0)
    for a, b in zip(erjs_select(pg, pw, p, cur, prev, step, keys, bnd),
                    erjs_step(pg, pw, p, cur, prev, step, keys, bnd)):
        assert torch.equal(a, b)
    dw = make_workload("deepwalk")
    tab = build_tables(pg, dw, dw.params())
    assert torch.equal(its_search(pg, tab, cur, keys),
                       its_offsets(pg, tab, cur, keys))
    assert all(v == 0 for v in build.LAUNCHES.values())


def test_kernel_input_checks():
    x = torch.zeros(4, dtype=torch.int64)
    build.require(x, "x", torch.int64, (4,), x.device)
    with pytest.raises(TypeError, match="dtype"):
        build.require(x.int(), "x", torch.int64, (4,), x.device)
    with pytest.raises(ValueError, match="shape"):
        build.require(x, "x", torch.int64, (5,), x.device)
    with pytest.raises(ValueError, match="contiguous"):
        build.require(torch.zeros(8, dtype=torch.int64)[::2], "x",
                      torch.int64, (4,), x.device)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(world, cuda_device):
    """K1 (both instances), K2 and K3 on the card against their plain
    versions on the same card tensors."""
    pg = world["pg"].to(cuda_device)
    cur, prev, step = (_t(world[k]).to(cuda_device)
                       for k in ("cur", "prev", "step"))
    keys = interop.keys_from_arrays(world["kd"], device=cuda_device)
    for name in ("node2vec", "deepwalk"):
        pw = make_workload(name)
        p = pw.params()
        for jump in (False, True):
            plain = ervs_mod.ervs_jump_step if jump else ervs_mod.ervs_step
            assert torch.equal(
                ervs_select(pg, pw, p, cur, prev, step, keys, tile=TILE,
                            jump=jump),
                plain(pg, pw, p, cur, prev, step, keys, tile=TILE))
    pw = make_workload("node2vec")
    bnd = torch.full(cur.shape, 8.0, device=cuda_device)
    for a, b in zip(erjs_select(pg, pw, pw.params(), cur, prev, step, keys,
                                bnd),
                    erjs_step(pg, pw, pw.params(), cur, prev, step, keys,
                              bnd)):
        assert torch.equal(a, b)
    dw = make_workload("deepwalk")
    tab = build_tables(pg, dw, dw.params())
    assert torch.equal(its_search(pg, tab, cur, keys),
                       its_offsets(pg, tab, cur, keys))
