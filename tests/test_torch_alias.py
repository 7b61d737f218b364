"""Port parity, part 5: the alias tables, kernel K5 and the precomputed
samplers.

Against the reference on the same inputs:

* ``uniform_pair_01`` bits on 10⁵ counters;
* the Vose alias tables bitwise — the vectorised build against the
  reference's per-row loop on raw rows (zero-total rows, d = 1, rows over
  256, with the lockstep and per-row phases forced in turn), and
  ``build_tables`` on power-law, random and hand-built graphs;
* the alias draw (K5's plain version) against the reference's
  ``alias_select`` and its Pallas ``alias_pick`` in interpret mode;
* ``its_precomp`` / ``alias_precomp`` staged end to end, including
  node2vec, which is not static and falls back to eRVS for good.

K5 itself runs only on the card (``cuda`` marker).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (cuda_device, one_torch_thread,  # noqa: F401
                         random_keys, to_port_graph)
from repro.core import EngineConfig as RefConfig
from repro.core import WalkEngine as RefEngine
from repro.core import precomp as ref_precomp
from repro.graphs import power_law_graph as ref_power_law
from repro.graphs import random_graph as ref_random
from repro.graphs.csr import from_edges as ref_from_edges
from repro.kernels import ops as ref_ops
from repro.kernels import prng as ref_prng
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.core import EngineConfig, WalkEngine, build_tables
from repro_torch.core import precomp
from repro_torch.graphs import power_law_graph
from repro_torch.kernels import build, prng
from repro_torch.kernels.alias import alias_pick
from repro_torch.walks import make_workload


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def test_uniform_pair_01_bits():
    n = 100_000
    kd = random_keys(n, seed=21)
    rng = np.random.default_rng(22)
    c0 = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    c1 = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    want = ref_prng.uniform_pair_01(jnp.asarray(kd[:, 0]),
                                    jnp.asarray(kd[:, 1]), jnp.asarray(c0),
                                    jnp.asarray(c1))
    t = lambda a: torch.from_numpy(a.astype(np.int64))
    got = prng.uniform_pair_01(t(kd[:, 0]), t(kd[:, 1]), t(c0), t(c1))
    for w, g in zip(want, got):
        assert np.array_equal(_bits(w), _bits(g.numpy()))


def _raw_rows(seed: int):
    """(w float64 [E], indptr) with every kind of row the build meets."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 40, size=1500)
    deg[:6] = [300, 1000, 1, 0, 257, 2]
    deg[rng.integers(6, 1500, size=30)] = rng.integers(200, 2500, size=30)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    E = int(indptr[-1])
    w = rng.uniform(1, 5, size=E).astype(np.float32).astype(np.float64)
    w *= rng.pareto(1.2, size=E) if seed % 2 else 1.0
    for v in rng.integers(0, 1500, size=60):  # zero-total rows
        w[indptr[v]:indptr[v + 1]] = 0.0
    w[rng.random(E) < 0.05] = 0.0
    w[rng.random(E) < 0.2] = 1.0  # ties on q == 1
    return w, indptr


@pytest.mark.parametrize("tail_rows", [0, 64, 10 ** 9])
def test_vose_build_matches_reference_rows(monkeypatch, tail_rows):
    """0: every row runs the lockstep loop to its end; 10⁹: every row
    finishes on Python floats; 64: the build's own split."""
    monkeypatch.setattr(precomp, "_VOSE_TAIL_ROWS", tail_rows)
    for seed in (1, 2):
        w, indptr = _raw_rows(seed)
        want_alias, want_prob = ref_precomp._vose_build(w, indptr)
        alias, prob = precomp.vose_build(w, indptr)
        assert np.array_equal(alias, want_alias)
        assert np.array_equal(_bits(prob), _bits(want_prob))


def _hand_built():
    """A hub row of 300, a row of 1, a zero-total row of 5, and random
    rows, with random h."""
    rng = np.random.default_rng(9)
    V = 400
    src = [np.zeros(300, np.int64), [1], np.full(5, 2)]
    dst = [np.arange(3, 303), [7], np.arange(10, 15)]
    for v in range(3, V):
        d = rng.integers(0, 12)
        src.append(np.full(d, v))
        dst.append(rng.choice(V, size=d, replace=False))
    src, dst = np.concatenate(src), np.concatenate(dst)
    h = rng.uniform(1, 5, size=src.size).astype(np.float32)
    h[src == 2] = 0.0
    return ref_from_edges(src, dst, V, h=h,
                          labels=np.zeros(src.size, np.int32))


GRAPHS = {
    "power_law": lambda: ref_power_law(500, 9, weight_dist="pareto", seed=6),
    "random": lambda: ref_random(300, 7, seed=2),
    "hand_built": _hand_built,
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("weighted", [True, False])
def test_build_tables_alias_bitwise(name, weighted):
    g = GRAPHS[name]()
    want = ref_precomp.build_tables(g, ref_make_workload(
        "deepwalk", weighted=weighted), (), aligned=False)
    pw = make_workload("deepwalk", weighted=weighted)
    got = build_tables(to_port_graph(g), pw, pw.params())
    assert np.array_equal(np.asarray(want.alias_off), got.alias_off.numpy())
    assert np.array_equal(_bits(want.alias_prob), _bits(got.alias_prob))
    assert np.array_equal(_bits(want.cdf), _bits(got.cdf))
    assert np.array_equal(_bits(want.total), _bits(got.total))


def test_max_degree_limit_raises():
    """As in the reference: alias offsets must stay exact in float32."""
    pw = make_workload("deepwalk")
    big = type(to_port_graph(ref_random(20, 2, seed=1)))(
        indptr=torch.tensor([0, 1 << 24], dtype=torch.int32),
        indices=torch.zeros(0, dtype=torch.int32), h=torch.zeros(0),
        labels=torch.zeros(0, dtype=torch.int32))
    with pytest.raises(ValueError, match="max degree"):
        build_tables(big, pw, pw.params())


def test_alias_draw_bitwise():
    g = _hand_built()
    pg = to_port_graph(g)
    tables = ref_precomp.build_tables(g, ref_make_workload("deepwalk"), (),
                                      aligned=True)
    ptab = interop.tables_from_arrays(
        tables.cdf, tables.total, tables.invalid,
        alias_off=tables.alias_off, alias_prob=tables.alias_prob)
    rng = np.random.default_rng(5)
    n = 3000
    cur = rng.integers(0, g.num_nodes, size=n)
    cur[:3] = [0, 1, 2]  # the hub, d = 1, the zero-total row
    kd = random_keys(n, seed=6)
    active = np.arange(n) % 7 != 0
    want = ref_precomp.alias_select(
        g, tables, jnp.asarray(cur, jnp.int32),
        jax.random.wrap_key_data(jnp.asarray(kd)),
        active=jnp.asarray(active))
    got = precomp.alias_select(pg, ptab, torch.from_numpy(cur),
                               interop.keys_from_arrays(kd),
                               active=torch.from_numpy(active))
    assert np.array_equal(np.asarray(want), got.numpy())
    assert got[:3].tolist() == [-1, 7, -1]  # inactive, d = 1, zero total
    # the wrapper's CPU dispatch, against the reference's Pallas kernel in
    # interpret mode on a slice
    m = 24
    vs = jnp.asarray(cur[:m], jnp.int32)
    deg = g.indptr[vs + 1] - g.indptr[vs]
    seeds = ref_precomp.threefry_seeds(
        jax.random.wrap_key_data(jnp.asarray(kd[:m])))
    off = ref_ops.alias_pick(tables.prob2d, tables.alias2d, tables.arow0[vs],
                             deg, tables.total[vs], seeds, interpret=True)
    build.reset_launches()
    got_off = alias_pick(pg, ptab, torch.from_numpy(cur[:m]),
                         interop.keys_from_arrays(kd[:m]))
    assert np.array_equal(np.asarray(off), got_off.numpy())
    assert build.LAUNCHES["alias_pick"] == 0  # plain version on the CPU


@pytest.mark.cuda
def test_alias_pick_kernel_matches_plain(cuda_device):
    g = power_law_graph(3000, 10, seed=7)
    pw = make_workload("deepwalk")
    tab = build_tables(g, pw, pw.params())
    rng = np.random.default_rng(8)
    cur = torch.from_numpy(rng.integers(0, g.num_nodes, size=4096))
    keys = torch.from_numpy(random_keys(4096, seed=9).astype(np.int64))
    want = precomp.alias_offsets(g, tab, cur, keys)
    dev = lambda t: t.to(cuda_device)
    gd = g.to(cuda_device)
    tabd = precomp.PrecompTables(*(dev(t) for t in (
        tab.cdf, tab.total, tab.alias_off, tab.alias_prob, tab.invalid)))
    got = alias_pick(gd, tabd, dev(cur), dev(keys))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name,method", [
    ("deepwalk", "its_precomp"), ("deepwalk", "alias_precomp"),
    ("node2vec", "its_precomp"), ("node2vec", "alias_precomp")])
def test_precomp_samplers_staged_match_reference(name, method):
    V = 300
    g = ref_power_law(V, 8, seed=3)
    kw = dict(method=method, tile=32, step_exec="staged")
    ref = RefEngine(g, ref_make_workload(name), RefConfig(**kw)).run(
        np.arange(V), num_steps=6, batch=100, epoch_len=4)
    eng = WalkEngine(power_law_graph(V, 8, seed=3), make_workload(name),
                     EngineConfig(device="cpu", **kw))
    got = eng.run(np.arange(V), num_steps=6, batch=100, epoch_len=4)
    assert np.array_equal(ref.paths, got.paths)
    for f in ("frac_rjs", "frac_precomp", "frac_stale", "rjs_fallbacks",
              "live_steps"):
        assert getattr(ref, f) == getattr(got, f), f
    if name == "node2vec":  # not static: no tables, eRVS for good
        assert eng.precomp is None and got.frac_precomp == 0.0
    else:
        assert got.frac_precomp == 1.0
        # the Vose tables are built only for the sampler that reads them
        assert (eng.precomp.alias_off is None) == (method == "its_precomp")


def test_alias_draw_needs_alias_tables():
    pg = to_port_graph(ref_random(30, 3, seed=1))
    pw = make_workload("deepwalk")
    tab = build_tables(pg, pw, pw.params(), alias=False)
    assert tab.alias_off is None and tab.alias_prob is None
    cur = torch.arange(4)
    keys = torch.zeros((4, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="alias=True"):
        alias_pick(pg, tab, cur, keys)
