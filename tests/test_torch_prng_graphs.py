"""Port parity, part 1: the Threefry generator and the graph substrate.

Bitwise against the reference on the same inputs: Threefry bits and both
uniform maps on 10^5 counters, jax's fold_in / bits / uniform semantics,
the per-query stream keys, generated graph arrays, node statistics, and
the has_edge / dist_code search.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, random_keys  # noqa: F401
from repro.core.types import WalkerState as RefWalkerState
from repro.graphs.csr import dist_code as ref_dist_code
from repro.graphs import has_edge as ref_has_edge
from repro.graphs import node_stats as ref_node_stats
from repro.graphs import power_law_graph as ref_power_law
from repro.graphs import random_graph as ref_random_graph
from repro.kernels import prng as ref_prng
from repro_torch.core.types import WalkerState
from repro_torch.graphs import (dist_code, has_edge, node_stats,
                                power_law_graph, random_graph, row_scan)
from repro_torch.kernels import prng

N = 100_000


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_threefry_bits_match_reference():
    k = random_keys(N, 0)
    c = random_keys(N, 1)
    r0, r1 = ref_prng.threefry2x32(k[:, 0], k[:, 1], c[:, 0], c[:, 1])
    p0, p1 = prng.threefry2x32(_t(k[:, 0]), _t(k[:, 1]), _t(c[:, 0]),
                               _t(c[:, 1]))
    assert np.array_equal(np.asarray(r0), p0.numpy())
    assert np.array_equal(np.asarray(r1), p1.numpy())


def test_uniform_01_matches_reference_bitwise():
    k = random_keys(N, 2)
    ctr = np.arange(N, dtype=np.uint32)
    want = np.asarray(ref_prng.uniform_01(k[:, 0], k[:, 1], np.uint32(0),
                                          ctr))
    got = prng.uniform_01(_t(k[:, 0]), _t(k[:, 1]), 0, _t(ctr)).numpy()
    assert np.array_equal(want.view(np.uint32), got.view(np.uint32))


def test_jax_fold_in_bits_and_uniform_match():
    """fold_in on 10^5 (key, data) pairs; bits and uniform(minval=1e-12)
    on 100 keys x 1000 counters; the scalar draw on 10^5 keys."""
    kd = random_keys(N, 3)
    data = np.random.default_rng(4).integers(0, 1 << 31, N).astype(np.int32)
    keys = jax.random.wrap_key_data(jnp.asarray(kd))
    want = np.asarray(jax.vmap(lambda k, d: jax.random.key_data(
        jax.random.fold_in(k, d)))(keys, jnp.asarray(data)))
    got = prng.fold_in(_t(kd), _t(data)).numpy()
    assert np.array_equal(want, got)

    few, pk = keys[:100], _t(kd[:100])
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (1000,)))(few))
    assert np.array_equal(bits, prng.random_bits(pk, 1000).numpy())
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (1000,), jnp.float32, minval=1e-12, maxval=1.0))(few))
    assert np.array_equal(u.view(np.uint32),
                          prng.uniform(pk, 1000).numpy().view(np.uint32))

    us = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (), jnp.float32, minval=1e-12, maxval=1.0))(keys))
    assert np.array_equal(us.view(np.uint32),
                          prng.uniform(_t(kd)).numpy().view(np.uint32))


def test_uniform_map_edges():
    """All-zero bits give exactly minval; all-one bits stay below 1."""
    ends = torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64)
    u = prng.uniform_from_bits(ends)
    assert u[0].item() == np.float32(1e-12)
    assert 0.0 < u[1].item() < 1.0


@pytest.mark.parametrize("seed", [0, 7, 123456, 2**31 - 1])
def test_key_data_of_seed(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    assert np.array_equal(want, prng.key_data(seed).numpy())


def test_stream_keys_match_reference():
    W = 257
    key = jax.random.key(5)
    ids = np.arange(1000, 1000 + W)
    steps = np.random.default_rng(6).integers(0, 80, W)
    rng = RefWalkerState.stream_key_data(key, jnp.asarray(ids, jnp.int32))
    ref = RefWalkerState(cur=jnp.zeros(W, jnp.int32),
                         prev=jnp.zeros(W, jnp.int32),
                         step=jnp.asarray(steps, jnp.int32),
                         alive=jnp.ones(W, bool), rng=rng)
    want = np.asarray(jax.vmap(jax.random.key_data)(ref.stream_keys()))
    prng_key = prng.key_data(5)
    port_rng = WalkerState.stream_key_data(prng_key, _t(ids))
    assert np.array_equal(np.asarray(rng), port_rng.numpy())
    st = WalkerState(cur=torch.zeros(W, dtype=torch.int64),
                     prev=torch.zeros(W, dtype=torch.int64), step=_t(steps),
                     alive=torch.ones(W, dtype=torch.bool), rng=port_rng)
    assert np.array_equal(want, st.stream_keys().numpy())


GRAPHS = [
    ("powerlaw", dict(num_nodes=500, avg_degree=8, weight_dist="uniform",
                      seed=1)),
    ("powerlaw", dict(num_nodes=300, avg_degree=12, weight_dist="pareto",
                      seed=2)),
    ("random", dict(num_nodes=400, avg_degree=6, weight_dist="degree",
                    seed=3)),
]


@pytest.fixture(scope="module", params=GRAPHS, ids=lambda g: g[1]["weight_dist"])
def graph_pair(request):
    kind, kw = request.param
    ref = (ref_power_law if kind == "powerlaw" else ref_random_graph)(**kw)
    port = (power_law_graph if kind == "powerlaw" else random_graph)(**kw)
    return ref, port


def test_generators_give_reference_arrays(graph_pair):
    ref, port = graph_pair
    for field in ("indptr", "indices", "h", "labels"):
        want = np.asarray(getattr(ref, field))
        got = getattr(port, field).numpy()
        assert want.dtype == got.dtype, field
        assert np.array_equal(want.view(np.uint32), got.view(np.uint32)), \
            field


def test_node_stats_match_reference(graph_pair):
    """Every field bitwise, h_sum and h_mean included (tolerance 0): both
    sides add a row's weights one by one in float32, in edge order —
    XLA's CPU segment_sum does, and the port's row_scan reproduces it."""
    ref, port = graph_pair
    want = ref_node_stats(ref, num_labels=5)
    got = node_stats(port, num_labels=5)
    for field in ("h_min", "h_max", "h_sum", "h_mean", "degree",
                  "label_count"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert np.array_equal(w.view(np.uint32), g.view(np.uint32)), field


def test_has_edge_and_dist_code_match_reference(graph_pair):
    ref, port = graph_pair
    V = port.num_nodes
    rng = np.random.default_rng(7)
    n = 3000
    v = rng.integers(-1, V, n)
    u = rng.integers(0, V, n)
    indptr = port.indptr.numpy()
    # a third of the pairs are real edges, some are u == v
    deg = np.diff(indptr)
    real = rng.random(n) < 0.33
    vv = np.maximum(v, 0)
    off = (rng.random(n) * np.maximum(deg[vv], 1)).astype(np.int64)
    u = np.where(real & (deg[vv] > 0) & (v >= 0),
                 port.indices.numpy()[np.minimum(indptr[vv] + off,
                                                 port.num_edges - 1)], u)
    u[::17] = np.maximum(v[::17], 0)
    want_e = np.asarray(ref_has_edge(ref, jnp.asarray(v, jnp.int32),
                                     jnp.asarray(u, jnp.int32)))
    want_d = np.asarray(ref_dist_code(ref, jnp.asarray(v, jnp.int32),
                                      jnp.asarray(u, jnp.int32)))
    assert np.array_equal(want_e, has_edge(port, _t(v), _t(u)).numpy())
    assert np.array_equal(want_d, dist_code(port, _t(v), _t(u)).numpy())
    assert want_e.any() and (want_d == 0).any() and (want_d == 2).any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_row_scan_is_sequential_cumsum_per_row(dtype):
    """Short rows (position-major) and long rows (np.cumsum) both give each
    row's own sequential cumsum, bit for bit."""
    rng = np.random.default_rng(8)
    deg = np.concatenate([rng.integers(0, 9, 300), [0, 40, 300, 1]])
    indptr = np.concatenate([[0], np.cumsum(deg)])
    vals = rng.pareto(1.5, indptr[-1]).astype(dtype)
    got = row_scan(vals, indptr, dtype, long_row=32)
    for v in range(deg.size):
        s, e = indptr[v], indptr[v + 1]
        want = np.cumsum(vals[s:e], dtype=dtype)
        assert np.array_equal(want, got[s:e]), v
