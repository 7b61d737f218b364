"""Shared helpers of the port's tests (``tests/test_torch_*.py``).

Every port test module imports :func:`one_torch_thread` (autouse): the
suite runs on several xdist workers that share the host's cores with
timing-sensitive tests, so torch is pinned to one intra-op thread while a
port module runs and restored afterwards.  Inputs are made with numpy
from a seed and handed to both packages as arrays.
"""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    """The card, or a skip: CUDA kernels have no CPU mode, and
    ``python3 chip_smoke.py`` holds them against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def to_port_graph(g, device="cpu"):
    """The port's CSRGraph of a reference CSRGraph (arrays handed over)."""
    from repro_torch import interop

    return interop.graph_from_arrays(np.asarray(g.indptr),
                                     np.asarray(g.indices), np.asarray(g.h),
                                     np.asarray(g.labels), device=device)


def random_keys(n: int, seed: int) -> np.ndarray:
    """[n, 2] uint32 raw key data."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n, 2), dtype=np.uint64).astype(
        np.uint32)


def step_keys(seed: int, queries: np.ndarray, steps: np.ndarray) -> np.ndarray:
    """Raw key data of the reference's per-step keys
    ``fold_in(fold_in(key(seed), query), step)`` ([n, 2] uint32)."""
    import jax
    import jax.numpy as jnp

    base = jax.random.key(seed)
    fn = jax.vmap(lambda q, t: jax.random.key_data(jax.random.fold_in(
        jax.random.fold_in(base, q), t)))
    return np.asarray(fn(jnp.asarray(queries, jnp.int32),
                         jnp.asarray(steps, jnp.int32)))


def walk_states(paths: np.ndarray):
    """(query, cur, prev, step) of every state a walk passed through and
    stepped out of: the reference's own walker states."""
    q, t = np.nonzero(paths[:, 1:] >= 0)
    cur = paths[q, t]
    prev = np.where(t > 0, paths[q, np.maximum(t - 1, 0)], -1)
    return q, cur.astype(np.int64), prev.astype(np.int64), t


def node_offsets(indptr, indices, cur, nodes) -> np.ndarray:
    """Row offsets of ``nodes`` in the sorted rows of ``cur``."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices)
    return np.array([np.searchsorted(indices[indptr[v]:indptr[v + 1]], u)
                     for v, u in zip(np.asarray(cur), np.asarray(nodes))],
                    np.int64)


def drive(sched, starts: np.ndarray, deg: np.ndarray):
    """``run()``'s own loop over an epoch scheduler of either package:
    queries in start-degree order into free slots, epochs until every
    query is done.  Returns the scheduler (its end state, paths and
    totals)."""
    queue = np.argsort(deg[starts], kind="stable")
    head = 0
    while head < starts.size or sched.busy:
        free = sched.free_slots()
        if head < starts.size and free.size:
            qs = queue[head:head + free.size]
            head += qs.size
            sched.admit(qs, starts[qs])
        sched.run_epoch()
    return sched


def chi2_critical(df: int, z: float = 3.7) -> float:
    """Wilson–Hilferty upper-tail chi-square quantile (z=3.7 ≈ p 1e-4)."""
    a = 2.0 / (9.0 * df)
    return df * (1.0 - a + z * np.sqrt(a)) ** 3


def chi2_vs_exact(out, p, nbr):
    support = nbr[(nbr >= 0) & (p > 0)]
    probs = p[(nbr >= 0) & (p > 0)]
    assert np.isin(out, support).all(), \
        f"sampled outside the support: {set(out) - set(support)}"
    counts = np.array([(out == v).sum() for v in support])
    expected = probs / probs.sum() * len(out)
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    return chi2, chi2_critical(max(len(support) - 1, 1))


#: row lengths of :func:`scan_rows_graph`: one warp pass and its edges,
#: tiles' edges, and a hub row of 70,000
SCAN_ROW_LENGTHS = (1, 2, 3, 5, 31, 32, 33, 255, 256, 257, 1023, 1025, 4097,
                    70_000)
#: the row kinds of :func:`scan_rows_graph` (see there)
SCAN_ROW_KINDS = ("plain", "mixed", "ties", "dead", "subnormal")


def scan_rows_graph(seed: int, kinds=SCAN_ROW_KINDS,
                    lengths=SCAN_ROW_LENGTHS):
    """Hand-built rows for the plain reservoir scan: (indptr, indices, h,
    labels, nodes, kind of each node's row) as numpy arrays.  For each kind
    and length one row, its start at the next alignment mod 4 (a filler
    row of 1 to 3 edges between); every other node holds 0 to 4 edges.
    Kinds of h: ``plain`` U(0.5, 5); ``mixed`` the same with 0, subnormal
    (1e-40), 1e30 and +inf among them, and one ordinary weight at least;
    ``ties`` a third +inf, so that those keys tie at -0.0 and the lowest
    offset among them wins; ``dead`` zeros only (no key: -1);
    ``subnormal`` 1e-40 only (keys of -inf and of huge finite size)."""
    rng = np.random.default_rng(seed)
    num_nodes = max(lengths) + 3 * len(kinds) * len(lengths) + 2000

    def h_row(kind, d):
        h = rng.uniform(0.5, 5.0, d).astype(np.float32)
        pick = rng.random(d)
        if kind == "mixed":
            h[pick < 0.1] = 0.0
            h[(pick >= 0.1) & (pick < 0.15)] = 1e-40
            h[(pick >= 0.15) & (pick < 0.2)] = 1e30
            h[(pick >= 0.2) & (pick < 0.25)] = np.inf
            h[rng.integers(d)] = rng.uniform(0.5, 5.0)
        elif kind == "ties":
            h[pick < 0.3] = np.inf
            h[rng.integers(d)] = np.inf
        elif kind == "dead":
            h[:] = 0.0
        elif kind == "subnormal":
            h[:] = 1e-40
        return h

    deg = rng.integers(0, 5, num_nodes)
    hs, nodes, node_kind = {}, [], []
    node = start = 0
    for i, (kind, d) in enumerate((k, d) for k in kinds for d in lengths):
        pad = (i - start) % 4
        if pad:
            deg[node] = pad
            start += pad
            node += 1
        deg[node] = d
        hs[node] = h_row(kind, d)
        nodes.append(node)
        node_kind.append(kind)
        start += d
        node += 1
    indptr = np.zeros(num_nodes + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = np.empty(indptr[-1], np.int32)
    h = np.empty(indptr[-1], np.float32)
    for v in range(num_nodes):
        lo, hi = indptr[v], indptr[v + 1]
        indices[lo:hi] = np.sort(rng.choice(num_nodes, hi - lo,
                                            replace=False))
        h[lo:hi] = hs[v] if v in hs else rng.uniform(0.5, 5.0, hi - lo)
    labels = rng.integers(0, 5, indptr[-1]).astype(np.int32)
    return (indptr.astype(np.int32), indices, h, labels, np.array(nodes),
            np.array(node_kind))


def scan_walkers(indptr, indices, nodes, per: int, seed: int):
    """``per`` walkers on each of ``nodes``: (cur, prev, step, raw keys) as
    numpy arrays; prev is a neighbour of cur, -1 or some other row's node,
    step below 80."""
    rng = np.random.default_rng(seed)
    cur = np.repeat(np.asarray(nodes, np.int64), per)
    prev = np.full(cur.size, -1, np.int64)
    for i, c in enumerate(cur):
        pick = rng.random()
        if pick < 0.6:
            row = indices[indptr[c]:indptr[c + 1]]
            prev[i] = row[rng.integers(row.size)]
        elif pick < 0.8:
            prev[i] = nodes[rng.integers(len(nodes))]
    step = rng.integers(0, 80, cur.size).astype(np.int64)
    return cur, prev, step, random_keys(cur.size, seed)
