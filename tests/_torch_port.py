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
