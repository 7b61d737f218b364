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


#: (trials, rounds) budgets of the eRJS trial tests
ERJS_BUDGETS = ((1, 1), (2, 3), (3, 5), (8, 16), (40, 2))
#: one program of each device rule (``kernels/rules.py``)
ERJS_PROGRAMS = ("deepwalk", "node2vec", "metapath", "2ndpr",
                 "visited_avoiding", "ppr_nibble")
#: row lengths of :func:`erjs_rows_graph` with ordinary weights
ERJS_ROW_LENGTHS = (1, 2, 3, 7, 31, 32, 33, 200, 1500)
#: trials of the pool every walker set is drawn from (the largest budget)
ERJS_POOL_TRIALS = 128
#: walkers of the pool, and of its random part a walker set carries
ERJS_POOL, ERJS_EXTRA = 6144, 40


def erjs_first_accepts(trials: int, rounds: int):
    """First accepting trials a walker set must hold: the first trial, the
    last and first of a round boundary (trials - 1, trials), 31 and 32,
    the last and first of the warp's first 32-trial pass after round 0
    (trials + 31, trials + 32), and the last trial of the budget."""
    budget = trials * rounds
    return sorted({t for t in (0, trials - 1, trials, 31, 32, trials + 31,
                               trials + 32, budget - 1) if 0 <= t < budget})


def erjs_rows_graph(seed: int = 21):
    """Hand-made rows for the eRJS trials: (indptr, indices, h, labels,
    rows, zero_row, empty_node) as numpy.  ``rows``: one node per length
    of ``ERJS_ROW_LENGTHS``, h U(0.5, 5); ``zero_row``: 20 edges of h 0
    (feasible, never accepts); ``empty_node``: no edge.  Every other node
    holds 1 to 4 edges; rows are sorted, labels 0..4."""
    rng = np.random.default_rng(seed)
    num_nodes = 2000
    deg = rng.integers(1, 5, num_nodes)
    rows = np.arange(len(ERJS_ROW_LENGTHS)) * 7 + 3
    deg[rows] = ERJS_ROW_LENGTHS
    zero_row, empty_node = 1, 2
    deg[zero_row], deg[empty_node] = 20, 0
    indptr = np.zeros(num_nodes + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    indices = np.concatenate([np.sort(rng.choice(num_nodes, d, replace=False))
                              for d in deg]).astype(np.int32)
    h = rng.uniform(0.5, 5.0, indices.size).astype(np.float32)
    h[indptr[zero_row]:indptr[zero_row + 1]] = 0.0
    labels = rng.integers(0, 5, indices.size).astype(np.int32)
    return (indptr.astype(np.int32), indices, h, labels, rows, zero_row,
            empty_node)


def _erjs_wstate(name, cur, indptr, indices, rng):
    """numpy program state of walkers at ``cur``: a visited-avoiding ring
    holding the first neighbours of the walker's row (trials onto them
    weigh 0), a PPR-Nibble mass; None for the stateless rules."""
    if name == "visited_avoiding":
        ring = np.full((cur.size, 16), -1, np.int32)
        for i, c in enumerate(cur):
            row = indices[indptr[c]:indptr[c + 1]][:rng.integers(0, 9)]
            ring[i, :row.size] = row
        return ring
    if name == "ppr_nibble":
        return rng.random(cur.size).astype(np.float32)
    return None


_ERJS_POOLS = {}


def erjs_pool(name: str):
    """A pool of walkers on :func:`erjs_rows_graph` for program ``name``
    and each one's first accepting trial under the port's plain
    ``erjs_step`` within ``ERJS_POOL_TRIALS`` trials (-1: none).  Trial t
    draws from counters 2t and 2t + 1 whatever the (trials, rounds)
    split, so one run of one round serves every budget.  Bounds are
    loose: 2 max(h) max(d(v), d(v')) / min(d(v), d(v')) of the row (above
    every rule's weight) times 1, 2, 4, ... 512, so first accepts spread
    over the budget."""
    if name in _ERJS_POOLS:
        return _ERJS_POOLS[name]
    from repro_torch import interop
    from repro_torch.core.erjs import erjs_step
    from repro_torch.walks import make_workload

    indptr, indices, h, labels, rows, _, _ = erjs_rows_graph()
    rng = np.random.default_rng(22)
    n = ERJS_POOL
    cur = rows[rng.integers(0, rows.size, n)].astype(np.int64)
    prev = np.full(n, -1, np.int64)
    deg = np.diff(indptr.astype(np.int64))
    for i, c in enumerate(cur):
        pick = rng.random()
        if pick < 0.6:
            prev[i] = indices[indptr[c] + rng.integers(deg[c])]
        elif pick < 0.8:
            prev[i] = rows[rng.integers(rows.size)]
    step = rng.integers(0, 80, n).astype(np.int64)
    kd = random_keys(n, 23)
    hmax = np.array([h[indptr[c]:indptr[c + 1]].max() for c in cur])
    dv = np.maximum(deg[cur], 1)
    dp = np.maximum(np.where(prev >= 0, deg[np.maximum(prev, 0)], 0), 1)
    bound = (2.0 * hmax * np.maximum(dv, dp) / np.minimum(dv, dp)
             * 2.0 ** rng.integers(0, 10, n)).astype(np.float32)
    ws = _erjs_wstate(name, cur, indptr, indices, rng)
    pw = make_workload(name)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    _, fb, used = erjs_step(
        interop.graph_from_arrays(indptr, indices, h, labels), pw,
        pw.params(), t(cur), t(prev), t(step), interop.keys_from_arrays(kd),
        torch.from_numpy(bound), ERJS_POOL_TRIALS, 1,
        wstate=interop.wstate_from_arrays(ws))
    first = np.where(fb.numpy(), -1, used.numpy() - 1)
    _ERJS_POOLS[name] = pool = dict(
        arrays=(indptr, indices, h, labels), cur=cur, prev=prev, step=step,
        kd=kd, bound=bound, ws=ws, first=first)
    return pool


def erjs_walkers(name: str, trials: int, rounds: int):
    """The eRJS walker set of program ``name`` at a budget: numpy (cur,
    prev, step, raw keys, bound, program state or None, each walker's
    first accepting trial or -1, the proposals it makes, and its kind)
    drawn from
    :func:`erjs_pool`.  Two walkers for each trial of
    ``erjs_first_accepts`` (fewer where the pool has fewer), four that
    fall back (no accept within the budget), two on the row of zero
    weights (they fall back too), infeasible ones: two on the node
    without edges and two of bound 0; and ``ERJS_EXTRA`` random pool
    walkers, so that warps mix all of them."""
    pool = erjs_pool(name)
    _, _, _, _, _, zero_row, empty_node = erjs_rows_graph()
    budget = trials * rounds
    first = pool["first"]
    rng = np.random.default_rng(24)
    pick, kind = [], []
    for t in erjs_first_accepts(trials, rounds):
        got = np.nonzero(first == t)[0][:2]
        pick += got.tolist()
        kind += [f"accept@{t}"] * got.size
    late = np.nonzero((first < 0) | (first >= budget))[0][:4]
    pick += late.tolist()
    kind += ["fallback"] * late.size
    extra = rng.choice(first.size, ERJS_EXTRA, replace=False)
    pick += extra.tolist()
    kind += ["random"] * ERJS_EXTRA
    sel = np.array(pick)
    cur, prev, step = (pool[k][sel].copy() for k in ("cur", "prev", "step"))
    kd, bound = pool["kd"][sel].copy(), pool["bound"][sel].copy()
    ws = None if pool["ws"] is None else pool["ws"][sel].copy()
    acc = np.where((first[sel] >= 0) & (first[sel] < budget), first[sel], -1)
    used = np.where(acc >= 0, acc + 1, budget)
    # the special walkers take over copies of random ones
    special = [("zero_row", zero_row, None), ("zero_row", zero_row, None),
               ("no_edges", empty_node, None), ("no_edges", empty_node, None),
               ("bound_0", None, 0.0), ("bound_0", None, 0.0)]
    n0 = len(pick) - ERJS_EXTRA
    for j, (what, node, b) in enumerate(special):
        i = n0 + j
        if node is not None:
            cur[i] = node
        if b is not None:
            bound[i] = b
        acc[i] = -1
        used[i] = budget if what == "zero_row" else 0
        kind[i] = what
    return dict(cur=cur, prev=prev, step=step, kd=kd, bound=bound, ws=ws,
                first=acc, used=used.astype(np.int32), kind=np.array(kind),
                arrays=pool["arrays"])


#: row lengths the table draws (K3's fence search, K5's pair table) treat
#: apart: inside one 16-entry CDF block, up to one block boundary or two,
#: and a hub row
TABLE_ROW_LENGTHS = (1, 15, 16, 17, 31, 32, 33)
TABLE_HUB_LENGTH = 70_000
#: kinds of h on those rows
TABLE_ROW_KINDS = ("plain", "integer", "plateaus")
#: Threefry key data whose ITS uniform (counters (0, ITS_SALT)) is the
#: largest there is, or the next: u * total rounds to the total there
TOP_UNIFORM_KEYS = ((3548999674, 2852473753), (1340893859, 2687700512),
                    (3806207594, 4073675450), (2517282670, 191853300),
                    (3814126426, 3399421186), (3963285522, 1958224422))


def table_rows_graph(kind: str, seed: int):
    """Hand-built rows for the table draws: (indptr, indices, h, labels) as
    numpy arrays.  For each length of ``TABLE_ROW_LENGTHS`` 32 rows one
    after another (a row of one edge before each where the length is a
    multiple of 16), so that their starts take every residue mod 16 and
    mod 32, and most rows share their first CDF block with the row before;
    then a row of ``TABLE_HUB_LENGTH`` edges, and empty rows and rows of
    zero total.  Kinds of h: ``plain`` U(0.5, 5); ``integer`` 1 to 3
    (targets land on CDF values exactly); ``plateaus`` U(0.5, 5) with runs
    of 1 to 40 zeros, which cross block boundaries, and rows ending in
    zeros."""
    rng = np.random.default_rng(seed)
    deg = []
    for d in TABLE_ROW_LENGTHS:
        for i in range(32):
            if d % 16 == 0:
                deg.append(1)
            deg.append(d)
    deg.append(TABLE_HUB_LENGTH)
    # empty rows, each before a row of zero total
    deg = np.array(deg + [0, 1, 0, 15, 0, 33, 0, 3], np.int64)
    V = deg.size
    indptr = np.zeros(V + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    E = int(indptr[-1])
    if kind == "integer":
        h = rng.integers(1, 4, E).astype(np.float32)
    else:
        h = rng.uniform(0.5, 5.0, E).astype(np.float32)
    if kind == "plateaus":
        at = 0
        while at < E:
            at += int(rng.integers(1, 40))
            run = int(rng.integers(1, 41))
            h[at:at + run] = 0.0
            at += run
        for v in range(1, V, 5):  # rows ending in zeros
            lo, hi = indptr[v], indptr[v + 1]
            h[max(lo + 1, hi - 3):hi] = 0.0
    zero_total = [v for v in range(1, V) if deg[v] and deg[v - 1] == 0]
    for v in zero_total:
        h[indptr[v]:indptr[v + 1]] = 0.0
    indices = np.concatenate(
        [np.sort(rng.integers(0, V, d)) for d in deg]).astype(np.int32)
    labels = np.zeros(E, np.int32)
    return indptr.astype(np.int32), indices, h, labels


def table_walkers(indptr, per: int, seed: int):
    """Walkers on every row: ``per`` with random keys and one with each of
    ``TOP_UNIFORM_KEYS``, 200 more with random keys on the largest row:
    (cur, raw key data [n, 2] uint32) as numpy arrays."""
    deg = np.diff(np.asarray(indptr, np.int64))
    V = deg.size
    top = np.asarray(TOP_UNIFORM_KEYS, np.uint32)
    cur = np.concatenate([np.repeat(np.arange(V), per),
                          np.repeat(np.arange(V), top.shape[0]),
                          np.full(200, int(np.argmax(deg)))])
    kd = np.concatenate([random_keys(V * per, seed), np.tile(top, (V, 1)),
                         random_keys(200, seed + 1)])
    return cur.astype(np.int64), kd


#: row lengths K6's tables and walk treat apart: one weight, a 16-chunk,
#: a 32-window and their edges, a tile and its edges, two tiles and one
#: more weight; and a hub
BLOCK_ROW_LENGTHS = (1, 16, 17, 32, 33, 1023, 1024, 1025, 2049)
BLOCK_HUB_LENGTH = 20_000
#: kinds of weights on those rows
BLOCK_ROW_KINDS = ("uniform", "plateaus", "pareto")


def block_rows(kind: str, seed: int):
    """K6's hand-built rows: (values, indptr) as numpy arrays, two rows of
    each of ``BLOCK_ROW_LENGTHS`` and one of ``BLOCK_HUB_LENGTH``.  In the
    aligned layout a last tile spans the stream rows of the rows after it,
    whose positive weights it must not read.  Kinds: ``uniform`` U(0.1,
    5); ``plateaus`` the same with runs of zeros that straddle 16-chunk
    and 32-window boundaries (positions 14-18, 30-34, 47-49, 250-262, 1020
    -1030 of every tile), weights of 1e-7 to 1e-4 at the other 16-chunk
    starts past position 256 (where the base-16 prefix sums associate
    differently, so they fall below the one before) and one row of zeros;
    ``pareto`` heavy tails."""
    rng = np.random.default_rng(seed)
    deg = np.array([d for d in BLOCK_ROW_LENGTHS for _ in range(2)]
                   + [BLOCK_HUB_LENGTH], np.int64)
    indptr = np.zeros(deg.size + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    E = int(indptr[-1])
    if kind == "pareto":
        vals = (rng.pareto(1.2, E) + 0.05).astype(np.float32)
    else:
        vals = rng.uniform(0.1, 5.0, E).astype(np.float32)
    if kind == "plateaus":
        within = np.arange(E) - np.repeat(indptr[:-1], deg)
        p = within % 1024
        runs = ((p >= 14) & (p <= 18)) | ((p >= 30) & (p <= 34)) \
            | ((p >= 47) & (p <= 49)) | ((p >= 250) & (p <= 262)) \
            | (p >= 1020)
        vals[runs] = 0.0
        # tiny weights at the 16-chunk starts past the first 256 of a
        # tile, where the prefix sum may fall below the one before
        tiny = (p >= 256) & (p % 16 == 0) & ~runs
        vals[tiny] = rng.uniform(1e-7, 1e-4, int(tiny.sum())).astype(
            np.float32)
        vals[indptr[8]:indptr[9]] = 0.0  # a row of 33 zeros
    return vals, indptr


def block_walkers(n_rows: int, seed: int):
    """Node indices of K6's walkers on ``n_rows`` rows: two on every row,
    60 on the last (the hub), 20 on the row of 2,049, in a random
    order."""
    rng = np.random.default_rng(seed)
    nodes = np.concatenate([np.repeat(np.arange(n_rows), 2),
                            np.full(60, n_rows - 1), np.full(20, n_rows - 2)])
    return rng.permutation(nodes)


def clipped_block_inputs(seed: int):
    """(w2d [64, 128] float32, row0, degs) of walkers whose rows start
    before the stream, past it, or run past its end, several on each
    (row0, deg), some sharing a row0 with another degree; a fifth of the
    weights zero."""
    rng = np.random.default_rng(seed)
    w2d = rng.uniform(0.1, 5.0, (64, 128)).astype(np.float32)
    w2d[rng.random(w2d.shape) < 0.2] = 0.0
    r0, dg = np.meshgrid([-20, -1, 0, 3, 56, 60, 63, 70],
                         [1, 17, 300, 1024, 1500, 3000])
    r0 = np.repeat(r0.ravel(), 3).astype(np.int32)
    dg = np.repeat(dg.ravel(), 3).astype(np.int32)
    return w2d, r0, dg


def ervs_model(w2d, row0, degs, seeds):
    """A plain-torch model of K6's decision order: per walker, the tile
    sums of ``ref.ervs_tile_tables_ref`` retire tiles, and a crossing's
    hit is the first p >= first with M[p] >= target (a sorted search of
    M, continued from the last hit), position 0 when there is none.
    Returns (offset, draws, jumped) [W] int32, as ``ref.ervs_select_ref``
    does."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.prng import uniform_pair_01

    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    flat = w2d.reshape(-1)
    R = flat.numel() // ref.LANES
    out = np.zeros((3, row0.numel()), np.int32)
    for i in range(row0.numel()):
        deg = int(degs[i])
        sums, firsts, m = ref.ervs_tile_tables_ref(w2d, row0[i:i + 1],
                                                   degs[i:i + 1])
        best_lk, t_rem = f32(float("-inf")), f32(0.0)
        best_off, draws, jumped = -1, 0, 0
        for t in range(sums.numel()):
            s = sums[t]
            if not (bool(s >= t_rem) and bool(s > 0)):
                t_rem = t_rem - s
                jumped += 1
                continue
            valid = min(deg - t * ref.TILE, ref.TILE)
            row_t = int(row0[i]) + t * ref.SUBLANES
            w_at = lambda p: flat[min(max(row_t + p // ref.LANES, 0), R - 1)
                                  * ref.LANES + p % ref.LANES]
            mt = m[t * ref.TILE:t * ref.TILE + valid]
            first = int(firsts[t])
            lo = valid if first < 0 else first
            base = f32(0.0)
            while bool(s - base >= t_rem):
                target = base + t_rem
                a = lo + int(torch.searchsorted(mt[lo:valid], target))
                if a < valid:
                    pos, base, lo = a, mt[a], a
                else:
                    pos, base = 0, w_at(0)
                    lo = valid if first < 0 else first
                w_m = w_at(pos)
                u1, u2 = uniform_pair_01(seeds[i:i + 1, 0], seeds[i:i + 1, 1],
                                         draws, ref.ERVS_SALT)
                t_w = ref.xla_exp((w_m * best_lk).clamp(-80.0, 0.0))
                uu = u1 if bool(best_lk == float("-inf")) else \
                    ref.fma32(u1, f32(1.0) - t_w, t_w)
                lk_new = ref.xla_log(uu.clamp(1e-38, 1.0)) \
                    / torch.clamp(w_m, min=1e-30)
                t_rem = (ref.xla_log(u2) / torch.clamp(lk_new, max=-1e-30))[0]
                best_lk, best_off = lk_new[0], t * ref.TILE + pos
                draws += 1
            t_rem = t_rem - (s - base)
        out[:, i] = best_off, draws, jumped
    return tuple(torch.from_numpy(x) for x in out)


#: row lengths the aligned K3 treats apart: one sector (1-8), one block
#: (9-16), one more entry, and rows of several blocks and 128-lane rows;
#: and a hub
ALIGNED_ROW_LENGTHS = tuple(range(1, 18)) + (127, 128, 129)
ALIGNED_HUB_LENGTH = 70_000
#: kinds of values on those rows
ALIGNED_ROW_KINDS = ("cdf", "raw", "integer")


def aligned_rows(kind: str, seed: int):
    """(values, indptr, totals): two rows of each of
    ``ALIGNED_ROW_LENGTHS`` and one of ``ALIGNED_HUB_LENGTH``.  ``cdf``:
    inclusive prefix sums of U(0.5, 5) weights with zeros at positions
    14-18 and 30-34 of every 16 (plateaus across block boundaries), the
    row's last entry its total; ``integer``: the same of weights 1 to 3
    (targets land on entries); ``raw``: the weights themselves with random
    totals, so rows are not monotone."""
    rng = np.random.default_rng(seed)
    deg = np.array([d for d in ALIGNED_ROW_LENGTHS for _ in range(2)]
                   + [ALIGNED_HUB_LENGTH], np.int64)
    indptr = np.zeros(deg.size + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    E = int(indptr[-1])
    w = (rng.integers(1, 4, E) if kind == "integer"
         else rng.uniform(0.5, 5.0, E)).astype(np.float32)
    within = np.arange(E) - np.repeat(indptr[:-1], deg)
    if kind != "raw":
        w[(within % 32 >= 14) & (within % 32 <= 18)] = 0.0
        w[(within % 64 >= 30) & (within % 64 <= 34)] = 0.0
    if kind == "raw":
        vals = w
        totals = rng.uniform(0.5, 5.0, deg.size).astype(np.float32)
    else:
        vals = np.concatenate([np.cumsum(w[a:b], dtype=np.float32)
                               for a, b in zip(indptr[:-1], indptr[1:])])
        totals = vals[indptr[1:] - 1]
    return vals, indptr, totals


def aligned_walkers(n_rows: int, totals, seed: int):
    """Node indices, totals (some zero) and seeds (raw key data, uint32):
    8 random keys and every ``TOP_UNIFORM_KEYS`` on each row, 200 more on
    the hub (the last row)."""
    top = np.asarray(TOP_UNIFORM_KEYS, np.uint32)
    nodes = np.concatenate([np.repeat(np.arange(n_rows), 8 + len(top)),
                            np.full(200, n_rows - 1)])
    kd = np.concatenate([
        np.concatenate([random_keys(8, seed + v), top]) for v in
        range(n_rows)] + [random_keys(200, seed - 1)])
    tot = totals[nodes].copy()
    tot[::23] = 0.0
    return nodes, tot, kd


def clipped_aligned_inputs(seed: int):
    """(values [64, 128] float32 of U(0, 5), row0, degs, totals, seeds as
    raw key data): walkers on rows that start before the stream, past it,
    or run past its end, and inside it, six on each (row0, deg)."""
    rng = np.random.default_rng(seed)
    v2d = rng.uniform(0.0, 5.0, (64, 128)).astype(np.float32)
    r0, dg = np.meshgrid([-20, -1, 0, 62, 63, 64, 70],
                         [1, 8, 9, 16, 17, 129, 300])
    r0 = np.repeat(r0.ravel(), 6).astype(np.int32)
    dg = np.repeat(dg.ravel(), 6).astype(np.int32)
    tot = rng.uniform(0.5, 5.0, r0.size).astype(np.float32)
    return v2d, r0, dg, tot, random_keys(r0.size, seed + 1)


def offset_stream(n_floats: int, offset_bytes: int, device="cpu"):
    """A zeroed float32 view of ``n_floats`` on ``device`` whose base lies
    ``offset_bytes`` past a 32 B boundary."""
    buf = torch.zeros(n_floats + 16, device=device)
    skip = ((offset_bytes - buf.data_ptr()) % 32) // 4
    view = buf[skip:skip + n_floats]
    assert view.data_ptr() % 32 == offset_bytes
    return view


def its_aligned_model(cdf2d, row0, degs, totals, seeds):
    """A plain model of the decision order of K3's aligned entry
    (``csrc/its.cuh`` ``its_aligned_offset``), one walker at a time: a row
    of at most 8 entries searched from the bits of its first 8 (``x <=
    target``), of 9 to 16 from its first 16; a longer row, or one clipped
    at the stream's ends, searched a clipped probe at a time.  Returns
    (offset [W] int32, each walker's path: "empty", "clipped", "sector",
    "block" or "long")."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.prng import uniform_01

    flat = cdf2d.reshape(-1).numpy()
    last = flat.size - 1
    target = (uniform_01(seeds[:, 0], seeds[:, 1], 0, ref.ITS_SALT)
              * totals).numpy()
    bits = lambda x, t: sum(1 << j for j, v in enumerate(x) if v <= t)

    def search_bits(le, lo, hi, levels):
        for _ in range(levels):
            mid = (lo + hi) >> 1
            if lo < hi:
                lo, hi = (mid + 1, hi) if (le >> mid) & 1 else (lo, mid)
        return lo

    out, paths = np.full(row0.numel(), -1, np.int32), []
    for i in range(row0.numel()):
        d, s, t = int(degs[i]), int(row0[i]) * ref.LANES, target[i]
        if d <= 0 or not bool(totals[i] > 0):
            paths.append("empty")
            continue
        if d > 16 or s < 0 or s + d - 1 > last:
            lo, hi = 0, d
            while lo < hi:
                mid = (lo + hi) >> 1
                if flat[min(max(s + mid, 0), last)] <= t:
                    lo = mid + 1
                else:
                    hi = mid
            paths.append("long" if 0 <= s and s + d - 1 <= last
                         else "clipped")
        else:
            n = 8 if d <= 8 else 16
            lo = search_bits(bits(flat[s:s + n], t), 0, d, 4 if n == 8 else 5)
            paths.append("sector" if n == 8 else "block")
        out[i] = min(lo, d - 1)
    return torch.from_numpy(out), paths


#: keys whose scalar jax uniform (counter 0, minval 0) is the largest there
#: is, 1 - 2^-23: ITS's target u * total then lies within an ulp or two of
#: the total, where the prefixes past the row's end take part in the count
TOP_BASELINE_KEYS = ((306217251, 1215394579), (2528959559, 2728799781),
                     (846369703, 2509441180), (3229793556, 3076456588),
                     (2406160195, 1509383560), (3556267319, 1022211501))
#: entries of the star row of :func:`baseline_rows_graph`: its base-16
#: scan has four levels (5,000 -> 313 -> 20 -> 2)
BASELINE_STAR_LENGTH = 5_000


def baseline_rows_graph(seed: int, nodes: int = 480, star: bool = True):
    """Rows for the baseline samplers: (indptr, indices, h, labels) as
    numpy.  ``nodes`` nodes of 1 to 24 sorted neighbours, h Pareto(1)
    with a fifth of the weights 0 (plateaus in the prefix sums), labels
    0..4; with ``star``, the last node's row has
    :data:`BASELINE_STAR_LENGTH` entries over the other nodes (sorted,
    repeats allowed), and node 0 has no edge."""
    rng = np.random.default_rng(seed)
    V = nodes + int(star)
    deg = rng.integers(1, 25, V)
    deg[0] = 0
    if star:
        deg[-1] = BASELINE_STAR_LENGTH
    indptr = np.zeros(V + 1, np.int64)
    indptr[1:] = np.cumsum(deg)
    rows = [np.sort(rng.choice(V, d, replace=False)) if d <= 24
            else np.sort(rng.integers(1, nodes, d)) for d in deg]
    indices = np.concatenate(rows).astype(np.int32)
    E = indices.size
    h = (rng.pareto(1.0, E) * (rng.random(E) >= 0.2)).astype(np.float32)
    labels = rng.integers(0, 5, E).astype(np.int32)
    return indptr.astype(np.int32), indices, h, labels


def baseline_walkers(indptr, indices, n: int, seed: int, window: int = 16):
    """n walkers on the rows of :func:`baseline_rows_graph` (a tenth on the
    last row, the star where there is one; a tenth just arrived from it;
    the first six with :data:`TOP_BASELINE_KEYS`): (cur, prev, step,
    raw keys [n, 2] uint32, visited rings [n, window] int32) as numpy."""
    rng = np.random.default_rng(seed)
    V = indptr.size - 1
    cur = rng.integers(0, V, n)
    cur[::10] = V - 1
    prev = rng.integers(-1, V, n)
    prev[1::10] = V - 1
    step = rng.integers(0, 12, n)
    keys = random_keys(n, seed)
    keys[:len(TOP_BASELINE_KEYS)] = TOP_BASELINE_KEYS
    ring = rng.integers(-1, V, (n, window)).astype(np.int32)
    for i in range(0, n, 3):  # rings holding the walker's own neighbours
        row = indices[indptr[cur[i]]:indptr[cur[i] + 1]][:window // 2]
        ring[i, :row.size] = row
    return cur, prev, step, keys, ring


def its_row_model(w: np.ndarray, pad: int):
    """K9's arithmetic on one row (``csrc/baselines.cuh``), in Python
    float32: (the row's prefixes [n], the prefix at ``pad`` - 1, the
    padded positions' groups [(value, positions)]).  The upper levels
    hold the 16-chunk sums level by level; a prefix is its chunk's
    sequential prefix plus the level above's prefix at chunk - 1; the
    padded positions [n, pad) form one group of equal prefixes per level
    they reach."""
    f32 = np.float32
    levs = [[f32(x) for x in w]]
    while len(levs[-1]) > 16:
        src = levs[-1]
        levs.append([_seq_sum(src[c:c + 16]) for c in range(0, len(src), 16)])
    K = len(levs) - 1
    top = _seq_sum(levs[K])

    def level(k):
        return levs[k] if k <= K else [top]

    def chunk_prefix(k, j):
        lv = level(k)
        c0 = j // 16 * 16
        return f32(0) if c0 >= len(lv) else _seq_sum(lv[c0:min(j, len(lv) - 1)
                                                        + 1])

    def chain(k, j):
        terms = [chunk_prefix(k, j)]
        while j // 16 >= 1:
            j, k = j // 16 - 1, k + 1
            terms.append(chunk_prefix(k, j))
        acc = f32(terms[-1] + f32(0))
        for t in reversed(terms[:-1]):
            acc = f32(t + acc)
        return acc

    n = len(w)
    prefixes = [chain(0, j) for j in range(n)]
    groups, his = [], []
    lo, hi, k = n, pad - 1, 0
    while lo <= hi:
        a, b = lo, min(lo // 16 * 16 + 15, hi)
        for kk in range(k - 1, -1, -1):
            a, b = 16 * (a + 1), min(16 * (b + 1) + 15, his[kk])
        groups.append((chain(k, lo), b - a + 1))
        if hi // 16 - 1 < lo // 16:
            break
        his.append(hi)
        lo, hi, k = lo // 16, hi // 16 - 1, k + 1
    return prefixes, chain(0, pad - 1), groups


def _seq_sum(xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = np.float32(acc + x)
    return acc
