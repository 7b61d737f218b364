"""Port parity, part 9: the standalone kernel ops on the tile-aligned layout
(``repro_torch.kernels.ops`` / ``ref`` against ``repro.kernels.ops`` /
``ref``).

* the aligned layouts (plain CSR, the overlay layout, ``bucket_rows``,
  the precomp tables' streams) bitwise;
* XLA's CPU sum and prefix-sum orders and its float32 exp / log, bitwise
  against ``jnp`` on random inputs;
* K6's plain version (block-jump eRVS) against ``ervs_select_ref``: offset,
  draws and jumped bitwise except, by contract, at a walker where some
  decision's two sides lie within 2 ulp (checked in float64); the
  exact-match rate is printed (it is 1.000000 on every case here);
  fig12a's own inputs give the reference's draw and jump means;
* K7's plain version (bound-based eRJS), the aligned ITS and alias draws
  and ``make_seeds``, bitwise;
* the reference's Pallas kernels in interpret mode on a few walkers;
* a chi-square of ``ops.ervs_select`` and of the semantic oracle against
  the exact probabilities;
* on the card (``cuda`` marker; skips here): K6, K7 and the aligned K3 /
  K5 entries against their plain versions, bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cuda_device, one_torch_thread  # noqa: F401
from repro.core import precomp as ref_precomp
from repro.graphs import power_law_graph as ref_power_law
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.walks import make_workload as ref_make_workload
from repro_torch import interop
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.prng import key_data

DEGREES = (1, 127, 128, 1023, 1024, 1025, 4096, 20_000)


def _rows(degs, dist: str, seed: int):
    """(values, indptr) of rows of the given degrees: uniform, Pareto, or
    uniform with a fifth of the weights zero."""
    rng = np.random.default_rng(seed)
    degs = np.asarray(degs, np.int64)
    indptr = np.zeros(degs.size + 1, np.int64)
    np.cumsum(degs, out=indptr[1:])
    E = int(indptr[-1])
    if dist == "pareto":
        vals = (rng.pareto(1.2, E) + 0.05).astype(np.float32)
    else:
        vals = rng.uniform(0.1, 5.0, E).astype(np.float32)
    if dist == "zeros":
        vals[rng.random(E) < 0.2] = 0.0
    return vals, indptr


def _both(vals, indptr):
    """The aligned layout in both packages (reference jnp, port torch)."""
    r = rops.align_rows(vals, indptr)
    p = ops.align_rows(vals, indptr, device="cpu")
    return r, p


def _seeds(key: int, n: int):
    s = np.asarray(rops.make_seeds(jax.random.key(key), n))
    return s, torch.from_numpy(s.astype(np.int64))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------- layout
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_align_rows_bitwise(dtype):
    vals, indptr = _rows([0, 5, 127, 128, 129, 0, 300, 1024, 3], "uniform", 1)
    vals = (vals * 100).astype(dtype)
    for a, b in zip(rops.align_rows(vals, indptr, dtype=dtype),
                    ops.align_rows(vals, indptr, dtype=dtype, device="cpu")):
        assert a.dtype == _np(b).dtype
        np.testing.assert_array_equal(np.asarray(a), _np(b))


@pytest.mark.parametrize("bucket_rows", [False, True])
def test_align_rows_overlay_layout_bitwise(bucket_rows):
    """Rows gathered from explicit spans with dead space between them (the
    overlay layout), R bucketed to a power of two or not."""
    rng = np.random.default_rng(2)
    degs = np.array([3, 0, 200, 17, 129, 1, 0, 640])
    gaps = rng.integers(0, 50, degs.size)
    starts = np.cumsum(np.concatenate([[0], degs[:-1] + gaps[:-1]]))
    vals = rng.uniform(0, 1, int(starts[-1] + degs[-1] + 10)).astype(
        np.float32)
    order = rng.permutation(degs.size)  # spans need not be in node order
    starts, degs = starts[order], degs[order]
    ref_out = rops.align_rows_layout(vals, starts, degs,
                                     bucket_rows=bucket_rows)
    got = ops.align_rows_layout(vals, starts, degs, bucket_rows=bucket_rows,
                                device="cpu")
    for a, b in zip(ref_out, got):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


def test_graph_aligned_weights_and_precomp_tables_bitwise():
    g = ref_power_law(300, 9, weight_dist="pareto", seed=7)
    wl = ref_make_workload("deepwalk")
    tables = ref_precomp.build_tables(g, wl, wl.params())
    pg = interop.graph_from_arrays(np.asarray(g.indptr), np.asarray(g.indices),
                                   np.asarray(g.h), np.asarray(g.labels))
    for a, b in zip(rops.graph_aligned_weights(g),
                    ops.graph_aligned_weights(pg)):
        np.testing.assert_array_equal(np.asarray(a), _np(b))
    pt = interop.tables_from_arrays(
        np.asarray(tables.cdf), np.asarray(tables.total),
        np.asarray(tables.invalid), alias_off=np.asarray(tables.alias_off),
        alias_prob=np.asarray(tables.alias_prob))
    want = rops.aligned_precomp_tables(tables, np.asarray(g.indptr))
    got = ops.aligned_precomp_tables(pt, pg.indptr)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), _np(b))


def test_align_rows_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        ops.align_rows(np.ones(3, np.float32), np.array([0, 3]))


# ------------------------------------------------------------ XLA math
def test_xla_sum_and_cumsum_orders():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 5, (300, 1024)).astype(np.float32)
    x[rng.random(x.shape) < 0.2] = 0.0
    want_s = np.asarray(jax.vmap(jnp.sum)(jnp.asarray(x)))
    want_c = np.asarray(jax.vmap(jnp.cumsum)(jnp.asarray(x)))
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(ref.xla_sum(t).numpy(), want_s)
    np.testing.assert_array_equal(ref.xla_cumsum(t).numpy(), want_c)
    # torch's own sum is not that order: the helpers are needed
    assert not np.array_equal(t.sum(dim=1).numpy(), want_s)
    # a tile gathered narrower (zeros past its weights) keeps both orders
    for m in (32, 96, 256, 512, 768):
        z = x.copy()
        z[:, m - 7:] = 0.0
        t = torch.from_numpy(z)
        np.testing.assert_array_equal(ref.xla_sum(t[:, :m].contiguous()),
                                      ref.xla_sum(t))
        np.testing.assert_array_equal(
            ref.xla_cumsum(t[:, :m].contiguous()), ref.xla_cumsum(t)[:, :m])


@pytest.mark.parametrize("lo,hi", [(-80.0, 0.0), (-1e-3, 0.0), (-20.0, 20.0)])
def test_xla_exp_bitwise(lo, hi):
    x = np.random.default_rng(4).uniform(lo, hi, 200_000).astype(np.float32)
    want = np.asarray(jnp.exp(jnp.asarray(x)))
    got = ref.xla_exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(2.0 ** -25, 1.0), (0.999, 1.0),
                                   (1e-30, 1e30)])
def test_xla_log_bitwise(lo, hi):
    x = np.random.default_rng(5).uniform(lo, hi, 200_000).astype(np.float32)
    x[:4] = [1.0, 0.0, np.inf, 1e-39]
    want = np.asarray(jnp.log(jnp.asarray(x)))
    got = ref.xla_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _round_f32(x):
    """The float32 nearest a Fraction, ties to the even mantissa."""
    from fractions import Fraction

    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(dist)
    near = [c for c, d in zip(cands, dist) if d == best]
    return near[0] if len(near) == 1 else next(
        c for c in near if not c.view(np.int32) & 1)


def test_fma32_is_a_correctly_rounded_fma():
    """``fma32`` equals the exactly rounded ``a * b + c`` — what XLA's
    contracted multiply-add and the card's ``fmaf`` give — on random
    inputs and where the float64 sum lands on a float32 tie."""
    from fractions import Fraction

    rng = np.random.default_rng(9)
    n = 3000
    a, b, c = (rng.standard_normal(n) * np.exp2(rng.integers(-30, 30, n))
               for _ in range(3))
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    one = np.float32(1.0)
    # exact sum 1 + 2^-24 + 2^-70: its float64 rounding is the float32 tie
    # 1 + 2^-24, which rounds to 1; the FMA rounds up to 1 + 2^-23
    a[0], b[0], c[0] = one + np.float32(2.0 ** -23), one - np.float32(
        2.0 ** -24), np.float32(2.0 ** -47 * (1 + 2.0 ** -23))
    a[1], b[1], c[1] = -a[0], b[0], -c[0]
    got = ref.fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert want[0] == one + np.float32(2.0 ** -23) and want[1] == -want[0]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ------------------------------------------------------------------ eRVS
@pytest.mark.parametrize("dist", ["uniform", "pareto", "zeros"])
def test_ervs_plain_matches_reference(dist):
    """K6's plain version against ``ervs_select_ref`` over 1,200 walkers
    (150 per degree), under the K6 contract."""
    degs = np.repeat(DEGREES, 150)
    vals, indptr = _rows(degs, dist, seed=len(dist))
    (w2d, row0, dg), (pw, pr, pd) = _both(vals, indptr)
    sj, sp = _seeds(6, degs.size)
    want = [np.asarray(a) for a in rref.ervs_select_ref(w2d, row0, dg, sj)]
    off, draws, jumped, margin = ref.ervs_select_ref(pw, pr, pd, sp,
                                                     margins=True)
    same = ((off.numpy() == want[0]) & (draws.numpy() == want[1])
            & (jumped.numpy() == want[2]))
    print(f"\nK6 plain vs ervs_select_ref [{dist}]: exact-match rate "
          f"{same.mean():.6f} over {same.size} walkers")
    near = margin.numpy() <= 2.0
    assert (same | near).all(), np.nonzero(~same & ~near)[0]
    assert (off.numpy() < degs).all() and (jumped.numpy() >= 0).all()
    # the jump is real: long rows retire most tiles by their sum
    long = degs == 20_000
    assert jumped.numpy()[long].mean() > 10


def test_fig12a_inputs_give_the_references_means():
    """benchmarks/fig12_kernel_ablation.py's RNG-draw inputs: 128 walkers
    on one row of uniform(0.5, 5.0) weights, make_seeds(key(1), 128)."""
    for deg in (512, 4096):
        vals = np.random.default_rng(0).uniform(0.5, 5.0, deg).astype(
            np.float32)
        (w2d, row0, dg), (pw, pr, pd) = _both(vals, np.array([0, deg]))
        sj, sp = _seeds(1, 128)
        want = rref.ervs_select_ref(w2d, jnp.tile(row0, 128),
                                    jnp.tile(dg, 128), sj)
        got = ops.ervs_select(pw, pr.repeat(128), pd.repeat(128), sp)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        print(f"\nfig12a deg {deg}, CPU: reference mean draws "
              f"{float(np.mean(np.asarray(want[1]))):.4f}, jumped "
              f"{float(np.mean(np.asarray(want[2]))):.4f}; port plain "
              f"{float(got[1].double().mean()):.4f}, "
              f"{float(got[2].double().mean()):.4f}")


def test_ervs_reference_pallas_in_interpret_mode():
    degs = [0, 1, 130, 1024, 1500, 2049]
    vals, indptr = _rows(degs, "zeros", seed=8)
    (w2d, row0, dg), (pw, pr, pd) = _both(vals, indptr)
    sj, sp = _seeds(9, len(degs))
    want = rops.ervs_select(w2d, row0, dg, sj)
    for a, b in zip(want, ops.ervs_select(pw, pr, pd, sp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_ervs_chi_square_against_exact_probabilities():
    D, N = 200, 20_000
    vals, indptr = _rows([D], "pareto", seed=10)
    _, (pw, pr, pd) = _both(vals, indptr)
    _, sp = _seeds(11, N)
    off, _, _ = ops.ervs_select(pw, pr.repeat(N), pd.repeat(N), sp)
    gen = torch.Generator().manual_seed(12)
    sem = ref.ervs_select_semantic(pw, pr.repeat(N), pd.repeat(N), gen, D)
    p = vals / vals.sum()
    crit = (D - 1) + 6 * (2 * (D - 1)) ** 0.5
    for out in (off.numpy(), sem.numpy()):
        f = np.bincount(out, minlength=D) / N
        assert float((N * (f - p) ** 2 / p).sum()) < crit


# ------------------------------------------------------------------ eRJS
@pytest.mark.parametrize("trials,rounds", [(8, 16), (1, 1), (2, 3)])
def test_erjs_plain_matches_reference(trials, rounds):
    degs = np.array([0, 1, 5, 127, 128, 129, 1024, 3000] * 40)
    vals, indptr = _rows(degs, "zeros", seed=13)
    (w2d, row0, dg), (pw, pr, pd) = _both(vals, indptr)
    rng = np.random.default_rng(14)
    row_max = np.array([vals[a:b].max(initial=0.0)
                        for a, b in zip(indptr[:-1], indptr[1:])], np.float32)
    # bound 0, tight (the row's max), loose, and too small (not a bound)
    scale = rng.choice([0.0, 1.0, 10.0, 0.3], degs.size).astype(np.float32)
    bounds = (row_max * scale).astype(np.float32)
    sj, sp = _seeds(15, degs.size)
    want = rref.erjs_select_ref(w2d, row0, dg, jnp.asarray(bounds), sj,
                                trials=trials, max_rounds=rounds)
    got = ops.erjs_select(pw, pr, pd, torch.from_numpy(bounds), sp,
                          trials=trials, max_rounds=rounds)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    off, used = (b.numpy() for b in got)
    assert (off[(degs == 0) | (bounds == 0)] == -1).all()
    assert (used[(degs == 0) | (bounds == 0)] == 0).all()
    assert (off >= 0).any() and (used <= trials * rounds).all()


def test_erjs_reference_pallas_in_interpret_mode():
    degs = [0, 3, 200, 1100]
    vals, indptr = _rows(degs, "uniform", seed=16)
    (w2d, row0, dg), (pw, pr, pd) = _both(vals, indptr)
    sj, sp = _seeds(17, len(degs))
    bounds = np.array([5.0, 5.0, 0.0, 5.0], np.float32)
    want = rops.erjs_select(w2d, row0, dg, jnp.asarray(bounds), sj)
    got = ops.erjs_select(pw, pr, pd, torch.from_numpy(bounds), sp)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_erjs_rejects_empty_budgets():
    vals, indptr = _rows([4], "uniform", seed=18)
    _, (pw, pr, pd) = _both(vals, indptr)
    with pytest.raises(ValueError, match="positive"):
        ops.erjs_select(pw, pr, pd, torch.ones(1), _seeds(0, 1)[1], trials=0)


def _outside_inputs(seed: int):
    """Walkers whose rows start before the stream, past it, or run past
    its end, on a [64, 128] stream of positive weights; seeds and
    bounds for K7, totals (some zero) for ITS and alias."""
    rng = np.random.default_rng(seed)
    w2d = rng.uniform(0.1, 5.0, (64, 128)).astype(np.float32)
    r0, dg = np.meshgrid([-20, -1, 0, 60, 63, 70, 1000],
                         [1, 300, 1500, 3000])
    r0, dg = r0.ravel().astype(np.int32), dg.ravel().astype(np.int32)
    bounds = np.full(r0.size, 5.0, np.float32)
    totals = rng.uniform(0.0, 2.0, r0.size).astype(np.float32)
    totals[::5] = 0.0
    return w2d, r0, dg, bounds, totals


def test_ops_clip_rows_outside_the_stream_as_the_reference():
    """A read outside the stream is clipped to it, as the reference does
    (eRVS / eRJS clip the row, ITS / alias the flat index): every op's
    plain version equals the reference's bitwise there."""
    w2d, r0, dg, bounds, totals = _outside_inputs(33)
    sj, sp = _seeds(34, r0.size)
    j = tuple(jnp.asarray(a) for a in (w2d, r0, dg, bounds, totals))
    p = tuple(torch.from_numpy(a) for a in (w2d, r0, dg, bounds, totals))
    pairs = [(rref.ervs_select_ref(j[0], j[1], j[2], sj),
              ops.ervs_select(p[0], p[1], p[2], sp)),
             (rref.erjs_select_ref(j[0], j[1], j[2], j[3], sj),
              ops.erjs_select(p[0], p[1], p[2], p[3], sp)),
             ((rref.its_search_ref(j[0], j[1], j[2], j[4], sj),),
              (ops.its_search(p[0], p[1], p[2], p[4], sp),)),
             ((rref.alias_pick_ref(j[0], j[0], j[1], j[2], j[4], sj),),
              (ops.alias_pick(p[0], p[0], p[1], p[2], p[4], sp),))]
    for want, got in pairs:
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.cuda
def test_ops_clip_rows_outside_the_stream_on_the_card(cuda_device):
    """The kernels clip reads outside the stream as their plain versions
    do, bitwise."""
    w2d, r0, dg, bounds, totals = (
        torch.from_numpy(a).to(cuda_device)
        for a in _outside_inputs(35))
    seeds = ops.make_seeds(key_data(36).to(cuda_device), r0.numel())
    pairs = [(ops.ervs_select(w2d, r0, dg, seeds),
              ref.ervs_select_ref(w2d, r0, dg, seeds)),
             (ops.erjs_select(w2d, r0, dg, bounds, seeds),
              ref.erjs_select_ref(w2d, r0, dg, bounds, seeds)),
             ((ops.its_search(w2d, r0, dg, totals, seeds),),
              (ref.its_search_ref(w2d, r0, dg, totals, seeds),)),
             ((ops.alias_pick(w2d, w2d, r0, dg, totals, seeds),),
              (ref.alias_pick_ref(w2d, w2d, r0, dg, totals, seeds),))]
    for got, want in pairs:
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# ------------------------------------------------- tables, seeds
def test_its_and_alias_on_aligned_streams_match_reference():
    g = ref_power_law(400, 10, weight_dist="pareto", seed=19)
    wl = ref_make_workload("deepwalk")
    tables = ref_precomp.build_tables(g, wl, wl.params())
    cdf2d, prob2d, alias2d, row0, dg = rops.aligned_precomp_tables(
        tables, np.asarray(g.indptr))
    pt = interop.tables_from_arrays(
        np.asarray(tables.cdf), np.asarray(tables.total),
        np.asarray(tables.invalid), alias_off=np.asarray(tables.alias_off),
        alias_prob=np.asarray(tables.alias_prob))
    pc, pp, pa, pr, pd = ops.aligned_precomp_tables(pt, np.asarray(g.indptr))
    rng = np.random.default_rng(20)
    nodes = np.concatenate([np.arange(400), rng.integers(0, 400, 600)])
    totals = np.asarray(tables.total)[nodes].copy()
    totals[::17] = 0.0  # zero-total rows draw -1
    sj, sp = _seeds(21, nodes.size)
    r0j, dj = jnp.asarray(row0)[nodes], jnp.asarray(dg)[nodes]
    r0p, dp = pr[nodes].contiguous(), pd[nodes].contiguous()
    tj, tp = jnp.asarray(totals), torch.from_numpy(totals)
    want = rref.its_search_ref(cdf2d, r0j, dj, tj, sj)
    got = ops.its_search(pc, r0p, dp, tp, sp)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    want = rref.alias_pick_ref(prob2d, alias2d, r0j, dj, tj, sj)
    got = ops.alias_pick(pp, pa, r0p, dp, tp, sp)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert (got.numpy()[::17] == -1).all()
    # the reference's Pallas kernels in interpret mode, a few walkers
    k = slice(0, 6)
    want = rops.its_search(cdf2d, r0j[k], dj[k], tj[k], sj[k])
    np.testing.assert_array_equal(
        np.asarray(want), ops.its_search(pc, r0p[k], dp[k], tp[k],
                                         sp[k]).numpy())
    want = rops.alias_pick(prob2d, alias2d, r0j[k], dj[k], tj[k], sj[k])
    np.testing.assert_array_equal(
        np.asarray(want), ops.alias_pick(pp, pa, r0p[k], dp[k], tp[k],
                                         sp[k]).numpy())


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 128), (12345, 1000),
                                    (-7, 33)])
def test_make_seeds_matches_reference(seed, n):
    want = np.asarray(rops.make_seeds(jax.random.key(seed), n))
    got = ops.make_seeds(key_data(seed), n)
    assert got.dtype == torch.int64 and tuple(got.shape) == (n, 2)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_ops_launch_nothing_on_the_cpu():
    build.reset_launches()
    vals, indptr = _rows([50, 2000], "uniform", seed=22)
    _, (pw, pr, pd) = _both(vals, indptr)
    sp = _seeds(23, 2)[1]
    ops.ervs_select(pw, pr, pd, sp)
    ops.erjs_select(pw, pr, pd, torch.full((2,), 5.0), sp)
    assert not any(build.LAUNCHES.values())


# ------------------------------------------------------------- the card
def _card_inputs(dev, seed: int):
    degs = np.repeat([0, 1, 31, 32, 33, 128, 1000, 1024, 1025, 5000, 70_000],
                     40)
    vals, indptr = _rows(degs, "zeros", seed=seed)
    w2d, row0, dg = ops.align_rows(vals, indptr, device=dev)
    seeds = ops.make_seeds(key_data(seed).to(dev), degs.size)
    return w2d, row0, dg, seeds


@pytest.mark.cuda
def test_ervs_block_kernel_matches_plain_on_the_card(cuda_device):
    w2d, row0, dg, seeds = _card_inputs(cuda_device, 30)
    got = ops.ervs_select(w2d, row0, dg, seeds)
    want = ref.ervs_select_ref(w2d, row0, dg, seeds)
    cpu = ref.ervs_select_ref(w2d.cpu(), row0.cpu(), dg.cpu(), seeds.cpu())
    for a, b, c in zip(got, want, cpu):
        assert torch.equal(a, b) and torch.equal(b.cpu(), c)


@pytest.mark.cuda
def test_erjs_block_kernel_matches_plain_on_the_card(cuda_device):
    w2d, row0, dg, seeds = _card_inputs(cuda_device, 31)
    g = torch.Generator(device="cpu").manual_seed(0)
    bounds = (torch.rand(row0.shape[0], generator=g) * 6.0).to(cuda_device)
    bounds[::9] = 0.0
    for trials, rounds in ((8, 16), (1, 1)):
        got = ops.erjs_select(w2d, row0, dg, bounds, seeds, trials, rounds)
        want = ref.erjs_select_ref(w2d, row0, dg, bounds, seeds, trials,
                                   rounds)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_aligned_table_draws_match_plain_on_the_card(cuda_device):
    w2d, row0, dg, seeds = _card_inputs(cuda_device, 32)
    totals = torch.ones(row0.shape[0], device=cuda_device)
    totals[::5] = 0.0
    cdf = torch.cumsum(w2d, dim=1)  # the search is bitwise on any values
    got = ops.its_search(cdf, row0, dg, totals, seeds)
    assert torch.equal(got, ref.its_search_ref(cdf, row0, dg, totals, seeds))
    prob = torch.rand(w2d.shape, device=cuda_device)
    alias = torch.floor(prob * 100.0)
    got = ops.alias_pick(prob, alias, row0, dg, totals, seeds)
    assert torch.equal(got, ref.alias_pick_ref(prob, alias, row0, dg, totals,
                                               seeds))
