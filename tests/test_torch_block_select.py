"""Port parity, K6's tables: the tile sums, the first counted positions
and the running maxima M that K6's table pass builds once per distinct
row (``ref.ervs_leaders_ref``, ``ref.ervs_tile_tables_ref``), and the
decision order its walk runs on them (``_torch_port.ervs_model``).

* the plain tables against the reference's own orders: ``jnp.sum`` and
  ``jnp.cumsum`` of each masked tile (XLA on the CPU), M's running
  maximum taken in numpy;
* M is non-decreasing although the prefix sums are not (the inputs hold
  tiles whose prefix sums fall at 16-chunk boundaries);
* the model of the decision order bitwise against ``ref.ervs_select_ref``
  and the reference's ``ervs_select_ref``, and on a few walkers inside
  the stream its Pallas kernel in interpret mode: rows of 1 to 2,049
  weights and a hub, zeros and plateaus across 16-chunk and 32-window boundaries, a last
  tile followed by other rows' positive weights, rows clipped at both
  ends of the stream, many walkers on one row;
* the plan's leaders: one per distinct (row0, deg) of a tabulated row,
  and a walker whose slot is led by another (row0, deg) leads its own;
* ``ops.ervs_tile_tables`` and ``ops.ervs_select`` on CPU tensors run the
  plain versions and launch nothing;
* K7's reads as its bound counts them (``ref.erjs_reads_ref``): one per
  trial, the accepted trial's at the offset's weight.

On the card, ``tests/test_torch_block_select_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (BLOCK_ROW_KINDS, block_rows,  # noqa: F401
                         block_walkers, clipped_block_inputs, ervs_model,
                         one_torch_thread)
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.prng import key_data


def _aligned(kind: str, seed: int):
    """(w2d, row0, degs, seeds) on the CPU: walkers of ``block_walkers``
    on ``block_rows``' aligned layout, seeds from ``make_seeds``."""
    vals, indptr = block_rows(kind, seed)
    w2d, row0, dg = ops.align_rows(vals, indptr, device="cpu")
    nodes = torch.from_numpy(block_walkers(row0.numel(), seed + 1))
    return (w2d, row0[nodes].contiguous(), dg[nodes].contiguous(),
            ops.make_seeds(key_data(seed + 2), nodes.numel()))


def _clipped(seed: int):
    w2d, r0, dg = clipped_block_inputs(seed)
    return (torch.from_numpy(w2d), torch.from_numpy(r0), torch.from_numpy(dg),
            ops.make_seeds(key_data(seed + 1), r0.size))


def _inputs(kind: str):
    return _clipped(50) if kind == "clipped" else _aligned(kind, 40)


KINDS = BLOCK_ROW_KINDS + ("clipped",)


def _each_row(row0, dg):
    """One walker a distinct (row0, deg), ascending: the rows whose tables
    the checks build, short rows too."""
    key = row0.to(torch.int64) * (1 << 32) + dg.to(torch.int64)
    _, inv = torch.unique(key, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), row0.numel()).scatter_reduce(
        0, inv, torch.arange(row0.numel()), "amin")
    return first.sort().values


def _tiles_jnp(w2d, row0, degs):
    """Per tile of rows (row0, degs): (sum, prefix sums, weights) as the
    reference computes them, ``jnp.sum`` / ``jnp.cumsum`` of the masked
    1024-weight tile, in numpy."""
    flat = np.asarray(w2d).reshape(-1)
    R = flat.size // ref.LANES
    out = []
    for r0, d in zip(np.asarray(row0), np.asarray(degs)):
        for t in range(-(-int(d) // ref.TILE)):
            valid = min(int(d) - t * ref.TILE, ref.TILE)
            o = np.arange(ref.TILE)
            rows = np.clip(int(r0) + t * ref.SUBLANES + o // ref.LANES, 0,
                           R - 1)
            w = np.where(o < valid, flat[rows * ref.LANES + o % ref.LANES],
                         np.float32(0.0)).astype(np.float32)
            out.append((np.asarray(jnp.sum(jnp.asarray(w))),
                        np.asarray(jnp.cumsum(jnp.asarray(w))), w, valid))
    return out


# ---------------------------------------------------------------- tables
@pytest.mark.parametrize("kind", KINDS)
def test_tables_match_the_references_orders(kind):
    w2d, row0, dg, _ = _inputs(kind)
    lead = _each_row(row0, dg)
    sums, firsts, m = ref.ervs_tile_tables_ref(w2d, row0[lead], dg[lead])
    tiles = _tiles_jnp(w2d.numpy(), row0[lead].numpy(), dg[lead].numpy())
    assert sums.numel() == firsts.numel() == len(tiles)
    at = 0
    for k, (s, cs, w, valid) in enumerate(tiles):
        assert s.tobytes() == sums[k].numpy().tobytes()
        counted = (w > 0) & ~np.isnan(cs)
        first = int(np.argmax(counted)) if counted.any() else -1
        assert first == int(firsts[k])
        want = np.maximum.accumulate(np.where(counted, cs, -np.inf))
        n = (valid + 31) // 32 * 32
        np.testing.assert_array_equal(m[at:at + n].numpy(),
                                      want[:n].astype(np.float32))
        at += n
    assert at == m.numel()


def test_m_is_monotone_where_the_prefix_sums_are_not():
    falls = 0
    for kind in BLOCK_ROW_KINDS:
        w2d, row0, dg, _ = _aligned(kind, 40)
        lead = _each_row(row0, dg)
        _, firsts, m = ref.ervs_tile_tables_ref(w2d, row0[lead], dg[lead])
        tiles = _tiles_jnp(w2d.numpy(), row0[lead].numpy(),
                           dg[lead].numpy())
        at = 0
        for (_, cs, w, valid), first in zip(tiles, firsts.tolist()):
            n = (valid + 31) // 32 * 32
            mt = m[at:at + n].numpy()
            at += n
            if first < 0:
                assert (mt == -np.inf).all()
                continue
            assert (mt[:first] == -np.inf).all()
            assert (np.diff(mt[first:]) >= 0).all()
            pos = np.flatnonzero(w[:valid] > 0)
            falls += int((np.diff(cs[pos]) < 0).sum())
    # the prefix sums fall at positive weights: a search over cs itself
    # would not be a search
    assert falls > 0


# ------------------------------------------------------- decision order
@pytest.mark.parametrize("kind", KINDS)
def test_model_matches_plain_and_reference(kind):
    w2d, row0, dg, seeds = _inputs(kind)
    model = ervs_model(w2d, row0, dg, seeds)
    plain = ref.ervs_select_ref(w2d, row0, dg, seeds)
    want = rref.ervs_select_ref(jnp.asarray(w2d.numpy()),
                                jnp.asarray(row0.numpy()),
                                jnp.asarray(dg.numpy()),
                                jnp.asarray(seeds.numpy().astype(np.uint32)))
    for a, b, c in zip(model, plain, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))
    assert int(plain[1].max()) > 1 and int(plain[2].max()) > 0


@pytest.mark.parametrize("kind", ("plateaus", "pareto"))
def test_model_matches_the_reference_pallas_kernel(kind):
    """In interpret mode, on rows inside the stream (the Pallas kernel
    reads a row outside it otherwise than the reference's plain version,
    which the port follows)."""
    w2d, row0, dg, seeds = _inputs(kind)
    pick = torch.tensor([0, 5, 17, 33, 40, 60])
    args = (w2d, row0[pick].contiguous(), dg[pick].contiguous(),
            seeds[pick].contiguous())
    want = rops.ervs_select(*(jnp.asarray(a.numpy()) for a in args[:3]),
                            jnp.asarray(args[3].numpy().astype(np.uint32)))
    for a, b in zip(ervs_model(*args), want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_fig12a_means_under_the_model():
    """Fig. 12a's RNG-draw inputs: 128 walkers on one row of uniform(0.5,
    5.0) weights, make_seeds(key(1), 128): mean draws 7.0000 at degree
    512, 9.1250 draws and 1.9297 jumped tiles at 4,096."""
    means = {}
    for deg in (512, 4096):
        vals = np.random.default_rng(0).uniform(0.5, 5.0, deg).astype(
            np.float32)
        w2d, row0, dg = ops.align_rows(vals, np.array([0, deg]), device="cpu")
        seeds = ops.make_seeds(key_data(1), 128)
        got = ervs_model(w2d, row0.repeat(128), dg.repeat(128), seeds)
        means[deg] = (float(got[1].double().mean()),
                      float(got[2].double().mean()))
    assert means[512][0] == 7.0
    assert means[4096] == (9.125, 1.9296875)


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("kind", BLOCK_ROW_KINDS)
def test_leaders_one_per_distinct_row(kind):
    w2d, row0, dg, _ = _aligned(kind, 40)
    lead = ref.ervs_leaders_ref(row0, dg, w2d.shape[0])
    tabled = dg > ref.ERVS_SHORT_MAX
    assert 0 < int(tabled.sum()) < dg.numel()  # rows on both sides
    keys = set(zip(row0[tabled].tolist(), dg[tabled].tolist()))
    assert len(keys) == lead.numel()
    assert set(zip(row0[lead].tolist(), dg[lead].tolist())) == keys
    # the largest walker index of each row leads it
    for r, d in keys:
        on = ((row0 == r) & (dg == d)).nonzero().squeeze(1)
        assert int(on.max()) in lead.tolist()
    assert bool((lead[1:] > lead[:-1]).all())


def test_leaders_of_clipped_and_shared_slots():
    """A slot (the clipped row0) led by another (row0, deg) leaves its
    other walkers to lead jobs of their own: every tabulated walker's
    (row0, deg) is some leader's."""
    w2d, row0, dg, _ = _clipped(50)
    lead = ref.ervs_leaders_ref(row0, dg, w2d.shape[0])
    tabled = dg > ref.ERVS_SHORT_MAX
    keys = set(zip(row0[lead].tolist(), dg[lead].tolist()))
    assert set(zip(row0[tabled].tolist(), dg[tabled].tolist())) == keys
    assert lead.numel() > len(set(row0[tabled].clamp(0, 63).tolist()))


@pytest.mark.parametrize("kind", KINDS)
def test_ops_tables_on_the_cpu_are_the_plain_ones(kind):
    w2d, row0, dg, seeds = _inputs(kind)
    build.reset_launches()
    lead, sums, firsts, m = ops.ervs_tile_tables(w2d, row0, dg)
    assert lead.numel() > 0
    assert torch.equal(lead, ref.ervs_leaders_ref(row0, dg, w2d.shape[0]))
    for a, b in zip((sums, firsts, m),
                    ref.ervs_tile_tables_ref(w2d, row0[lead], dg[lead])):
        assert torch.equal(a, b)
    got = ops.ervs_select(w2d, row0, dg, seeds)
    for a, b in zip(got, ref.ervs_select_ref(w2d, row0, dg, seeds)):
        assert torch.equal(a, b)
    assert not any(build.LAUNCHES.values())


def test_the_split_is_the_kernels_own():
    """``ref.ERVS_SHORT_MAX`` (the plain plan's split) is the number the
    kernels are compiled with, ``kShortMax`` in ``csrc/ervs_block.cu``."""
    import re
    from pathlib import Path

    src = (Path(ref.__file__).parent / "csrc" / "ervs_block.cu").read_text()
    found = re.findall(r"constexpr int kShortMax = (\d+);", src)
    assert found == [str(ref.ERVS_SHORT_MAX)]


def test_drop_scratch_frees_one_kernels_tensors():
    dev = torch.device("cpu")
    keep = build.scratch("k7_test.a", dev, 0, 4, torch.int32)
    build.scratch("k6_test.a", dev, 0, 4, torch.int32)
    build.scratch("k6_test.b", dev, 0, 8, torch.float32)
    build.drop_scratch("k6_test.")
    assert not [k for k in build.SCRATCH if k[0].startswith("k6_test.")]
    assert build.scratch("k7_test.a", dev, 0, 4, torch.int32) is keep
    build.drop_scratch("k7_test.")


# --------------------------------------------------------- K7's reads
@pytest.mark.parametrize("kind", KINDS)
def test_k7_reads_are_the_plain_versions_candidates(kind):
    """``ref.erjs_reads_ref`` replays every trial's read: as many as the
    trials, each inside the stream, and an accepted walker's last read is
    its offset's weight."""
    w2d, row0, dg, seeds = _inputs(kind)
    rng = np.random.default_rng(54)
    bounds = torch.from_numpy(rng.choice([0.0, 1.0, 4.0], row0.numel())
                              .astype(np.float32)) * float(w2d.max())
    off, used = ref.erjs_select_ref(w2d, row0, dg, bounds, seeds, 2, 3)
    at = ref.erjs_reads_ref(w2d, row0, dg, seeds, used)
    assert at.numel() == int(used.sum()) > row0.numel()
    assert int(at.min()) >= 0 and int(at.max()) < w2d.numel()
    # the last trial of walker i is read at position cumsum(used)[i] - 1
    # of the trial-major order: rebuild it walker-major to compare
    last = {}
    k = 0
    for t in range(int(used.max())):
        for i in (used > t).nonzero().squeeze(1).tolist():
            last[i] = int(at[k])
            k += 1
    R = w2d.shape[0]
    for i in (off >= 0).nonzero().squeeze(1).tolist():
        o = int(off[i])
        r = min(max(int(row0[i]) + o // ref.LANES, 0), R - 1)
        assert last[i] == r * ref.LANES + o % ref.LANES
        assert float(w2d.reshape(-1)[last[i]]) > 0


def test_ops_refuse_walkers_on_an_empty_stream():
    w2d = torch.zeros((0, ref.LANES), dtype=torch.float32)
    row0 = torch.zeros(2, dtype=torch.int32)
    dg = torch.tensor([3, 200], dtype=torch.int32)
    seeds = ops.make_seeds(key_data(60), 2)
    with pytest.raises(ValueError, match="no rows"):
        ops.ervs_select(w2d, row0, dg, seeds)
    with pytest.raises(ValueError, match="no rows"):
        ops.ervs_tile_tables(w2d, row0, dg)
