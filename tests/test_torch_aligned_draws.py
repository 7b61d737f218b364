"""Port parity: the aligned entries of the table draws (K3's and K5's on
the tile-aligned streams of ``kernels/ops.py``) and what their bounds
count.

* ``ref.its_reads_ref`` / ``ref.alias_reads_ref`` replay the reads of the
  plain versions; held against reads counted by hand, and their distinct
  32 B sectors (``chip_smoke.distinct_sectors``) on a base that is 32 B
  aligned and on one that is 16 B past it.
* The decision order of the redesigned K3 (``_torch_port.
  its_aligned_model``: a row of at most 16 entries from its first sector
  or block, a longer row a probe at a time) gives the plain
  version's answer bit for bit, and the reference's (``repro.kernels.ref``
  and, on a few walkers, its Pallas kernel in interpret mode): rows of 1
  to 17, 127 to 129 and 70,000 entries, CDF rows with zero plateaus
  across 16-entry blocks, raw (non-monotone) rows, integer rows (targets
  on CDF values), keys whose target rounds to the total, and rows that
  start before the stream or run past its end.  K5's plain version is
  held to the reference on the same rows.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (ALIGNED_HUB_LENGTH,  # noqa: F401
                         ALIGNED_ROW_KINDS, aligned_rows, aligned_walkers,
                         clipped_aligned_inputs, its_aligned_model,
                         offset_stream, one_torch_thread, random_keys)
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops, ref

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

@pytest.mark.parametrize("offset,want_sectors", [(0, 4), (16, 5)])
def test_its_reads_ref_by_hand(offset, want_sectors):
    """Rows whose search goes the same way for every target: entries
    above any target (always left) or of 0 (always right)."""
    flat = offset_stream(4 * 128, offset)
    cdf2d = flat.view(4, 128)
    cdf2d[1, :5] = 10.0   # A: 5 entries, left: mids 2, 1, 0
    cdf2d[3, :8] = 10.0   # C: 8 entries, left: mids 4, 2, 1, 0
    # B: row 2, 20 zeros, right: mids 10, 15, 18, 19
    row0 = torch.tensor([1, 2, 3, 0, 0], dtype=torch.int32)
    degs = torch.tensor([5, 20, 8, 0, 7], dtype=torch.int32)
    totals = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0])
    seeds = torch.from_numpy(random_keys(5, 40).astype(np.int64))
    got = ref.its_reads_ref(cdf2d, row0, degs, totals, seeds)
    want = [130, 266, 388,  # level 1 of A, B, C
            129, 271, 386,
            128, 274, 385,
            275, 384]
    assert got.tolist() == want
    # A: 1 sector; B: 266/271 and 274/275; C: one sector aligned, two
    # when the base is 16 B past a boundary (384-387 | 388-391)
    assert chip_smoke.distinct_sectors(flat, got)[0] == want_sectors
    off = ops.its_search(cdf2d, row0, degs, totals, seeds)
    assert off.tolist() == [0, 19, 0, -1, -1]


@pytest.mark.parametrize("offset", [0, 16])
def test_alias_reads_ref_by_hand(offset):
    prob2d = offset_stream(4 * 128, offset).view(4, 128)
    alias2d = offset_stream(4 * 128, offset).view(4, 128)
    prob2d[1, 0] = 1.0   # kept: u2 < 1 always
    prob2d[2, 0] = 0.0   # rejected: the alias is read
    alias2d[2, 0] = 0.0
    row0 = torch.tensor([1, 2, 3, 0], dtype=torch.int32)
    degs = torch.tensor([1, 1, 0, 1], dtype=torch.int32)
    totals = torch.tensor([1.0, 1.0, 1.0, 0.0])
    seeds = torch.from_numpy(random_keys(4, 41).astype(np.int64))
    prob_at, alias_at = ref.alias_reads_ref(prob2d, row0, degs, totals,
                                            seeds)
    assert prob_at.tolist() == [128, 256] and alias_at.tolist() == [256]
    count, first = chip_smoke.distinct_sectors(prob2d, prob_at)
    assert count == 2 and first.tolist() == [128, 256]
    assert ops.alias_pick(prob2d, alias2d, row0, degs, totals,
                          seeds).tolist() == [0, 0, -1, -1]


def test_distinct_sectors_first_reads_in_order():
    flat = offset_stream(256, 0)
    at = torch.tensor([40, 9, 41, 8, 0, 47, 48, 3])
    count, first = chip_smoke.distinct_sectors(flat, at)
    assert count == 4 and first.tolist() == [40, 9, 0, 48]


def _check_its(cdf2d, r0, dg, tot, kd, pallas=()):
    """The model against both plain versions (the port's and the
    reference's), bitwise; the reference's Pallas kernel on ``pallas``.
    Returns the model's (offsets, paths)."""
    t_seeds = torch.from_numpy(kd.astype(np.int64))
    args = (torch.from_numpy(cdf2d), torch.from_numpy(r0),
            torch.from_numpy(dg), torch.from_numpy(tot), t_seeds)
    got, paths = its_aligned_model(*args)
    want = ref.its_search_ref(*args)
    assert torch.equal(got, want)
    jargs = (jnp.asarray(cdf2d), jnp.asarray(r0), jnp.asarray(dg),
             jnp.asarray(tot), jnp.asarray(kd))
    np.testing.assert_array_equal(np.asarray(rref.its_search_ref(*jargs)),
                                  got.numpy())
    if len(pallas):
        k = np.asarray(pallas)
        np.testing.assert_array_equal(
            np.asarray(rops.its_search(jargs[0],
                                       *(a[k] for a in jargs[1:]))),
            got.numpy()[k])
    return got.numpy(), paths


@pytest.mark.parametrize("kind", ALIGNED_ROW_KINDS)
def test_its_model_matches_plain_and_reference(kind):
    vals, indptr, totals = aligned_rows(kind, 50)
    cdf2d, row0, degs = (t.numpy() for t in ops.align_rows(
        vals, indptr, device="cpu"))
    nodes, tot, kd = aligned_walkers(indptr.size - 1, totals, 51)
    r0, dg = row0[nodes], degs[nodes]
    # a few walkers for the Pallas kernel: a sector row, a block row, a
    # long row, the hub
    pick = [int(np.argmax(dg == d))
            for d in (5, 16, 129, ALIGNED_HUB_LENGTH)]
    got, paths = _check_its(cdf2d, r0, dg, tot, kd, pallas=pick)
    assert {"empty", "sector", "block", "long"} <= set(paths)
    # the cases the design treats apart are all there
    u = ref.uniform_01(torch.from_numpy(kd[:, 0].astype(np.int64)),
                       torch.from_numpy(kd[:, 1].astype(np.int64)), 0,
                       ref.ITS_SALT).numpy()
    target = u * tot
    assert ((target == tot) & (tot > 0)).any()   # targets on the total
    if kind == "integer":   # targets on an entry inside the row
        on = got > 0
        flat = cdf2d.reshape(-1)
        assert (target[on] == flat[r0[on] * 128 + got[on] - 1]).any()
    if kind == "cdf":   # plateaus across a block boundary
        flat = cdf2d.reshape(-1)
        s = row0[indptr.size - 2] * 128
        assert flat[s + 15] == flat[s + 16] and flat[s + 31] == flat[s + 32]
    if kind == "raw":   # non-monotone rows, short and long
        assert (np.diff(vals[:8]) < 0).any()
        assert (np.diff(vals[indptr[-2]:indptr[-1]]) < 0).any()


def test_its_model_on_rows_clipped_at_the_stream_ends():
    cdf2d, r0, dg, tot, kd = clipped_aligned_inputs(52)
    _, paths = _check_its(cdf2d, r0, dg, tot, kd)
    inside = (r0 >= 0) & (r0 * 128 + dg - 1 <= cdf2d.size - 1)
    assert all(p == "clipped" for p, ok in zip(paths, inside) if not ok)
    assert {"sector", "block", "long"} <= set(
        p for p, ok in zip(paths, inside) if ok)


@pytest.mark.parametrize("kind", ["cdf", "raw"])
def test_alias_plain_matches_reference(kind):
    """K5's aligned entry keeps the plain order (the column's keep
    probability, then its alias where rejected): its plain version on the
    same rows, and on rows past the streams' ends, against the
    reference's."""
    vals, indptr, totals = aligned_rows(kind, 54)
    rng = np.random.default_rng(55)
    prob = rng.uniform(0.0, 1.0, vals.size).astype(np.float32)
    alias = np.floor(rng.uniform(0.0, 1.0, vals.size)
                     * np.repeat(np.diff(indptr), np.diff(indptr))
                     ).astype(np.float32)
    prob2d, row0, degs = (t.numpy() for t in ops.align_rows(
        prob, indptr, device="cpu"))
    alias2d = ops.align_rows(alias, indptr, device="cpu")[0].numpy()
    nodes, tot, kd = aligned_walkers(indptr.size - 1, totals, 56)
    r0 = np.concatenate([row0[nodes], [-20, -1, prob2d.shape[0] - 1,
                                       prob2d.shape[0] + 3] * 4])
    dg = np.concatenate([degs[nodes], np.repeat([1, 8, 9, 300], 4)])
    r0, dg = r0.astype(np.int32), dg.astype(np.int32)
    tot = np.concatenate([tot, np.ones(16, np.float32)])
    kd = np.concatenate([kd, random_keys(16, 57)])
    t_args = (torch.from_numpy(prob2d), torch.from_numpy(alias2d),
              torch.from_numpy(r0), torch.from_numpy(dg),
              torch.from_numpy(tot), torch.from_numpy(kd.astype(np.int64)))
    got = ops.alias_pick(*t_args).numpy()
    jargs = (jnp.asarray(prob2d), jnp.asarray(alias2d), jnp.asarray(r0),
             jnp.asarray(dg), jnp.asarray(tot), jnp.asarray(kd))
    np.testing.assert_array_equal(np.asarray(rref.alias_pick_ref(*jargs)),
                                  got)
    k = np.array([int(np.argmax(dg == d))
                  for d in (3, 8, 9, ALIGNED_HUB_LENGTH)])
    np.testing.assert_array_equal(
        np.asarray(rops.alias_pick(*jargs[:2], *(a[k] for a in jargs[2:]))),
        got[k])
    ok = got >= 0
    assert (~ok).any()
    u1 = ref.uniform_pair_01(t_args[5][:, 0], t_args[5][:, 1], 0,
                             ref.ALIAS_SALT)[0].numpy()
    col = np.minimum((u1 * dg.astype(np.float32)).astype(np.int64),
                     np.maximum(dg - 1, 0))
    # both branches, on short rows and on long ones
    for rows in (dg <= 8, dg > 8):
        assert (ok & rows & (got == col)).any()
        assert (ok & rows & (got != col)).any()
