"""The aligned entries of K3 and K5 on the card (``cuda`` marker; they
skip where there is no card): ``ops.its_search`` and ``ops.alias_pick``
bitwise against their plain versions (``ref.its_search_ref`` /
``alias_pick_ref``) on rows of 1 to 17, 127 to 129 and 70,000 entries of
CDF, integer and raw (non-monotone) values, keys whose target rounds to
the total, rows clipped at the stream's ends, and streams whose base is 4,
8 or 16 B past a 32 B boundary (scalar loads below 16 B).  No JAX here:
``tests/test_torch_aligned_draws.py`` holds the plain versions to the
reference.

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q -m cuda \\
        tests/test_torch_aligned_draws_card.py
"""
import numpy as np
import pytest
import torch

from _torch_port import (aligned_rows, aligned_walkers,  # noqa: F401
                         clipped_aligned_inputs, cuda_device, offset_stream,
                         one_torch_thread)
from repro_torch.kernels import build, ops, ref


def _inputs(kind: str, seed: int):
    """(values, row0, degs, totals, seeds) on the host: ``clipped`` rows
    (``clipped_aligned_inputs``), or the walkers of ``aligned_walkers`` on
    the rows of ``aligned_rows`` of that kind in the aligned layout."""
    if kind == "clipped":
        v2d, r0, dg, tot, kd = clipped_aligned_inputs(seed)
        return v2d, r0, dg, tot, kd.astype(np.int64)
    vals, indptr, totals = aligned_rows(kind, seed)
    v2d, row0, degs = (t.numpy() for t in ops.align_rows(vals, indptr,
                                                          device="cpu"))
    nodes, tot, kd = aligned_walkers(indptr.size - 1, totals, seed + 1)
    return v2d, row0[nodes], degs[nodes], tot, kd.astype(np.int64)


def _on_card(v2d, offset_bytes: int, dev):
    """``v2d`` on the card, its base ``offset_bytes`` past a 32 B
    boundary."""
    view = offset_stream(v2d.size, offset_bytes, dev)
    view.copy_(torch.from_numpy(v2d).reshape(-1))
    return view.view(v2d.shape)


def _walker_tensors(row0, degs, tot, seeds, dev):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (row0, degs, tot, seeds))


CASES = [(kind, offset) for kind in ("cdf", "integer", "raw")
         for offset in (0, 16)] + [("raw", 4), ("cdf", 8), ("clipped", 0),
                                   ("clipped", 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,offset", CASES)
def test_aligned_its_matches_plain_on_the_card(cuda_device, kind, offset):
    v2d, row0, degs, tot, seeds = _inputs(kind, 60)
    cdf2d = _on_card(v2d, offset, cuda_device)
    r0, dg, t, s = _walker_tensors(row0, degs, tot, seeds, cuda_device)
    build.reset_launches()
    got = ops.its_search(cdf2d, r0, dg, t, s)
    assert build.LAUNCHES["its_search_aligned"] == 1
    want = ref.its_search_ref(cdf2d, r0, dg, t, s)
    assert torch.equal(got, want)
    assert torch.equal(want.cpu(), ref.its_search_ref(
        cdf2d.cpu(), r0.cpu(), dg.cpu(), t.cpu(), s.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,offset", CASES)
def test_aligned_alias_matches_plain_on_the_card(cuda_device, kind, offset):
    v2d, row0, degs, tot, seeds = _inputs(kind, 61)
    rng = np.random.default_rng(62)
    prob = rng.uniform(0.0, 1.0, v2d.shape).astype(np.float32)
    prob2d = _on_card(prob, offset, cuda_device)
    # alias offsets, or (raw) the values themselves, which convert toward
    # zero
    alias = v2d if kind in ("raw", "clipped") else np.floor(
        rng.uniform(0.0, 200.0, v2d.shape)).astype(np.float32)
    alias2d = _on_card(alias, 0, cuda_device)
    r0, dg, t, s = _walker_tensors(row0, degs, tot, seeds, cuda_device)
    build.reset_launches()
    got = ops.alias_pick(prob2d, alias2d, r0, dg, t, s)
    assert build.LAUNCHES["alias_pick_aligned"] == 1
    assert torch.equal(got, ref.alias_pick_ref(prob2d, alias2d, r0, dg, t,
                                               s))
