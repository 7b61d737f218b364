"""K6 (``ops.ervs_select``), its plan and table pass
(``ops.ervs_tile_tables``) and K7 (``ops.erjs_select``) on the card,
held bit for bit against their plain PyTorch versions on the same card
tensors, on ``_torch_port.block_rows``' rows (1 to 2,049 weights and a
hub; zeros, plateaus and tiny weights across 16-chunk and 32-window
boundaries, where the prefix sums fall; last tiles followed by other
rows' positive weights; many walkers on one row) and on rows clipped at
both ends of the stream.  Every test needs the card (``cuda`` marker);
this file imports no JAX.
"""
import numpy as np
import pytest
import torch

from _torch_port import (BLOCK_ROW_KINDS, block_rows,  # noqa: F401
                         block_walkers, clipped_block_inputs, cuda_device,
                         one_torch_thread)
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.prng import key_data

KINDS = BLOCK_ROW_KINDS + ("clipped",)


def _inputs(kind: str, dev):
    """(w2d, row0, degs, seeds, bounds) on ``dev``; bounds are each row's
    largest weight, some scaled up (loose) or down (not a bound), some 0."""
    if kind == "clipped":
        w2d, r0, dg = clipped_block_inputs(50)
        w2d, r0, dg = (torch.from_numpy(a) for a in (w2d, r0, dg))
    else:
        vals, indptr = block_rows(kind, 40)
        w2d, row0, deg = ops.align_rows(vals, indptr, device="cpu")
        nodes = torch.from_numpy(block_walkers(row0.numel(), 41))
        r0, dg = row0[nodes].contiguous(), deg[nodes].contiguous()
    rng = np.random.default_rng(52)
    scale = rng.choice([0.0, 1.0, 4.0, 0.5], r0.numel()).astype(np.float32)
    bounds = torch.from_numpy(scale) * float(w2d.max())
    seeds = ops.make_seeds(key_data(53), r0.numel())
    return tuple(x.to(dev) for x in (w2d, r0, dg, seeds, bounds))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_k6_matches_plain_version(kind, cuda_device):
    w2d, r0, dg, seeds, _ = _inputs(kind, cuda_device)
    build.reset_launches()
    got = ops.ervs_select(w2d, r0, dg, seeds)
    assert build.LAUNCHES["ervs_block_select"] == 1
    want = ref.ervs_select_ref(w2d, r0, dg, seeds)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(want[1].max()) > 1 and int(want[2].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_k6_tables_match_plain_versions(kind, cuda_device):
    w2d, r0, dg, _, _ = _inputs(kind, cuda_device)
    build.reset_launches()
    lead, sums, firsts, m = ops.ervs_tile_tables(w2d, r0, dg)
    assert not any(build.LAUNCHES.values())
    assert lead.numel() > 0
    assert torch.equal(lead, ref.ervs_leaders_ref(r0, dg, w2d.shape[0]))
    want = ref.ervs_tile_tables_ref(w2d, r0[lead], dg[lead])
    for a, b in zip((sums, firsts, m), want):
        assert torch.equal(a, b)
    # and the same tables as the plain versions compute on the CPU
    cpu = ref.ervs_tile_tables_ref(w2d.cpu(), r0[lead].cpu(), dg[lead].cpu())
    for a, b in zip(want, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_k7_matches_plain_version(kind, cuda_device):
    w2d, r0, dg, seeds, bounds = _inputs(kind, cuda_device)
    for trials, rounds in ((8, 16), (1, 1), (2, 3)):
        build.reset_launches()
        got = ops.erjs_select(w2d, r0, dg, bounds, seeds, trials, rounds)
        assert build.LAUNCHES["erjs_block_select"] == 1
        want = ref.erjs_select_ref(w2d, r0, dg, bounds, seeds, trials,
                                   rounds)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_k6_fig12a_means(cuda_device):
    """Fig. 12a's RNG-draw inputs on the card: mean draws 7.0000 at degree
    512, 9.1250 draws and 1.9297 jumped tiles at 4,096."""
    means = {}
    for deg in (512, 4096):
        vals = np.random.default_rng(0).uniform(0.5, 5.0, deg).astype(
            np.float32)
        w2d, row0, dg = ops.align_rows(vals, np.array([0, deg]),
                                       device=cuda_device)
        seeds = ops.make_seeds(key_data(1).to(cuda_device), 128)
        got = ops.ervs_select(w2d, row0.repeat(128), dg.repeat(128), seeds)
        means[deg] = (float(got[1].double().mean()),
                      float(got[2].double().mean()))
    assert means[512][0] == 7.0
    assert means[4096] == (9.125, 1.9296875)


@pytest.mark.cuda
def test_k6_refuses_a_stream_off_16_bytes(cuda_device):
    w2d, r0, dg, seeds, _ = _inputs("uniform", cuda_device)
    off = torch.empty(w2d.numel() + 1, device=cuda_device)[1:].view(
        w2d.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ops.ervs_select(off, r0, dg, seeds)
