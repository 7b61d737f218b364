"""Port parity: the Gumbel-max token sampler (K8's plain version) against
the reference's ``kernels/ref.py:token_sample_ref`` and its Pallas
``token_sample`` in interpret mode, bitwise in the token ids.

The plain version reproduces the reference as XLA on the CPU compiles
it: the key ``logit * (1/T) + g`` is one fused multiply-add and ``g =
-ln(-ln u)`` takes XLA's log, so the keys, not only the ids, equal the
jitted reference's (checked here too).  Inputs come from numpy seeds.

* the shapes of ``tests/test_kernels.py``'s sampler test × T ∈ {1.0, 0.7};
* greedy is the arg-max; a ``seed0`` that wraps mod 2^32 across rows;
* a chi-square against softmax (the reference's V=32, N=12,000 test);
* the wrappers' CPU dispatch (``ops.token_sample``, ``sample_tokens``);
* K8's host side: its chunk count and its scratch (``build.scratch``),
  kept per (device, stream), grown on demand, zeroed once;
* on the card (``cuda`` marker; skips here): K8 against its plain version
  bitwise, sampled and greedy, on vocab sizes that leave a ragged last
  chunk and on a wrapping seed; on V not divisible by 4, V below one
  chunk, an unaligned row start, NaN and all ``-inf`` rows, equal maxima
  in different chunks, B = 1 and 128; and over calls of alternating shape,
  which reuse the scratch and need its counters reset by the kernel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cuda_device, one_torch_thread  # noqa: F401
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.prng import uniform_01 as ref_uniform_01
from repro_torch.kernels import build, ops, ref, token_sampler
from repro_torch.kernels.prng import MASK32, uniform_01
from repro_torch.serving import sample_tokens

SHAPES = [(3, 100), (8, 512), (5, 1000), (16, 2048)]
SEED = (11, 22)


def _logits(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 2.0).astype(
        np.float32)


def _port(logits, seed, **kw):
    return ops.token_sample(torch.from_numpy(logits),
                            torch.tensor(seed, dtype=torch.int64), **kw)


def _seed32(seed):
    return jnp.asarray(np.asarray(seed, np.uint32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_plain_equals_reference_and_interpret_kernel(shape, temperature):
    lg = _logits(shape)
    got = _port(lg, SEED, temperature=temperature).numpy()
    assert got.dtype == np.int32
    want = np.asarray(rref.token_sample_ref(jnp.asarray(lg), _seed32(SEED),
                                            temperature=temperature))
    kern = np.asarray(rops.token_sample(jnp.asarray(lg), _seed32(SEED),
                                        temperature=temperature,
                                        interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, kern)


def test_keys_equal_the_jitted_references():
    """The Gumbel keys themselves, not only their arg-max, are XLA's:
    ``fma32`` for the multiply-add and ``xla_log`` for the two logs."""
    B, V, T = 4, 4096, 0.7
    lg = _logits((B, V), seed=1)

    def ref_keys(lg, seed):
        ctr = jnp.arange(V, dtype=jnp.uint32)

        def row(l, r):
            u = ref_uniform_01(seed[0] + r, seed[1], ctr,
                               jnp.uint32(0x700C0DE))
            return l * jnp.float32(1.0 / T) + -jnp.log(-jnp.log(u))

        return jax.vmap(row)(lg, jnp.arange(B, dtype=jnp.uint32))

    want = np.asarray(jax.jit(ref_keys)(jnp.asarray(lg), _seed32(SEED)))
    rows = torch.arange(B)[:, None]
    u = uniform_01((SEED[0] + rows) & MASK32, SEED[1],
                   torch.arange(V)[None, :], ref.TOKEN_SALT)
    g = -ref.xla_log(-ref.xla_log(u))
    got = ref.fma32(torch.from_numpy(lg), float(np.float32(1.0 / T)), g)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_is_the_argmax():
    lg = _logits((9, 777), seed=4)
    lg[2, 5] = lg[2, 700] = lg[2].max() + 1.0  # a tie: the first index wins
    got = _port(lg, (1, 2), greedy=True).numpy()
    np.testing.assert_array_equal(got, np.argmax(lg, axis=1))
    want = np.asarray(rops.token_sample(jnp.asarray(lg), _seed32((1, 2)),
                                        greedy=True, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_wrapping_seed_equals_reference():
    """``seed0 + row`` wraps mod 2^32 (uint32 in the reference)."""
    seed = (2**32 - 3, 22)
    lg = _logits((8, 512), seed=5)
    got = _port(lg, seed, temperature=0.8).numpy()
    want = np.asarray(rref.token_sample_ref(jnp.asarray(lg), _seed32(seed),
                                            temperature=0.8))
    np.testing.assert_array_equal(got, want)


def test_distribution_matches_softmax():
    V, N = 32, 12_000
    row = np.random.default_rng(2).standard_normal(V).astype(np.float32)
    out = _port(np.tile(row[None, :], (N, 1)), (7, 13)).numpy()
    p = np.exp(row.astype(np.float64) - row.max())
    p /= p.sum()
    f = np.bincount(out, minlength=V) / N
    chi2 = float((N * ((f - p) ** 2 / p)).sum())
    assert chi2 < 31 + 6 * (2 * 31) ** 0.5


def test_cpu_wrappers_run_the_plain_version():
    lg = torch.from_numpy(_logits((5, 1000), seed=6))
    seed = torch.tensor(SEED, dtype=torch.int64)
    build.reset_launches()
    want = ref.token_sample_ref(lg, seed, 0.7)
    assert torch.equal(ops.token_sample(lg, seed, 0.7), want)
    assert torch.equal(sample_tokens(lg, seed, 0.7, False), want)
    assert build.LAUNCHES["token_sample"] == 0


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    """K8 against its plain version on the same card tensors, bitwise."""
    for shape, seed in (((5, 151_936), SEED), ((8, 4097), (2**32 - 3, 9)),
                        ((1, 1), SEED), ((33, 1000), (0, 0))):
        lg = torch.from_numpy(_logits(shape, seed=7)).to(cuda_device)
        s = torch.tensor(seed, dtype=torch.int64, device=cuda_device)
        for kw in (dict(temperature=0.8), dict(temperature=1.0),
                   dict(greedy=True)):
            got = ops.token_sample(lg, s, **kw)
            assert torch.equal(got, ref.token_sample_ref(lg, s, **kw)), \
                (shape, seed, kw)


def test_chunk_count():
    assert [token_sampler.chunks_of(v) for v in (1, 4095, 4096, 4097,
                                                  151_936)] == [1, 1, 1, 2, 38]


def test_scratch_kept_per_stream_and_grown_on_demand():
    """``build.scratch``, which keeps K8's pairs and counters (and K1
    jump's walker list): zeroed once, reused, grown, one per stream."""
    cpu = torch.device("cpu")
    build.SCRATCH.clear()
    a = build.scratch("k.pairs", cpu, 7, 8 * 38, torch.float32)
    assert a.numel() == 8 * 38 and a.dtype == torch.float32
    assert not bool(a.any())
    a.fill_(3.0)  # what a kernel left there stays for the next launch
    assert build.scratch("k.pairs", cpu, 7, 6, torch.float32) is a
    grown = build.scratch("k.pairs", cpu, 7, 128 * 38, torch.float32)
    assert grown is not a and grown.numel() == 128 * 38
    assert not bool(grown.any())
    assert build.scratch("k.pairs", cpu, 7, 38, torch.float32) is grown
    other = build.scratch("k.pairs", cpu, 8, 1, torch.float32)
    counters = build.scratch("k.counters", cpu, 7, 8, torch.int32)
    assert other is not grown and counters.dtype == torch.int32
    assert set(build.SCRATCH) == {("k.pairs", None, 7), ("k.pairs", None, 8),
                                  ("k.counters", None, 7)}
    build.SCRATCH.clear()


@pytest.mark.parametrize("logits, seed, what", [
    (torch.zeros(5), torch.zeros(2, dtype=torch.int64), "[B, V]"),
    (torch.zeros((2, 0)), torch.zeros(2, dtype=torch.int64), "V > 0"),
    (torch.zeros((2, 3), dtype=torch.float64),
     torch.zeros(2, dtype=torch.int64), "dtype"),
    (torch.zeros((3, 2)).t(), torch.zeros(2, dtype=torch.int64),
     "contiguous"),
    (torch.zeros((2, 3)), torch.zeros(3, dtype=torch.int64), "shape"),
])
def test_input_checks_name_the_fault(logits, seed, what):
    with pytest.raises((ValueError, TypeError), match=what):
        token_sampler._check(logits, seed)


def _on_card(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _equal_on_card(lg, seed, dev, label):
    s = torch.tensor(seed, dtype=torch.int64, device=dev)
    for kw in (dict(temperature=0.8), dict(greedy=True)):
        got = ops.token_sample(lg, s, **kw)
        want = ref.token_sample_ref(lg, s, **kw)
        assert torch.equal(got, want), (label, kw)
    return got


@pytest.mark.cuda
def test_kernel_edge_cases_on_card(cuda_device):
    """Ragged and short vocabs, an unaligned row start, NaN and all-``-inf``
    rows, equal maxima in different chunks, B = 1 and 128."""
    V = 151_936
    for shape in ((1, V), (128, V), (4, 4097), (4, 4099), (3, 1000),
                  (2, 7), (1, 1)):
        _equal_on_card(_on_card(_logits(shape, seed=8), cuda_device), SEED,
                       cuda_device, shape)
    # a contiguous [4, 1000] view 4 bytes past a 16-byte boundary
    flat = _on_card(_logits((4 * 1000 + 1,), seed=9), cuda_device)
    _equal_on_card(flat[1:].view(4, 1000), SEED, cuda_device, "unaligned")
    lg = _logits((6, V), seed=10)
    lg[0, 777] = np.nan
    lg[0, 150_000] = np.nan  # the first NaN wins
    lg[1] = -np.inf
    lg[2, 100] = lg[2, 100_000] = 1e3  # equal maxima in chunks 0 and 24
    lg[3, 5000] = lg[3, 9000] = lg[3, 151_935] = 1e3
    lg[4, :] = 2.5  # every token ties
    got = _equal_on_card(_on_card(lg, cuda_device), SEED, cuda_device,
                         "special rows")
    assert got[:5].tolist() == [777, 0, 100, 5000, 0]


@pytest.mark.cuda
def test_kernel_over_alternating_shapes_on_card(cuda_device):
    """Calls of alternating shape share K8's scratch on one stream: each
    must equal the plain version, so the arrival counters were left 0."""
    wide = _on_card(_logits((128, 151_936), seed=11), cuda_device)
    small = _on_card(_logits((3, 4097), seed=12), cuda_device)
    for lg in (wide[:8], wide, small, wide[:1], wide, wide[:8], small):
        _equal_on_card(lg.contiguous(), (5, 6), cuda_device, tuple(lg.shape))
