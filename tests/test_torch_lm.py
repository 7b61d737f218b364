"""Port parity: the LM serving path (``repro_torch.models``,
``repro_torch.serving``) against the reference on the CPU.

Both packages run the reference's own ``init_params`` weights, carried
into the port by ``interop.params_from_arrays``; other inputs come from
numpy seeds.

* the config registry's data equals the reference's, and the port's
  parameter count equals ``param_count()`` (full widths on the meta
  device: nothing is allocated);
* layers at smoke widths: ``rms_norm``, ``rope``, ``attention_decode``
  (cache update, the ``kpos <= index`` mask) and the MLP within 1e-5 in
  float32; in bf16 within ``BF16_TOL`` (below);
* ``decode_step`` logits over 6 steps with their caches on the
  qwen3-0.6b, yi-6b and minicpm-2b smoke configs in float32, within
  1e-4; at step 0 in bf16 within ``BF16_TOL``;
* ``generate`` token ids equal to the reference's, greedy and sampled
  (T = 0.8), on the float32 qwen3 smoke config (the reference's runs are
  shared through a module fixture: 2 calls, ~5 s each);
* families with layers the port lacks raise ``NotImplementedError``;
* the model and its cache go to the card unless ``device="cpu"`` is
  passed, and ``generate`` refuses the plain sampler there (``cuda``
  marker; skips here).
"""
import ast
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import cuda_device, one_torch_thread  # noqa: F401
from repro import configs as rconfigs
from repro.models import decode_step as ref_decode_step
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models import layers as RL
from repro.serving import GenerateConfig as RefGenerateConfig
from repro.serving import generate as ref_generate
from repro_torch import configs, interop
from repro_torch.kernels.prng import key_data
from repro_torch.models import (DecoderLM, decode_step, init_cache,
                                init_params)
from repro_torch.models import layers as L
from repro_torch.serving import GenerateConfig, generate

DENSE = ["qwen3-0.6b", "yi-6b", "minicpm-2b"]
# bf16: the two packages round bf16 matmul outputs and casts at the same
# places but sum in other orders, so an activation may land one bf16 ulp
# (2^-8 relative) apart and carry that through the layers.  Logits and
# activations here are below 4 in magnitude, where 5 ulps are 0.078.
BF16_TOL = 0.08


def _cfgs(arch, dtype):
    return (dataclasses.replace(rconfigs.get_smoke(arch), dtype=dtype),
            dataclasses.replace(configs.get_smoke(arch), dtype=dtype))


def _arrays(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _models(arch, dtype, seed=0):
    rcfg, tcfg = _cfgs(arch, dtype)
    rp = ref_init_params(rcfg, jax.random.key(seed))
    return rcfg, tcfg, rp, interop.params_from_arrays(tcfg, _arrays(rp),
                                                      device="cpu")


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tol(dtype):
    return 1e-5 if dtype == "float32" else BF16_TOL


def _close(what, got: torch.Tensor, want, dtype) -> None:
    """|got - want| within the dtype's tolerance; prints the maximum."""
    err = float(np.abs(got.float().numpy() - _np(want)).max())
    print(f"{what} [{dtype}]: max |error| {err:.3g} (tolerance "
          f"{_tol(dtype)})")
    assert err <= _tol(dtype)


# -------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_config_registry_is_the_references(arch):
    for which in ("get_config", "get_smoke"):
        got = getattr(configs, which)(arch)
        want = getattr(rconfigs, which)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.layer_kinds() == want.layer_kinds()
    assert configs.train_schedule(arch) == rconfigs.train_schedule(arch)
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()}


@pytest.mark.parametrize("arch", DENSE + ["chameleon-34b", "musicgen-medium",
                                          "qwen3-8b"])
def test_parameter_count_at_full_width(arch):
    """The port's modules hold ``param_count()`` parameters, counted on the
    meta device (no memory)."""
    cfg = configs.get_config(arch)
    model = DecoderLM(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert len([b for seg in model.segments for b in seg]) == cfg.num_layers


def test_qwen3_0_6b_is_the_published_shape():
    cfg = configs.get_config("qwen3-0.6b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.tie_embeddings,
            cfg.qk_norm) == (28, 1024, 16, 8, 128, 3072, 151936, True, True)
    assert cfg.param_count() == 596_049_920


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "moonshot-v1-16b-a3b",
                                  "recurrentgemma-9b", "mamba2-1.3b"])
def test_unsupported_family_raises(arch):
    cfg = configs.get_smoke(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        init_cache(cfg, 2, 8, device="cpu")


def test_init_params_scales_and_dtypes():
    cfg = configs.get_smoke("qwen3-0.6b")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    blk = model.segments[0][0]
    assert model.embed.dtype == torch.bfloat16
    assert blk.attn.q_norm.dtype == torch.float32
    assert not blk.norm1.any() and not model.final_norm.any()
    assert abs(float(blk.mlp.wd.float().std()) * cfg.d_ff ** 0.5 - 1) < 0.05
    assert model.head_f32.dtype == torch.float32
    assert torch.equal(model.head_f32, model.embed.float())
    again = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 again.parameters()))


# --------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    w = (rng.standard_normal(16) * 0.1).astype(np.float32)
    pos = np.array([[0, 5, 17], [3, 9, 40]], np.int32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = L.rms_norm(tx, torch.from_numpy(w))
    assert got.dtype == tx.dtype
    _close("rms_norm", got, RL.rms_norm(jx, jnp.asarray(w)), dtype)
    got = L.rope(tx, torch.from_numpy(pos).long(), 1_000_000.0)
    assert got.dtype == tx.dtype
    _close("rope", got, RL.rope(jx, jnp.asarray(pos), 1_000_000.0), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "yi-6b"])
def test_attention_decode_and_mlp(arch, dtype):
    rcfg, tcfg, rp, tp = _models(arch, dtype)
    rblk = jax.tree.map(lambda a: a[0], rp["segments"][0]["b0_attn"])
    tblk = tp.segments[0][0]
    B, Smax, index = 2, 8, 5
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 1, rcfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, B, Smax, rcfg.num_kv_heads,
                              rcfg.head_dim)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    cache = {"k": jnp.asarray(kv[0]).astype(dtype),
             "v": jnp.asarray(kv[1]).astype(dtype)}
    want, new = RL.attention_decode(rblk["attn"], rcfg, jx, cache,
                                    jnp.int32(index))
    kc, vc = (torch.from_numpy(kv[i]).to(tx.dtype) for i in (0, 1))
    got = L.attention_decode(tblk.attn, tcfg, tx, kc, vc, index)
    _close(f"attention_decode[{arch}]", got, want, dtype)
    _close(f"attention_decode[{arch}] k cache", kc, new["k"], dtype)
    _close(f"attention_decode[{arch}] v cache", vc, new["v"], dtype)
    # positions past index are masked: changing them changes nothing
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[:, index + 1:] = 7.0
    vc2[:, index + 1:] = -7.0
    assert torch.equal(L.attention_decode(tblk.attn, tcfg, tx, kc2, vc2,
                                          index), got)
    _close(f"mlp[{arch}]", L.mlp_fwd(tblk.mlp, tx),
           RL.mlp_fwd(rblk["mlp"], jx), dtype)


# ----------------------------------------------------------- decode step
def _decode_errors(arch, dtype, steps):
    rcfg, tcfg, rp, tp = _models(arch, dtype)
    B, Smax = 2, 8
    toks = np.random.default_rng(2).integers(0, rcfg.vocab_size,
                                             (B, steps))
    rc = ref_init_cache(rcfg, B, Smax)
    tc = init_cache(tcfg, B, Smax, device="cpu")
    errs = []
    for i in range(steps):
        want, rc = ref_decode_step(rp, rcfg, jnp.asarray(toks[:, i:i + 1],
                                                         jnp.int32),
                                   rc, jnp.int32(i))
        got, tc = decode_step(tp, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                              tc, i)
        assert got.dtype == torch.float32 and got.shape == (B,
                                                            rcfg.vocab_size)
        errs.append(float(np.abs(got.numpy() - np.asarray(want)).max()))
    k_ref = np.asarray(jnp.asarray(rc[0]["b0_attn"]["kv"]["k"], jnp.float32))
    return errs, k_ref, tc[0]["k"].float().numpy()


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_logits_float32(arch):
    errs, k_ref, k_got = _decode_errors(arch, "float32", 6)
    print(f"decode_step[{arch}, float32]: max |logit error| per step "
          f"{[f'{e:.2e}' for e in errs]}")
    assert max(errs) <= 1e-4
    np.testing.assert_allclose(k_got, k_ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_logits_bfloat16_step0(arch):
    errs, _, _ = _decode_errors(arch, "bfloat16", 1)
    print(f"decode_step[{arch}, bfloat16]: step-0 max |logit error| "
          f"{errs[0]:.4f}")
    assert errs[0] <= BF16_TOL


# -------------------------------------------------------------- generate
PROMPT = np.random.default_rng(3).integers(0, 256, (2, 6)).astype(np.int32)


@pytest.fixture(scope="module")
def served():
    """The float32 qwen3 smoke model in both packages, and the reference's
    generate runs (greedy, sampled at T = 0.8), each made once."""
    rcfg, tcfg, rp, tp = _models("qwen3-0.6b", "float32")
    want = {}
    for greedy in (True, False):
        want[greedy] = np.asarray(ref_generate(
            rp, rcfg, jnp.asarray(PROMPT),
            RefGenerateConfig(max_new_tokens=6, temperature=0.8,
                              greedy=greedy), key=jax.random.key(2)))
    return tcfg, tp, want


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_generate_equals_reference(served, greedy):
    tcfg, tp, want = served
    got = generate(tp, tcfg, torch.from_numpy(PROMPT),
                   GenerateConfig(max_new_tokens=6, temperature=0.8,
                                  greedy=greedy),
                   key=key_data(2)).numpy()
    assert got.dtype == np.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got[:, :6], PROMPT)
    np.testing.assert_array_equal(got, want[greedy])


def test_generate_defaults_match_reference():
    assert dataclasses.asdict(GenerateConfig()) == \
        dataclasses.asdict(RefGenerateConfig())


def test_model_and_cache_default_to_the_card():
    """Without ``device="cpu"`` the model, its weights and its cache go to
    the card, and asking for it without one raises."""
    cfg = configs.get_smoke("qwen3-0.6b")
    builders = (lambda: DecoderLM(cfg),
                lambda: init_params(cfg, torch.Generator(
                    "cuda" if torch.cuda.is_available() else "cpu")),
                lambda: init_cache(cfg, 2, 4)[0]["k"],
                lambda: L.init_kv_cache(cfg, 2, 4, 1)[0])
    for build_one in builders:
        if torch.cuda.is_available():
            got = build_one()
            dev = got.embed.device if isinstance(got, DecoderLM) \
                else got.device
            assert dev.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                build_one()
    with pytest.raises(ValueError, match="generator"):
        init_params(cfg, torch.Generator(), device="meta")


@pytest.mark.cuda
def test_generate_refuses_the_plain_sampler_on_card(cuda_device):
    """``use_pallas_sampler=False`` would sample on the card without K8."""
    cfg = configs.get_smoke("qwen3-0.6b")
    model = init_params(cfg, torch.Generator(cuda_device).manual_seed(0),
                        device=cuda_device)
    prompt = torch.zeros((2, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="K8"):
        generate(model, cfg, prompt, GenerateConfig(
            max_new_tokens=2, use_pallas_sampler=False))


def test_decode_step_updates_the_cache_in_place():
    cfg = configs.get_smoke("qwen3-0.6b")
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    caches = init_cache(cfg, 2, 4, device="cpu")
    k = caches[0]["k"]
    assert k.shape == (cfg.num_layers, 2, 4, cfg.num_kv_heads, cfg.head_dim)
    tokens = torch.zeros((2, 1), dtype=torch.long)
    logits, out = decode_step(model, cfg, tokens, caches, 0)
    assert out[0]["k"] is k and logits.shape == (2, cfg.vocab_size)
    assert k[:, :, 0].abs().sum() > 0 and not k[:, :, 1:].any()


def test_serve_launcher_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "3", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "token_sample launches: 0" in out and "on the host CPU" in out
    reqs = [ln for ln in out.splitlines() if ln.startswith("  req")]
    assert len(reqs) == 2 and all(
        len(ast.literal_eval(r.split(" ", 4)[-1])) == 7 for r in reqs)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--arch", "qwen3-0.6b", "--smoke"])
