"""Serving launcher of the port: batched generation with the Gumbel-max
token sampler (K8) on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --batch 8 --prompt-len 16 --new-tokens 32

``--smoke`` serves the architecture's reduced config; ``--device cpu``
runs on the CPU with the sampler's plain version.  Weights are random
(``init_params`` from a ``torch.Generator`` seeded 0), prompts are
uniform token ids from numpy's ``default_rng(1)``, and the sampler's key
is ``key_data(2)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.device import DEVICES, resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.prng import key_data
from repro_torch.models import init_params
from repro_torch.serving import GenerateConfig, generate


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the architecture's reduced config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--greedy", action="store_true")
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "the host CPU"
    print(f"[serve] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params on "
          f"{where}")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int32))
    gcfg = GenerateConfig(max_new_tokens=args.new_tokens,
                          temperature=args.temperature, greedy=args.greedy)
    build.reset_launches()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompts.to(dev), gcfg, key=key_data(2))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] {args.batch}×{args.new_tokens} tokens in {dt:.2f}s "
          f"({args.batch * args.new_tokens / dt:.1f} tok/s on {where}); "
          f"token_sample launches: {build.LAUNCHES['token_sample']}")
    for b, row in enumerate(out.cpu().tolist()):
        print("  req", b, row)


if __name__ == "__main__":
    main()
