"""Architecture registry and input shapes: the port's own copy of the
reference's ``repro/configs`` (pure data, the same values).

Every architecture has a FULL config (published dimensions) and a SMOKE
config (same family, reduced widths and depth) that the tests run on the
CPU.  The port serves the families whose every layer is ``attn`` (dense,
vlm, audio); ``chip_smoke.py`` serves ``qwen3-0.6b``'s FULL config on the
card.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig

_MODULES = {
    "minicpm-2b": "minicpm_2b",
    "yi-6b": "yi_6b",
    "qwen3-8b": "qwen3_8b",
    "qwen3-0.6b": "qwen3_0_6b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "chameleon-34b": "chameleon_34b",
    "mamba2-1.3b": "mamba2_1_3b",
    "musicgen-medium": "musicgen_medium",
}

ARCHS: List[str] = list(_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def train_schedule(arch: str) -> str:
    return getattr(_module(arch), "TRAIN_SCHEDULE", "cosine")


def cell_supported(arch: str, shape: str) -> Tuple[bool, str]:
    """Whether (arch × shape) is a valid dry-run cell.

    long_500k needs sub-quadratic attention: run for SSM/hybrid, skip for
    pure full-attention archs (recorded in DESIGN.md §Arch-applicability).
    All 10 archs are decoders, so decode shapes otherwise apply.
    """
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.supports_long_context:
        return False, ("full quadratic attention at 524k context — "
                       "skipped per assignment (sub-quadratic archs only)")
    return True, ""


def all_cells(include_skipped: bool = False):
    for arch in ARCHS:
        for shape in SHAPES:
            ok, why = cell_supported(arch, shape)
            if ok or include_skipped:
                yield arch, shape, ok, why
