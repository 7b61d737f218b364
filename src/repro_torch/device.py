"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device`` ("cuda" by default).

    Asking for CUDA where none exists raises: the port never carries on
    silently on the CPU.  Pass ``device="cpu"`` to run the plain PyTorch
    versions of the kernels; ``"meta"`` builds shapes only (a model's
    parameter count) and runs nothing."""
    dev = torch.device(device)
    if dev.type == "meta":
        return dev
    if dev.type not in DEVICES:
        raise ValueError(f"device {device!r} is not one of {DEVICES}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions")
    return dev
