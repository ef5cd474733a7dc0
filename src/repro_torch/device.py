"""Device resolution and float32 numerics for the port.

No JAX counterpart: JAX picks its backend globally (``JAX_PLATFORMS``); the
port threads an explicit ``device`` through its entry points instead.
"""
from __future__ import annotations

import torch


def set_numerics() -> None:
    """Keep float32 products in full float32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default) raises
    when no card is visible: the port never moves to the CPU on its own —
    the caller asks for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def wait(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a host clock then times it);
    nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
