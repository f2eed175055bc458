"""The port's device rule: every entry point that takes `device` defaults to
the card, and the CPU is used only when the caller passes device="cpu"."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device on a machine without one
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; the port "
            "runs on the card by default: pass device='cpu' to run on the CPU")
    return dev
