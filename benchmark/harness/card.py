"""The cards a run uses: refusal without them, their name and power
limit, and the result line's `device` entry."""

from __future__ import annotations

import subprocess


class NoCard(RuntimeError):
    """The run asked for more cards than the machine has (or none)."""


def require_cards(n: int) -> None:
    """Raise NoCard unless torch sees at least `n` CUDA devices.  A
    benchmark run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: this benchmark runs on the card only")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the cell needs {n} cards, torch sees {have}")


def name_and_limit() -> str:
    """nvidia-smi's name and power limit of the first card, as it prints
    them ("NVIDIA H100 80GB HBM3, 700.00 W")."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_entry(count: int, memory_peak_bytes: int) -> dict:
    """The result line's `device`: platform, torch's card name, the card
    count, the peak allocated bytes on the fullest card, and nvidia-smi's
    name and power limit ("card")."""
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak_bytes), "card": name_and_limit()}
