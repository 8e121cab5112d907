"""The card a run measures: its presence, name, power limit and peak."""

from __future__ import annotations

import subprocess
from typing import Optional


class NoCard(RuntimeError):
    """The run asks for more cards than this machine shows."""


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False: this benchmark runs only on a card")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"the cell asks for {n} cards and torch.cuda.device_count() is {have}")


def describe(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": count,
                "memory_peak_bytes": 0}
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": count,
        "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
    }


def power_limit() -> Optional[str]:
    """nvidia-smi's name and power limit of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
