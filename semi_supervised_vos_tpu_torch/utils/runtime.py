"""Device selection."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``cuda`` or ``cpu`` → a torch device. ``cuda`` without a usable card
    raises: the port never falls back to the CPU on its own."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was requested but no CUDA device is available; "
            "pass --device cpu to run on the CPU"
        )
    return torch.device(name)
