"""Device selection for the port's entry points: they run on the card
unless the caller asks for the CPU, and never fall back silently."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}")
    return d
