"""Device resolution for the port's entry points: no fallback."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent
    (the port never moves work to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain versions"
        )
    return dev
