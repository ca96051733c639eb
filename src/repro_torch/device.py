"""Device resolution for the PyTorch port.

The port runs on the card unless the caller names another device. There is
no silent fallback: asking for the default device on a machine without CUDA
raises, so a run that was meant for the GPU can never measure the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` resolves to ``cuda`` and raises when no CUDA device is
    present; anything else is taken as given (tests pass ``"cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly "
                "to run the port's plain PyTorch path on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
