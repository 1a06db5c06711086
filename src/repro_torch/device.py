"""Device choice for the port's entry points: the card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; with no card present that raises
    instead of running silently on the CPU. Pass ``device="cpu"`` to run
    there on purpose."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device present; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
