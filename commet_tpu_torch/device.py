"""Device selection: the caller names the device; nothing falls back."""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) requires a CUDA card and raises when
    there is none; ``"cpu"`` runs the kernels' plain PyTorch versions and is
    taken only when the caller asks for it."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but no CUDA card is available "
                "(pass --device cpu to run the plain PyTorch path)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
