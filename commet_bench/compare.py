"""Comparisons of the program's outputs with the reference's: counts of
what differs, each held against its limit."""

from __future__ import annotations

import numpy as np
import torch

_POPCOUNT = torch.tensor([bin(i).count("1") for i in range(256)],
                         dtype=torch.int64)


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Bits that differ between two equal-length uint8 tensors on one
    device (chunked: a few GB at a time)."""
    if a.shape != b.shape:
        return 8 * max(a.numel(), b.numel())
    if torch.equal(a, b):
        return 0
    lut = _POPCOUNT.to(a.device)
    total, step = 0, 1 << 28
    for s in range(0, a.numel(), step):
        x = torch.bitwise_xor(a[s:s + step], b[s:s + step])
        total += int(lut[x.to(torch.int64)].sum())
    return total


def planes_differ(port_planes: torch.Tensor, ref_packed: torch.Tensor) -> int:
    """Bits that differ between the program's plane set (int32 words
    carrying uint32 bits) and the reference's packed planes."""
    mine = port_planes.contiguous().view(torch.uint8)
    return bits_differ(mine, ref_packed.to(mine.device))


def tags_differ(got: np.ndarray, want: np.ndarray) -> int:
    if got.shape != want.shape:
        return max(len(got), len(want))
    return int((got != want).sum())
