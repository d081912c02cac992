"""The gather and 2-bit pack of a read batch on the device, from a set's
one-byte codes already there.

The host route (engine.EncodedSet.gather_packed, the native
cio_gather_packed) gathers rows of a set's flat codes and packs them into
the wire format every kernel takes; ``gather_pack`` makes the same batch
where the codes live: a CUDA tensor runs the hand-written kernel
``csrc/pack.cu`` (``commet_gather_pack``, counted in
``gather_pack.launches``), a CPU tensor runs ``gather_pack_plain``.

The batch: ``codes2`` [n, ceil(lpad/16)] int32 (base p at bits 2*(p%16) of
word p/16, 0 where invalid or past the read), ``valid`` [n, ceil(lpad/32)]
int32 (bit p%32 of word p/32 set where base p is valid), both uint32 bit
patterns (keys.py), and ``lengths`` [n] int32, each read's length cut to
lpad.
"""

from __future__ import annotations

import ctypes

import torch

from commet_tpu_torch.core import keys
from commet_tpu_torch.core.planes import _as_int32

# the codes buffer's start and length are multiples of this many bytes, so
# the kernel's aligned 4-byte loads stay inside it
CODES_ALIGN = 4


def gather_pack_plain(codes: torch.Tensor, offsets: torch.Tensor,
                      lengths: torch.Tensor, ids: torch.Tensor, lpad: int):
    """gather_pack in plain PyTorch: each read's first lpad positions
    gathered as int64 codes (INVALID_CODE past its length), then the valid
    and code bits shifted into their words and summed."""
    n = ids.shape[0]
    nw2, nwv = -(-lpad // 16), -(-lpad // 32)
    rows = ids.to(torch.int64)
    ln = lengths[rows].to(torch.int64).clamp(max=lpad)
    pos = torch.arange(32 * nwv, dtype=torch.int64, device=codes.device)
    inside = pos[None, :] < ln[:, None]
    c = torch.full((n, 32 * nwv), keys.INVALID_CODE, dtype=torch.int64,
                   device=codes.device)
    c[inside] = codes[(offsets[rows][:, None] + pos[None, :])[inside]].to(
        torch.int64)
    ok = c < keys.INVALID_CODE
    bits = torch.arange(32, dtype=torch.int64, device=codes.device)
    valid = (ok.to(torch.int64).view(n, nwv, 32) << bits).sum(dim=-1)
    code = torch.where(ok, c, 0).view(n, 2 * nwv, 16)
    codes2 = (code << (2 * bits[:16])).sum(dim=-1)[:, :nw2]
    return _as_int32(codes2), _as_int32(valid), ln.to(torch.int32)


def _check(fn, name, x, dtype, device):
    if x.device != device or x.dtype != dtype or x.dim() != 1 \
            or not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous 1-D {dtype} "
                         f"tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def gather_pack(codes: torch.Tensor, offsets: torch.Tensor,
                lengths: torch.Tensor, ids: torch.Tensor, lpad: int):
    """(codes2, valid, lengths) of reads ``ids`` padded to ``lpad``
    positions, bit for bit what EncodedSet.gather_packed gives for the same
    rows: ``codes`` uint8 [bases] (a multiple of CODES_ALIGN bytes from an
    aligned start), ``offsets`` int64 and ``lengths`` int32 [reads], ``ids``
    int64 [n] (reads past the offsets are not checked: the device would have
    to be asked), all on one device. A CUDA tensor runs csrc/pack.cu, a CPU
    tensor gather_pack_plain."""
    fn = "gather_pack"
    device = codes.device
    for name, x, dtype in (("codes", codes, torch.uint8),
                           ("offsets", offsets, torch.int64),
                           ("lengths", lengths, torch.int32),
                           ("ids", ids, torch.int64)):
        _check(fn, name, x, dtype, device)
    if offsets.shape != lengths.shape or lpad < 1:
        raise ValueError(f"{fn}: {offsets.shape[0]} offsets, "
                         f"{lengths.shape[0]} lengths, lpad {lpad}")
    if device.type == "cpu":
        return gather_pack_plain(codes, offsets, lengths, ids, lpad)
    if device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {device}")
    if codes.numel() % CODES_ALIGN or codes.data_ptr() % CODES_ALIGN:
        raise ValueError(f"{fn}: codes must start on a {CODES_ALIGN}-byte "
                         f"boundary and be a multiple of {CODES_ALIGN} bytes "
                         f"long, got {codes.numel()} bytes at "
                         f"{codes.data_ptr():#x}")
    n = ids.shape[0]
    codes2 = torch.empty((n, -(-lpad // 16)), dtype=torch.int32,
                         device=device)
    valid = torch.empty((n, -(-lpad // 32)), dtype=torch.int32,
                        device=device)
    lens = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return codes2, valid, lens
    from commet_tpu_torch.core import _cuda
    lib = _cuda.load("pack")
    ptr = [ctypes.c_void_p(x.data_ptr())
           for x in (codes, offsets, lengths, ids, codes2, valid, lens)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.commet_gather_pack(*ptr[:4], ctypes.c_int64(n),
                                     ctypes.c_int(lpad), *ptr[4:],
                                     ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"commet_gather_pack launch failed: cudaError "
                           f"{err}")
    gather_pack.launches += 1
    return codes2, valid, lens


gather_pack.launches = 0
