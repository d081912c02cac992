"""The dense-plane membership structure: four bit planes of 2^k bits per
index partition, their build and their probe.

Counterpart of the plane part of commet_tpu/core/kernels.py. The reference's
"Bloom filter" (include/bloom_filter.h) maps each of four projections of a
window's (keya, keyb) pair injectively to one bit: plane A = keya, B = keyb,
C = keya ^ keyb, D = keya | keyb. A window is a member when all four bits are
set; a read is tagged when either strand has t greedy non-overlapping members
(search_reads.h:34-87).

Layout: one flat int32 tensor of ``4 * plane_words(k)`` words carrying uint32
bit patterns (torch has no uint32 arithmetic), plane p at words
[p * plane_words(k), (p + 1) * plane_words(k)). Keys are whole int64 values for
k <= 36, so a key's word is ``key >> 5`` and its bit ``key & 31`` at every k
(commet_tpu splits keys into uint32 (lo, hi) and addresses
``(lo >> 5) | (hi << 27)``, the same word).

The build and the probes run the hand-written CUDA kernels of
``csrc/planes.cu`` on a CUDA tensor and their plain PyTorch versions on a CPU
tensor; each kernel wrapper counts its launches in ``.launches``. The build
updates the planes in place (commet_tpu's build returns a new array).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from commet_tpu_torch.core import greedy, keys

SIGN = 1 << 31


def plane_words(k: int) -> int:
    """uint32 words per plane (2^k bits, at least one word)."""
    return 1 << (k - 5) if k >= 5 else 1


def plane_bytes(k: int) -> int:
    """Device bytes of one four-plane set."""
    return 4 * plane_words(k) * 4


def _check_k(fn: str, k: int) -> None:
    if not 1 <= k <= keys.MAX_K:
        raise ValueError(f"{fn}: k={k} outside 1..{keys.MAX_K}")


def alloc_planes(k: int, device) -> torch.Tensor:
    """Zeroed four-plane set [4 * plane_words(k)] int32 on ``device``."""
    _check_k("alloc_planes", k)
    return torch.zeros(4 * plane_words(k), dtype=torch.int32,
                       device=torch.device(device))


def plane_addr(key: torch.Tensor):
    """(word, bit) of int64 keys in their plane: key >> 5, key & 31."""
    return key >> 5, key & 31


def four_plane_keys(a: torch.Tensor, b: torch.Tensor):
    """The keys planes A, B, C, D hold for window pairs (a, b)."""
    return a, b, a ^ b, a | b


def _unpack(codes2, valid_or_lengths, clean: bool, length: int):
    if clean:
        return keys.unpack_codes_clean(codes2, valid_or_lengths, length)
    return keys.unpack_codes(codes2, valid_or_lengths, length)


def _wmax(length: int, k: int, wmax: Optional[int]) -> int:
    return max(1, length - k + 1) if wmax is None else int(wmax)


# --------------------------------------------------------------------------
# Argument checks shared by the kernel wrappers
# --------------------------------------------------------------------------

def _check_int32(fn: str, name: str, x: torch.Tensor, dim: int,
                 device: torch.device) -> None:
    if x.device != device or x.dtype != torch.int32 or x.dim() != dim \
            or not x.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous {dim}-D int32 "
                         f"tensor on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _check_planes(fn: str, planes: torch.Tensor, k: int,
                  device: torch.device) -> None:
    _check_int32(fn, "planes", planes, 1, device)
    if planes.numel() != 4 * plane_words(k):
        raise ValueError(f"{fn}: planes hold {planes.numel()} words, k={k} "
                         f"needs {4 * plane_words(k)}")


def _check_batch(fn: str, codes2: torch.Tensor, aux: torch.Tensor,
                 clean: bool, length: int, k: int) -> None:
    """codes2 [B, >= ceil(length/16)] int32; aux the lengths [B] int32
    (clean) or the validity words [B, >= ceil(length/32)] int32."""
    _check_k(fn, k)
    device = codes2.device
    _check_int32(fn, "codes2", codes2, 2, device)
    if length < 0 or codes2.shape[1] * 16 < length:
        raise ValueError(f"{fn}: codes2 has {codes2.shape[1]} words a read, "
                         f"too few for length {length}")
    if clean:
        _check_int32(fn, "lengths", aux, 1, device)
        if aux.shape[0] != codes2.shape[0]:
            raise ValueError(f"{fn}: {aux.shape[0]} lengths for "
                             f"{codes2.shape[0]} reads")
    else:
        _check_int32(fn, "valid", aux, 2, device)
        if aux.shape[0] != codes2.shape[0] or aux.shape[1] * 32 < length:
            raise ValueError(f"{fn}: valid {tuple(aux.shape)} does not "
                             f"cover {codes2.shape[0]} reads of {length}")


def _launch(fn_name: str, *args) -> None:
    from commet_tpu_torch.core import _cuda
    lib = _cuda.load("planes")
    err = getattr(lib, fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {err}")


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _batch_args(codes2, aux, clean: bool, length: int):
    nwv = 0 if clean else aux.shape[1]
    return (_ptr(codes2), ctypes.c_int64(codes2.shape[1]), _ptr(aux),
            ctypes.c_int64(nwv), ctypes.c_int(int(clean)),
            ctypes.c_int64(codes2.shape[0]), ctypes.c_int(length))


# --------------------------------------------------------------------------
# Build
# --------------------------------------------------------------------------

def _bit_value(bit: torch.Tensor) -> torch.Tensor:
    """1 << bit as the int32 bit pattern (bit 31 is the sign bit)."""
    v = torch.ones_like(bit) << bit
    return torch.where(v >= SIGN, v - (1 << 32), v).to(torch.int32)


def build_planes_plain(planes: torch.Tensor, codes2, valid_or_lengths,
                       clean: bool, length: int, k: int) -> torch.Tensor:
    """Set the four plane bits of every valid forward window of the batch,
    in place, in plain PyTorch: per plane the unique keys, less the bits
    already set (a gather of their words), then one accumulating
    ``index_put_`` over all four planes. A sum of distinct bits of a word is
    their OR (also through the int32 sign bit), so the add is a scatter-OR.
    Allocates per window, never per plane bit."""
    w = plane_words(k)
    a, b = keys.index_keys(_unpack(codes2, valid_or_lengths, clean, length),
                           k)
    idx, val = [], []
    for p, key in enumerate(four_plane_keys(a, b)):
        word, bit = plane_addr(torch.unique(key))
        flat = word + p * w
        have = (planes[flat].to(torch.int64) >> bit) & 1
        new = have == 0
        idx.append(flat[new])
        val.append(_bit_value(bit[new]))
    planes.index_put_((torch.cat(idx),), torch.cat(val), accumulate=True)
    return planes


def build_planes(planes: torch.Tensor, codes2, valid_or_lengths,
                 clean: bool, length: int, k: int) -> torch.Tensor:
    """Set the four plane bits of every complete forward window of a packed
    batch (reference index_reads.h:49-61), in place; returns ``planes``.
    ``clean``: ``valid_or_lengths`` holds the lengths [B] int32 (N-free
    reads), else the validity words. Counterpart of kernels.build_chunk_packed
    / build_chunk_packed_clean: a CUDA tensor runs csrc/planes.cu
    (commet_build_planes, counted in ``build_planes.launches``), a CPU tensor
    runs build_planes_plain."""
    fn = "build_planes"
    _check_batch(fn, codes2, valid_or_lengths, clean, length, k)
    _check_planes(fn, planes, k, codes2.device)
    if codes2.device.type == "cpu":
        return build_planes_plain(planes, codes2, valid_or_lengths, clean,
                                  length, k)
    if codes2.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {codes2.device}")
    if codes2.shape[0] == 0:
        return planes
    with torch.cuda.device(codes2.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("commet_build_planes", _ptr(planes), ctypes.c_int64(
            plane_words(k)), *_batch_args(codes2, valid_or_lengths, clean,
                                          length),
                ctypes.c_int(k), ctypes.c_void_p(stream))
    build_planes.launches += 1
    return planes


build_planes.launches = 0


# --------------------------------------------------------------------------
# Probe
# --------------------------------------------------------------------------

def _plane_member(planes: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  k: int) -> torch.Tensor:
    """All four plane bits set, for [B, W] key pairs: four gathers."""
    w = plane_words(k)
    hit = None
    for p, key in enumerate(four_plane_keys(a, b)):
        word, bit = plane_addr(key)
        got = (planes[word + p * w].to(torch.int64) >> bit) & 1
        hit = got == 1 if hit is None else hit & (got == 1)
    return hit


def _probe_keys(planes: torch.Tensor, wk, k: int, t: int) -> torch.Tensor:
    tagged = None
    for s in ("f", "r"):
        ok = wk["ok"]
        # keys of invalid windows are unspecified: address word 0 instead
        a = torch.where(ok, wk[s + "a"], 0)
        b = torch.where(ok, wk[s + "b"], 0)
        tag = greedy.greedy_ge(_plane_member(planes, a, b, k) & ok, k, t)
        tagged = tag if tagged is None else tagged | tag
    return tagged


def probe_planes_plain(planes: torch.Tensor, codes2, valid_or_lengths,
                       clean: bool, length: int, k: int, t: int,
                       wmax: Optional[int] = None) -> torch.Tensor:
    """Tags [B] bool in plain PyTorch: window keys, four gathers per window
    and strand, greedy_ge per strand."""
    wk = keys.window_keys(_unpack(codes2, valid_or_lengths, clean, length),
                          k, "both", _wmax(length, k, wmax))
    return _probe_keys(planes, wk, k, t)


def probe_planes(planes: torch.Tensor, codes2, valid_or_lengths, clean: bool,
                 length: int, k: int, t: int,
                 wmax: Optional[int] = None) -> torch.Tensor:
    """Tags [B] bool of a packed batch against one plane set: a read is
    tagged when its forward or its reverse-complement strand has t greedy
    non-overlapping windows whose four plane bits are all set, windows
    0 .. wmax - 1 (wmax defaults to length - k + 1). Counterpart of
    kernels.search_batch(_fwd/_rc)(_packed): a CUDA tensor runs
    csrc/planes.cu (commet_probe_planes, counted in
    ``probe_planes.launches``), a CPU tensor runs probe_planes_plain."""
    fn = "probe_planes"
    _check_batch(fn, codes2, valid_or_lengths, clean, length, k)
    _check_planes(fn, planes, k, codes2.device)
    if codes2.device.type == "cpu":
        return probe_planes_plain(planes, codes2, valid_or_lengths, clean,
                                  length, k, t, wmax)
    if codes2.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {codes2.device}")
    out = torch.empty(codes2.shape[0], dtype=torch.bool, device=codes2.device)
    if codes2.shape[0] == 0:
        return out
    with torch.cuda.device(codes2.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("commet_probe_planes", _ptr(planes), ctypes.c_int64(
            plane_words(k)), *_batch_args(codes2, valid_or_lengths, clean,
                                          length),
                ctypes.c_int(k), ctypes.c_int(t),
                ctypes.c_int(_wmax(length, k, wmax)), _ptr(out),
                ctypes.c_void_p(stream))
    probe_planes.launches += 1
    return out


probe_planes.launches = 0


class PlaneSlots:
    """The S plane sets one grouped probe launch serves (each a contiguous
    int32 four-plane set of one size, on one device), and on the card the
    device table of their addresses, [S] int64. The object holds the plane
    tensors, so the addresses stay valid as long as the table."""

    def __init__(self, planes_list: List[torch.Tensor]):
        planes_list = list(planes_list)
        if not planes_list:
            raise ValueError("PlaneSlots: need S >= 1 plane sets")
        self.device = planes_list[0].device
        size = planes_list[0].numel()
        for s, p in enumerate(planes_list):
            _check_int32("PlaneSlots", f"planes[{s}]", p, 1, self.device)
            if p.numel() != size:
                raise ValueError(f"PlaneSlots: planes[{s}] holds "
                                 f"{p.numel()} words, planes[0] {size}")
        self.planes = planes_list
        self.table = None
        if self.device.type == "cuda":
            self.table = torch.tensor([p.data_ptr() for p in planes_list],
                                      dtype=torch.int64).to(self.device)

    def __len__(self) -> int:
        return len(self.planes)


def probe_planes_multi_plain(planes_list, codes2, valid_or_lengths,
                             clean: bool, length: int, k: int, t: int,
                             wmax: Optional[int] = None) -> torch.Tensor:
    """[S, B] tags in plain PyTorch: the window keys once, then each plane
    set's gathers and greedy counts."""
    wk = keys.window_keys(_unpack(codes2, valid_or_lengths, clean, length),
                          k, "both", _wmax(length, k, wmax))
    return torch.stack([_probe_keys(p, wk, k, t) for p in planes_list])


def probe_planes_multi(slots: PlaneSlots, codes2, valid_or_lengths,
                       clean: bool, length: int, k: int, t: int,
                       wmax: Optional[int] = None) -> torch.Tensor:
    """Tags [S, B] bool of one packed batch against each of the S plane sets
    of ``slots``, row s for slot s, from one upload of the batch. Replaces
    what commet_tpu's probe_cascade2_multi_* serve in the plane cohorts,
    with exact tags in one pass: a CUDA tensor runs one launch of
    csrc/planes.cu (commet_probe_planes_multi, counted in
    ``probe_planes_multi.launches``), a CPU tensor runs
    probe_planes_multi_plain."""
    fn = "probe_planes_multi"
    _check_batch(fn, codes2, valid_or_lengths, clean, length, k)
    if codes2.device != slots.device:
        raise ValueError(f"{fn}: batch on {codes2.device}, planes on "
                         f"{slots.device}")
    _check_planes(fn, slots.planes[0], k, slots.device)
    if codes2.device.type == "cpu":
        return probe_planes_multi_plain(slots.planes, codes2,
                                        valid_or_lengths, clean, length, k,
                                        t, wmax)
    if codes2.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {codes2.device}")
    n_s = len(slots)
    if n_s > 65535:
        raise ValueError(f"{fn}: {n_s} slots exceed the grid's 65535")
    out = torch.empty((n_s, codes2.shape[0]), dtype=torch.bool,
                      device=codes2.device)
    if codes2.shape[0] == 0:
        return out
    with torch.cuda.device(codes2.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("commet_probe_planes_multi", _ptr(slots.table),
                ctypes.c_int64(n_s), ctypes.c_int64(plane_words(k)),
                *_batch_args(codes2, valid_or_lengths, clean, length),
                ctypes.c_int(k), ctypes.c_int(t),
                ctypes.c_int(_wmax(length, k, wmax)), _ptr(out),
                ctypes.c_void_p(stream))
    probe_planes_multi.launches += 1
    return out


probe_planes_multi.launches = 0
