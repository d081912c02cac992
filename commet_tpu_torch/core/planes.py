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

A shard of a plane set sharded on the word axis (parallel/sharded.py) holds
words [lo, lo + wl) of each plane as its own [4 * wl] int32 tensor, plane p
at [p * wl, (p + 1) * wl). Its build is ``build_planes_range``; its probe,
over windows packed 32 to an int32 word ([B, 2, window_words(wmax)], bit
w % 32 of word w // 32, strand 0 forward), is ``probe_planes_part_a`` (pass
A: the A hits in range) then ``probe_planes_part`` (pass B/C/D: the vetoes
of windows whose merged A bit is set).
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
                       clean: bool, length: int, k: int, lo: int = 0,
                       wl: Optional[int] = None) -> torch.Tensor:
    """Set the four plane bits of every valid forward window of the batch,
    in place, in plain PyTorch: per plane the unique keys, less the bits
    already set (a gather of their words), then one accumulating
    ``index_put_`` over all four planes. A sum of distinct bits of a word is
    their OR (also through the int32 sign bit), so the add is a scatter-OR.
    Allocates per window, never per plane bit. With ``lo`` and ``wl``,
    ``planes`` is a shard holding words [lo, lo + wl) of each plane, and
    only the bits whose word lies there are set."""
    w = plane_words(k) if wl is None else wl
    a, b = keys.index_keys(_unpack(codes2, valid_or_lengths, clean, length),
                           k)
    idx, val = [], []
    for p, key in enumerate(four_plane_keys(a, b)):
        word, bit = plane_addr(torch.unique(key))
        word = word - lo
        mine = (word >= 0) & (word < w)
        word, bit = word[mine], bit[mine]
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


def _check_shard(fn: str, shard: torch.Tensor, k: int, lo: int, wl: int,
                 device: torch.device) -> None:
    _check_int32(fn, "shard", shard, 1, device)
    if wl < 1 or lo < 0 or lo + wl > plane_words(k) or shard.numel() != 4 * wl:
        raise ValueError(f"{fn}: a shard of {shard.numel()} words cannot "
                         f"hold words [{lo}, {lo + wl}) of k={k}'s "
                         f"{plane_words(k)}-word planes")


def build_planes_range(shard: torch.Tensor, codes2, valid_or_lengths,
                       clean: bool, length: int, k: int, lo: int,
                       wl: int) -> torch.Tensor:
    """build_planes into one shard of a plane set sharded on the word axis:
    ``shard`` [4 * wl] int32 holds words [lo, lo + wl) of each plane, and
    only the bits whose word lies there are set, in place; returns
    ``shard``. Counterpart of the _build of commet_tpu's
    sharded.build_search_step: a CUDA tensor runs csrc/planes.cu
    (commet_build_planes_range, counted in ``build_planes_range.launches``),
    a CPU tensor runs build_planes_plain with the range."""
    fn = "build_planes_range"
    _check_batch(fn, codes2, valid_or_lengths, clean, length, k)
    _check_shard(fn, shard, k, lo, wl, codes2.device)
    if codes2.device.type == "cpu":
        return build_planes_plain(shard, codes2, valid_or_lengths, clean,
                                  length, k, lo, wl)
    if codes2.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {codes2.device}")
    if codes2.shape[0] == 0:
        return shard
    with torch.cuda.device(codes2.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("commet_build_planes_range", _ptr(shard), ctypes.c_int64(wl),
                ctypes.c_int64(lo), *_batch_args(codes2, valid_or_lengths,
                                                 clean, length),
                ctypes.c_int(k), ctypes.c_void_p(stream))
    build_planes_range.launches += 1
    return shard


build_planes_range.launches = 0


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


def window_words(wmax: int) -> int:
    """int32 words of one strand's packed window bits: ceil(wmax / 32)."""
    return (wmax + 31) // 32


def pack_window_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., W] bool -> [..., window_words(W)] int32 bit patterns, bit w % 32
    of word w // 32; the bits past W are 0."""
    lead, w = bits.shape[:-1], bits.shape[-1]
    nw = window_words(w)
    padded = torch.zeros((*lead, nw * 32), dtype=torch.int64,
                         device=bits.device)
    padded[..., :w] = bits
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (padded.view(*lead, nw, 32) << shifts).sum(dim=-1)
    return torch.where(words >= SIGN, words - (1 << 32), words).to(
        torch.int32)


def unpack_window_bits(words: torch.Tensor, wmax: int) -> torch.Tensor:
    """[..., window_words(wmax)] int32 -> [..., wmax] bool, through the
    words' bytes (little-endian: byte j of a word holds its bits 8j ..
    8j + 7), a byte a bit."""
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    bits = (words.contiguous().view(torch.uint8)[..., None] >> shifts) & 1
    return bits.view(torch.bool).reshape(*words.shape[:-1], -1)[..., :wmax]


def _part_bits(shard: torch.Tensor, codes2, valid_or_lengths, clean: bool,
               length: int, k: int, lo: int, wl: int, wmax: Optional[int]):
    """ok [B, W] and, per strand (forward, reverse complement) and plane,
    (word in [lo, lo + wl) of a complete window, its bit set) [B, W] bool:
    _plane_member's gathers, plane by plane, against one shard."""
    wk = keys.window_keys(_unpack(codes2, valid_or_lengths, clean, length),
                          k, "both", _wmax(length, k, wmax))
    ok = wk["ok"]
    strands = []
    for s in ("f", "r"):
        a = torch.where(ok, wk[s + "a"], 0)
        b = torch.where(ok, wk[s + "b"], 0)
        bits = []
        for p, key in enumerate(four_plane_keys(a, b)):
            word, bit = plane_addr(key)
            word = word - lo
            mine = (word >= 0) & (word < wl) & ok
            got = (shard[word.clamp(0, wl - 1) + p * wl].to(torch.int64)
                   >> bit) & 1 == 1
            bits.append((mine, got))
        strands.append(bits)
    return ok, strands


def probe_planes_part_a_plain(shard: torch.Tensor, codes2, valid_or_lengths,
                              clean: bool, length: int, k: int, lo: int,
                              wl: int, wmax: Optional[int] = None
                              ) -> torch.Tensor:
    """Pass A in plain PyTorch: [B, 2, window_words(W)] int32, the bit of
    each complete window whose plane-A word lies in [lo, lo + wl) and whose
    A bit is set."""
    ok, strands = _part_bits(shard, codes2, valid_or_lengths, clean, length,
                             k, lo, wl, wmax)
    return pack_window_bits(torch.stack([bits[0][0] & bits[0][1]
                                         for bits in strands], dim=1))


def probe_planes_part_plain(shard: torch.Tensor, codes2, valid_or_lengths,
                            clean: bool, length: int, k: int, lo: int,
                            wl: int, wmax: Optional[int],
                            ahit: torch.Tensor) -> torch.Tensor:
    """Pass B/C/D in plain PyTorch: [B, 2, window_words(W)] int32 vetoes of
    the windows whose bit in ``ahit`` (the merged pass-A words) is set and
    one of whose B, C, D words lies in [lo, lo + wl) with its bit clear."""
    ok, strands = _part_bits(shard, codes2, valid_or_lengths, clean, length,
                             k, lo, wl, wmax)
    veto = torch.stack([torch.stack([mine & ~got for mine, got in
                                     bits[1:]]).any(dim=0)
                        for bits in strands], dim=1)
    return pack_window_bits(veto & unpack_window_bits(ahit, ok.shape[1]))


def _check_window_words(fn: str, name: str, x: torch.Tensor, b: int, w: int,
                        device: torch.device) -> None:
    _check_int32(fn, name, x, 3, device)
    if tuple(x.shape) != (b, 2, window_words(w)):
        raise ValueError(f"{fn}: {name} {tuple(x.shape)}, expected "
                         f"{(b, 2, window_words(w))}")


def _window_words_out(fn: str, out: Optional[torch.Tensor], codes2,
                      w: int) -> torch.Tensor:
    """``out`` checked, or zeroed [B, 2, window_words(w)] int32."""
    b = codes2.shape[0]
    if out is None:
        return torch.zeros((b, 2, window_words(w)), dtype=torch.int32,
                           device=codes2.device)
    _check_window_words(fn, "out", out, b, w, codes2.device)
    return out


def probe_planes_part_a(shard: torch.Tensor, codes2, valid_or_lengths,
                        clean: bool, length: int, k: int, lo: int, wl: int,
                        wmax: Optional[int] = None,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pass A of the ranged probe against one shard (``shard`` [4 * wl]
    int32, words [lo, lo + wl) of each plane): for read b, strand s (0
    forward, 1 reverse complement) and window w < W (wmax, by default
    length - k + 1), bit w % 32 of word [b, s, w // 32] is set when the
    window is complete, its plane-A word lies in the range and its A bit is
    set. ORed into ``out`` ([B, 2, window_words(W)] int32) where given, so
    the shards of one device accumulate; a word lives on one shard, so the
    OR over all shards is "A is set". Counterpart of the plane-A part of
    commet_tpu's sharded._local_membership and its psum: a CUDA tensor runs
    csrc/planes.cu (commet_probe_planes_part_a, counted in
    ``probe_planes_part_a.launches``), a CPU tensor runs
    probe_planes_part_a_plain."""
    fn = "probe_planes_part_a"
    _check_batch(fn, codes2, valid_or_lengths, clean, length, k)
    _check_shard(fn, shard, k, lo, wl, codes2.device)
    w = _wmax(length, k, wmax)
    out = _window_words_out(fn, out, codes2, w)
    if codes2.shape[0] == 0:
        return out
    if codes2.device.type == "cpu":
        out |= probe_planes_part_a_plain(shard, codes2, valid_or_lengths,
                                         clean, length, k, lo, wl, w)
        return out
    if codes2.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {codes2.device}")
    with torch.cuda.device(codes2.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("commet_probe_planes_part_a", _ptr(shard),
                ctypes.c_int64(wl), ctypes.c_int64(lo),
                *_batch_args(codes2, valid_or_lengths, clean, length),
                ctypes.c_int(k), ctypes.c_int(w), _ptr(out),
                ctypes.c_void_p(stream))
    probe_planes_part_a.launches += 1
    return out


probe_planes_part_a.launches = 0


def probe_planes_part(shard: torch.Tensor, codes2, valid_or_lengths,
                      clean: bool, length: int, k: int, lo: int, wl: int,
                      wmax: Optional[int], ahit: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pass B/C/D of the ranged probe against one shard, packed as
    probe_planes_part_a's and ORed into ``out`` where given: given
    ``ahit``, the merged pass-A words of the batch, bit w is a veto of a
    window whose A bit is set and one of whose B, C, D words lies in the
    range with its bit clear; a window whose A bit is clear loads nothing,
    and a window's three loads go out together. The members are
    ahit & ~(OR of every shard's vetoes). Counterpart of _local_membership's
    B, C, D part and its psum: a CUDA tensor runs csrc/planes.cu
    (commet_probe_planes_part, counted in ``probe_planes_part.launches``),
    a CPU tensor runs probe_planes_part_plain."""
    fn = "probe_planes_part"
    _check_batch(fn, codes2, valid_or_lengths, clean, length, k)
    _check_shard(fn, shard, k, lo, wl, codes2.device)
    w = _wmax(length, k, wmax)
    _check_window_words(fn, "ahit", ahit, codes2.shape[0], w, codes2.device)
    out = _window_words_out(fn, out, codes2, w)
    if codes2.shape[0] == 0:
        return out
    if codes2.device.type == "cpu":
        out |= probe_planes_part_plain(shard, codes2, valid_or_lengths, clean,
                                       length, k, lo, wl, w, ahit)
        return out
    if codes2.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {codes2.device}")
    with torch.cuda.device(codes2.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("commet_probe_planes_part", _ptr(shard), ctypes.c_int64(wl),
                ctypes.c_int64(lo), *_batch_args(codes2, valid_or_lengths,
                                                 clean, length),
                ctypes.c_int(k), ctypes.c_int(w), _ptr(ahit), _ptr(out),
                ctypes.c_void_p(stream))
    probe_planes_part.launches += 1
    return out


probe_planes_part.launches = 0


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
