"""Per-window k-mer keys from 2-bit packed reads, as whole int64 keys.

Counterparts of commet_tpu/core/kernels.py: ``unpack_codes``,
``unpack_codes_clean`` and ``window_keys``. Key semantics are the
reference's (include/hash_key.h:65-125): keya bit = G/T, keyb bit = C/T;
the forward key holds the window's first base in its top bit, the
reverse-complement key holds the complement of the window's first base in
bit 0. For k <= 36 a key fits one int64, so there is no (lo, hi) split.

Packed words arrive as int32 tensors that carry uint32 bit patterns (torch has
no uint32 arithmetic); ``host_u32`` makes them from numpy uint32 arrays and
the unpackers widen them to int64 with ``& 0xFFFFFFFF``.
"""

from __future__ import annotations

import numpy as np
import torch

INVALID_CODE = 4
MAX_K = 36


def host_u32(arr: np.ndarray) -> torch.Tensor:
    """numpy uint32 -> int32 tensor with the same bits (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(arr, np.uint32).view(np.int32))


def _widen(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int64) & 0xFFFFFFFF


def _bits(words: torch.Tensor, per_word: int, width: int, length: int):
    """[N, nw] packed words -> [N, length] fields of ``width`` bits each,
    field j of word w at bit width*j (LSB first)."""
    n = words.shape[0]
    shifts = torch.arange(per_word, device=words.device) * width
    mask = (1 << width) - 1
    out = (_widen(words)[:, :, None] >> shifts) & mask
    return out.reshape(n, words.shape[1] * per_word)[:, :length]


def unpack_codes(codes2: torch.Tensor, valid: torch.Tensor, length: int):
    """2-bit code words [N, ceil(L/16)] + validity words [N, ceil(L/32)] ->
    [N, L] int64 codes, INVALID_CODE where the validity bit is 0."""
    c = _bits(codes2, 16, 2, length)
    v = _bits(valid, 32, 1, length)
    return torch.where(v == 1, c, INVALID_CODE)


def unpack_codes_clean(codes2: torch.Tensor, lengths: torch.Tensor,
                       length: int):
    """Unpack for reads with no internal invalid base: position < length is
    the validity (the validity plane never travels)."""
    c = _bits(codes2, 16, 2, length)
    pos = torch.arange(length, device=codes2.device)[None, :]
    return torch.where(pos < lengths.to(torch.int64)[:, None], c,
                       INVALID_CODE)


def _windows(bits: torch.Tensor, k: int, msb_first: bool) -> torch.Tensor:
    """Value of every k-bit window of ``bits`` ([B, n] int64 0/1): column j
    holds bits j..j+k-1, the first one in the top bit (msb_first) or in
    bit 0. Binary lifting: log2(k) doublings plus one join per set bit of
    k, each a [B, n] elementwise op, instead of k shift-or passes."""
    n = bits.shape[1]
    cur, clen = bits, 1          # windows of length clen, n - clen + 1 cols
    res, rlen = None, 0          # windows of length rlen, n - rlen + 1 cols
    kk = k
    while True:
        if kk & 1:
            if res is None:
                res, rlen = cur, clen
            else:
                m = n - rlen - clen + 1
                tail = cur[:, rlen:rlen + m]
                if msb_first:
                    res = (res[:, :m] << clen) | tail
                else:
                    res = res[:, :m] | (tail << rlen)
                rlen += clen
        kk >>= 1
        if not kk:
            return res
        m = n - 2 * clen + 1
        if msb_first:
            cur = (cur[:, :m] << clen) | cur[:, clen:clen + m]
        else:
            cur = cur[:, :m] | (cur[:, clen:clen + m] << clen)
        clen *= 2


def window_keys(codes: torch.Tensor, k: int, strand: str = "both",
                wmax=None):
    """Keys of the windows ending at positions k-1 .. k-1+W-1 (W = wmax or
    L-k+1), as [B, W] int64 tensors: ``fa``/``fb`` (forward keya/keyb),
    ``ra``/``rb`` (reverse complement) and ``ok`` (all k bases valid; an
    invalid base resets the run). Keys of windows with ok False are
    unspecified. Equals kernels.window_keys with lo | hi << 32."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside 1..{MAX_K}")
    b, length = codes.shape
    w = max(1, (length - k + 1) if wmax is None else wmax)
    need = k - 1 + w
    if need > length:
        codes = torch.nn.functional.pad(codes, (0, need - length),
                                        value=INVALID_CODE)
    codes = codes[:, :need].to(torch.int64)
    valid = codes < INVALID_CODE
    run = torch.zeros((b, need + 1), dtype=torch.int32, device=codes.device)
    run[:, 1:] = torch.cumsum(valid, dim=1, dtype=torch.int32)
    out = {"ok": (run[:, k:] - run[:, :w]) == k}
    vbit = valid.to(torch.int64)
    abit = ((codes >> 1) & 1) * vbit
    bbit = (codes & 1) * vbit
    if strand in ("both", "fwd"):
        out["fa"] = _windows(abit, k, msb_first=True)
        out["fb"] = _windows(bbit, k, msb_first=True)
    if strand in ("both", "rc"):
        out["ra"] = _windows(1 - abit, k, msb_first=False)
        out["rb"] = _windows(1 - bbit, k, msb_first=False)
    return out


def index_keys(codes: torch.Tensor, k: int):
    """Forward (keya, keyb) of every valid window, flattened: what one batch
    feeds into the sorted index (counterpart of stream.chunk_index_keys*,
    which maps invalid windows to SENTINEL where this drops them)."""
    wk = window_keys(codes, k, "fwd")
    ok = wk["ok"]
    return wk["fa"][ok], wk["fb"][ok]
