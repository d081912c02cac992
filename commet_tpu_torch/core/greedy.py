"""Greedy non-overlapping hit counting (reference search_reads.h:49-63).

Counterparts of commet_tpu/core/kernels.py ``greedy_ge``,
``_greedy_count_fast`` and ``_greedy_count``: a hit at window i clears the
rolling hash, so the next countable window is i + k or later; a read strand
is tagged once the count reaches t.
"""

from __future__ import annotations

import torch

# t above which the unrolled pointer jumps stop paying off
GREEDY_FAST_MAX_T = 16


def greedy_count_fast(member: torch.Tensor, k: int, t: int) -> torch.Tensor:
    """Greedy count capped at t for [B, W] bool hits: a suffix-min "next hit
    at or after i" table plus t pointer jumps."""
    b, w = member.shape
    inf = w + k + 2
    pos = torch.arange(w, device=member.device)
    hitpos = torch.where(member, pos, inf)
    nxt = torch.cummin(hitpos.flip(1), dim=1).values.flip(1)
    cnt = torch.zeros(b, dtype=torch.int64, device=member.device)
    cur = nxt[:, 0]
    for m in range(t):
        found = cur < w
        cnt += found
        if m == t - 1:
            break
        idx = (cur + k).clamp(0, w - 1)
        nxt_val = nxt.gather(1, idx[:, None])[:, 0]
        cur = torch.where(found & (cur + k < w), nxt_val, inf)
    return cnt


def greedy_count(member: torch.Tensor, k: int, t: int) -> torch.Tensor:
    """The sequential form: one step per window position, capped at t."""
    n, w = member.shape
    cnt = torch.zeros(n, dtype=torch.int64, device=member.device)
    allow = torch.zeros(n, dtype=torch.int64, device=member.device)
    for i in range(w):
        hit = member[:, i] & (allow <= i) & (cnt < t)
        cnt += hit
        allow = torch.where(hit, i + k, allow)
    return cnt


def greedy_ge(member: torch.Tensor, k: int, t: int) -> torch.Tensor:
    """greedy(member) >= t over the last axis of a [..., W] bool tensor.
    t=1: any hit; t=2: two hits >= k apart, i.e. max - min position >= k;
    t <= 16: pointer jumps; larger t: the sequential count."""
    lead = member.shape[:-1]
    if t <= 0:
        return torch.ones(lead, dtype=torch.bool, device=member.device)
    if t == 1:
        return member.any(dim=-1)
    w = member.shape[-1]
    if t == 2:
        pos = torch.arange(w, device=member.device)
        minp = torch.where(member, pos, w + k).amin(dim=-1)
        maxp = torch.where(member, pos, -(k + 1)).amax(dim=-1)
        return (maxp - minp) >= k
    flat = member.reshape(-1, w)
    if t <= GREEDY_FAST_MAX_T:
        cnt = greedy_count_fast(flat, k, t)
    else:
        cnt = greedy_count(flat, k, t)
    return (cnt >= t).reshape(lead)
