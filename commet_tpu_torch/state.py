"""State carried across from the JAX package: a commet_tpu StreamIndex, given
as numpy arrays, becomes the port's StreamIndex, so both packages can be
held against each other on the same index."""

from __future__ import annotations

import numpy as np
import torch

from commet_tpu_torch.core.stream import (StreamIndex,
                                          index_from_sorted_pairs,
                                          lexsort_pairs)


def stream_index_from_jax(ika, ikb, ihib, mi, sa=None, sb=None, sc=None,
                          sd=None, device="cpu") -> StreamIndex:
    """ika/ikb/ihib: the JAX join planes ([Ri, 128] uint32, sorted by the
    keya low word, valid prefix [0, mi)); ihib carries the hi bits for
    k = 33/34 (a_hi << 8 | b_hi) and is None for k <= 32. sa..sd: the JAX
    exact-fallback sets (valid prefix [0, mi), ascending), None for wide
    keys; sa is the keya column, which the port reads from the pairs. Where
    the sets are None the port sorts its own from the whole keys."""
    mi = int(np.asarray(mi))

    def prefix(x):
        return np.asarray(x).reshape(-1)[:mi].astype(np.int64)

    a, b = prefix(ika), prefix(ikb)
    if ihib is not None:
        hib = prefix(ihib)
        a |= (hib >> 8) << 32
        b |= (hib & 0xFF) << 32
    dev = torch.device(device)
    ika_t, ikb_t = lexsort_pairs(torch.from_numpy(a).to(dev),
                                 torch.from_numpy(b).to(dev))
    sets = None
    if sb is not None:
        sets = tuple(torch.from_numpy(prefix(s)).to(dev) for s in (sb, sc, sd))
    return index_from_sorted_pairs(ika_t, ikb_t, sets)
