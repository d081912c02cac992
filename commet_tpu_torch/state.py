"""State carried across from the JAX package: a commet_tpu StreamIndex, given
as numpy arrays, becomes the port's StreamIndex, a commet_tpu ResidentIndex
the port's ResidentIndex, a commet_tpu plane set (uint32 words) the port's
int32 plane tensor and a commet_tpu ResidentPlanes the port's
ResidentPlanes, so both packages can be held against each other on the same
index."""

from __future__ import annotations

import numpy as np
import torch

from commet_tpu_torch.core.keys import host_u32
from commet_tpu_torch.core.stream import (StreamIndex,
                                          index_from_sorted_pairs,
                                          lexsort_pairs)
from commet_tpu_torch.engine.engine import ResidentIndex, ResidentPlanes


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


def resident_from_jax(jres, device="cpu"):
    """The port's ResidentIndex holding the partitions of a commet_tpu
    ResidentIndex (each read as numpy arrays through stream_index_from_jax;
    its host-side exact sets are not needed: every port partition keeps
    sb/sc/sd on the device)."""
    parts = [stream_index_from_jax(sx.ika, sx.ikb, sx.ihib, sx.mi, sx.sa,
                                   sx.sb, sx.sc, sx.sd, device=device)
             for sx in jres.partitions]
    return ResidentIndex(jres.name, parts, int(jres.nb_indexed),
                         int(jres.total_kmers), float(jres.build_seconds))


def planes_from_jax(words, device="cpu") -> torch.Tensor:
    """A commet_tpu plane set ([4 * plane_words] uint32, as numpy) as the
    port's [4 * plane_words] int32 tensor with the same bits, in memory of
    its own (the port's build updates planes in place)."""
    return host_u32(np.array(words, dtype=np.uint32).reshape(-1)).to(
        torch.device(device))


def resident_planes_from_jax(jres, device="cpu") -> ResidentPlanes:
    """The port's ResidentPlanes holding the plane sets of a commet_tpu
    ResidentPlanes."""
    return ResidentPlanes(jres.name,
                          [planes_from_jax(p, device) for p in jres.partitions],
                          [float(f) for f in jres.fills],
                          int(jres.nb_indexed), int(jres.total_kmers),
                          float(jres.build_seconds))
