"""Read-quality filtering: length / N-count / Shannon-entropy / max-reads,
the host part of commet_tpu/core/filter.py (the device class counts of
filter_batch_device, K10, are not ported yet).

Bit-exact reproduction of the reference filter (src/filter_reads.cpp:184-306):
  per read, in order: reject if len < min_size; else reject if
  #non-ACGT > max_N; else reject if shannon_index < min_shannon; else select.
  Stop selecting once ``max_reads`` reads are selected; every read from the
  first dropped one onward is rejected (untag_last_reads,
  read_file.h:76-82).

Shannon index (filter_reads.cpp:265-306): 5 symbol classes (A,C,G,T,other,
case-insensitive), counts accumulated as float; freq = float32 division by
read length; index accumulated as
    index = float32(index + float64(freq * logf(freq)) / log(2))
where ``freq * logf(freq)`` is a float32 product (C++ float * float) and the
division by log(2) promotes to double. glibc's logf is correctly rounded, so
float32(log(float64 x)) reproduces it exactly.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

_LOG2 = np.log(np.float64(2.0))


def shannon_index(counts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized reference shannon_index. counts: [N, 5] int64 per-class
    counts; lengths: [N]. Returns float32 [N]."""
    n = counts.shape[0]
    index = np.zeros(n, dtype=np.float32)
    len_f = lengths.astype(np.float32)
    for cls in range(5):
        cnt_f = counts[:, cls].astype(np.float32)
        freq = np.where(len_f > 0, cnt_f / np.where(len_f > 0, len_f, 1), 0.0)
        freq = freq.astype(np.float32)
        # float32 log via correctly-rounded double log (== glibc logf)
        with np.errstate(divide="ignore", invalid="ignore"):
            logf = np.log(freq.astype(np.float64)).astype(np.float32)
            prod32 = (freq * logf).astype(np.float32)      # float * float
        term = prod32.astype(np.float64) / _LOG2           # / log(2) in double
        nz = freq != 0
        index = np.where(nz,
                         (index.astype(np.float64) + term).astype(np.float32),
                         index)
    return np.abs(index)


def class_counts(seqs: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-read counts of A,C,G,T,other (case-insensitive) and lengths."""
    n = len(seqs)
    counts = np.zeros((n, 5), dtype=np.int64)
    lengths = np.zeros(n, dtype=np.int64)
    if n == 0:
        return counts, lengths
    lut = np.full(256, 4, dtype=np.uint8)
    for chars, v in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
        lut[chars[0]] = v
        lut[chars[1]] = v
    flat = np.frombuffer(b"".join(seqs), dtype=np.uint8)
    lengths[:] = np.fromiter((len(s) for s in seqs), dtype=np.int64, count=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    cls = lut[flat]
    read_id = np.repeat(np.arange(n, dtype=np.int64), lengths)
    np.add.at(counts, (read_id, cls), 1)
    return counts, lengths


def filter_reads(seqs: List[bytes], min_size: int = 0,
                 max_n: int = 2**31 - 1, min_shannon: float = 0.0,
                 max_reads: int = -1):
    """Filter from raw sequences (python-parsed path)."""
    counts, lengths = class_counts(seqs)
    return filter_reads_counts(counts, lengths, min_size=min_size,
                               max_n=max_n, min_shannon=min_shannon,
                               max_reads=max_reads)


def filter_reads_counts(counts: np.ndarray, lengths: np.ndarray,
                        min_size: int = 0, max_n: int = 2**31 - 1,
                        min_shannon: float = 0.0, max_reads: int = -1):
    """Returns (keep: bool [N], stats dict). Reference order of tests and
    the max-reads tail cut (filter_reads.cpp:188-205). Operates purely on
    per-read class counts + lengths (native-parser friendly)."""
    n = len(lengths)

    # Reference quirk (filter_reads.cpp:188): the loop stops at the first
    # EMPTY read; later reads are never examined and stay selected (the
    # filter vector starts all-true).
    empty = lengths == 0
    if empty.any():
        first_empty = int(np.argmax(empty))
        processed = np.arange(n) < first_empty
    else:
        processed = np.ones(n, dtype=bool)

    rm_len = processed & (lengths < min_size)
    n_counts = counts[:, 4]
    rm_n = processed & (~rm_len) & (n_counts > max_n)
    min_shannon32 = np.float32(min_shannon)
    if min_shannon32 > 0:
        sh = shannon_index(counts, lengths)
        rm_sh = processed & (~rm_len) & (~rm_n) & (sh < min_shannon32)
    else:
        rm_sh = np.zeros(n, dtype=bool)
    keep = ~(rm_len | rm_n | rm_sh)

    # Reference quirk (filter_reads.cpp:188,203-205): a read is only
    # examined while nb_selected < max_reads; once the cap is reached every
    # read from there on is untagged wholesale (untag_last_reads), so the
    # rm_* statistics only count reads up to the cap.
    if max_reads == 0:
        # the reference loop never runs; untag_last_reads clears every read
        keep[:] = False
        return keep, {"nb_rm_length": 0, "nb_rm_N": 0, "nb_rm_shannon": 0,
                      "nb_selected": 0}
    if max_reads > 0:
        sel_cum = np.cumsum(keep & processed)
        reached = sel_cum >= max_reads
        if reached.any():
            cap_idx = int(np.argmax(reached))  # index of the max'th selected
            keep[cap_idx + 1 :] = False
            newly_processed = np.arange(n) <= cap_idx
            processed = processed & newly_processed
            rm_len = rm_len & processed
            rm_n = rm_n & processed
            rm_sh = rm_sh & processed

    stats = {
        "nb_rm_length": int(rm_len.sum()),
        "nb_rm_N": int(rm_n.sum()),
        "nb_rm_shannon": int(rm_sh.sum()),
        "nb_selected": int(keep.sum()),
    }
    return keep, stats
