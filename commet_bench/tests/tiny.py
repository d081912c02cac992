"""Sizes at which the cells run on the CPU in the tests: k = 21 (planes of
2^21 bits, a few percent full, one partition)."""

TINY = {
    "partition-search": {"config": {"k": 21, "set_reads": 2000},
                         "params": {"query_reads": 600}},
    "partition-build": {"config": {"k": 21, "set_reads": 2000},
                        "params": {"sample_words": 4096}},
}
CELLS = sorted(TINY)
SEED = 2**31 + 12345
