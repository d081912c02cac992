"""The sets are made from the seed alone."""

import numpy as np

from commet_bench import data
from commet_bench.tests.tiny import SEED


def test_cohort_same_seed_same_sets():
    a = data.make_cohort(SEED, [500, 300], [200, 200], 100, 66, 0.01)
    b = data.make_cohort(SEED, [500, 300], [200, 200], 100, 66, 0.01)
    for xs, ys in zip(a, b):
        for x, y in zip(xs, ys):
            assert np.array_equal(x, y)
    c = data.make_cohort(SEED + 1, [500, 300], [200, 200], 100, 66, 0.01)
    assert not np.array_equal(a[0][0], c[0][0])


def test_cohort_layout():
    (index,), queries = data.make_cohort(SEED, [1000], [400, 400], 100, 66,
                                         0.01)
    for q in queries:
        # even reads hold an N-free fragment, odd ones do not, and a
        # hundredth of the reads carry one N
        assert (q[::2] < 4).all()
        assert (q >= 4).any(axis=1).sum() == 4
    assert (index >= 4).any(axis=1).sum() == 10
    assert index.max() <= 4 and index.dtype == np.uint8


def test_fasta_parses_back(tmp_path):
    from commet_tpu_torch.io.reads import ReadSet
    (codes,), _q = data.make_cohort(SEED, [300], [], 100, 66, 0.05)
    (path,) = data.write_sets(str(tmp_path), ["s"], [codes])
    rs = ReadSet("s")
    rs.add_file(path)
    flat, offsets, lengths = rs.files[0].encoded()
    assert rs.files[0].nb_reads == 300 and (lengths == 100).all()
    assert np.array_equal(flat.reshape(300, 100), np.minimum(codes, 4))
