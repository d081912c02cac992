"""The port's .bv algebra (commet_tpu_torch.io.bv) against commet_tpu's
BitVector: the same bits in, the same bytes out, the reference's
padding-bit behaviour kept, and files of either package read by the
other."""

import numpy as np
import pytest

from commet_tpu.io.bv import BitVector as JaxBitVector
from commet_tpu_torch.io.bv import BitVector

OPS = ("full_and", "full_or", "full_and_not")


def _pair(bits, comment=""):
    return (BitVector.from_bool_array(bits, comment),
            JaxBitVector.from_bool_array(bits, comment))


@pytest.mark.parametrize("size", [1, 8, 63, 1000])
def test_algebra_matches_jax(size):
    rng = np.random.default_rng(0)
    a_bits = rng.random(size) < 0.5
    b_bits = rng.random(size) < 0.3
    for op in OPS:
        (a, ja), (b, jb) = _pair(a_bits), _pair(b_bits)
        getattr(a, op)(b)
        getattr(ja, op)(jb)
        assert a.data.dtype == np.uint8
        assert a.data.tobytes() == ja.data.tobytes(), op
        assert a.nb_one() == ja.nb_one()
    a, ja = _pair(a_bits)
    a.full_not()
    ja.full_not()
    assert a.data.dtype == np.uint8
    assert a.data.tobytes() == ja.data.tobytes()
    # the flipped padding bits count too, up to the cap
    padding = 8 * (size // 8 + 1) - size
    assert a.nb_one() == ja.nb_one() == min(
        size - int(a_bits.sum()) + padding, size)
    for i in rng.integers(0, size, 5):
        for bv in (a, ja):
            bv.set(int(i))
        assert a.as_bool_array()[i]
        assert a.data.tobytes() == ja.data.tobytes()
        for bv in (a, ja):
            bv.unset(int(i))
        assert not a.as_bool_array()[i]
        assert a.data.tobytes() == ja.data.tobytes()
    np.testing.assert_array_equal(a.as_bool_array(), ja.as_bool_array())


def test_padding_bits_after_not_and_fill():
    """NOT flips the bits past ``size`` in the last byte, as the reference
    does, and the next operation keeps them; a filled vector clears
    them."""
    bv = BitVector(10)
    bv.full_not()
    assert bv.data.tolist() == [0xFF, 0xFF]
    bv = BitVector(10, fill=True)
    assert bv.data.tolist() == [0xFF, 0x03]
    bv.full_not()
    assert bv.data.tolist() == [0x00, 0xFC]
    bv.full_or(BitVector(10))
    assert bv.data.tolist() == [0x00, 0xFC]
    jbv = JaxBitVector(10, fill=True)
    jbv.full_not()
    jbv.full_or(JaxBitVector(10))
    assert bv.data.tobytes() == jbv.data.tobytes()


def test_nb_one_caps_at_size():
    bv = BitVector(5)
    bv.full_not()  # 5 bits set, 3 more in the padding byte
    assert bv.nb_one() == 5
    bv.full_not()
    assert bv.nb_one() == 0
    bv = BitVector(8)
    bv.full_not()  # 8 bits set, 8 more in the padding byte
    assert bv.nb_one() == 8


def test_size_mismatch_raises():
    a, b = BitVector(12), BitVector(13)
    for op in OPS:
        with pytest.raises(ValueError,
                           match="the two vectors are not the same size"):
            getattr(a, op)(b)


def test_reads_files_jax_wrote(tmp_path):
    """After each operation commet_tpu writes the vector; the port reads
    the same size, comment and payload, and writes the same file back."""
    rng = np.random.default_rng(0)
    a_bits = rng.random(77) < 0.5
    b_bits = rng.random(77) < 0.5
    for op in OPS + ("full_not", "set_all_true"):
        ja = JaxBitVector.from_bool_array(a_bits, f"a {op}")
        jb = JaxBitVector.from_bool_array(b_bits)
        getattr(ja, op)(*(() if op in ("full_not", "set_all_true")
                          else (jb,)))
        ja.write(str(tmp_path / "j.bv"))
        got = BitVector.read(str(tmp_path / "j.bv"))
        assert (got.size, got.comment) == (77, f"a {op}")
        assert got.data.tobytes() == ja.data.tobytes()
        assert got.nb_one() == ja.nb_one()
        got.write(str(tmp_path / "t.bv"))
        assert (tmp_path / "t.bv").read_bytes() == \
            (tmp_path / "j.bv").read_bytes()
