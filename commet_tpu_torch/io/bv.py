"""Reference-compatible packed bit-vector (.bv) codec and algebra, the
port's copy of commet_tpu/io/bv.py (byte-identical files).

File format (reference include/boolean_vector.h:302-346):
    <comment bytes>\n#<size>\n<raw packed bits, LSB-first within each byte>
The payload is always ``size // 8 + 1`` bytes (one extra byte even when the
size is a multiple of 8, reference boolean_vector.h:101,133). Bits beyond
``size`` in the padding byte are preserved verbatim through operations (the
reference's NOT sets them; popcount caps at ``size``,
reference boolean_vector.h:266-268).
"""

from __future__ import annotations

import numpy as np


class BitVector:
    """A packed array of bits, byte-layout-identical to the reference's
    BooleanVector (reference include/boolean_vector.h:45)."""

    __slots__ = ("data", "size", "comment")

    def __init__(self, size: int = 0, fill: bool = False, comment: str = ""):
        self.size = int(size)
        nbytes = self.size // 8 + 1
        if fill:
            # init_true: all bytes 0xff then clear bits >= size
            # (reference boolean_vector.h:148-164)
            self.data = np.full(nbytes, 0xFF, dtype=np.uint8)
            for i in range(self.size, nbytes * 8):
                self.unset(i)
        else:
            self.data = np.zeros(nbytes, dtype=np.uint8)
        self.comment = comment

    # ---------------------------------------------------------------- bits
    def set(self, i: int) -> None:
        self.data[i // 8] |= np.uint8(1 << (i % 8))

    def unset(self, i: int) -> None:
        self.data[i // 8] &= ~np.uint8(1 << (i % 8))

    # ------------------------------------------------------- bulk (numpy)
    def as_bool_array(self) -> np.ndarray:
        """Unpacked bool array of length ``size`` (LSB-first)."""
        return np.unpackbits(self.data, bitorder="little")[: self.size].astype(bool)

    @classmethod
    def from_bool_array(cls, bits: np.ndarray, comment: str = "") -> "BitVector":
        bv = cls(len(bits), comment=comment)
        packed = np.packbits(np.asarray(bits, dtype=np.uint8), bitorder="little")
        bv.data[: len(packed)] = packed
        return bv

    def set_many(self, idx: np.ndarray) -> None:
        """Set all bits at positions ``idx`` (vectorized)."""
        if len(idx) == 0:
            return
        bits = np.zeros(self.size, dtype=np.uint8)
        bits[idx] = 1
        packed = np.packbits(bits, bitorder="little")
        self.data[: len(packed)] |= packed

    def nb_one(self) -> int:
        """Popcount capped at ``size`` (reference boolean_vector.h:244-270)."""
        res = int(np.unpackbits(self.data).sum())
        return min(res, self.size)

    # --------------------------------------------------------------- algebra
    def _check(self, other: "BitVector") -> None:
        if other.size != self.size:
            raise ValueError("the two vectors are not the same size")

    def full_and(self, other: "BitVector") -> None:
        self._check(other)
        self.data &= other.data

    def full_or(self, other: "BitVector") -> None:
        self._check(other)
        self.data |= other.data

    def full_not(self) -> None:
        # also flips the padding bits, like the reference
        # (boolean_vector.h:444-449)
        self.data = (~self.data).astype(np.uint8)

    def full_and_not(self, other: "BitVector") -> None:
        self._check(other)
        self.data &= ~other.data

    def copy(self) -> "BitVector":
        bv = BitVector(0)
        bv.size = self.size
        bv.data = self.data.copy()
        bv.comment = self.comment
        return bv

    def set_all_false(self) -> None:
        self.data[:] = 0

    # ------------------------------------------------------------------ file
    def write(self, path: str) -> None:
        """Serialize in the reference on-disk format (boolean_vector.h:302-346)."""
        header = (self.comment + "\n#" + str(self.size) + "\n").encode("latin-1")
        with open(path, "wb") as f:
            f.write(header)
            f.write(self.data.tobytes())

    @classmethod
    def read(cls, path: str) -> "BitVector":
        """Parse the reference on-disk format (boolean_vector.h:353-414):
        comment = bytes until the first '#', minus its trailing byte;
        then the decimal size until newline; then packed payload."""
        with open(path, "rb") as f:
            raw = f.read()
        hash_pos = raw.find(b"#")
        if hash_pos < 0:
            raise ValueError(f"{path}: boolean vector has no size marker")
        comment = raw[:hash_pos]
        comment = comment[:-1] if comment else comment  # strip trailing \n
        nl = raw.find(b"\n", hash_pos)
        size_str = raw[hash_pos + 1 : nl if nl >= 0 else len(raw)]
        if not size_str:
            raise ValueError(f"{path}: boolean vector does not contain its size")
        size = int(size_str)
        bv = cls(size)
        payload = raw[nl + 1 : nl + 1 + len(bv.data)]
        arr = np.frombuffer(payload, dtype=np.uint8)
        bv.data[: len(arr)] = arr
        bv.comment = comment.decode("latin-1")
        return bv

    def __len__(self) -> int:
        return self.size
