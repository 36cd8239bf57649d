"""MSB-first bit readers/writers for MPEG bitstream parsing.

Behavioural parity target: the BitReader/BitWriter pair used by every PSI/ES
parser in the reference (reference: Amatsukaze/StreamUtils.hpp:79-271).
Implemented independently on top of Python ints; byte order is big-endian,
bits are consumed most-significant first, as in all MPEG syntax.

The port's copy of amatsukaze_tpu/utils/bits.py.
"""

from __future__ import annotations


class EOFError_(Exception):
    """Read past end of buffer."""


class BitReader:
    """MSB-first bit reader over a bytes-like buffer."""

    __slots__ = ("data", "pos")  # pos = bit offset from start

    def __init__(self, data: bytes | bytearray | memoryview, bit_offset: int = 0):
        self.data = memoryview(data).cast("B") if not isinstance(data, memoryview) else data
        self.pos = bit_offset

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.data) * 8

    def bits_left(self) -> int:
        return len(self.data) * 8 - self.pos

    def byte_pos(self) -> int:
        """Current position in whole bytes (floor)."""
        return self.pos >> 3

    def is_byte_aligned(self) -> bool:
        return (self.pos & 7) == 0

    # -- reads --------------------------------------------------------------
    def read(self, nbits: int) -> int:
        v = self.peek(nbits)
        self.pos += nbits
        return v

    def peek(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        end = self.pos + nbits
        if end > len(self.data) * 8:
            raise EOFError_(f"read {nbits} bits at {self.pos}, buffer {len(self.data)*8}")
        first = self.pos >> 3
        last = (end + 7) >> 3
        chunk = int.from_bytes(self.data[first:last], "big")
        shift = last * 8 - end
        return (chunk >> shift) & ((1 << nbits) - 1)

    def skip(self, nbits: int) -> None:
        if self.pos + nbits > len(self.data) * 8:
            raise EOFError_("skip past end")
        self.pos += nbits

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    # -- exp-golomb (H.264) ---------------------------------------------------
    def ue(self) -> int:
        """Unsigned Exp-Golomb code (H.264 ue(v))."""
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
            if zeros > 32:
                raise EOFError_("bad exp-golomb")
        if zeros == 0:
            return 0
        return (1 << zeros) - 1 + self.read(zeros)

    def se(self) -> int:
        """Signed Exp-Golomb code (H.264 se(v))."""
        k = self.ue()
        return (k + 1) // 2 if (k & 1) else -(k // 2)


class BitWriter:
    """MSB-first bit writer producing a bytearray."""

    __slots__ = ("_buf", "_acc", "_nacc")

    def __init__(self):
        self._buf = bytearray()
        self._acc = 0  # pending bits, MSB-first in low bits
        self._nacc = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._nacc += nbits
        while self._nacc >= 8:
            self._nacc -= 8
            self._buf.append((self._acc >> self._nacc) & 0xFF)
        self._acc &= (1 << self._nacc) - 1

    def write_bytes(self, data: bytes) -> None:
        if self._nacc == 0:
            self._buf.extend(data)
        else:
            for b in data:
                self.write(b, 8)

    def byte_align(self, fill: int = 0) -> None:
        if self._nacc:
            pad = 8 - self._nacc
            self.write(0xFF if fill else 0, pad)

    def bit_length(self) -> int:
        return len(self._buf) * 8 + self._nacc

    def getvalue(self) -> bytes:
        assert self._nacc == 0, "unaligned writer"
        return bytes(self._buf)
