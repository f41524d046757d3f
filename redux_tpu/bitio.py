"""Bit-level I/O over byte streams.

Host-side (oracle / compatibility path) implementation of the reference's
bit I/O layer (``/root/reference/src/bitio/mod.rs``), with identical
observable semantics, verified against the reference's golden byte vectors
(``src/bitio/tests.rs``):

* MSB-first bit order within each byte (``bitio/mod.rs:78-120, 148-181``).
* ``read_bits(n)`` returns ``n`` bits as an int; raises :class:`EofError`
  when the underlying stream is exhausted (``bitio/mod.rs:106-108``) and
  :class:`InvalidInputError` when ``n`` exceeds the word width
  (``bitio/mod.rs:79-81``; we keep the reference's 64-bit usize limit).
* ``write_bits(sym, n)`` rejects values wider than ``n``
  (``bitio/mod.rs:149``).
* ``flush_bits`` pads the final partial byte with trailing zeros via left
  shift (``bitio/mod.rs:183-198``).
* Both carry a byte counter exposed as ``count`` — bytes consumed from /
  emitted to the underlying stream (``bitio/mod.rs:13-16,71-75,141-145``).

The device data path does *not* use this module per-bit; the JAX coders pack
bits with vectorized shift/mask arithmetic (see ``redux_tpu/ops``).  This
module defines the format contract and serves the sequential compat path.
"""

from __future__ import annotations

import io
from typing import BinaryIO

from .errors import EofError, InvalidInputError

_WORD_BITS = 64  # reference: size_of::<usize>() * 8 on 64-bit targets


class BitReader:
    """MSB-first bit reader over a byte stream (reference BitReader, bitio/mod.rs:54-120)."""

    __slots__ = ("_stream", "_bits", "_nbits", "count")

    def __init__(self, stream: BinaryIO):
        self._stream = stream
        self._bits = 0  # pending (unread) bits, right-aligned
        self._nbits = 0  # number of pending bits
        self.count = 0  # bytes consumed from the underlying stream

    def read_bits(self, bits: int) -> int:
        if bits > _WORD_BITS:
            raise InvalidInputError()
        # Fill the staging buffer byte-by-byte like the reference loop
        # (bitio/mod.rs:82-117); reading ahead only whole bytes that are
        # needed keeps the byte counter identical at every step.
        while self._nbits < bits:
            b = self._stream.read(1)
            if not b:
                raise EofError()
            self.count += 1
            self._bits = (self._bits << 8) | b[0]
            self._nbits += 8
        self._nbits -= bits
        result = self._bits >> self._nbits
        self._bits &= (1 << self._nbits) - 1
        return result


class BitWriter:
    """MSB-first bit writer over a byte stream (reference BitWriter, bitio/mod.rs:124-198)."""

    __slots__ = ("_stream", "_bits", "_nbits", "count")

    def __init__(self, stream: BinaryIO):
        self._stream = stream
        self._bits = 0  # pending (unwritten) bits, right-aligned
        self._nbits = 0
        self.count = 0  # bytes emitted to the underlying stream

    def write_bits(self, symbol: int, bits: int) -> None:
        if bits > _WORD_BITS or (symbol >> bits) > 0:
            raise InvalidInputError()  # value too wide (bitio/mod.rs:149)
        self._bits = (self._bits << bits) | symbol
        self._nbits += bits
        if self._nbits >= 8:
            nbytes, rem = divmod(self._nbits, 8)
            out = (self._bits >> rem).to_bytes(nbytes, "big")
            self._stream.write(out)
            self.count += nbytes
            self._nbits = rem
            self._bits &= (1 << rem) - 1

    def flush_bits(self) -> None:
        # Pad the final partial byte with trailing zeros (bitio/mod.rs:185).
        if self._nbits > 0:
            self._stream.write(bytes([(self._bits << (8 - self._nbits)) & 0xFF]))
            self.count += 1
            self._bits = 0
            self._nbits = 0


def pack_bits(bit_chunks) -> bytes:
    """Pack ``(value, nbits)`` chunks MSB-first into bytes with zero padding.

    Convenience used by tests and host-side splicing; equivalent to feeding
    the chunks through :class:`BitWriter` and flushing.
    """
    buf = io.BytesIO()
    w = BitWriter(buf)
    for value, nbits in bit_chunks:
        w.write_bits(value, nbits)
    w.flush_bits()
    return buf.getvalue()
