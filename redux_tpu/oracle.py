"""Reference-semantics sequential codec (the oracle, and the compat path).

A slow, obvious, bit-exact implementation of the reference's
Witten–Neal–Cleary-style integer arithmetic coder
(the reference's ``src/codec.rs``), used as:

* the differential-test oracle for the device coders (the same role the
  reference's linear model plays for its tree model, lib.rs:8-9);
* the compatibility path for encoding/decoding *reference-format*
  single streams (a redux_tpu 1-block payload is bit-identical to a
  reference stream).

State machine parity with ``codec.rs:11-177``:

* state: ``low``/``high`` interval bounds, ``pending`` (pending-bit count
  when encoding, code value when decoding, codec.rs:16-18), ``extra``
  (trailing bits to emit / leading bits to prime, codec.rs:19-21);
* encode (codec.rs:55-101): narrow interval by the model range with exact
  integer division ``low + range*bound/count``, then E1/E2 renormalization
  emitting a bit (plus accumulated opposite pending bits, codec.rs:39-46)
  while the interval sits in one half, E3 pending-increment while it
  straddles the midpoint quarter; after the EOF symbol, drain ``extra``
  disambiguation bits from ``low`` and zero-pad to a byte (codec.rs:91-99);
* decode (codec.rs:123-158): prime ``code_bits`` bits, locate the symbol by
  ``value = ((pending - low + 1)*count - 1)/range``, renormalize mirroring
  the encoder, consuming one bit per iteration;
* stream loops (codec.rs:104-120,164-176): encode until input EOF then emit
  the EOF symbol; decode until the EOF symbol appears.

Python ints are arbitrary precision, so the u64 products (up to
``2**(code_bits+freq_bits) <= 2**64``, codec.rs:59-60,131) are exact for
every legal parameter set.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Optional, Tuple

from .bitio import BitReader, BitWriter
from .errors import EofError
from .models.base import Model
from .models.fenwick import AdaptiveFenwickModel
from .params import Parameters


class Codec:
    """Arithmetic coder engine (reference Codec, codec.rs:11-177)."""

    def __init__(self, model: Model):
        p = model.params
        self.low = p.code_min  # codec.rs:30
        self.high = p.code_max  # codec.rs:31
        self.pending = 0  # codec.rs:32
        self.extra = p.code_bits  # codec.rs:33
        self.model = model

    # -- encode ------------------------------------------------------------

    def _put_bit(self, bit: bool, output: BitWriter) -> None:
        # Emit a bit plus accumulated opposite pending bits (codec.rs:39-46).
        output.write_bits(1 if bit else 0, 1)
        if self.pending:
            opp = 0 if bit else 1
            for _ in range(self.pending):
                output.write_bits(opp, 1)
            self.pending = 0

    def compress_symbol(self, symbol: int, output: BitWriter) -> None:
        p = self.model.params
        count = self.model.total_frequency()
        low_f, high_f = self.model.get_frequency(symbol)
        rng = self.high - self.low + 1
        # Exact integer interval narrowing (codec.rs:58-60).
        self.high = self.low + (rng * high_f) // count - 1
        self.low = self.low + (rng * low_f) // count

        is_eof = symbol == p.symbol_eof
        while True:
            if self.high < p.code_half:  # E1
                self._put_bit(False, output)
                if is_eof:
                    self.extra -= 1
            elif self.low >= p.code_half:  # E2
                self._put_bit(True, output)
                if is_eof:
                    self.extra -= 1
            elif self.low >= p.code_one_fourth and self.high < p.code_three_fourths:  # E3
                self.pending += 1
                self.low -= p.code_one_fourth
                self.high -= p.code_one_fourth
                if is_eof:
                    self.extra -= 1
            else:
                break
            self.high = ((self.high << 1) + 1) & p.code_max
            self.low = (self.low << 1) & p.code_max

        if is_eof:
            # Drain `extra` disambiguation bits from low, then pad (codec.rs:91-99).
            while self.extra > 0:
                self._put_bit((self.low & p.code_half) != 0, output)
                self.low = (self.low << 1) & p.code_max
                self.extra -= 1
            output.flush_bits()

    def compress_stream(self, input: BitReader, output: BitWriter) -> None:
        p = self.model.params
        while True:
            try:
                symbol = input.read_bits(p.symbol_bits)
            except EofError:
                symbol = p.symbol_eof  # inject EOF symbol (codec.rs:108)
            self.compress_symbol(symbol, output)
            if symbol == p.symbol_eof:
                break

    # -- decode ------------------------------------------------------------

    def _get_bit(self, input: BitReader) -> None:
        self.pending = (self.pending << 1) | input.read_bits(1)  # codec.rs:50

    def decompress_symbol(self, input: BitReader) -> int:
        p = self.model.params
        while self.extra > 0:  # prime code_bits bits (codec.rs:124-127)
            self._get_bit(input)
            self.extra -= 1

        rng = self.high - self.low + 1
        count = self.model.total_frequency()
        value = ((self.pending - self.low + 1) * count - 1) // rng  # codec.rs:131
        symbol, low_f, high_f = self.model.get_symbol(value)
        self.high = self.low + (rng * high_f) // count - 1
        self.low = self.low + (rng * low_f) // count

        if symbol == p.symbol_eof:  # codec.rs:137-139
            return symbol

        while True:
            if self.high < p.code_half:  # E1
                pass
            elif self.low >= p.code_half:  # E2
                self.pending -= p.code_half
                self.low -= p.code_half
                self.high -= p.code_half
            elif self.low >= p.code_one_fourth and self.high < p.code_three_fourths:  # E3
                self.pending -= p.code_one_fourth
                self.low -= p.code_one_fourth
                self.high -= p.code_one_fourth
            else:
                break
            self.low <<= 1
            self.high = (self.high << 1) + 1
            self._get_bit(input)

        return symbol

    def decompress_stream(self, input: BitReader, output: BitWriter) -> None:
        p = self.model.params
        while True:
            symbol = self.decompress_symbol(input)
            if symbol == p.symbol_eof:
                break
            output.write_bits(symbol, p.symbol_bits)

    def decompress_symbols(self, input: BitReader, n: int) -> bytes:
        """Decode exactly ``n`` data symbols (stored-length termination).

        redux_tpu extension used by the block container: when the symbol
        count is known from the header, decoding stops after ``n`` symbols
        and never needs to decode the trailing EOF symbol.
        """
        out = bytearray()
        for _ in range(n):
            out.append(self.decompress_symbol(input))
        return bytes(out)


# -- block-format (v2) sequential codec -------------------------------------
#
# The RXT2 per-block payload differs from a reference stream (codec.rs:91-99)
# in two ways, both possible because the container stores per-block symbol
# counts:
#
# * no EOF symbol and no code_bits drain — the decoder stops after the
#   stored count;
# * a minimal 2-bit terminator: after the last symbol's renormalization the
#   interval satisfies high - low + 1 > quarter AND low < half <= high, so
#   tq = ceil(low / quarter) is in {0, 1, 2} and the code value
#   V = tq * quarter (2 emitted bits, zero tail) always lies in
#   [low, high]; the decoder reads zeros past the stream end, making its
#   effective code value exactly V.
#
# The adaptation increment ``delta`` generalizes the reference's +1
# (adaptive_tree.rs:86-89).  These sequential implementations are the
# differential-test oracles for the vectorized/Pallas v2 kernels.


class _ZeroPadBitReader:
    """BitReader returning zero bits past the end of the stream.

    The v2 decoder legitimately reads past the payload (priming plus the
    terminator's zero tail); the container guards real truncation with its
    stored byte lengths and checksum instead.
    """

    def __init__(self, stream: BinaryIO):
        self._r = BitReader(stream)

    def read_bits(self, bits: int) -> int:
        try:
            return self._r.read_bits(bits)
        except EofError:
            return 0


def compress_block(
    data: bytes,
    params: Parameters,
    init_cum=None,
    delta: int = 1,
) -> bytes:
    """Sequentially encode one v2 block payload (oracle for the device path)."""
    from .models.dense import DenseModel

    model = DenseModel(params, init_cum, delta)
    codec = Codec(model)
    out = io.BytesIO()
    writer = BitWriter(out)
    for b in data:
        codec.compress_symbol(b, writer)
    p = params
    # Terminator: tq = ceil(low / quarter) in {0,1,2}; 2 bits, pending
    # flushed after the first (put_bit semantics, codec.rs:39-46).
    tq = (codec.low + p.code_one_fourth - 1) // p.code_one_fourth
    codec._put_bit((tq >> 1) != 0, writer)
    codec._put_bit((tq & 1) != 0, writer)
    writer.flush_bits()
    return out.getvalue()


def decompress_block(
    payload: bytes,
    n_symbols: int,
    params: Parameters,
    init_cum=None,
    delta: int = 1,
) -> bytes:
    """Sequentially decode one v2 block payload of ``n_symbols`` bytes."""
    from .models.dense import DenseModel

    model = DenseModel(params, init_cum, delta)
    codec = Codec(model)
    reader = _ZeroPadBitReader(io.BytesIO(payload))
    out = bytearray()
    for _ in range(n_symbols):
        out.append(codec.decompress_symbol(reader))
    return bytes(out)


# -- top-level stream API (reference lib.rs:102-120) -----------------------


def compress(
    istream: BinaryIO, ostream: BinaryIO, model: Optional[Model] = None
) -> Tuple[int, int]:
    """Compress ``istream`` into ``ostream``; returns ``(bytes_in, bytes_out)``.

    Parity with ``redux::compress`` (lib.rs:102-109).  Default model matches
    the reference CLI: Fenwick with Parameters(8, 30, 32) (main.rs:108).
    """
    if model is None:
        model = AdaptiveFenwickModel(Parameters.default())
    codec = Codec(model)
    reader = BitReader(istream)
    writer = BitWriter(ostream)
    codec.compress_stream(reader, writer)
    return (reader.count, writer.count)


def decompress(
    istream: BinaryIO, ostream: BinaryIO, model: Optional[Model] = None
) -> Tuple[int, int]:
    """Decompress ``istream`` into ``ostream``; returns ``(bytes_in, bytes_out)``.

    Parity with ``redux::decompress`` (lib.rs:113-120).
    """
    if model is None:
        model = AdaptiveFenwickModel(Parameters.default())
    codec = Codec(model)
    reader = BitReader(istream)
    writer = BitWriter(ostream)
    codec.decompress_stream(reader, writer)
    return (reader.count, writer.count)


def compress_bytes(data: bytes, model: Optional[Model] = None) -> bytes:
    """Convenience: compress an in-memory buffer (doc example, lib.rs:23-39)."""
    out = io.BytesIO()
    compress(io.BytesIO(data), out, model)
    return out.getvalue()


def decompress_bytes(data: bytes, model: Optional[Model] = None) -> bytes:
    """Convenience: decompress an in-memory buffer (doc example, lib.rs:23-39)."""
    out = io.BytesIO()
    decompress(io.BytesIO(data), out, model)
    return out.getvalue()
