"""Round-trip tests for the sequential reference-semantics codec.

Covers the reference's doc example (lib.rs:23-39), degenerate inputs from
``resources/artificial`` (corpora.rs:87-115), corpus slices, and the
truncated-input EOF path (bitio/mod.rs:106-108).
"""

import io
import random

import pytest

from redux_tpu.bitio import BitReader
from redux_tpu.errors import EofError
from redux_tpu.models import AdaptiveFenwickModel, AdaptiveLinearModel, DenseModel
from redux_tpu.oracle import Codec, compress_bytes, decompress_bytes
from redux_tpu.params import Parameters

from conftest import corpus_file


def roundtrip(data: bytes, params: Parameters, model_cls=AdaptiveFenwickModel):
    comp = compress_bytes(data, model_cls(params))
    decomp = decompress_bytes(comp, model_cls(params))
    assert decomp == data
    return comp


def test_doc_example():
    # lib.rs:23-39: the five bytes "redux" with Parameters(8, 14, 16).
    data = bytes([0x72, 0x65, 0x64, 0x75, 0x78])
    roundtrip(data, Parameters(8, 14, 16))


def test_empty_input():
    comp = roundtrip(b"", Parameters(8, 14, 16))
    assert len(comp) > 0  # EOF symbol + padding still emitted


def test_single_byte():
    # artificial/a.txt is a single byte (corpora.rs:88-96).
    data = corpus_file("artificial", "a.txt").read_bytes()
    assert len(data) == 1
    roundtrip(data, Parameters(8, 14, 16))
    roundtrip(data, Parameters(8, 30, 32))


@pytest.mark.parametrize("freq,code", [(14, 16), (22, 24), (30, 32)])
def test_repeated_symbol(freq, code):
    # aaa.txt-style degenerate input: one symbol repeated (corpora.rs:98).
    roundtrip(b"a" * 3000, Parameters(8, freq, code))


def test_incompressible_random():
    # random.txt-style: uniform random bytes must still round-trip.
    rng = random.Random(42)
    data = bytes(rng.randrange(256) for _ in range(2048))
    comp = roundtrip(data, Parameters(8, 30, 32))
    assert len(comp) >= 2048  # incompressible: slight expansion expected


def test_alphabet_cycle():
    data = bytes(i % 256 for i in range(4096))
    roundtrip(data, Parameters(8, 30, 32))


def test_calgary_slice_all_models():
    # Differential at codec level: all three models must produce identical
    # streams (they are observably identical state machines).
    data = corpus_file("calgary", "book1").read_bytes()[:4096]
    p = Parameters(8, 14, 16)
    streams = {
        compress_bytes(data, cls(p))
        for cls in (AdaptiveFenwickModel, AdaptiveLinearModel, DenseModel)
    }
    assert len(streams) == 1
    comp = streams.pop()
    assert decompress_bytes(comp, AdaptiveFenwickModel(p)) == data


def test_known_symbol_count_decode():
    # Stored-length termination (container extension): decoding exactly n
    # symbols recovers the data without consuming the EOF symbol.
    data = b"hello, adaptive arithmetic coding on device!" * 20
    p = Parameters(8, 14, 16)
    comp = compress_bytes(data, AdaptiveFenwickModel(p))
    codec = Codec(AdaptiveFenwickModel(p))
    out = codec.decompress_symbols(BitReader(io.BytesIO(comp)), len(data))
    assert out == data


def test_truncated_input_raises_eof():
    # Truncated archive surfaces as Eof mid-decode (bitio/mod.rs:106-108).
    data = b"some reasonably long test data for truncation" * 10
    p = Parameters(8, 14, 16)
    comp = compress_bytes(data, AdaptiveFenwickModel(p))
    truncated = comp[: len(comp) // 4]
    with pytest.raises(EofError):
        decompress_bytes(truncated, AdaptiveFenwickModel(p))


def test_freeze_roundtrip():
    # Small freq_max forces the adaptation freeze mid-stream
    # (adaptive_tree.rs:84); round-trip must still be exact.
    data = corpus_file("calgary", "paper5").read_bytes()[:6000]
    roundtrip(data, Parameters(8, 10, 16))


def test_byte_counts_match_stream_lengths():
    # corpora.rs:40-41: returned byte counts equal actual stream lengths.
    from redux_tpu.oracle import compress, decompress

    data = b"byte count parity check" * 50
    p = Parameters(8, 14, 16)
    src, dst = io.BytesIO(data), io.BytesIO()
    n_in, n_out = compress(src, dst, AdaptiveFenwickModel(p))
    assert n_in == len(data)
    assert n_out == len(dst.getvalue())

    src2, dst2 = io.BytesIO(dst.getvalue()), io.BytesIO()
    n_in2, n_out2 = decompress(src2, dst2, AdaptiveFenwickModel(p))
    assert n_in2 == len(dst.getvalue())
    assert n_out2 == len(data)
