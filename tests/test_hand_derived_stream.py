"""A reference stream derived BY HAND from codec.rs — independent format anchor.

Every other stream check in this repo is differential (oracle vs Fenwick vs
native C++ vs device coders), which anchors to the reference only through the
transcribed bitio golden vectors.  This test closes the remaining loop: the
expected bytes below are worked out step by step from the reference's coder
arithmetic (codec.rs:28-120) and bit I/O (bitio/mod.rs:148-198) with plain
integer math — no codec code involved — and every implementation must
reproduce them exactly.

Input: the single byte b"A" (symbol 65) at the doc-example config
Parameters(8, 14, 16) (lib.rs:31) with the uniform initial model
(freq[i] = 1 for all 257 symbols, cum[i] = i; adaptive_linear.rs:26-28).

Derivation (code_max 65535, half 32768, quarter 16384, three_q 49152):

symbol 65 (codec.rs:55-89):
  count = 257; (flo, fhi) = (cum[65], cum[66]) = (65, 66)
  range = high - low + 1 = 65536
  high  = 0 + 65536*66//257 - 1 = 16829
  low   = 0 + 65536*65//257     = 16575
  model adapts: cum[i>65] += 1, count -> 258
  renorm (E1/E2/E3 loop, codec.rs:62-89):
    emits, in order: 0 (high<half), 1, 0, 0, 0, 0, 0   -- 7 bits "0100000"
    leaving low = 24448, high = 57087, pending = 0

EOF symbol 256 (codec.rs:91-120; the stream API appends EOF):
  count = 258; (flo, fhi) = (cum[256], cum[257]) = (257, 258)
  range = 57087 - 24448 + 1 = 32640
  high  = 24448 + 32640*258//258 - 1 = 57087
  low   = 24448 + 32640*257//258     = 56961
  (count == freq_max? no: 258 < 16383, but EOF still adapts; irrelevant —
   nothing further is coded)
  renorm emits 9 more bits: "110111101", leaving low = 512, extra = 7
  drain `extra` disambiguation bits from the top of low (codec.rs:91-99):
    low = 512 = 0b0000001000000000 -> next 7 top bits: "0000001"

Bit sequence (23 bits): 01000001 10111101 0000001
flush_bits zero-pads the final byte (bitio/mod.rs:185): "010000011011110100000010"
  = 0x41 0xBD 0x02
"""

import pytest

from redux_tpu import oracle
from redux_tpu.models.fenwick import AdaptiveFenwickModel
from redux_tpu.models.linear import AdaptiveLinearModel
from redux_tpu.params import Parameters

EXPECTED = bytes.fromhex("41bd02")
PARAMS = Parameters(8, 14, 16)


@pytest.mark.parametrize("model_cls", [AdaptiveLinearModel, AdaptiveFenwickModel])
def test_oracle_models_match_hand_derivation(model_cls):
    assert oracle.compress_bytes(b"A", model_cls(PARAMS)) == EXPECTED


def test_native_matches_hand_derivation():
    native = pytest.importorskip("redux_tpu.native")
    try:
        got = native.compress_bytes(b"A", PARAMS)
    except Exception as e:  # pragma: no cover - build-environment only
        pytest.skip(f"native build unavailable: {e}")
    assert got == EXPECTED


def test_hand_derived_stream_decodes():
    assert oracle.decompress_bytes(EXPECTED, AdaptiveFenwickModel(PARAMS)) == b"A"
