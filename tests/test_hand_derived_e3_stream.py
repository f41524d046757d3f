"""Hand-derived streams forcing E3 underflow + the pending-bit flush.

tests/test_hand_derived_stream.py anchors the E1/E2 paths, but its
derivation has ``pending = 0`` throughout — the E3 underflow counter
(codec.rs:75-82) and the pending-opposite-bit flush (codec.rs:39-46)
were only ever checked differentially between our own implementations.
The two vectors below close that loophole: worked out step by step from
the reference's integer arithmetic with no codec code involved, they
drive E3 eight times in a row and then flush all eight pending bits.

Input: the single byte b"\x80" (symbol 128) at Parameters(8, 14, 16)
(lib.rs:31) with the uniform initial model (cum[i] = i, count = 257).

== Reference-format stream (EOF symbol + extra drain) ==

symbol 128 (codec.rs:55-89):
  range = 65536; low = 65536*128//257 = 32640; high = 65536*129//257 - 1
  = 32894.  [32640, 32894] straddles half = 32768 with low >= quarter
  (16384) and high < 3*quarter (49152): the E3 branch fires EIGHT times
  (codec.rs:75-82), each subtracting quarter and doubling —
    pending 1: low 32512  high 33021
    pending 2: low 32256  high 33275
    pending 3: low 31744  high 33783
    pending 4: low 30720  high 34799
    pending 5: low 28672  high 36831
    pending 6: low 24576  high 40895
    pending 7: low 16384  high 49023
    pending 8: low     0  high 65279   (loop breaks; NO bits emitted yet)
  model adapts: cum[i > 128] += 1, count -> 258.

EOF symbol 256 (codec.rs:91-120):
  range = 65280; low = 0 + 65280*257//258 = 65026; high = 65280*258//258
  - 1 = 65279.  low >= half: put_bit(1) flushes the EIGHT pending
  opposite bits (codec.rs:39-46) -> "100000000"; seven more renorm
  iterations emit "1111110" (six E2 ones, one E1 zero), leaving
  low = 512 and extra = 16 - 8 = 8.  The extra-drain (codec.rs:91-99)
  emits the top 8 bits of low = 0b0000001000000000 -> "00000010".

  Bits: 1000000 00111111 000000010 (24) -> bytes 0x80 0x7E 0x02.

== v2 block payload (redux_tpu's own terminator, container.py) ==

Same symbol-128 coding (pending = 8, low = 0, high = 65279), then the
2-bit terminator: tq = ceil(low / quarter) = 0; the first terminator
bit put_bit(0) flushes the eight pending ONES -> "011111111"; the
second emits "0".  Bits: 0111111110 + 6 pad zeros -> 0x7F 0x80.
"""

import numpy as np
import pytest

from redux_tpu import oracle
from redux_tpu.models.dense import DenseModel, uniform_init_cum
from redux_tpu.models.fenwick import AdaptiveFenwickModel
from redux_tpu.models.linear import AdaptiveLinearModel
from redux_tpu.params import Parameters

INPUT = b"\x80"
PARAMS = Parameters(8, 14, 16)
EXPECTED_REF = bytes.fromhex("807e02")
EXPECTED_V2 = bytes.fromhex("7f80")


@pytest.mark.parametrize("model_cls", [AdaptiveLinearModel, AdaptiveFenwickModel])
def test_oracle_models_match_e3_derivation(model_cls):
    assert oracle.compress_bytes(INPUT, model_cls(PARAMS)) == EXPECTED_REF


def test_dense_model_matches_e3_derivation():
    assert oracle.compress_bytes(INPUT, DenseModel(PARAMS)) == EXPECTED_REF


def test_native_matches_e3_derivation():
    native = pytest.importorskip("redux_tpu.native")
    assert native.compress_bytes(INPUT, PARAMS) == EXPECTED_REF


def test_e3_stream_decodes():
    assert oracle.decompress_bytes(EXPECTED_REF, AdaptiveFenwickModel(PARAMS)) == INPUT


def test_v2_terminator_oracle_matches_derivation():
    ic = uniform_init_cum(PARAMS).astype(np.int64)
    assert oracle.compress_block(INPUT, PARAMS, ic, 1) == EXPECTED_V2
    assert oracle.decompress_block(EXPECTED_V2, 1, PARAMS, ic, 1) == INPUT


def test_v2_terminator_native_matches_derivation():
    native = pytest.importorskip("redux_tpu.native")
    assert native.compress_block_v2(INPUT, PARAMS, None, 1) == EXPECTED_V2
    assert native.decompress_block_v2(EXPECTED_V2, 1, PARAMS, None, 1) == INPUT


def test_v2_terminator_xla_coder_matches_derivation():
    import jax.numpy as jnp

    from redux_tpu.ops.coder import encode_blocks_v2
    from redux_tpu.ops.ranks import precompute_encode_model

    ic = uniform_init_cum(PARAMS).astype(np.int32)
    syms = jnp.asarray(np.frombuffer(INPUT, np.uint8)[None, :].astype(np.int32))
    lens = jnp.asarray(np.array([1], np.int32))
    lo, hi, tot, _, _, _ = precompute_encode_model(
        syms, lens, jnp.asarray(ic), PARAMS.freq_max, delta=1
    )
    words, blens, ovf = encode_blocks_v2(lo, hi, tot, lens, PARAMS, 8)
    assert not bool(np.asarray(ovf).any())
    got = np.asarray(words)[0].astype(">u4").tobytes()[: int(np.asarray(blens)[0])]
    assert got == EXPECTED_V2


def test_v2_terminator_pallas_kernels_match_derivation():
    import jax.numpy as jnp

    from redux_tpu.ops.backend import KernelCoder
    from redux_tpu.ops.triton_coder import decode_blocks

    ic = uniform_init_cum(PARAMS).astype(np.int32)
    syms = jnp.asarray(np.frombuffer(INPUT, np.uint8)[None, :].astype(np.int32))
    lens = jnp.asarray(np.array([1], np.int32))
    words, blens, ovf = KernelCoder(interpret=True).encode(
        syms, lens, jnp.asarray(ic), PARAMS, 8, 1
    )
    got = np.asarray(words)[0].astype(">u4").tobytes()[: int(np.asarray(blens)[0])]
    assert got == EXPECTED_V2
    wpad = np.zeros((1, 8), np.uint32)
    wpad[0, 0] = int.from_bytes(EXPECTED_V2 + b"\0\0", "big")
    dec = np.asarray(
        decode_blocks(
            jnp.asarray(wpad), lens, jnp.asarray(ic), PARAMS, 1, 1, interpret=True
        )
    )
    assert bytes(dec[0, :1]) == INPUT
