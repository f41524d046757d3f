"""Freeze-overshoot regression: totals may exceed freq_max by delta-1.

The adaptation freeze (adaptive_linear.rs:34, adaptive_tree.rs:84) stops
updates once ``total >= freq_max`` — but with the redux_tpu generalized
increment ``delta > 1`` the LAST update can overshoot: the final total is
``init_total + delta * t_freeze`` which lands anywhere in
``[freq_max, freq_max + delta - 1]``.  After that, ``cdf[256]``
(= total - EOF weight) can itself exceed ``freq_max``, so any decoder
formulation that uses ``freq_max`` as an "above every cumulative entry"
sentinel mis-decodes the TOP symbol (0xFF) post-freeze.

These tests drive streams that (a) cross the freeze with an overshoot
(init_total chosen so ``(freq_max - init_total) % delta != 0``) and
(b) decode 0xFF afterwards — through every decode path.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from redux_tpu import oracle
from redux_tpu.models.dense import uniform_init_cum
from redux_tpu.ops.coder import decode_blocks, max_block_words
from redux_tpu.params import Parameters

PARAMS = Parameters(8, 14, 16)  # freq_max 16383
DELTA = 16
# uniform init_total = 257; (16383 - 257) % 16 = 14 != 0 -> overshoot:
# final total = 257 + 16 * 1008 = 16385 = freq_max + 2, cdf[256] = 16384.
K = 1200  # crosses t_freeze = 1008 with ~190 post-freeze symbols


def _overshoot_block(rng):
    data = rng.integers(0, 256, K, dtype=np.uint8)
    data[1010:] = 255  # decode the top symbol well after the freeze
    return bytes(data)


def _encode_oracle(data, ic):
    return oracle.compress_block(data, PARAMS, ic.astype(np.int64), DELTA)


def _words_matrix(streams, n_words):
    b = len(streams)
    words = np.zeros((b, n_words), dtype=np.uint32)
    for i, s in enumerate(streams):
        padded = s + b"\0" * (-len(s) % 4)
        w = np.frombuffer(padded, dtype=">u4").astype(np.uint32)
        words[i, : len(w)] = w
    return words


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(99)
    data = [_overshoot_block(rng) for _ in range(3)]
    ic = uniform_init_cum(PARAMS).astype(np.int32)
    streams = [_encode_oracle(d, ic) for d in data]
    return data, streams, ic


def test_overshoot_reaches_top_symbol(blocks):
    # Meta-test: the scenario really overshoots and codes 0xFF after it.
    _, _, ic = blocks
    total = int(ic[-1]) + DELTA * -(-(PARAMS.freq_max - int(ic[-1])) // DELTA)
    assert total > PARAMS.freq_max  # overshoot happened
    assert K > 1008


def test_xla_decode_blocks_overshoot(blocks):
    data, streams, ic = blocks
    n_words = max_block_words(PARAMS.freq_max + DELTA, PARAMS.symbol_count, PARAMS, K)
    words = _words_matrix(streams, n_words + 2)
    lens = np.full(len(data), K, dtype=np.int32)
    out = np.asarray(
        decode_blocks(
            jnp.asarray(words), jnp.asarray(lens), jnp.asarray(ic), PARAMS, K,
            delta=DELTA,
        )
    )
    for i, d in enumerate(data):
        assert out[i, :K].astype(np.uint8).tobytes() == d, f"block {i}"


def test_pallas_decode_overshoot(blocks):
    from redux_tpu.ops.triton_coder import decode_blocks as kernel_decode

    data, streams, ic = blocks
    n_words = max_block_words(PARAMS.freq_max + DELTA, PARAMS.symbol_count, PARAMS, K)
    words = _words_matrix(streams, n_words)
    lens = np.full(len(data), K, dtype=np.int32)
    out = np.asarray(
        kernel_decode(
            jnp.asarray(words), jnp.asarray(lens), jnp.asarray(ic), PARAMS, K,
            DELTA, interpret=True,
        )
    )
    for i, d in enumerate(data):
        assert out[i, :K].astype(np.uint8).tobytes() == d, f"block {i}"


def test_pallas_encode_overshoot(blocks):
    from redux_tpu.ops.backend import KernelCoder

    data, streams, ic = blocks
    syms = np.zeros((len(data), K), dtype=np.int32)
    for i, d in enumerate(data):
        syms[i] = np.frombuffer(d, dtype=np.uint8)
    lens = np.full(len(data), K, dtype=np.int32)
    n_words = max_block_words(PARAMS.freq_max + DELTA, PARAMS.symbol_count, PARAMS, K)
    words, byte_lens, ovf = KernelCoder(interpret=True).encode(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), PARAMS, n_words, DELTA
    )
    assert not np.asarray(ovf).any()
    words = np.asarray(words)
    byte_lens = np.asarray(byte_lens)
    for i, s in enumerate(streams):
        got = words[i].astype(">u4").tobytes()[: byte_lens[i]]
        assert got == s, f"block {i}"
