"""Differential tests: the Pallas GPU decode kernel vs the sequential v2 oracle.

On the CPU the kernel runs in Pallas interpret mode (``interpret=True``):
the semantics the Triton route compiles, so these tests pin the kernel's
bit-level behavior without a GPU.
"""

import numpy as np
import pytest

from redux_tpu import oracle
from redux_tpu.models.dense import prior_init_cum, quantize_prior, uniform_init_cum
from redux_tpu.ops import coder
from redux_tpu.ops.coder import bytes_to_words_device
from redux_tpu.ops.triton_coder import TB, decode_blocks
from redux_tpu.params import Parameters

import jax.numpy as jnp


def _encode_blocks_oracle(blocks, params, init_cum, delta):
    return [oracle.compress_block(b, params, init_cum.astype(np.int64), delta) for b in blocks]


def _to_words(streams, extra_words=4):
    wn = max((len(s) + 3) // 4 for s in streams) + extra_words
    byts = np.zeros((len(streams), wn * 4), dtype=np.uint8)
    for i, s in enumerate(streams):
        byts[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    return np.asarray(bytes_to_words_device(jnp.asarray(byts)))


def _roundtrip(blocks, params, init_cum, delta, k, extra_words=4):
    streams = _encode_blocks_oracle(blocks, params, init_cum, delta)
    words = _to_words(streams, extra_words)
    lens = np.array([len(b) for b in blocks], dtype=np.int32)
    got = np.asarray(
        decode_blocks(
            jnp.asarray(words), jnp.asarray(lens), jnp.asarray(init_cum), params,
            k, delta, interpret=True,
        )
    )
    assert got.shape == (len(blocks), k) and got.dtype == np.uint8
    for i, b in enumerate(blocks):
        np.testing.assert_array_equal(
            got[i, : len(b)], np.frombuffer(b, dtype=np.uint8), err_msg=f"block {i}"
        )
        assert not got[i, len(b) :].any(), f"block {i}: symbols past lens"
    return words, lens, got


def test_wide_config_random_and_text():
    params = Parameters.tpu_wide()
    rng = np.random.default_rng(0)
    k = 512
    blocks = [
        bytes(rng.integers(0, 256, k, dtype=np.uint8)),  # incompressible
        bytes([65] * k),  # degenerate single symbol
        (b"the quick brown fox jumps over the lazy dog. " * 20)[:k],
        bytes(rng.integers(0, 4, k, dtype=np.uint8)),  # tiny alphabet
        b"x",  # 1-byte block
        bytes(rng.integers(0, 256, 77, dtype=np.uint8)),  # short block
    ]
    ic = uniform_init_cum(params).astype(np.int32)
    _roundtrip(blocks, params, ic, delta=16, k=k)


def test_u32_config_delta1():
    params = Parameters.tpu32()
    rng = np.random.default_rng(1)
    k = 300
    blocks = [
        bytes(rng.integers(0, 256, k, dtype=np.uint8)),
        (b"abcabcabd" * 40)[:k],
    ]
    ic = uniform_init_cum(params).astype(np.int32)
    _roundtrip(blocks, params, ic, delta=1, k=k)


def test_prior_init_and_freeze():
    """Warm-start prior + a freq cap small enough to freeze mid-block."""
    params = Parameters(8, 20, 22)
    rng = np.random.default_rng(2)
    k = 400
    data = (b"aaabbbcccddd" * 200)[:k]
    hist = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    extra = quantize_prior(hist, params, 4096)
    full = np.zeros(params.symbol_count, dtype=np.int64)
    full[: extra.shape[0]] = extra
    ic = prior_init_cum(full, params).astype(np.int32)
    blocks = [data, bytes(rng.integers(0, 256, k, dtype=np.uint8))]
    _roundtrip(blocks, params, ic, delta=64, k=k)  # delta*k drives toward cap


def test_many_lanes_cross_tile():
    """More blocks than one program's TB lanes: the grid and the lane
    padding of the last program."""
    params = Parameters.tpu_wide()
    rng = np.random.default_rng(3)
    k = 96
    blocks = [bytes(rng.integers(0, 256, rng.integers(1, k + 1), dtype=np.uint8)) for _ in range(2 * TB + 3)]
    ic = uniform_init_cum(params).astype(np.int32)
    _roundtrip(blocks, params, ic, delta=16, k=k)


def test_divergent_rates_slab_refill():
    """Incompressible and constant blocks in one program: each lane's
    stream position diverges across thousands of words."""
    params = Parameters.tpu_wide()
    rng = np.random.default_rng(4)
    k = 4096
    blocks = [
        bytes(rng.integers(0, 256, k, dtype=np.uint8)),  # ~8 KB stream
        bytes([7] * k),  # ~tens of bytes
        bytes(rng.integers(0, 16, k, dtype=np.uint8)),
        (b"z" * 100 + bytes(rng.integers(0, 256, 100, dtype=np.uint8))) * 20,
    ]
    blocks[3] = blocks[3][:k]
    ic = uniform_init_cum(params).astype(np.int32)
    _roundtrip(blocks, params, ic, delta=16, k=k)


def test_reads_past_the_word_buffer_are_zero_bits():
    """With no padding words at all, the decoder's read-ahead past the
    buffer's end must see zero bits (the v2 termination contract)."""
    params = Parameters.tpu_wide()
    rng = np.random.default_rng(8)
    k = 64
    blocks = [bytes(rng.integers(0, 256, k, dtype=np.uint8)), b"ab" * 32, b"q"]
    ic = uniform_init_cum(params).astype(np.int32)
    _roundtrip(blocks, params, ic, delta=16, k=k, extra_words=0)


def test_matches_xla_scan_on_garbage_free_lanes():
    """Kernel and XLA scan agree symbol for symbol, padding lanes
    (lens 0) included."""
    params = Parameters.tpu_wide()
    rng = np.random.default_rng(9)
    k = 128
    blocks = [bytes(rng.integers(0, 256, rng.integers(1, k + 1), dtype=np.uint8)) for _ in range(5)]
    blocks.append(b"")
    ic = uniform_init_cum(params).astype(np.int32)
    streams = _encode_blocks_oracle(blocks, params, ic, 16)
    words = _to_words([s or b"\0" for s in streams])
    lens = np.array([len(b) for b in blocks], dtype=np.int32)
    args = (jnp.asarray(words), jnp.asarray(lens), jnp.asarray(ic), params, k)
    got = np.asarray(decode_blocks(*args, 16, interpret=True))
    want = np.asarray(coder.decode_blocks(*args, delta=16))
    np.testing.assert_array_equal(got, want)


def test_rejects_configs_beyond_32_bit_renorm():
    """code_bits > 30 does not fit the kernel's 32-bit renorm words."""
    params = Parameters.default()  # (8, 30, 32)
    words = jnp.zeros((1, 4), jnp.uint32)
    with pytest.raises(ValueError):
        decode_blocks(words, jnp.ones((1,), jnp.int32),
                      jnp.asarray(uniform_init_cum(params)), params, 4, 1,
                      interpret=True)
