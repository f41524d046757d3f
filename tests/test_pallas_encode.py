"""Differential tests: the Pallas GPU encode kernel vs the XLA v2 encoder/oracle.

CPU runs use Pallas interpret mode (``interpret=True``): the semantics the
Triton route compiles, so stream bit-exactness is pinned without a GPU.
"""

import numpy as np
import jax.numpy as jnp

from redux_tpu import oracle
from redux_tpu.models.dense import prior_init_cum, uniform_init_cum
from redux_tpu.ops import backend
from redux_tpu.ops.coder import encode_blocks_v2, max_block_words
from redux_tpu.ops.ranks import precompute_encode_model
from redux_tpu.ops.triton_coder import TB, encode_blocks
from redux_tpu.params import Parameters

KERNEL = backend.KernelCoder(interpret=True)


def _blocks_matrix(blocks, k):
    n = len(blocks)
    syms = np.zeros((n, k), dtype=np.int32)
    lens = np.zeros(n, dtype=np.int32)
    for i, d in enumerate(blocks):
        syms[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        lens[i] = len(d)
    return syms, lens


def _check(blocks, words, byte_lens, ovf, params, ic, delta):
    words = np.asarray(words)
    byte_lens = np.asarray(byte_lens)
    assert not np.asarray(ovf).any()
    for i, d in enumerate(blocks):
        exp = oracle.compress_block(d, params, ic.astype(np.int64), delta)
        got = words[i].astype(">u4").tobytes()[: byte_lens[i]]
        assert got == exp, (
            f"block {i}: len {len(got)} vs {len(exp)}; "
            f"first diff at {next((j for j in range(min(len(got), len(exp))) if got[j] != exp[j]), -1)}"
        )


def _run(blocks, params, delta, k):
    syms, lens = _blocks_matrix(blocks, k)
    ic = uniform_init_cum(params).astype(np.int32)
    lo, hi, tot, _, _, _ = precompute_encode_model(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), params.freq_max,
        delta=delta, with_tot=False,
    )
    assert tot is None  # totals are computed in-kernel (closed form of t)
    max_count = min(params.symbol_count + delta * k, params.freq_max)
    n_words = max_block_words(max_count, params.symbol_count, params, k)
    words, byte_lens, ovf = encode_blocks(
        lo, hi, jnp.asarray(lens), jnp.asarray(ic, dtype=jnp.int32)[-1],
        params, n_words, delta, interpret=True,
    )
    assert words.shape == (len(blocks), n_words)
    _check(blocks, words, byte_lens, ovf, params, ic, delta)


def test_wide_config_mixed_blocks():
    params = Parameters.tpu_wide()
    rng = np.random.default_rng(0)
    k = 300
    blocks = [
        bytes(rng.integers(0, 256, k, dtype=np.uint8)),
        bytes([65] * k),
        (b"the quick brown fox jumps over the lazy dog. " * 10)[:k],
        b"x",
        bytes(rng.integers(0, 256, 97, dtype=np.uint8)),
    ]
    _run(blocks, params, delta=16, k=k)


def test_u32_config_delta1():
    params = Parameters.tpu32()
    rng = np.random.default_rng(1)
    k = 200
    blocks = [
        bytes(rng.integers(0, 256, k, dtype=np.uint8)),
        (b"abcabcabd" * 40)[:k],
    ]
    _run(blocks, params, delta=1, k=k)


def test_epoch_boundaries_and_tiles():
    """Odd k; more blocks than one program's TB lanes (lane padding)."""
    params = Parameters.tpu_wide()
    rng = np.random.default_rng(2)
    k = 77
    blocks = [bytes(rng.integers(0, 256, rng.integers(1, k + 1), dtype=np.uint8)) for _ in range(TB + 2)]
    _run(blocks, params, delta=16, k=k)


def test_freeze_plateau():
    params = Parameters(8, 14, 16)  # small cap freezes mid-block
    rng = np.random.default_rng(3)
    k = 600
    blocks = [bytes(rng.integers(0, 8, k, dtype=np.uint8))]
    _run(blocks, params, delta=4, k=k)


def _run_ranked(blocks, params, delta, k, prior=False):
    """The GPU coder's whole encode (rank precompute + kernel) vs the oracle."""
    syms, lens = _blocks_matrix(blocks, k)
    ic = uniform_init_cum(params).astype(np.int32)
    if prior:
        full = np.zeros(params.symbol_count, dtype=np.int64)
        full[:256] = 3
        ic = prior_init_cum(full, params).astype(np.int32)
    max_count = min(int(ic[-1]) + delta * k, params.freq_max)
    n_words = max_block_words(max_count, params.symbol_count, params, k)
    words, byte_lens, ovf = KERNEL.encode(
        jnp.asarray(syms.astype(np.uint8)), jnp.asarray(lens), jnp.asarray(ic),
        params, n_words, delta,
    )
    _check(blocks, words, byte_lens, ovf, params, ic, delta)


def test_ranked_kernel_wide_mixed():
    params = Parameters.tpu_wide()
    rng = np.random.default_rng(4)
    k = 300
    blocks = [
        bytes(rng.integers(0, 256, k, dtype=np.uint8)),
        bytes([65] * k),
        (b"the quick brown fox jumps over the lazy dog. " * 10)[:k],
        b"x",
        bytes(rng.integers(0, 256, 97, dtype=np.uint8)),
    ]
    _run_ranked(blocks, params, delta=16, k=k)


def test_ranked_kernel_prior_and_freeze():
    params = Parameters(8, 14, 16)
    rng = np.random.default_rng(5)
    k = 600
    blocks = [bytes(rng.integers(0, 8, k, dtype=np.uint8)),
              (b"abcabcabd" * 80)[:k]]
    _run_ranked(blocks, params, delta=4, k=k, prior=True)


def test_kernel_matches_xla_encoder_words_and_overflow_cut():
    """Same byte lengths and ovf flags as encode_blocks_v2, and the same
    words up to each stream's end — also when ``n_words`` cuts a stream
    short (the api then stores that block raw)."""
    params = Parameters.tpu_wide()
    rng = np.random.default_rng(6)
    k = 256
    blocks = [bytes(rng.integers(0, 256, k, dtype=np.uint8)),
              (b"mostly text, mostly " * 20)[:k], b"\x00" * k]
    syms, lens = _blocks_matrix(blocks, k)
    ic = jnp.asarray(uniform_init_cum(params).astype(np.int32))
    lo, hi, tot, _, _, _ = precompute_encode_model(
        jnp.asarray(syms), jnp.asarray(lens), ic, params.freq_max, delta=16
    )
    n_words = k // 8  # too small for the random block's stream
    wk, bk, ok = encode_blocks(lo, hi, jnp.asarray(lens), ic[-1], params,
                               n_words, 16, interpret=True)
    wx, bx, ox = encode_blocks_v2(lo, hi, tot, jnp.asarray(lens), params, n_words)
    np.testing.assert_array_equal(np.asarray(bk), np.asarray(bx))
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(ox))
    assert int(np.asarray(bk)[0]) > 4 * n_words  # the cut stream says so
    for i in range(len(blocks)):
        n = min(-(-int(np.asarray(bx)[i]) // 4), n_words)
        np.testing.assert_array_equal(np.asarray(wk)[i, :n], np.asarray(wx)[i, :n])
