"""Vectorized coder vs. sequential oracle — bit-exact differential tests.

The device encode path must produce byte-identical per-block streams to the
reference-semantics oracle (the analog of the reference's linear-vs-tree
differential tier, model/tests.rs, lifted to whole-codec level), and the
vectorized decoder must invert both.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from redux_tpu.models import AdaptiveFenwickModel
from redux_tpu.models.dense import uniform_init_cum
from redux_tpu.oracle import compress_bytes
from redux_tpu.ops.bitpack import streams_to_words, words_to_streams
from redux_tpu.ops.coder import decode_blocks, encode_blocks, max_block_words
from redux_tpu.ops.ranks import precompute_encode_model
from redux_tpu.params import Parameters

from conftest import corpus_file

CONFIGS = [
    Parameters(8, 14, 16),  # doc example; u32 path
    Parameters(8, 15, 17),  # 32-bit config; u32 path
    Parameters(8, 30, 32),  # production config; i64 path
    Parameters(8, 10, 16),  # heavy adaptation freeze; u32 path
]


def _encode_jax(blocks, params):
    b = len(blocks)
    k = max(max((len(d) for d in blocks), default=1), 1)
    syms = np.zeros((b, k), dtype=np.int32)
    lens = np.array([len(d) for d in blocks], dtype=np.int32)
    for i, d in enumerate(blocks):
        syms[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
    ic = uniform_init_cum(params).astype(np.int32)
    lo, hi, tot, el, eh, et = precompute_encode_model(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), params.freq_max
    )
    w = max_block_words(min(257 + k, params.freq_max), params.symbol_count, params, k)
    words, byte_lens = encode_blocks(
        lo, hi, tot, el, eh, et, jnp.asarray(lens), params, w
    )
    return words_to_streams(np.asarray(words), np.asarray(byte_lens)), w, lens, ic, k


def _decode_jax(streams, lens, ic, params, k, w):
    words = streams_to_words(streams, w)
    syms = np.asarray(
        decode_blocks(jnp.asarray(words), jnp.asarray(lens), jnp.asarray(ic), params, k)
    )
    return [bytes(syms[i, : lens[i]].astype(np.uint8)) for i in range(len(streams))]


def _test_blocks(params, blocks):
    streams, w, lens, ic, k = _encode_jax(blocks, params)
    refs = [compress_bytes(d, AdaptiveFenwickModel(params)) for d in blocks]
    for i, (s, r) in enumerate(zip(streams, refs)):
        assert s == r, f"block {i}: jax stream != oracle stream"
    decoded = _decode_jax(streams, lens, ic, params, k, w)
    for i, d in enumerate(blocks):
        assert decoded[i] == d, f"block {i}: decode mismatch"


@pytest.mark.parametrize("params", CONFIGS, ids=lambda p: f"{p.symbol_bits}-{p.freq_bits}-{p.code_bits}")
def test_corpus_blocks_bit_exact(params):
    book1 = corpus_file("calgary", "book1").read_bytes()
    geo = corpus_file("calgary", "geo").read_bytes()
    rng = np.random.default_rng(3)
    blocks = [
        book1[:800],
        geo[:800],  # binary data
        b"",
        b"\x00" * 500,
        b"\xff" * 500,
        bytes(range(256)) * 2,
        rng.integers(0, 256, 700, dtype=np.uint8).tobytes(),
        b"redux",
    ]
    _test_blocks(params, blocks)


def test_many_lanes_ragged():
    # 50 blocks of scattered lengths, one lane per block.
    rng = np.random.default_rng(5)
    book2 = corpus_file("calgary", "book2").read_bytes()
    blocks = []
    off = 0
    for _ in range(50):
        n = int(rng.integers(0, 600))
        blocks.append(book2[off : off + n])
        off += n
    _test_blocks(Parameters(8, 14, 16), blocks)


@pytest.mark.parametrize(
    "params",
    [p for p in CONFIGS if p.fits_u32],
    ids=lambda p: f"{p.symbol_bits}-{p.freq_bits}-{p.code_bits}",
)
def test_fast_encoder_matches_reference_shaped(params):
    """The planned (scatter-free) encoder is bit-identical to encode_blocks."""
    from redux_tpu.ops.coder import encode_blocks_fast

    rng = np.random.default_rng(11)
    book1 = corpus_file("calgary", "book1").read_bytes()
    b, k = 24, 768
    syms = np.zeros((b, k), dtype=np.int32)
    lens = rng.integers(0, k + 1, b).astype(np.int32)
    lens[0], lens[1], lens[2] = 0, 1, k
    for i in range(b):
        if i % 3 == 0:
            row = np.frombuffer(book1[i * k : i * k + k], dtype=np.uint8)
        elif i % 3 == 1:
            row = rng.integers(0, 256, k, dtype=np.uint8)
        else:
            row = np.full(k, i % 256, dtype=np.uint8)
        syms[i, : len(row)] = row
    ic = uniform_init_cum(params).astype(np.int32)
    pre = precompute_encode_model(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), params.freq_max
    )
    w = max_block_words(min(257 + k, params.freq_max), params.symbol_count, params, k)
    w_ref, bl_ref = encode_blocks(*pre, jnp.asarray(lens), params, w)
    w_new, bl_new, ovf = encode_blocks_fast(*pre, jnp.asarray(lens), params, w)
    assert not np.asarray(ovf).any()
    assert np.array_equal(np.asarray(bl_ref), np.asarray(bl_new))
    w_ref, w_new = np.asarray(w_ref), np.asarray(w_new)
    nw = (np.asarray(bl_new) + 3) // 4
    for i in range(b):
        assert np.array_equal(w_ref[i, : nw[i]], w_new[i, : nw[i]]), i


def test_single_block_archive_equals_reference_stream():
    # A 1-block uniform-prior payload IS a reference stream (SURVEY §7.1).
    data = corpus_file("canterbury", "grammar.lsp").read_bytes()[:1500]
    params = Parameters(8, 30, 32)
    streams, *_ = _encode_jax([data], params)
    assert streams[0] == compress_bytes(data, AdaptiveFenwickModel(params))
