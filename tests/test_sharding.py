"""Multi-device (8 virtual CPU devices) sharded codec tests.

Validates the multi-chip dp path: shard_map'ed encode/decode over a 1-D
mesh produces bit-identical streams to the single-device oracle, with
lanes partitioned across devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from redux_tpu.models.dense import uniform_init_cum
from redux_tpu.oracle import compress_block
from redux_tpu.ops import coder
from redux_tpu.ops.bitpack import streams_to_words, words_to_streams
from redux_tpu.parallel import (
    data_parallel_mesh,
    decode_blocks_sharded,
    encode_symbols_sharded,
    pad_to_devices,
)
from redux_tpu.params import Parameters

from conftest import corpus_file

K = 512
DELTA = 4


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    return data_parallel_mesh()


def _prep(params, n_blocks=16, k=K):
    data = corpus_file("calgary", "news").read_bytes()
    blocks = [data[i * k : (i + 1) * k] for i in range(n_blocks)]
    blocks[-1] = blocks[-1][: k // 3]  # ragged tail
    syms = np.zeros((n_blocks, k), dtype=np.int32)
    lens = np.zeros(n_blocks, dtype=np.int32)
    for i, d in enumerate(blocks):
        syms[i, : len(d)] = np.frombuffer(d, dtype=np.uint8)
        lens[i] = len(d)
    ic = uniform_init_cum(params).astype(np.int32)
    return blocks, syms, lens, ic


def test_sharded_encode_matches_oracle(mesh):
    p = Parameters(8, 14, 16)
    n = pad_to_devices(16, mesh)
    blocks, syms, lens, ic = _prep(p, n_blocks=n)
    w = coder.max_block_words(min(257 + DELTA * K, p.freq_max), p.symbol_count, p, K)
    words, byte_lens, ovf = encode_symbols_sharded(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), p, w, mesh, DELTA
    )
    assert not np.asarray(ovf).any()
    streams = words_to_streams(np.asarray(words), np.asarray(byte_lens))
    for i, d in enumerate(blocks):
        assert streams[i] == compress_block(d, p, ic.astype(np.int64), DELTA), i


def test_sharded_decode_roundtrip(mesh):
    p = Parameters(8, 14, 16)
    n = pad_to_devices(16, mesh)
    blocks, syms, lens, ic = _prep(p, n_blocks=n)
    w = coder.max_block_words(min(257 + DELTA * K, p.freq_max), p.symbol_count, p, K)
    refs = [compress_block(d, p, ic.astype(np.int64), DELTA) for d in blocks]
    wm = streams_to_words(refs, w)
    dec = np.asarray(
        decode_blocks_sharded(
            jnp.asarray(wm), jnp.asarray(lens), jnp.asarray(ic), p, K, mesh, delta=DELTA
        )
    )
    for i, d in enumerate(blocks):
        assert bytes(dec[i, : lens[i]].astype(np.uint8)) == d, i


def test_sharded_output_is_actually_sharded(mesh):
    p = Parameters(8, 14, 16)
    n = pad_to_devices(16, mesh)
    _, syms, lens, ic = _prep(p, n_blocks=n)
    w = coder.max_block_words(min(257 + DELTA * K, p.freq_max), p.symbol_count, p, K)
    words, _, _ = encode_symbols_sharded(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), p, w, mesh, DELTA
    )
    # The lane axis must be partitioned across all mesh devices.
    assert len(words.sharding.device_set) == mesh.devices.size


# ---------------------------------------------------------------------------
# The api's path: the GPU coder kernels under the same dp mesh (interpret
# mode on the CPU — identical semantics, the same shard_map wiring the api
# uses on several cards).
# ---------------------------------------------------------------------------


def _kernel_coder():
    from redux_tpu.ops.backend import KernelCoder

    return KernelCoder(interpret=True)


def test_sharded_pallas_encode_decode_bit_exact(mesh):
    p = Parameters(8, 14, 16)
    kc = _kernel_coder()
    n = kc.lane_quantum * mesh.devices.size  # whole kernel tiles per shard
    blocks, syms, lens, ic = _prep(p, n_blocks=12)
    syms = np.pad(syms, ((0, n - 12), (0, 0)))
    lens = np.pad(lens, (0, n - 12))
    w = K // 4 + 16
    words, byte_lens, ovf = encode_symbols_sharded(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), p, w, mesh,
        DELTA, kc,
    )
    assert not np.asarray(ovf).any()
    assert len(words.sharding.device_set) == mesh.devices.size
    wn, bl = np.asarray(words), np.asarray(byte_lens)
    for i, d in enumerate(blocks):
        got = wn[i].astype(">u4").tobytes()[: bl[i]]
        assert got == compress_block(d, p, ic.astype(np.int64), DELTA), i
    refs = [compress_block(d, p, ic.astype(np.int64), DELTA) for d in blocks]
    wm = np.zeros((n, w + 2), np.uint32)
    wm[:12] = streams_to_words(refs, w + 2)
    dec = decode_blocks_sharded(
        jnp.asarray(wm), jnp.asarray(lens), jnp.asarray(ic), p, K, mesh,
        DELTA, kc,
    )
    assert len(dec.sharding.device_set) == mesh.devices.size
    dec = np.asarray(dec)
    for i, d in enumerate(blocks):
        assert bytes(dec[i, : lens[i]].astype(np.uint8)) == d, i


def test_sharded_pallas_output_is_partitioned(mesh):
    p = Parameters(8, 14, 16)
    kc = _kernel_coder()
    q = kc.lane_quantum * mesh.devices.size
    _, syms, lens, ic = _prep(p, n_blocks=8)
    syms = np.pad(syms, ((0, q - 8), (0, 0)))
    lens = np.pad(lens, (0, q - 8))
    words, byte_lens, _ = encode_symbols_sharded(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic), p, 256, mesh,
        DELTA, kc,
    )
    # The lane axis of the kernel output must span every mesh device.
    assert len(words.sharding.device_set) == mesh.devices.size
    assert len(byte_lens.sharding.device_set) == mesh.devices.size


def test_api_kernel_path_on_the_mesh(monkeypatch, mesh):
    """api.encode/decode with the GPU coder kernels (interpret mode)
    sharded over every device: the lane quantum is TB times the device
    count, and the archive equals the XLA path's byte for byte."""
    from redux_tpu import api
    from redux_tpu.ops import backend

    data = (b"sharded kernel path " * 300)[:5000] + bytes(range(256)) * 4
    want = api.encode(data, block_size=256)
    kc = _kernel_coder()
    monkeypatch.setattr(backend, "select", lambda params: kc)
    got = api.encode(data, block_size=256)
    assert got == want
    assert api.decode(got) == data
