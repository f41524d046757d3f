"""Device-resident benchmark pipeline (used by the repo-root ``bench.py``).

Measures the shipped configuration (Parameters.tpu_wide, the api's block
sizing, delta 16, warm-start prior — container.py defaults) through the
coder :func:`redux_tpu.ops.backend.select` picks for the backend:

* device-resident encode (rank stage + coder) and decode, inputs and
  outputs left on the device, each run ending in ``block_until_ready``,
  after one warm-up run (compilation);
* end-to-end ``api.encode`` / ``api.decode`` wall times, host bytes to
  archive bytes and back, after one warm-up pass.

Round-trip bit-exactness is verified every run, the ratio comes from the
archive bytes, and every result names the device it ran on.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from . import api, container
from .ops import backend
from .params import Parameters

DELTA = container.DEFAULT_DELTA


def device_info() -> dict:
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _times(step, iters: int):
    """Wall seconds of ``iters`` runs of ``step``, each synced."""
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(step())
        ts.append(time.perf_counter() - t0)
    return ts


def run_device_benchmark(data: bytes, block_size: int = 0, iters: int = 10):
    if not block_size:  # the shipped default: api's auto block sizing
        block_size = (
            api._auto_block_size(len(data))
            if len(data) >= api._AUTO_BS_MIN
            else container.DEFAULT_BLOCK_SIZE
        )
    params = Parameters.tpu_wide()
    coder = backend.select(params)
    hist = np.bincount(np.frombuffer(data, dtype=np.uint8), minlength=256)
    budget = min(container.DEFAULT_PRIOR_BUDGET, params.freq_max // 2)
    prior = api.quantize_prior(hist, params, budget)[:256]
    ic = api._init_cum(params, prior)

    syms_np, lens_np, n_blocks = api._split_blocks(data, block_size, coder.lane_quantum)
    k = block_size
    n_words = min(api._static_words(params, k, DELTA), k // 4 + 16)
    syms = jax.device_put(jnp.asarray(syms_np))
    lens = jax.device_put(jnp.asarray(lens_np))
    icj = jax.device_put(jnp.asarray(ic))

    def encode_step():
        return coder.encode(syms, lens, icj, params, n_words, DELTA)

    words, byte_lens, ovf = jax.block_until_ready(encode_step())
    t_enc = _times(encode_step, iters)

    # Blocks whose coded stream reaches their raw size are stored raw by
    # the container and bypass the decoder (zero-length lanes).
    blk_bytes = np.minimum(k, len(data) - k * np.arange(n_blocks))
    bl_np = np.asarray(byte_lens)[:n_blocks]
    raw = np.asarray(ovf)[:n_blocks] | (bl_np >= blk_bytes)
    dlens = jnp.asarray(np.where(np.pad(raw, (0, len(lens_np) - n_blocks)), 0, lens_np))
    wpad = jnp.pad(words, ((0, 0), (0, 2)))

    def decode_step():
        return coder.decode(wpad, dlens, icj, params, k, DELTA)

    decoded = np.asarray(jax.block_until_ready(decode_step()))
    t_dec = _times(decode_step, iters)
    src = syms_np[:n_blocks]
    verified = bool((decoded[:n_blocks][~raw] == src[~raw]).all())

    archive = api.encode(data, params=params, block_size=block_size, delta=DELTA)
    verified = verified and api.decode(archive) == data  # warm-up pass
    t0 = time.perf_counter()
    archive = api.encode(data, params=params, block_size=block_size, delta=DELTA)
    t_enc_e2e = time.perf_counter() - t0
    t0 = time.perf_counter()
    verified = verified and api.decode(archive) == data
    t_dec_e2e = time.perf_counter() - t0

    n = len(data)
    te, td = float(np.median(t_enc)), float(np.median(t_dec))
    return {
        "device": device_info(),
        "coder": coder.name,
        "encode_gbps": n / te / 1e9,
        "decode_gbps": n / td / 1e9,
        "aggregate_gbps": 2 * n / (te + td) / 1e9,
        "encode_e2e_gbps": n / t_enc_e2e / 1e9,
        "decode_e2e_gbps": n / t_dec_e2e / 1e9,
        "encode_ms": [round(t * 1e3, 3) for t in t_enc],
        "decode_ms": [round(t * 1e3, 3) for t in t_dec],
        "ratio": n / len(archive),
        "verified": verified,
        "n_blocks": n_blocks,
        "block_size": block_size,
    }
