"""Randomized differential campaign: the GPU coder kernels vs the oracle.

Usage: python scripts/fuzz_campaign.py [minutes]

Random valid (8, f, c) configs x random deltas x random priors x mixed
block contents, comparing the Pallas coder kernels of
redux_tpu.ops.triton_coder (interpret mode, on the CPU) against the
sequential oracle bit-for-bit, encode and decode.  Every 4th trial
additionally runs the generic device-path coders (ops/generic: dense
JaxModel) against the specialized ranks+encode_blocks path and
round-trips the result.  Not part of CI — a bounded bug hunt.
"""
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from redux_tpu import oracle
from redux_tpu.models.dense import prior_init_cum, quantize_prior, uniform_init_cum
from redux_tpu.ops.coder import bytes_to_words_device, encode_blocks, max_block_words
from redux_tpu.ops.generic import (
    decode_blocks_generic,
    dense_jax_model,
    encode_blocks_generic,
)
from redux_tpu.ops.ranks import precompute_encode_model
from redux_tpu.ops.triton_coder import decode_blocks as kernel_decode
from redux_tpu.ops.triton_coder import encode_blocks as kernel_encode
from redux_tpu.ops.triton_coder import supports
from redux_tpu.params import Parameters

DEADLINE = time.time() + float(sys.argv[1]) * 60 if len(sys.argv) > 1 else time.time() + 20 * 60
rng = np.random.default_rng(int(time.time()))

CONFIGS = [
    (8, 10, 12), (8, 12, 14), (8, 14, 16), (8, 16, 18), (8, 20, 22),
    (8, 18, 22), (8, 22, 24), (8, 12, 18),
]


def rand_block(k):
    kind = rng.integers(0, 6)
    n = int(rng.integers(1, k + 1)) if rng.integers(0, 3) == 0 else k
    if kind == 0:
        return bytes(rng.integers(0, 256, n, dtype=np.uint8))
    if kind == 1:
        return bytes([int(rng.integers(0, 256))] * n)
    if kind == 2:
        return bytes(rng.integers(0, int(rng.integers(2, 17)), n, dtype=np.uint8))
    if kind == 3:
        return (b"the quick brown fox 0123456789 " * (n // 8 + 1))[:n]
    if kind == 4:  # boundary-heavy: symbols near multiples of 8
        base = (np.arange(n) * 8 + rng.integers(-1, 2, n)) % 256
        return bytes(base.astype(np.uint8))
    return bytes(rng.integers(248, 256, n, dtype=np.uint8))


trial = 0
while time.time() < DEADLINE:
    trial += 1
    sb, fb, cb = CONFIGS[rng.integers(0, len(CONFIGS))]
    params = Parameters(sb, fb, cb)
    if not supports(params):
        continue
    delta = int(rng.integers(1, 256))
    k = int([48, 96, 160, 224, 288, 352][rng.integers(0, 6)])
    nb = int(rng.integers(1, 7))
    blocks = [rand_block(k) for _ in range(nb)]
    if rng.integers(0, 2):
        ic = uniform_init_cum(params).astype(np.int32)
    else:
        hist = np.bincount(
            np.frombuffer(b"".join(blocks), np.uint8), minlength=256
        )
        extra = quantize_prior(hist, params, int(rng.integers(64, params.freq_max // 2)))
        full = np.zeros(params.symbol_count, dtype=np.int64)
        full[: extra.shape[0]] = extra
        ic = prior_init_cum(full, params).astype(np.int32)
    if int(ic[-1]) >= params.freq_max:
        continue
    streams = [
        oracle.compress_block(b, params, ic.astype(np.int64), delta)
        for b in blocks
    ]
    # decode differential
    wn = max((len(s) + 3) // 4 for s in streams) + 4
    byts = np.zeros((nb, wn * 4), dtype=np.uint8)
    for i, s in enumerate(streams):
        byts[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    words = np.asarray(bytes_to_words_device(jnp.asarray(byts)))
    lens = np.array([len(b) for b in blocks], dtype=np.int32)
    got = np.asarray(
        kernel_decode(
            jnp.asarray(words), jnp.asarray(lens), jnp.asarray(ic), params,
            k, delta, interpret=True,
        )
    )
    for i, b in enumerate(blocks):
        exp = np.frombuffer(b, dtype=np.uint8)
        if not np.array_equal(got[i, : len(b)], exp):
            print(f"DECODE MISMATCH trial={trial} params={(sb,fb,cb)} "
                  f"delta={delta} k={k} block={i}")
            sys.exit(1)
    # encode differential (rank precompute + kernel vs the oracle streams)
    syms = np.zeros((nb, k), np.int32)
    for i, b in enumerate(blocks):
        syms[i, : len(b)] = np.frombuffer(b, np.uint8)
    lo_r, hi_r, _, _, _, _ = precompute_encode_model(
        jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic),
        params.freq_max, delta=delta, with_tot=False,
    )
    kw, kl, kovf = kernel_encode(
        lo_r, hi_r, jnp.asarray(lens), jnp.asarray(ic)[-1], params, wn, delta,
        interpret=True,
    )
    for i, s in enumerate(streams):
        got_s = np.asarray(kw)[i].astype(">u4").tobytes()[: int(np.asarray(kl)[i])]
        if bool(np.asarray(kovf)[i]) or got_s != s:
            print(f"ENCODE MISMATCH trial={trial} params={(sb,fb,cb)} "
                  f"delta={delta} k={k} block={i}")
            sys.exit(1)
    # generic device-path coders (every 4th trial; reference stream format)
    if trial % 4 == 0:
        model = dense_jax_model(params, ic, delta=delta)
        # The last update may overshoot freq_max by up to delta - 1.
        w = max_block_words(
            min(int(ic[-1]) + delta * (k + 1), params.freq_max + delta),
            params.symbol_count, params, k,
        )
        gw, gl = encode_blocks_generic(
            jnp.asarray(syms), jnp.asarray(lens), model, params, w
        )
        sw, sl = encode_blocks(
            *precompute_encode_model(
                jnp.asarray(syms), jnp.asarray(lens), jnp.asarray(ic),
                params.freq_max, delta=delta,
            ),
            jnp.asarray(lens), params, w,
        )
        if not (np.array_equal(np.asarray(gl), np.asarray(sl))
                and np.array_equal(np.asarray(gw), np.asarray(sw))):
            print(f"GENERIC ENCODE MISMATCH trial={trial} params={(sb,fb,cb)} "
                  f"delta={delta} k={k}")
            sys.exit(1)
        dec = np.asarray(
            decode_blocks_generic(gw, jnp.asarray(lens), model, params, k)
        )
        for i, b in enumerate(blocks):
            if not np.array_equal(
                dec[i, : len(b)], np.frombuffer(b, np.uint8).astype(np.int32)
            ):
                print(f"GENERIC DECODE MISMATCH trial={trial} "
                      f"params={(sb,fb,cb)} delta={delta} k={k} block={i}")
                sys.exit(1)
    if trial % 20 == 0:
        print(f"trial {trial} ok ({(sb,fb,cb)} d{delta} k{k})", flush=True)
    if trial % 40 == 0:
        jax.clear_caches()  # bound host RAM: each (k, config) compile persists

print(f"CAMPAIGN CLEAN: {trial} trials, no mismatches")
