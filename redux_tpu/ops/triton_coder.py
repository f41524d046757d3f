"""Pallas coder kernels for NVIDIA GPUs (Triton route).

The XLA coders in :mod:`redux_tpu.ops.coder` run the per-symbol chain as a
``lax.scan``: every symbol step is a few kernel launches, and the decoder
moves its whole ``(B, 258)`` model state through device memory on each of
them.  These kernels run the same chain inside one program per tile of
blocks, with a ``fori_loop`` over symbol positions and all state in
registers:

* :func:`decode_blocks` -- the adaptive model is a ``(DECODE_TB, 256)``
  int32 loop carry holding ``cdf[1..256]`` (``cdf[0]`` is always 0) and
  the running total a ``(DECODE_TB,)`` vector.  One compare pass gives the
  symbol (a count), both bounds (masked max / min) and the ``+delta``
  suffix update (adaptive_linear.rs:33-39).  Each block reads its stream straight from
  device memory: two word loads at its own bit position.
* :func:`encode_blocks` -- consumes the per-position model values of
  :func:`redux_tpu.ops.ranks.precompute_encode_model` (the running totals
  are a closed form of ``t``), runs the closed-form renormalization and the
  96-bit emission window of :func:`redux_tpu.ops.coder.encode_blocks_v2`,
  and stores each finished word at its own offset ``out[nw, lane]``.

Interval products are exact in int64 and divided through float64 (exact
in the kernels' operand range, :func:`_div64`); the renormalization bit
tricks run on 32-bit words (:func:`supports`).  The encoder's model
values and words are lane-minor, so the ``TB`` lanes of one step touch
contiguous memory; the decoder's words and symbols are block-major, so
one block's reads and writes are contiguous.  Streams are bit-identical
to the XLA coders and the sequential oracle; the tests run both kernels
in interpret mode on the CPU.

Every shift amount below stays inside its operand's width: the Triton
lowering emits plain LLVM shifts, for which an over-wide shift is undefined
(XLA's shift semantics do not carry over).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..params import Parameters
from .coder import _append96, _leftalign64, _piece64

# Program geometry, measured on an H100 (PERF.md): the decoder runs one
# warp per block (its 256 model rows spread over the warp's 32 threads,
# reductions by shuffles), the encoder one lane per thread of a warp.
DECODE_TB = 1
DECODE_WARPS = 1
TB = 32  # encoder blocks per program; the api's lane quantum
ENCODE_WARPS = 1

i32 = jnp.int32
i64 = jnp.int64
u32 = jnp.uint32
u64 = jnp.uint64


def supports(params: Parameters) -> bool:
    """Configs the kernels take: byte symbols, renorm state in 32-bit words
    (``code_bits <= 30``: one symbol consumes at most ``code_bits`` bits,
    read in one 31-bit window) and interval products below 2**53
    (``code_bits + freq_bits <= 52``, see :func:`_div64`)."""
    return (
        params.symbol_bits == 8
        and params.code_bits <= 30
        and params.code_bits + params.freq_bits <= 52
    )


def _renorm(low, high, active, cb: int):
    """Closed-form E1/E2/E3 renormalization (codec.rs:62-89, derivation in
    :mod:`redux_tpu.ops.coder`) on int32 lanes.

    Returns ``(n1, n3, low', high')``: the E1/E2 run, the E3 run and the
    renormalized interval.  Inactive lanes keep their interval.
    """
    cmax = (1 << cb) - 1
    half = 1 << (cb - 1)
    n1 = jnp.where(active, lax.clz(low ^ high) - (32 - cb), 0)
    low1 = (low << n1) & cmax
    high1 = ((high << n1) | ((1 << n1) - 1)) & cmax
    a = lax.clz(~(low1 << (33 - cb)))
    b = lax.clz(high1 << (33 - cb))
    n3 = jnp.where(active, jnp.minimum(jnp.minimum(a, b), cb - 1), 0)
    low2 = (low1 << n3) & (cmax >> 1)
    high2 = (((high1 << n3) | ((1 << n3) - 1)) & (cmax >> 1)) | half
    return n1, n3, jnp.where(active, low2, low), jnp.where(active, high2, high)


def _div64(x, y):
    """``x // y`` for non-negative int64 operands with ``x + y < 2**53``.

    Exact through float64: both operands are exact doubles, rounding is
    monotonic so ``fl(x / y) >= n = x // y``, and it cannot reach
    ``n + 1``: that is at least ``1 / y`` above ``x / y``, more than half
    an ulp whenever ``y * (n + 1) <= x + y < 2**53``.  On the GPU this is
    cheaper than the emulated 64-bit integer divide.  The kernels'
    dividends stay below ``2**(code_bits + freq_bits) + 2**code_bits *
    delta`` (the freeze may overshoot ``freq_max`` by ``delta - 1``),
    which :func:`supports` and the container's ``delta <= 255`` keep far
    enough below 2**53.
    """
    return (x.astype(jnp.float64) / y.astype(jnp.float64)).astype(i64)


def _muldiv(a, b, c):
    """``a * b // c`` for non-negative int32 operands, exact in int64."""
    return _div64(a.astype(i64) * b.astype(i64), c.astype(i64)).astype(i32)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decode_kernel(words_ref, lens_ref, init_ref, out_ref, *, params, k, delta):
    cb = params.code_bits
    freq_max = params.freq_max
    wn = words_ref.shape[1]
    col = pl.ds(pl.program_id(0) * DECODE_TB, DECODE_TB)
    lanes = pl.program_id(0) * DECODE_TB + jnp.arange(DECODE_TB, dtype=i32)
    lens = lens_ref[col]

    def read(pos, n):
        """``n`` (<= 31) stream bits at bit ``pos`` of each lane, MSB first;
        reads past the stream's words are zero bits."""
        w = pos >> 5
        a = plgpu.load(words_ref.at[lanes, w], mask=w < wn, other=0)
        b = plgpu.load(words_ref.at[lanes, w + 1], mask=w + 1 < wn, other=0)
        x = (a.astype(u64) << 32) | b.astype(u64)
        x = x << (pos & 31).astype(u64)
        return ((x >> 32) >> (32 - n).astype(u64)).astype(i32)

    def step(t, carry):
        cdf, tot, low, high, z, pos = carry
        active = t < lens
        rng = high - low + 1
        # Symbol locate (codec.rs:131 with z = pending - low).
        value = _div64(
            (z + 1).astype(i64) * tot.astype(i64) - 1, rng.astype(i64)
        ).astype(i32)
        value = jnp.minimum(value, tot - 1)  # garbage-input guard
        le = cdf <= value[:, None]
        sym = jnp.sum(le.astype(i32), axis=1)
        flo = jnp.max(jnp.where(le, cdf, 0), axis=1)
        fhi = jnp.minimum(jnp.min(jnp.where(le, 2**31 - 1, cdf), axis=1), tot)
        dv = jnp.where(active & (tot < freq_max), delta, 0)
        cdf = cdf + jnp.where(le, 0, dv[:, None])

        # Narrow (codec.rs:58-60); z moves with low.
        dlo = _muldiv(rng, flo, tot)
        dhi = _muldiv(rng, fhi, tot)
        z = jnp.where(active, z - dlo, z)
        n1, n3, low, high = _renorm(
            jnp.where(active, low + dlo, low),
            jnp.where(active, low + dhi - 1, high),
            active,
            cb,
        )
        n = n1 + n3  # <= code_bits: the bits this symbol consumed
        z = jnp.where(active, ((z << n) | read(pos, n)) & params.code_max, z)
        out_ref[col, t] = jnp.where(active, sym, 0).astype(jnp.uint8)
        return cdf, tot + dv, low, high, z, pos + n

    cdf = jnp.broadcast_to(init_ref[0, :][None, :], (DECODE_TB, 256))
    tot = init_ref[1, pl.ds(0, DECODE_TB)]
    zeros = jnp.zeros((DECODE_TB,), i32)
    # Prime: z = the first code_bits bits (codec.rs:124-127).
    z = read(zeros, zeros + cb)
    carry = (cdf, tot, zeros, zeros + params.code_max, z, zeros + cb)
    lax.fori_loop(i32(0), i32(k), step, carry)


@functools.partial(jax.jit, static_argnames=("params", "k", "delta", "interpret"))
def decode_blocks(words, lens, init_cum, params: Parameters, k: int,
                  delta: int = 1, interpret: bool = False):
    """Drop-in for :func:`redux_tpu.ops.coder.decode_blocks` (v2 payloads).

    Args:
      words: ``(B, W)`` uint32 big-endian per-block streams, zero past each
        stream's end (the v2 termination contract).
      lens: ``(B,)`` int32 symbol counts (``<= k``).
      init_cum: ``(258,)`` initial cumulative row.
      k: symbols per block (static).
      interpret: run the kernel in the Pallas interpreter (CPU tests).

    Returns ``(B, k)`` uint8 decoded symbols (0 past ``lens``).
    """
    if not supports(params):
        raise ValueError(f"decode kernel does not support {params}")
    b = words.shape[0]
    b_pad = -(-b // DECODE_TB) * DECODE_TB
    words_p = jnp.pad(words.astype(u32), ((0, b_pad - b), (0, 0)))
    lens_p = jnp.pad(lens.astype(i32), (0, b_pad - b))
    ic = jnp.asarray(init_cum, i32)
    init = jnp.stack([ic[1:257], jnp.broadcast_to(ic[257], (256,))])
    out = pl.pallas_call(
        functools.partial(_decode_kernel, params=params, k=k, delta=delta),
        out_shape=jax.ShapeDtypeStruct((b_pad, k), jnp.uint8),
        grid=(b_pad // DECODE_TB,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=DECODE_WARPS, num_stages=1),
        interpret=interpret,
        name="redux_decode",
    )(words_p, lens_p, init)
    return out[:b]


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _encode_kernel(lo_ref, hi_ref, lens_ref, consts_ref, out_ref, blen_ref,
                   ovf_ref, *, params, k, delta):
    cb = params.code_bits
    n_words = out_ref.shape[0]
    col = pl.ds(pl.program_id(0) * TB, TB)
    lanes = pl.program_id(0) * TB + jnp.arange(TB, dtype=i32)
    lens = lens_ref[col]
    init_total = consts_ref[0]
    tfreeze = consts_ref[1]

    def flush(a0, a1, a2, accbits, nw):
        """Store a completed leading word at the lane's own offset."""
        full = accbits >= 32
        plgpu.store(out_ref.at[nw, lanes], a0.astype(u32),
                    mask=full & (nw < n_words))
        return (
            jnp.where(full, a1, a0),
            jnp.where(full, a2, a1),
            jnp.where(full, u32(0), a2),
            jnp.where(full, accbits - 32, accbits),
            nw + full.astype(i32),
        )

    def step(t, carry):
        low, high, pending, a0, a1, a2, accbits, nw, ovf = carry
        active = t < lens
        is_term = t == lens
        tk = jnp.minimum(t, k - 1)  # t == k only codes terminators
        flo = lo_ref[tk, col]
        fhi = hi_ref[tk, col]
        # tot_t = init_total + delta * min(t, lens, t_freeze) (ranks.py).
        count = jnp.maximum(
            init_total + delta * jnp.minimum(jnp.minimum(t, lens), tfreeze), 1
        )
        rng = high - low + 1
        low_n = jnp.where(active, low + _muldiv(rng, flo, count), low)
        high_n = jnp.where(active, low + _muldiv(rng, fhi, count) - 1, high)
        n1, n3, low2, high2 = _renorm(low_n, high_n, active, cb)

        # Data piece [b1][pending opposite][n1-1 prefix bits] (codec.rs:39-46),
        # or the 2-bit v2 terminator tq = ceil(low / quarter) at t == lens.
        emit = n1 > 0
        rest_len = jnp.maximum(n1 - 1, 0)
        prefix = jnp.where(emit, low_n >> (cb - n1), 0)
        b1 = prefix >> rest_len
        rest = prefix & ((1 << rest_len) - 1)
        tq = (low_n + (params.code_one_fourth - 1)) >> (cb - 2)
        b1 = jnp.where(is_term, tq >> 1, b1)
        rest = jnp.where(is_term, tq & 1, rest)
        rest_len = jnp.where(is_term, 1, rest_len)
        emit = emit | is_term

        m1 = jnp.where(emit, rest_len + 1 + pending, 0)
        ovf = ovf | (m1 > 64)
        m1 = jnp.minimum(m1, 64)
        phi, plo = _piece64(b1.astype(u32), pending, rest.astype(u32), rest_len)
        lhi, llo = _leftalign64(phi, plo, m1)
        n0, n1w, n2 = _append96(a0, a1, a2, accbits, lhi, llo)
        a0 = jnp.where(emit, n0, a0)
        a1 = jnp.where(emit, n1w, a1)
        a2 = jnp.where(emit, n2, a2)
        accbits = accbits + m1
        pending = jnp.where(emit, 0, pending) + n3
        a0, a1, a2, accbits, nw = flush(a0, a1, a2, accbits, nw)
        a0, a1, a2, accbits, nw = flush(a0, a1, a2, accbits, nw)
        return low2, high2, pending, a0, a1, a2, accbits, nw, ovf

    zeros = jnp.zeros((TB,), i32)
    uz = jnp.zeros((TB,), u32)
    carry = (zeros, zeros + params.code_max, zeros, uz, uz, uz, zeros, zeros,
             jnp.zeros((TB,), jnp.bool_))
    _, _, _, a0, _, _, accbits, nw, ovf = lax.fori_loop(
        i32(0), i32(k + 1), step, carry
    )
    # Tail: the remaining accbits (< 32) are left-aligned in a0; zero bits
    # past the terminator are the byte padding the decoder expects.
    plgpu.store(out_ref.at[nw, lanes], a0, mask=(accbits > 0) & (nw < n_words))
    blen_ref[col] = (nw * 32 + accbits + 7) >> 3
    ovf_ref[col] = ovf.astype(i32)


@functools.partial(
    jax.jit, static_argnames=("params", "n_words", "delta", "interpret")
)
def encode_blocks(lo, hi, lens, init_total, params: Parameters, n_words: int,
                  delta: int = 1, interpret: bool = False):
    """Drop-in for :func:`redux_tpu.ops.coder.encode_blocks_v2`.

    Args: ``(B, K)`` int32 model values ``lo``/``hi`` (rank precompute),
    ``(B,)`` lens and the initial model total ``init_cum[-1]``.  Returns
    ``(words (B, n_words) uint32, byte_lens (B,), ovf (B,))``; words past a
    lane's ``byte_lens`` are unspecified, and a stream longer than
    ``n_words`` words is cut there (its ``byte_lens`` still says its length).
    """
    if not supports(params):
        raise ValueError(f"encode kernel does not support {params}")
    b, k = lo.shape
    b_pad = -(-b // TB) * TB

    def lane_minor(x):
        return jnp.pad(x.astype(i32), ((0, b_pad - b), (0, 0))).T

    it0 = jnp.asarray(init_total, i32)
    # Updates stop once the running total reaches freq_max
    # (adaptive_linear.rs:34; the same formula as ranks.py).
    tfreeze = jnp.maximum((params.freq_max - it0 + (delta - 1)) // delta, 0)
    words_t, blen, ovf = pl.pallas_call(
        functools.partial(_encode_kernel, params=params, k=k, delta=delta),
        out_shape=(
            jax.ShapeDtypeStruct((n_words, b_pad), u32),
            jax.ShapeDtypeStruct((b_pad,), i32),
            jax.ShapeDtypeStruct((b_pad,), i32),
        ),
        grid=(b_pad // TB,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=ENCODE_WARPS, num_stages=1),
        interpret=interpret,
        name="redux_encode",
    )(lane_minor(lo), lane_minor(hi), jnp.pad(lens.astype(i32), (0, b_pad - b)),
      jnp.stack([it0, tfreeze.astype(i32)]))
    return words_t.T[:b], blen[:b], ovf[:b].astype(bool)
