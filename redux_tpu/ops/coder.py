"""Vectorized Witten–Neal–Cleary interval coder with closed-form renorm.

The reference coder (its ``src/codec.rs``) renormalizes one bit at a time:
E1/E2 emit/consume a bit while the interval sits in one half, E3 handles
the middle-straddle underflow (codec.rs:62-89,141-158).  A bit-serial loop
is the worst possible shape for a vector machine, so this module
re-derives the SAME state machine in closed form, processing each symbol's
entire renormalization with a handful of wide vector ops and **no per-bit
loops**:

* E1/E2 run length ``n1`` = number of common leading bits of ``low`` and
  ``high`` (tops equal ⇔ exactly the E1/E2 conditions) = ``clz(low ^ high)``
  in code_bits width.  The emitted bits are the top ``n1`` bits of ``low``,
  with the reference's pending-bit flush after the first emitted bit
  (codec.rs:39-46).
* E3 run length ``n3`` = min(leading 1s of ``low`` after its top 0,
  leading 0s of ``high`` after its top 1) — each E3 step removes the
  second bit of both bounds (codec.rs:75-82).  ``pending += n3``.
* Interval updates collapse to shift/mask forms:
  ``low ← ((low << n1) & mask) << n3  & (mask >> 1)`` (with the top bit
  pattern preserved), etc. — verified bit-exact against the per-bit oracle.
* The decoder tracks ``z = pending - low`` (the offset of the code value
  within the interval): every renorm step maps to ``z ← (z << 1) | bit``
  regardless of E1/E2/E3, so the decoder consumes ``n1 + n3`` bits per
  symbol in at most two chunked window reads.  The symbol-locate formula
  ``value = ((z + 1)·count - 1)/range`` is codec.rs:131 with
  ``z = pending - low``.

Batching: every op is shaped ``(B, ...)`` over independent blocks, so the
sequential ``lax.scan`` is over symbol positions only while the vector
lanes carry blocks.  Per-block output streams are bit-identical to the
reference/oracle (differential tests in tests/test_jax_codec.py).

Integer width policy (``Parameters.fits_u32``): uint32 when
``code_bits + freq_bits <= 32``, int64 otherwise
(products < 2**62 for code_bits <= 32, exact in XLA's emulated 64-bit).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from ..params import Parameters


def coder_dtype(params: Parameters):
    """Working dtype for interval arithmetic (uint32 fast path or int64)."""
    if params.code_bits > 32 or params.code_bits + params.freq_bits > 62:
        raise ValueError(
            "vectorized coder supports code_bits <= 32 and code+freq <= 62; "
            "use the sequential oracle for wider configs"
        )
    return jnp.uint32 if params.fits_u32 else jnp.int64


def max_block_words(max_count: int, n_symbols: int, params: Parameters, k: int) -> int:
    """Upper bound (in u32 words) on one block's compressed size.

    Every symbol's code length is at most ``ceil(log2(count/freq)) + 2``
    bits with ``freq >= 1`` and ``count <= max_count``; add the EOF symbol,
    the ``code_bits`` disambiguation drain (codec.rs:91-99) and byte
    padding.  Checked at runtime by the caller (overflow is detected, never
    silent).
    """
    bps = max(1, math.ceil(math.log2(max(2, max_count)))) + 2
    total_bits = (k + 1) * bps + params.code_bits + 8
    return total_bits // 32 + 2


def _clz(x, wdt):
    """Count leading zeros in the full dtype width (clz(0) = width)."""
    return jax.lax.clz(x).astype(jnp.int32)


def _word_bits(wdt) -> int:
    return 32 if wdt == jnp.uint32 else 64


@functools.partial(jax.jit, static_argnames=("params", "n_words"))
def encode_blocks(lo, hi, tot, eof_lo, eof_hi, eof_tot, lens, params: Parameters, n_words: int):
    """Encode ``B`` blocks in parallel from precomputed model triples.

    Args:
      lo, hi, tot: ``(B, K)`` int32 per-position model values
        (from :func:`~redux_tpu.ops.ranks.precompute_encode_model`).
      eof_lo, eof_hi, eof_tot: ``(B,)`` int32 EOF-symbol triples.
      lens: ``(B,)`` int32 symbol count per block (``<= K``).
      n_words: output buffer width per block, in u32 words.

    Returns:
      ``(words, byte_lens)``: ``(B, n_words)`` uint32 big-endian bit
      buffers and ``(B,)`` int32 compressed byte counts.  Each lane's
      first ``byte_lens[b]`` bytes are a complete reference-format stream
      for that block (EOF symbol + extra bits + zero padding,
      codec.rs:91-99).
    """
    B, K = lo.shape
    wdt = coder_dtype(params)
    W = _word_bits(wdt)
    cb = params.code_bits
    half = jnp.asarray(params.code_half, wdt)
    q1 = jnp.asarray(params.code_one_fourth, wdt)
    cmax = jnp.asarray(params.code_max, wdt)
    cmax_half = jnp.asarray(params.code_max >> 1, wdt)  # mask with top bit clear
    one = jnp.asarray(1, wdt)
    zero = jnp.asarray(0, wdt)
    rows = jnp.arange(B)

    def flush_full(buf, nword, acc, accbits):
        full = accbits == 32
        idx = jnp.minimum(nword, n_words - 1)
        cur = buf[rows, idx]
        buf = buf.at[rows, idx].set(jnp.where(full, acc.astype(jnp.uint32), cur))
        nword = nword + full.astype(jnp.int32)
        acc = jnp.where(full, zero, acc)
        accbits = jnp.where(full, 0, accbits)
        return buf, nword, acc, accbits

    def append_bits(state, value, nbits, mask):
        """Append ``nbits`` (<= 32) of ``value`` to masked lanes.

        Maintains ``acc < 2**accbits``, ``accbits < 32``; at most two
        word-boundary chunks, statically unrolled (no data-dependent loop).
        """
        buf, nword, acc, accbits = state
        n = jnp.where(mask, nbits, 0).astype(jnp.int32)
        value = jnp.where(mask, value, zero)
        for _ in range(2):  # one word boundary can be crossed at most once
            m = jnp.minimum(n, 32 - accbits)
            msh = m.astype(wdt)
            rem = (n - m).astype(wdt)
            chunk = jnp.where(m > 0, value >> rem, zero) & ((one << msh) - one)
            acc = jnp.where(m > 0, (acc << msh) | chunk, acc)
            accbits = accbits + m
            value = value & ((one << rem) - one)
            n = n - m
            buf, nword, acc, accbits = flush_full(buf, nword, acc, accbits)
        return (buf, nword, acc, accbits)

    def append_run(state, bit, n, mask):
        """Append ``n`` copies of ``bit`` (n unbounded, expected tiny)."""
        n = jnp.where(mask, n, 0).astype(jnp.int32)

        def cond(c):
            return jnp.any(c[1] > 0)

        def body(c):
            state, n = c
            # Chunk cap 31 keeps every shift amount < dtype width.
            m = jnp.minimum(n, 31)
            pat = jnp.where(bit > 0, (one << m.astype(wdt)) - one, zero)
            state = append_bits(state, pat, m, n > 0)
            return (state, n - m)

        state, _ = jax.lax.while_loop(cond, body, (state, n))
        return state

    def scan_step(carry, xs):
        t, lo_t, hi_t, tot_t = xs
        low, high, pending, extra, acc, accbits, nword, buf, bytelens, done = carry
        is_eof = (t == lens) & ~done
        active = (t <= lens) & ~done
        flo = jnp.where(is_eof, eof_lo, lo_t).astype(wdt)
        fhi = jnp.where(is_eof, eof_hi, hi_t).astype(wdt)
        count = jnp.where(is_eof, eof_tot, tot_t).astype(wdt)

        # Interval narrowing (codec.rs:58-60).
        rng = high - low + one
        nhigh = low + (rng * fhi) // count - one
        nlow = low + (rng * flo) // count
        low = jnp.where(active, nlow, low)
        high = jnp.where(active, nhigh, high)

        # Closed-form renorm counts.
        x = low ^ high
        n1 = jnp.where(active, _clz(x, wdt) - (W - cb), 0)
        # Shift out the n1 common bits (reference: per-iteration
        # (low<<1)&mask / ((high<<1)+1)&mask, codec.rs:87-88).
        n1w = n1.astype(wdt)
        low1 = jnp.where(active, (low << n1w) & cmax, low)
        high1 = jnp.where(active, ((high << n1w) | ((one << n1w) - one)) & cmax, high)
        # E3 count: leading 1s of low1 after its top 0 / leading 0s of high1
        # after its top 1 (only valid when tops differ, i.e. post-n1 state).
        shift_top = W - cb + 1
        low_sh = (low1 << shift_top).astype(wdt)
        high_sh = (high1 << shift_top).astype(wdt)
        a = _clz(~low_sh, wdt)
        b = _clz(high_sh, wdt)
        n3 = jnp.where(active, jnp.minimum(jnp.minimum(a, b), cb - 1), 0)
        n3w = n3.astype(wdt)
        low2 = jnp.where(active, (low1 << n3w) & cmax_half, low1)
        high2 = jnp.where(
            active, (((high1 << n3w) | ((one << n3w) - one)) & cmax_half) | half, high1
        )

        # Emission: [b1][pending opposite bits][remaining n1-1 prefix bits]
        # (put_bit semantics, codec.rs:39-46).
        emit = active & (n1 > 0)
        prefix = jnp.where(emit, low >> (jnp.asarray(cb, wdt) - n1.astype(wdt)), zero)
        b1 = prefix >> jnp.maximum(n1 - 1, 0).astype(wdt)
        rest = prefix & ((one << jnp.maximum(n1 - 1, 0).astype(wdt)) - one)
        state = (buf, nword, acc, accbits)
        state = append_bits(state, b1, jnp.ones_like(n1), emit)
        state = append_run(state, one - b1, pending, emit)
        state = append_bits(state, rest, n1 - 1, emit)
        pending = jnp.where(emit, 0, pending) + n3
        extra = extra - jnp.where(is_eof, n1 + n3, 0)

        # EOF epilogue: drain `extra` bits of low (codec.rs:91-99) with the
        # same emission pattern, then flush to a byte boundary.
        low = low2
        high = high2
        drain = is_eof & (extra > 0)
        ndr = jnp.where(drain, jnp.maximum(extra, 0), 0)
        dprefix = jnp.where(drain, low >> (jnp.asarray(cb, wdt) - ndr.astype(wdt)), zero)
        d1 = dprefix >> jnp.maximum(ndr - 1, 0).astype(wdt)
        drest = dprefix & ((one << jnp.maximum(ndr - 1, 0).astype(wdt)) - one)
        state = append_bits(state, d1, jnp.ones_like(ndr), drain)
        state = append_run(state, one - d1, pending, drain)
        state = append_bits(state, drest, ndr - 1, drain)
        pending = jnp.where(drain, 0, pending)
        buf, nword, acc, accbits = state

        # flush_bits: zero-pad to a byte (bitio/mod.rs:183-198) and
        # left-justify the tail word for big-endian byte extraction.
        padn = ((8 - (accbits % 8)) % 8).astype(jnp.int32)
        acc = jnp.where(is_eof, acc << padn.astype(wdt), acc)
        accbits = jnp.where(is_eof, accbits + padn, accbits)
        new_bytelen = (nword * 32 + accbits) // 8
        wmask = is_eof & (accbits > 0)
        idx = jnp.minimum(nword, n_words - 1)
        tail = (acc << (32 - accbits).astype(wdt)).astype(jnp.uint32)
        cur = buf[rows, idx]
        buf = buf.at[rows, idx].set(jnp.where(wmask, tail, cur))
        bytelens = jnp.where(is_eof, new_bytelen, bytelens)
        acc = jnp.where(is_eof, zero, acc)
        accbits = jnp.where(is_eof, 0, accbits)
        done = done | is_eof

        return (low, high, pending, extra, acc, accbits, nword, buf, bytelens, done), None

    init = (
        jnp.full((B,), params.code_min, wdt),  # low  (codec.rs:30)
        jnp.full((B,), params.code_max, wdt),  # high (codec.rs:31)
        jnp.zeros((B,), jnp.int32),  # pending
        jnp.full((B,), cb, jnp.int32),  # extra (codec.rs:33)
        jnp.zeros((B,), wdt),  # acc
        jnp.zeros((B,), jnp.int32),  # accbits
        jnp.zeros((B,), jnp.int32),  # nword
        jnp.zeros((B, n_words), jnp.uint32),  # buf
        jnp.zeros((B,), jnp.int32),  # bytelens
        jnp.zeros((B,), bool),  # done
    )
    ts = jnp.arange(K + 1, dtype=jnp.int32)
    # Transposed (K+1, B) scan inputs: each step reads one contiguous row
    # instead of dynamic-slicing a column out of a (B, K) array (a full
    # tile-row gather per step — the dominant cost of the naive scan).
    pad = jnp.zeros((1, B), lo.dtype)
    xs = (
        ts,
        jnp.concatenate([lo.T, pad], axis=0),
        jnp.concatenate([hi.T, pad], axis=0),
        # tot pads with ones: at t == K lanes already done still compute
        # (rng*fhi)//count, and a zero count would be an (untrapped but
        # implementation-defined) integer division by zero in XLA.
        jnp.concatenate([tot.T, pad + 1], axis=0),
    )
    carry, _ = jax.lax.scan(scan_step, init, xs)
    buf, bytelens = carry[7], carry[8]
    return buf, bytelens


@functools.partial(jax.jit, static_argnames=("params", "k", "delta"))
def decode_blocks(words, lens, init_cum, params: Parameters, k: int, delta: int = 1):
    """Decode ``B`` blocks in parallel; each lane runs the reference decoder.

    Args:
      words: ``(B, W)`` uint32 big-endian per-block bitstreams.
      lens: ``(B,)`` int32 symbol counts (stored-length termination: the
        trailing EOF symbol in each stream is never decoded).
      init_cum: ``(symbol_count + 1,)`` int32 initial cumulative row
        (uniform or warm-start prior — must match the encoder's).
      k: max symbols per block (static).

    Returns:
      ``(B, k)`` int32 decoded symbols (entries past ``lens`` are 0).

    The bitstream is consumed through a per-lane two-word register window
    (``cur``/``nxt``) refilled by at most one masked gather per read, so
    the hot loop is pure vector arithmetic — no per-bit I/O (the
    reference's get_bit-per-renorm-iteration, codec.rs:147-157, is
    replaced by chunked window reads of the same bits).
    """
    B, Wn = words.shape
    S = params.symbol_count
    wdt = coder_dtype(params)
    W = _word_bits(wdt)
    cb = params.code_bits
    half = jnp.asarray(params.code_half, wdt)
    cmax = jnp.asarray(params.code_max, wdt)
    cmax_half = jnp.asarray(params.code_max >> 1, wdt)
    one = jnp.asarray(1, wdt)
    freq_max = params.freq_max
    # The last adaptation step may overshoot the freeze threshold: totals
    # (and hence cdf[256]) land anywhere in [freq_max, freq_max+delta-1]
    # (the +delta generalization of adaptive_linear.rs:34).  The int16
    # packing and the above-every-entry sentinel must both account for it.
    cdt = jnp.int16 if freq_max + delta <= 32767 else jnp.int32
    sentinel = jnp.asarray(freq_max + delta, cdt)  # > any cumulative entry
    freeze_at = jnp.asarray(freq_max, cdt)
    rows = jnp.arange(B)

    def read_bits(win, m):
        """Read ``m`` (<= 31) bits from the register window; 1 masked gather."""
        cur, avail, nxt, wordidx = win
        take1 = jnp.minimum(m, avail)
        t1s = (32 - take1).astype(jnp.uint32)
        v1 = jnp.where(take1 > 0, cur >> t1s, jnp.uint32(0))
        cur = jnp.where(take1 > 0, cur << take1.astype(jnp.uint32), cur)
        avail = avail - take1
        m2 = m - take1
        need2 = m2 > 0
        m2c = jnp.maximum(m2, 1).astype(jnp.uint32)
        v2 = jnp.where(need2, nxt >> (32 - m2c), jnp.uint32(0))
        cur = jnp.where(need2, nxt << m2c, cur)
        avail = jnp.where(need2, 32 - m2, avail)
        # Refill nxt (one gather, masked by need2).
        idx = jnp.minimum(wordidx, Wn - 1)
        loaded = words[rows, idx]
        nxt = jnp.where(need2, loaded, nxt)
        wordidx = wordidx + need2.astype(jnp.int32)
        val = ((v1 << m2c) | v2).astype(wdt)
        val = jnp.where(need2, val, v1.astype(wdt))
        return val, (cur, avail, nxt, wordidx)

    win0 = (
        words[:, 0],
        jnp.full((B,), 32, jnp.int32),
        words[:, 1] if Wn > 1 else jnp.zeros((B,), jnp.uint32),
        jnp.full((B,), 2, jnp.int32),
    )
    # Prime: z = first code_bits bits (z = pending - low with low = 0,
    # codec.rs:124-127).
    n_reads = 1 if cb <= 31 else 2
    z0 = jnp.zeros((B,), wdt)
    prime = jnp.full((B,), cb, jnp.int32)
    win = win0
    for _ in range(2):
        m = jnp.minimum(prime, 31)
        val, win = read_bits(win, m)
        z0 = (z0 << m.astype(wdt)) | val
        prime = prime - m

    def scan_step(carry, t):
        low, high, z, cdf, win = carry
        active = t < lens

        rng = high - low + one
        count = cdf[:, S].astype(wdt)
        value = ((z + one) * count - one) // rng  # codec.rs:131 with z=pending-low
        value = jnp.minimum(value, count - one)  # garbage-input guard
        vq = value.astype(cdt)
        # One fused pass over the cumulative row: the comparison mask gives
        # the symbol (popcount), both bounds (masked max/min — the row is
        # strictly increasing), and the adaptation mask (+1 above the
        # symbol unless frozen, adaptive_linear.rs:33-39).
        b = cdf <= vq[:, None]
        sym = jnp.sum(b, axis=1, dtype=jnp.int32) - 1
        sym = jnp.clip(sym, 0, S - 1)
        flo = jnp.max(jnp.where(b, cdf, 0), axis=1).astype(wdt)
        fhi = jnp.min(jnp.where(b, sentinel, cdf), axis=1).astype(wdt)
        upd = active & (cdf[:, S] < freeze_at)
        cdf = cdf + jnp.where(b | ~upd[:, None], 0, delta).astype(cdt)

        # Narrow; z moves with low (z' = pending - low').
        dlo = (rng * flo) // count
        nhigh = low + (rng * fhi) // count - one
        nlow = low + dlo
        z = jnp.where(active, z - dlo, z)
        low = jnp.where(active, nlow, low)
        high = jnp.where(active, nhigh, high)

        # Closed-form renorm counts (identical to the encoder's).
        x = low ^ high
        n1 = jnp.where(active, _clz(x, wdt) - (W - cb), 0)
        n1w = n1.astype(wdt)
        low1 = jnp.where(active, (low << n1w) & cmax, low)
        high1 = jnp.where(active, ((high << n1w) | ((one << n1w) - one)) & cmax, high)
        shift_top = W - cb + 1
        a = _clz(~((low1 << shift_top).astype(wdt)), wdt)
        b = _clz((high1 << shift_top).astype(wdt), wdt)
        n3 = jnp.where(active, jnp.minimum(jnp.minimum(a, b), cb - 1), 0)
        n3w = n3.astype(wdt)
        low = jnp.where(active, (low1 << n3w) & cmax_half, low1)
        high = jnp.where(
            active, (((high1 << n3w) | ((one << n3w) - one)) & cmax_half) | half, high1
        )

        # Consume n1 + n3 bits (n <= code_bits <= 32): z <- (z << n) | bits.
        n = n1 + n3
        for _ in range(n_reads):
            m = jnp.minimum(n, 31)
            val, win = read_bits(win, m)
            mw = m.astype(wdt)
            z = jnp.where(m > 0, (z << mw) | val, z)
            n = n - m

        out = jnp.where(active, sym, 0)
        if params.symbol_bits <= 8:  # uint8 minimizes the fetch transfer
            out = out.astype(jnp.uint8)
        return (low, high, z, cdf, win), out

    init = (
        jnp.full((B,), params.code_min, wdt),
        jnp.full((B,), params.code_max, wdt),
        z0,
        jnp.broadcast_to(init_cum.astype(cdt), (B, S + 1)),
        win,
    )
    ts = jnp.arange(k, dtype=jnp.int32)
    _, syms = jax.lax.scan(scan_step, init, ts)
    return syms.T  # (B, k)


# ---------------------------------------------------------------------------
# Fast planned encoder (uint32 configs): scatter-free, scan-light.
#
# The straightforward encoder above appends bits into a (B, n_words) buffer
# from inside the symbol scan — a dozen scatters of a multi-MB array per
# step, far from device-memory speed.  The
# planned encoder removes every scatter from the hot loop:
#
#   1. *Plan scan*: carries only (B,)-shaped coder state plus a 96-bit
#      left-aligned bit accumulator per lane.  Each step builds the step's
#      emitted bits as ONE <=64-bit "piece" [b1][pending opposite bits][rest]
#      (the closed-form renorm emission, codec.rs:39-46/62-89), ORs it into
#      the accumulator, and flushes at most two completed u32 words as scan
#      outputs (dense writes — no indexed stores).
#   2. *EOF drain* (codec.rs:91-99) is one piece per lane, appended after
#      the scan with pure (B,) vector math.
#   3. *Compaction*: a lane's stream is the sequence of its valid flushed
#      words.  An int16 cumulative count + a vectorized binary search
#      (13 take_along_axis gathers) maps every output word slot to its
#      producing step — gathers only, instead of the scatter XLA
#      serializes.
#
# Lanes whose E3 `pending` run would not fit the 64-bit piece (probability
# ~2^-47 per symbol) are flagged in `ovf` and must be re-encoded with the
# reference-shaped encoder above; the output stream format is bit-identical
# between the two paths.
# ---------------------------------------------------------------------------

_U32 = jnp.uint32
# Plain Python int (not a jnp scalar): these helpers are reused inside
# Pallas kernels, where captured device-array constants are rejected.
_MASK5 = 31


def _u(x):
    return x.astype(_U32) if hasattr(x, "astype") else jnp.uint32(x)


def _ones64(n):
    """(hi, lo) = 2**n - 1 for n in [0, 63] (clamped)."""
    n = jnp.clip(n, 0, 63).astype(_U32)
    hi = jnp.where(n > 32, (_u(1) << ((n - 32) & _MASK5)) - 1, _u(0))
    lo = jnp.where(n >= 32, _u(0xFFFFFFFF), (_u(1) << (n & _MASK5)) - 1)
    return hi, lo


def _leftalign64(hi, lo, m):
    """Shift an m-bit value (right-aligned in 64) to the top; 0 if m == 0."""
    s = jnp.clip(64 - m, 0, 63).astype(_U32)
    sl = s & _MASK5
    ge32 = s >= 32
    nh_lt = (hi << sl) | jnp.where(sl == 0, _u(0), lo >> ((32 - sl) & _MASK5))
    nh = jnp.where(ge32, lo << sl, nh_lt)
    nl = jnp.where(ge32, _u(0), lo << sl)
    valid = m > 0
    return jnp.where(valid, nh, 0), jnp.where(valid, nl, 0)


def _piece64(lead, run_len, rest, rest_len):
    """[lead][run_len x ~lead][rest(rest_len bits)] right-aligned in 64.

    The per-step emission pattern of the coder: first resolved bit, the
    E3 pending flush of opposite bits (codec.rs:39-46), then the remaining
    resolved prefix bits.  rest_len must be < 32; run_len is clamped to 63
    (callers flag overflow separately).
    """
    opp_hi, opp_lo = _ones64(run_len)
    opp_hi = jnp.where(lead == 0, opp_hi, 0)
    opp_lo = jnp.where(lead == 0, opp_lo, 0)
    sh = jnp.clip(rest_len, 0, 31).astype(_U32)
    oh = (opp_hi << sh) | jnp.where(sh == 0, _u(0), opp_lo >> ((32 - sh) & _MASK5))
    ol = opp_lo << sh
    pos = jnp.clip(run_len + rest_len, 0, 63).astype(_U32)
    lh = jnp.where(pos >= 32, lead << ((pos - 32) & _MASK5), _u(0))
    ll = jnp.where(pos < 32, lead << (pos & _MASK5), _u(0))
    return oh | lh, ol | ll | rest


def _append96(a0, a1, a2, accbits, lhi, llo):
    """OR a left-aligned 64-bit piece into a 96-bit left-aligned window."""
    o = accbits.astype(_U32) & _MASK5
    p0 = lhi >> o
    p1 = jnp.where(o == 0, llo, (lhi << ((32 - o) & _MASK5)) | (llo >> o))
    p2 = jnp.where(o == 0, _u(0), llo << ((32 - o) & _MASK5))
    return a0 | p0, a1 | p1, a2 | p2


def compact_flushed_words(ws0, ws1, nv, n_words):
    """Gather-free monotone shift compaction of per-step flushed words.

    Each scan step flushes 0..2 words (``nv`` in {0,1,2}); lane-wise, the
    valid words (read in step order) are already in output-slot order, so
    compaction is a monotone move-up: element at row ``p`` must land at
    slot ``s`` with displacement ``delta = p - s`` NON-DECREASING along
    rows.  Such a compaction is exactly log2(P) masked static shifts
    (LSB-first binary decomposition of delta): at phase j every element
    whose delta has bit j moves up by 2^j.  Collision-freedom: two valid
    elements colliding at phase j would need floor(delta_a/2^{j+1}) >
    floor(delta_b/2^{j+1}) with delta_a <= delta_b — impossible.  This
    replaces per-slot binary-search gathers with dense shift/select
    passes at device-memory speed.

    Args:
      ws0, ws1: ``(T, B)`` uint32 words flushed per step (first, second).
      nv: ``(T, B)`` int8 number of valid words per step (0..2).
      n_words: output rows to keep.

    Returns:
      ``(scan_word, nw)``: ``(n_words, B)`` compacted words (rows past a
      lane's count are garbage — callers overwrite them with tail words)
      and ``(B,)`` int32 per-lane word counts.
    """
    T, B = nv.shape
    c = jnp.cumsum(nv.astype(jnp.int32), axis=0)  # (T, B) inclusive counts
    nw = c[-1]  # scan-flushed words per lane
    P = 2 * T

    val = jnp.stack([ws0, ws1], axis=1).reshape(P, B)
    v0 = nv >= 1
    v1 = nv >= 2
    base = c - nv.astype(jnp.int32)  # first slot of this step
    pos = 2 * jnp.arange(T, dtype=jnp.int32)[:, None]
    # Both row displacements coincide: (pos+1) - (base+1) == pos - base.
    # delta reaches ~2K, so it must stay int32 (int16 overflows at the
    # production K=65536 and silently corrupts the compaction).
    disp = pos - base
    delta = jnp.stack([disp, disp], axis=1).reshape(P, B)
    valid = jnp.stack([v0, v1], axis=1).reshape(P, B)
    delta = jnp.where(valid, delta, 0)

    def shift_up(a, n):
        # a[r] <- a[r+n], zero-fill at the tail (slice + pad; no wraparound).
        pad = jnp.zeros((n,) + a.shape[1:], a.dtype)
        return jnp.concatenate([a[n:], pad], axis=0)

    for j in range(max(1, math.ceil(math.log2(P)))):
        sh = 1 << j
        move = valid & (((delta >> j) & 1) == 1)
        m_in = shift_up(move, sh)
        val = jnp.where(m_in, shift_up(val, sh), val)
        delta = jnp.where(m_in, shift_up(delta, sh), delta)
        valid = m_in | (valid & ~move)

    if P < n_words:
        # Tiny blocks (2 words/step * steps < n_words): pad rows so the
        # caller's (n_words, B) tail merge broadcasts (only the first nw
        # rows are meaningful either way).
        val = jnp.concatenate(
            [val, jnp.zeros((n_words - P, B), val.dtype)], axis=0
        )
    return val[:n_words], nw


@functools.partial(jax.jit, static_argnames=("params", "n_words"))
def encode_blocks_fast(
    lo, hi, tot, eof_lo, eof_hi, eof_tot, lens, params: Parameters, n_words: int
):
    """Planned encoder: same contract as :func:`encode_blocks` plus ``ovf``.

    Returns ``(words, byte_lens, ovf)``; lanes with ``ovf`` set hit the
    pathological-pending bound and must be re-encoded with
    :func:`encode_blocks` (identical stream format).  Requires a uint32
    configuration (``params.fits_u32``).
    """
    if not params.fits_u32:
        raise ValueError("encode_blocks_fast requires code_bits + freq_bits <= 32")
    B, K = lo.shape
    cb = params.code_bits
    cmax = _u(params.code_max)
    cmax_half = _u(params.code_max >> 1)
    half = _u(params.code_half)
    one = _u(1)

    def scan_step(carry, xs):
        t, lo_t, hi_t, tot_t = xs
        (low, high, pending, extra, a0, a1, a2, accbits, done, ovf) = carry
        is_eof = (t == lens) & ~done
        active = (t <= lens) & ~done
        flo = _u(jnp.where(is_eof, eof_lo, lo_t))
        fhi = _u(jnp.where(is_eof, eof_hi, hi_t))
        count = _u(jnp.where(is_eof, eof_tot, tot_t))

        # Interval narrowing (codec.rs:58-60).
        rng = high - low + one
        nhigh = low + (rng * fhi) // count - one
        nlow = low + (rng * flo) // count
        low = jnp.where(active, nlow, low)
        high = jnp.where(active, nhigh, high)

        # Closed-form renorm counts (see module docstring).
        n1 = jnp.where(active, _clz(low ^ high, _U32) - (32 - cb), 0)
        n1w = _u(n1)
        low1 = jnp.where(active, (low << n1w) & cmax, low)
        high1 = jnp.where(active, ((high << n1w) | ((one << n1w) - one)) & cmax, high)
        shift_top = 32 - cb + 1
        a = _clz(~(low1 << shift_top), _U32)
        b = _clz(high1 << shift_top, _U32)
        n3 = jnp.where(active, jnp.minimum(jnp.minimum(a, b), cb - 1), 0)
        n3w = _u(n3)
        low2 = jnp.where(active, (low1 << n3w) & cmax_half, low1)
        high2 = jnp.where(
            active, (((high1 << n3w) | ((one << n3w) - one)) & cmax_half) | half, high1
        )

        # This step's piece: [b1][pending opposite][n1-1 prefix bits].
        emit = active & (n1 > 0)
        prefix = jnp.where(emit, low >> _u(cb - n1), _u(0))
        b1 = prefix >> _u(jnp.maximum(n1 - 1, 0))
        rest = prefix & ((one << _u(jnp.maximum(n1 - 1, 0))) - one)
        m1 = jnp.where(emit, n1 + pending, 0)
        ovf = ovf | (m1 > 64)
        m1 = jnp.minimum(m1, 64)
        phi, plo = _piece64(b1, pending, rest, jnp.maximum(n1 - 1, 0))
        lhi, llo = _leftalign64(phi, plo, m1)
        a0n, a1n, a2n = _append96(a0, a1, a2, accbits, lhi, llo)
        a0 = jnp.where(emit, a0n, a0)
        a1 = jnp.where(emit, a1n, a1)
        a2 = jnp.where(emit, a2n, a2)
        accbits = accbits + m1
        pending = jnp.where(emit, 0, pending) + n3
        extra = extra - jnp.where(is_eof, n1 + n3, 0)

        # Flush up to two completed words (dense scan outputs, no scatter).
        f1 = accbits >= 32
        w0 = jnp.where(f1, a0, 0)
        a0 = jnp.where(f1, a1, a0)
        a1 = jnp.where(f1, a2, a1)
        a2 = jnp.where(f1, _u(0), a2)
        accbits = jnp.where(f1, accbits - 32, accbits)
        f2 = accbits >= 32
        w1 = jnp.where(f2, a0, 0)
        a0 = jnp.where(f2, a1, a0)
        a1 = jnp.where(f2, a2, a1)
        a2 = jnp.where(f2, _u(0), a2)
        accbits = jnp.where(f2, accbits - 32, accbits)
        nv = f1.astype(jnp.int8) + f2.astype(jnp.int8)

        low = low2
        high = high2
        done = done | is_eof
        carry = (low, high, pending, extra, a0, a1, a2, accbits, done, ovf)
        return carry, (w0, w1, nv)

    init = (
        jnp.full((B,), params.code_min, _U32),  # low  (codec.rs:30)
        jnp.full((B,), params.code_max, _U32),  # high (codec.rs:31)
        jnp.zeros((B,), jnp.int32),  # pending
        jnp.full((B,), cb, jnp.int32),  # extra (codec.rs:33)
        jnp.zeros((B,), _U32),  # a0..a2: 96-bit left-aligned window
        jnp.zeros((B,), _U32),
        jnp.zeros((B,), _U32),
        jnp.zeros((B,), jnp.int32),  # accbits
        jnp.zeros((B,), bool),  # done
        jnp.zeros((B,), bool),  # ovf
    )
    ts = jnp.arange(K + 1, dtype=jnp.int32)
    # Transposed (K+1, B) scan inputs — contiguous row reads per step (see
    # encode_blocks).
    pad = jnp.zeros((1, B), lo.dtype)
    xs = (
        ts,
        jnp.concatenate([lo.T, pad], axis=0),
        jnp.concatenate([hi.T, pad], axis=0),
        # Ones pad: avoid implementation-defined div-by-zero at t == K
        # for lanes already done (see encode_blocks).
        jnp.concatenate([tot.T, pad + 1], axis=0),
    )
    carry, (ws0, ws1, nv) = jax.lax.scan(scan_step, init, xs)
    low, _, pending, extra, a0, a1, a2, accbits, _, ovf = carry

    # EOF drain (codec.rs:91-99): one piece per lane, appended post-scan.
    drain = extra > 0
    ndr = jnp.where(drain, extra, 0)
    dprefix = jnp.where(drain, low >> _u(jnp.clip(cb - ndr, 0, 31)), _u(0))
    d1 = dprefix >> _u(jnp.maximum(ndr - 1, 0))
    drest = dprefix & ((one << _u(jnp.maximum(ndr - 1, 0))) - one)
    m2 = jnp.where(drain, ndr + pending, 0)
    ovf = ovf | (m2 > 64)
    m2 = jnp.minimum(m2, 64)
    phi, plo = _piece64(d1, jnp.where(drain, pending, 0), drest, jnp.maximum(ndr - 1, 0))
    lhi, llo = _leftalign64(phi, plo, m2)
    t0, t1, t2 = _append96(a0, a1, a2, accbits, lhi, llo)
    t0 = jnp.where(drain, t0, a0)
    t1 = jnp.where(drain, t1, a1)
    t2 = jnp.where(drain, t2, a2)
    tail_bits = accbits + m2

    scan_word, nw = compact_flushed_words(ws0, ws1, nv, n_words)

    # Tail words (<=3) follow the scan-flushed words; bits past the drain
    # are zero by construction, which is exactly flush_bits' zero padding
    # (bitio/mod.rs:183-198).
    wi = jnp.arange(n_words, dtype=jnp.int32)[:, None]
    dt = wi - nw[None, :]
    word = jnp.where(
        dt < 0,
        scan_word,
        jnp.where(dt == 0, t0[None, :], jnp.where(dt == 1, t1[None, :], jnp.where(dt == 2, t2[None, :], 0))),
    )
    byte_lens = (nw * 32 + tail_bits + 7) // 8
    return word.T, byte_lens.astype(jnp.int32), ovf


# ---------------------------------------------------------------------------
# v2 block-format encoder: no EOF symbol, minimal 2-bit terminator.
#
# The RXT2 container stores per-block symbol counts, so the per-block EOF
# symbol + code_bits drain of the reference format (codec.rs:91-99) are
# dead weight (~3-5 bytes/block).  Instead, after the last symbol's
# renormalization the invariants  high - low + 1 > quarter  and
# low < half <= high  guarantee tq = ceil(low/quarter) is in {0,1,2} and
# the code value V = tq*quarter (2 bits, zero tail) lies in [low, high] —
# so 2 emitted bits (+ any pending underflow bits) terminate the stream,
# and the decoder's zero-padded reads reconstruct V exactly.
# (Oracle: redux_tpu.oracle.compress_block / decompress_block.)
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("params", "n_words"))
def encode_blocks_v2(lo, hi, tot, lens, params: Parameters, n_words: int):
    """Planned v2 encoder: returns ``(words, byte_lens, ovf)``.

    Same scatter-free plan/compaction architecture as
    :func:`encode_blocks_fast`, with the v2 terminator instead of the EOF
    symbol, and interval arithmetic widened to int64 when the config
    exceeds uint32 products (``params.fits_u32`` false) — the bit-plan
    accumulator stays in uint32 triples either way.
    """
    B, K = lo.shape
    wdt = coder_dtype(params)
    cb = params.code_bits
    cmax = jnp.asarray(params.code_max, wdt)
    cmax_half = jnp.asarray(params.code_max >> 1, wdt)
    half = jnp.asarray(params.code_half, wdt)
    one = jnp.asarray(1, wdt)
    W = _word_bits(wdt)

    def to_u32(x):
        return x.astype(_U32)

    def scan_step(carry, xs):
        t, lo_t, hi_t, tot_t = xs
        (low, high, pending, a0, a1, a2, accbits, done, ovf) = carry
        is_term = (t == lens) & ~done
        active = (t < lens) & ~done

        flo = lo_t.astype(wdt)
        fhi = hi_t.astype(wdt)
        count = jnp.maximum(tot_t, 1).astype(wdt)

        # Interval narrowing (codec.rs:58-60).
        rng = high - low + one
        nhigh = low + (rng * fhi) // count - one
        nlow = low + (rng * flo) // count
        low = jnp.where(active, nlow, low)
        high = jnp.where(active, nhigh, high)

        # Closed-form renorm counts (see module docstring).
        n1 = jnp.where(active, _clz(low ^ high, wdt) - (W - cb), 0)
        n1w = n1.astype(wdt)
        low1 = jnp.where(active, (low << n1w) & cmax, low)
        high1 = jnp.where(active, ((high << n1w) | ((one << n1w) - one)) & cmax, high)
        shift_top = W - cb + 1
        a = _clz(~((low1 << shift_top).astype(wdt)), wdt)
        b = _clz((high1 << shift_top).astype(wdt), wdt)
        n3 = jnp.where(active, jnp.minimum(jnp.minimum(a, b), cb - 1), 0)
        n3w = n3.astype(wdt)
        low2 = jnp.where(active, (low1 << n3w) & cmax_half, low1)
        high2 = jnp.where(
            active, (((high1 << n3w) | ((one << n3w) - one)) & cmax_half) | half, high1
        )

        # Data-symbol piece: [b1][pending opposite][n1-1 prefix bits].
        emit = active & (n1 > 0)
        prefix = jnp.where(emit, low >> (jnp.asarray(cb, wdt) - n1w), jnp.asarray(0, wdt))
        b1 = to_u32(prefix >> jnp.maximum(n1 - 1, 0).astype(wdt))
        rest = to_u32(prefix & ((one << jnp.maximum(n1 - 1, 0).astype(wdt)) - one))
        rest_len = jnp.maximum(n1 - 1, 0)

        # Terminator piece: [b1][pending opposite][b2] with
        # tq = ceil(low / quarter) in {0,1,2} (low < half).
        q = jnp.asarray(params.code_one_fourth, wdt)
        tq = to_u32((low + q - one) >> jnp.asarray(cb - 2, wdt))
        b1 = jnp.where(is_term, tq >> 1, b1)
        rest = jnp.where(is_term, tq & 1, rest)
        rest_len = jnp.where(is_term, 1, rest_len)
        emit = emit | is_term

        m1 = jnp.where(emit, rest_len + 1 + pending, 0)
        ovf = ovf | (m1 > 64)
        m1 = jnp.minimum(m1, 64)
        phi, plo = _piece64(b1, pending, rest, rest_len)
        lhi, llo = _leftalign64(phi, plo, m1)
        a0n, a1n, a2n = _append96(a0, a1, a2, accbits, lhi, llo)
        a0 = jnp.where(emit, a0n, a0)
        a1 = jnp.where(emit, a1n, a1)
        a2 = jnp.where(emit, a2n, a2)
        accbits = accbits + m1
        pending = jnp.where(emit, 0, pending) + n3

        # Flush up to two completed words (dense scan outputs, no scatter).
        f1 = accbits >= 32
        w0 = jnp.where(f1, a0, 0)
        a0 = jnp.where(f1, a1, a0)
        a1 = jnp.where(f1, a2, a1)
        a2 = jnp.where(f1, _u(0), a2)
        accbits = jnp.where(f1, accbits - 32, accbits)
        f2 = accbits >= 32
        w1 = jnp.where(f2, a0, 0)
        a0 = jnp.where(f2, a1, a0)
        a1 = jnp.where(f2, a2, a1)
        a2 = jnp.where(f2, _u(0), a2)
        accbits = jnp.where(f2, accbits - 32, accbits)
        nv = f1.astype(jnp.int8) + f2.astype(jnp.int8)

        low = low2
        high = high2
        done = done | is_term
        carry = (low, high, pending, a0, a1, a2, accbits, done, ovf)
        return carry, (w0, w1, nv)

    init = (
        jnp.full((B,), params.code_min, wdt),  # low  (codec.rs:30)
        jnp.full((B,), params.code_max, wdt),  # high (codec.rs:31)
        jnp.zeros((B,), jnp.int32),  # pending
        jnp.zeros((B,), _U32),  # a0..a2: 96-bit left-aligned window
        jnp.zeros((B,), _U32),
        jnp.zeros((B,), _U32),
        jnp.zeros((B,), jnp.int32),  # accbits
        jnp.zeros((B,), bool),  # done
        jnp.zeros((B,), bool),  # ovf
    )
    ts = jnp.arange(K + 1, dtype=jnp.int32)
    pad = jnp.zeros((1, B), lo.dtype)
    xs = (
        ts,
        jnp.concatenate([lo.T, pad], axis=0),
        jnp.concatenate([hi.T, pad], axis=0),
        jnp.concatenate([tot.T, pad + 1], axis=0),  # ones: no div-by-zero
    )
    carry, (ws0, ws1, nv) = jax.lax.scan(scan_step, init, xs)
    _, _, _, t0, t1, t2, accbits, _, ovf = carry

    scan_word, nw = compact_flushed_words(ws0, ws1, nv, n_words)

    # Tail words (<= 3) follow the scan-flushed words; zero bits past the
    # terminator are exactly the byte padding the decoder expects.
    wi = jnp.arange(n_words, dtype=jnp.int32)[:, None]
    dt = wi - nw[None, :]
    word = jnp.where(
        dt < 0,
        scan_word,
        jnp.where(dt == 0, t0[None, :], jnp.where(dt == 1, t1[None, :], jnp.where(dt == 2, t2[None, :], 0))),
    )
    byte_lens = (nw * 32 + accbits + 7) // 8
    return word.T, byte_lens.astype(jnp.int32), ovf


@jax.jit
def words_to_bytes_device(words):
    """(B, W) uint32 → (B, 4W) uint8, big-endian byte order.

    Compressed words are converted to bytes on-device, so the host
    fetches them as the byte stream it splices.
    """
    b = words.shape[0]
    parts = [
        (words >> 24).astype(jnp.uint8),
        (words >> 16).astype(jnp.uint8),
        (words >> 8).astype(jnp.uint8),
        words.astype(jnp.uint8),
    ]
    return jnp.stack(parts, axis=-1).reshape(b, -1)


@jax.jit
def bytes_to_words_device(byts):
    """(B, 4W) uint8 → (B, W) uint32, big-endian byte order."""
    b = byts.shape[0]
    r = byts.reshape(b, -1, 4).astype(jnp.uint32)
    return (r[..., 0] << 24) | (r[..., 1] << 16) | (r[..., 2] << 8) | r[..., 3]


# Backwards-compatible alias used by high-level code.
CoderConfig = Parameters
