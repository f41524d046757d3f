"""Parallel precompute of per-symbol model values for the encoder.

The reference encoder interleaves model reads with model updates, forcing a
strict symbol-serial order (codec.rs:56-57 → adaptive_tree.rs:83-92).  But
the adaptation rule is always "+1 to every cumulative entry above the
symbol, while not frozen" (adaptive_linear.rs:33-39), so the cumulative
frequency table at time ``t`` has a closed form:

    cum_t[i] = init_cum[i] + #{ s < min(t, t_freeze) : sym_s < i }

with ``t_freeze = freq_max - init_total`` (the adaptation freeze,
adaptive_linear.rs:34 / adaptive_tree.rs:84).  Therefore the values the
coder needs at step ``t`` —

    low_t  = cum_t[v_t]     = init_cum[v_t]     + c_t
    high_t = cum_t[v_t + 1] = init_cum[v_t + 1] + c_t + d_t
    tot_t  = init_total + min(t, t_freeze)

— reduce to two *rank* quantities per position, computable in parallel for
a whole block (and batched over thousands of blocks):

    c_t = #{ s < min(t, t_freeze) : sym_s <  v_t }   (dominance count)
    d_t = #{ s < min(t, t_freeze) : sym_s == v_t }   (occurrence rank)

Computation is **fully parallel — no sequential scan**:

1. per-chunk symbol histograms ``H[b, k, a]`` (one fused compare-reduce);
2. exclusive prefix sums of ``H`` over the chunk axis (cross-chunk
   counts) and over the alphabet axis (dominance), giving the
   carry-in ranks by two gathers; and
3. an in-chunk pairwise term ``#{s < t in chunk : v_s (<|=) v_t}``
   (fused compare-multiply-reduce over the ``chunk×chunk`` triangle).

This is what breaks the reference's encode-side bit-serial order: every
op is a wide fused compare-reduce over (blocks × chunks × chunk) with no
dependence on the coder.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("n_symbols", "chunk"))
def _ranks_parallel(
    symbols: jax.Array,  # (B, Kp) int32, padded to a multiple of chunk
    contrib_limit: jax.Array,  # (B,) int32: positions s < contrib_limit contribute
    n_symbols: int,
    chunk: int,
):
    """(c, d) ranks for every position, shape ``(B, Kp)`` int32 each.

    Kept as a second formulation (differential-tested against the fused
    production path in :func:`_model_values_parallel`, which folds the
    carry lookups into precombined tables — ~2x fewer vector ops).
    """
    B, Kp = symbols.shape
    nc = Kp // chunk
    vc = symbols.reshape(B, nc, chunk)
    pos = (
        jnp.arange(nc, dtype=jnp.int32)[:, None] * chunk
        + jnp.arange(chunk, dtype=jnp.int32)[None, :]
    )  # (nc, chunk) global positions
    m = pos[None] < contrib_limit[:, None, None]  # (B, nc, chunk) contributors

    # 1. Per-chunk histograms (fused compare-reduce; nothing materialized
    #    at (B, nc, chunk, n_symbols)).
    alpha = jnp.arange(n_symbols, dtype=jnp.int32)
    onehot = (vc[..., None] == alpha) & m[..., None]
    H = jnp.sum(onehot, axis=2, dtype=jnp.int32)  # (B, nc, n_symbols)

    # 2. Cross-chunk carries: exclusive prefix over chunks, then per-symbol
    #    lookups as fused compare-reduces.  NOT gathers (take_along_axis
    #    can lower to serialized dynamic-slice loops) and NOT one-hot
    #    matmuls (a dot would materialize the (B, nc, chunk, A) one-hot
    #    operand — gigabytes).  The masked reductions fuse like the
    #    histogram above: nothing 4-D is ever materialized.
    #    c_carry[t] = #{earlier chunks, value < vc_t} = sum_{a < vc_t} cumH[a].
    cumH = jnp.cumsum(H, axis=1) - H  # counts in chunks before k
    cumH_b = cumH[:, :, None, :]  # (B, nc, 1, A) broadcast over positions
    lt = alpha < vc[..., None]  # (B, nc, chunk, A), fused
    c_carry = jnp.sum(jnp.where(lt, cumH_b, 0), axis=-1, dtype=jnp.int32)
    eq = alpha == vc[..., None]
    d_carry = jnp.sum(jnp.where(eq, cumH_b, 0), axis=-1, dtype=jnp.int32)

    # 3. In-chunk pairwise triangle (fused; compute O(B*Kp*chunk)).
    tri = jnp.triu(jnp.ones((chunk, chunk), dtype=bool), k=1)  # [s, t]: s < t
    vs = vc[:, :, :, None]  # source position s
    vt = vc[:, :, None, :]  # target position t
    w = m[:, :, :, None] & tri[None, None]
    c_intra = jnp.sum(w & (vs < vt), axis=2, dtype=jnp.int32)
    d_intra = jnp.sum(w & (vs == vt), axis=2, dtype=jnp.int32)

    c = (c_carry + c_intra).reshape(B, Kp)
    d = (d_carry + d_intra).reshape(B, Kp)
    return c, d


@functools.partial(jax.jit, static_argnames=("n_symbols", "chunk", "delta"))
def _model_values_parallel(
    symbols: jax.Array,  # (B, Kp) int32 in [0, 256), multiple-of-chunk Kp
    contrib_limit: jax.Array,  # (B,) int32
    init_cum: jax.Array,  # (n_symbols + 1,) int32
    n_symbols: int,
    chunk: int,
    delta: int,
):
    """Fused (lo, hi) model values, shape ``(B, Kp)`` int32 each.

    The production formulation: instead of looking up four 257-wide
    tables per position (carry-lt, carry-eq, init-lo, init-hi — the
    dominant cost of the rank precompute), fold everything linear in
    the carries into TWO precombined per-chunk tables,

        T_lo[a] = init_cum[a]   + delta * P[a]
        T_hi[a] = init_cum[a+1] + delta * (P[a] + cumH[a])

    (P = exclusive alphabet-prefix of the prior-chunk histogram cumH), so

        lo[t] = T_lo[v_t] + delta * c_intra[t]
        hi[t] = T_hi[v_t] + delta * (c_intra + d_intra)[t]

    needs ONE shared equality mask and two masked reduces.  Data symbols
    are < 256 (EOF's triple has a closed form, see the caller), so the
    lookup alphabet is 256 wide.
    """
    B, Kp = symbols.shape
    nc = Kp // chunk
    A = n_symbols - 1  # 256: data symbols only, EOF never appears in-stream
    vc = symbols.reshape(B, nc, chunk)
    pos = (
        jnp.arange(nc, dtype=jnp.int32)[:, None] * chunk
        + jnp.arange(chunk, dtype=jnp.int32)[None, :]
    )
    m = pos[None] < contrib_limit[:, None, None]  # (B, nc, chunk)

    alpha = jnp.arange(A, dtype=jnp.int32)
    onehot = (vc[..., None] == alpha) & m[..., None]
    H = jnp.sum(onehot, axis=2, dtype=jnp.int32)  # (B, nc, A)

    cumH = jnp.cumsum(H, axis=1) - H  # counts in chunks before this one
    P = jnp.cumsum(cumH, axis=2) - cumH  # exclusive alphabet prefix
    d32 = jnp.int32(delta)
    t_lo = init_cum[None, None, :A] + d32 * P
    t_hi = init_cum[None, None, 1 : A + 1] + d32 * (P + cumH)

    # One equality mask, two fused masked reduces (no gathers — see
    # _ranks_parallel on why).
    eq = vc[..., None] == alpha  # (B, nc, chunk, A), fused
    lo_c = jnp.sum(jnp.where(eq, t_lo[:, :, None, :], 0), axis=-1, dtype=jnp.int32)
    hi_c = jnp.sum(jnp.where(eq, t_hi[:, :, None, :], 0), axis=-1, dtype=jnp.int32)

    # In-chunk pairwise triangle (identical to _ranks_parallel).
    tri = jnp.triu(jnp.ones((chunk, chunk), dtype=bool), k=1)
    vs = vc[:, :, :, None]
    vt = vc[:, :, None, :]
    w = m[:, :, :, None] & tri[None, None]
    c_intra = jnp.sum(w & (vs < vt), axis=2, dtype=jnp.int32)
    d_intra = jnp.sum(w & (vs == vt), axis=2, dtype=jnp.int32)

    lo = (lo_c + d32 * c_intra).reshape(B, Kp)
    hi = (hi_c + d32 * (c_intra + d_intra)).reshape(B, Kp)
    return lo, hi


def precompute_encode_model(
    symbols: jax.Array,  # (B, K) int32 data symbols (padded with anything past len)
    lens: jax.Array,  # (B,) int32 valid symbol count per lane
    init_cum: jax.Array,  # (n_symbols + 1,) int32 initial cumulative row
    freq_max: int,
    chunk: int = 64,
    delta: int = 1,
    with_tot: bool = True,
):
    """Per-position model values for the vectorized encoder.

    Returns ``(lo, hi, tot, eof_lo, eof_hi, eof_tot)``:

    * ``lo/hi/tot``: (B, K) int32 — the model triple the coder consumes at
      each data position (entries past ``lens`` are don't-care);
    * ``eof_*``: (B,) int32 — the triple for the EOF symbol encoded at
      position ``lens`` (closed form: every data symbol sorts below EOF,
      so EOF's rank contribution is just the update count).

    With ``delta == 1`` this exactly reproduces ``model.total_frequency()``
    + ``get_frequency`` sequences of the reference models (verified by
    differential tests).  ``delta > 1`` is the redux_tpu generalized
    adaptation increment: ``cum_t[i] = init[i] + delta * c_t(i)`` with the
    freeze once ``init_total + delta*t >= freq_max`` (the reference's +1
    freeze rule, adaptive_linear.rs:34, applied to the scaled total).
    """
    symbols = symbols.astype(jnp.int32)  # accepts uint8 (cheap transfer dtype)
    B, K = symbols.shape
    n_symbols = int(init_cum.shape[0]) - 1  # symbol_count (incl. EOF)
    init_total = init_cum[n_symbols].astype(jnp.int32)
    # Updates stop at the first t with total >= freq_max:
    # t_freeze = ceil((freq_max - init_total) / delta).
    t_freeze = (jnp.int32(freq_max) - init_total + (delta - 1)) // jnp.int32(delta)
    contrib_limit = jnp.maximum(0, jnp.minimum(lens, t_freeze))

    chunk = min(chunk, K) if K > 0 else 1
    Kp = ((K + chunk - 1) // chunk) * chunk
    if Kp != K:
        symbols = jnp.pad(symbols, ((0, 0), (0, Kp - K)))
    init_cum = init_cum.astype(jnp.int32)
    lo, hi = _model_values_parallel(
        symbols, contrib_limit, init_cum, n_symbols, chunk, int(delta)
    )
    lo, hi = lo[:, :K], hi[:, :K]
    if with_tot:
        t_idx = jnp.arange(K, dtype=jnp.int32)[None, :]
        n_upd_t = jnp.minimum(jnp.minimum(t_idx, lens[:, None]), t_freeze)
        tot = init_total + delta * n_upd_t
    else:
        # The GPU encode kernel computes the closed-form totals in-kernel
        # (triton_coder.encode_blocks) — skip materializing the (B, K)
        # plane (one third of the rank output's device-memory traffic).
        tot = None

    n_upd = jnp.maximum(0, jnp.minimum(lens, t_freeze))  # updates before EOF
    eof_lo = init_cum[n_symbols - 1] + delta * n_upd
    eof_hi = init_cum[n_symbols] + delta * n_upd
    eof_tot = init_cum[n_symbols] + delta * n_upd
    return lo, hi, tot, eof_lo, eof_hi, eof_tot


def precompute_encode_model_np(symbols, lens, init_cum, freq_max, delta=1):
    """Slow numpy oracle of :func:`precompute_encode_model` for testing."""
    symbols = np.asarray(symbols)
    lens = np.asarray(lens)
    init_cum = np.asarray(init_cum, dtype=np.int64)
    B, K = symbols.shape
    n_symbols = init_cum.shape[0] - 1
    lo = np.zeros((B, K), dtype=np.int64)
    hi = np.zeros((B, K), dtype=np.int64)
    tot = np.zeros((B, K), dtype=np.int64)
    eof = np.zeros((B, 3), dtype=np.int64)
    for b in range(B):
        cum = init_cum.copy()
        L = int(lens[b])
        for t in range(K):
            v = int(symbols[b, t])
            lo[b, t], hi[b, t], tot[b, t] = cum[v], cum[v + 1], cum[n_symbols]
            if t < L and cum[n_symbols] < freq_max:  # freeze rule
                cum[v + 1 :] += delta
        # recompute cum at time L for the EOF triple
        cum = init_cum.copy()
        for t in range(L):
            if cum[n_symbols] >= freq_max:
                break
            cum[int(symbols[b, t]) + 1 :] += delta
        eof[b] = (cum[n_symbols - 1], cum[n_symbols], cum[n_symbols])
    return lo, hi, tot, eof[:, 0], eof[:, 1], eof[:, 2]
