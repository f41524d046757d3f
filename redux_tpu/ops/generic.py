"""User-defined adaptive models on the jit device path.

The reference's headline extension point is the ``Model`` trait
(the reference's ``src/lib.rs:14-15``; trait at ``model/mod.rs:17-29``):
any type implementing four methods plugs into the codec.  redux_tpu's
production coders specialize the dense order-0 ``+delta`` rule for
speed; this module restores trait-level generality ON DEVICE.  A
:class:`JaxModel` bundles the trait's methods as pure lane-batched JAX
functions over an arbitrary state pytree, and the coders below drive it
inside ``jax.jit``/``lax.scan`` with the same closed-form renormalization
as ``ops.coder`` — streams are bit-identical to the host oracle running
the same model rule (``tests/test_generic_model.py``).

Split-lookup contract (vs the host trait): the host ``Model`` adapts
inside ``get_frequency``/``get_symbol`` (model/mod.rs:23-25); here the
lookup and the adaptation are separate pure functions so the coder can
gate the update on lane liveness.  A host rule maps mechanically:
``get_frequency(s)`` = ``encode_sym`` then ``update``; ``get_symbol(v)``
= ``decode_val`` then ``update``.

Performance note: a generic model runs at XLA-``scan`` speed (the state
update is O(state) per position), not at the specialized Pallas kernels'
speed.  It is the extension escape hatch the trait promises — the
production dense path stays on ``ops.coder``/``ops.pallas_*``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..params import Parameters
from .coder import _clz, _word_bits, coder_dtype, encode_blocks


class JaxModel(NamedTuple):
    """A lane-batched adaptive model: pure functions over a state pytree.

    All callables are traced under ``jit``; shapes are batched over ``B``
    independent blocks (lanes).  Frequencies are int32 (every legal config
    has ``freq_bits <= 30``, params.py).

    * ``init(B)`` → state pytree with leading batch dim ``B``.
    * ``total(state)`` → ``(B,)`` int32 cumulative total (model/mod.rs:21).
    * ``encode_sym(state, sym)`` → ``(flo, fhi)`` ``(B,)`` int32 cumulative
      bounds of ``sym`` (the lookup half of model/mod.rs:23).
    * ``decode_val(state, value)`` → ``(sym, flo, fhi)`` ``(B,)`` int32 —
      the symbol whose range contains ``value`` (model/mod.rs:25).
    * ``update(state, sym, active)`` → new state; must be a no-op for
      lanes where ``active`` is False (padded positions past ``lens``).
    """

    init: Callable[[int], Any]
    total: Callable[[Any], jax.Array]
    encode_sym: Callable[[Any, jax.Array], Tuple[jax.Array, jax.Array]]
    decode_val: Callable[[Any, jax.Array], Tuple[jax.Array, jax.Array, jax.Array]]
    update: Callable[[Any, jax.Array, jax.Array], Any]


def dense_jax_model(params: Parameters, init_cum, delta: int = 1) -> JaxModel:
    """The production dense order-0 ``+delta`` rule as a :class:`JaxModel`.

    Exists as the differential bridge: streams through the generic coder
    must equal the specialized ``ops.coder`` path for this model.  State is
    the ``(B, S+1)`` cumulative row; freeze once ``total >= freq_max``
    (adaptive_linear.rs:34 generalized to ``+delta``).
    """
    S = params.symbol_count
    freq_max = params.freq_max
    ic = jnp.asarray(init_cum, jnp.int32)
    sentinel = jnp.int32(freq_max + max(delta, 1))  # > any live entry

    def init(B: int):
        return jnp.broadcast_to(ic, (B, S + 1)).astype(jnp.int32)

    def total(cum):
        return cum[:, S]

    def encode_sym(cum, sym):
        flo = jnp.take_along_axis(cum, sym[:, None], axis=1)[:, 0]
        fhi = jnp.take_along_axis(cum, sym[:, None] + 1, axis=1)[:, 0]
        return flo, fhi

    def decode_val(cum, value):
        b = cum <= value[:, None]
        sym = jnp.clip(jnp.sum(b, axis=1, dtype=jnp.int32) - 1, 0, S - 1)
        flo = jnp.max(jnp.where(b, cum, 0), axis=1)
        fhi = jnp.min(jnp.where(b, sentinel, cum), axis=1)
        return sym, flo, fhi

    def update(cum, sym, active):
        upd = active & (cum[:, S] < freq_max)
        mask = jnp.arange(S + 1, dtype=jnp.int32)[None, :] > sym[:, None]
        return cum + jnp.where(mask & upd[:, None], jnp.int32(delta), 0)

    return JaxModel(init, total, encode_sym, decode_val, update)


def static_jax_model(params: Parameters, cum_row) -> JaxModel:
    """A frozen (non-adaptive) model from a fixed cumulative row.

    The classic trait use case the dense production rule cannot express:
    code against a precomputed distribution with zero adaptation cost.
    ``cum_row`` is ``(S+1,)`` nondecreasing with every symbol's width >= 1
    and total <= freq_max.
    """
    m = dense_jax_model(params, cum_row, delta=0)
    return m._replace(update=lambda state, sym, active: state)


def model_values_generic(model: JaxModel, syms, lens, params: Parameters):
    """Per-position model values for :func:`ops.coder.encode_blocks`.

    The generic twin of ``ops.ranks.precompute_encode_model``: runs the
    model forward over the known symbols (one ``lax.scan`` over positions,
    lanes batched) and returns ``(lo, hi, tot, eof_lo, eof_hi, eof_tot)``
    in the exact layout ``encode_blocks`` consumes.
    """
    syms = jnp.asarray(syms).astype(jnp.int32)
    lens = jnp.asarray(lens).astype(jnp.int32)
    B, K = syms.shape
    state0 = model.init(B)

    def step(state, xs):
        sym, t = xs
        tot = model.total(state)
        flo, fhi = model.encode_sym(state, sym)
        state = model.update(state, sym, t < lens)
        return state, (flo, fhi, tot)

    ts = jnp.arange(K, dtype=jnp.int32)
    state, (lo, hi, tot) = jax.lax.scan(step, state0, (syms.T, ts))
    eof = jnp.full((B,), params.symbol_eof, jnp.int32)
    eof_lo, eof_hi = model.encode_sym(state, eof)
    eof_tot = model.total(state)
    return lo.T, hi.T, tot.T, eof_lo, eof_hi, eof_tot


def encode_blocks_generic(syms, lens, model: JaxModel, params: Parameters, n_words: int):
    """Encode ``B`` blocks with an arbitrary :class:`JaxModel`.

    Returns ``(words, byte_lens)`` exactly like ``encode_blocks`` —
    per-block streams in the reference format (EOF symbol + ``code_bits``
    drain, codec.rs:91-99), bit-identical to ``oracle.compress_bytes``
    driving the same model rule.
    """
    vals = model_values_generic(model, syms, lens, params)
    return encode_blocks(*vals, jnp.asarray(lens).astype(jnp.int32), params, n_words)


def decode_blocks_generic(words, lens, model: JaxModel, params: Parameters, k: int):
    """Decode ``B`` blocks with an arbitrary :class:`JaxModel`.

    The generic twin of ``ops.coder.decode_blocks`` (see that docstring
    for the closed-form renorm derivation and the register-window stream
    reads — the interval machinery here is identical; only the model
    lookups go through the :class:`JaxModel` callbacks).  Returns
    ``(B, k)`` int32 symbols (entries past ``lens`` are 0).
    """
    words = jnp.asarray(words)
    lens = jnp.asarray(lens).astype(jnp.int32)
    B, Wn = words.shape
    wdt = coder_dtype(params)
    W = _word_bits(wdt)
    cb = params.code_bits
    half = jnp.asarray(params.code_half, wdt)
    cmax = jnp.asarray(params.code_max, wdt)
    cmax_half = jnp.asarray(params.code_max >> 1, wdt)
    one = jnp.asarray(1, wdt)
    rows = jnp.arange(B)

    def read_bits(win, m):
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
        idx = jnp.minimum(wordidx, Wn - 1)
        loaded = words[rows, idx]
        nxt = jnp.where(need2, loaded, nxt)
        wordidx = wordidx + need2.astype(jnp.int32)
        val = ((v1 << m2c) | v2).astype(wdt)
        val = jnp.where(need2, val, v1.astype(wdt))
        return val, (cur, avail, nxt, wordidx)

    win = (
        words[:, 0],
        jnp.full((B,), 32, jnp.int32),
        words[:, 1] if Wn > 1 else jnp.zeros((B,), jnp.uint32),
        jnp.full((B,), 2, jnp.int32),
    )
    n_reads = 1 if cb <= 31 else 2
    z0 = jnp.zeros((B,), wdt)
    prime = jnp.full((B,), cb, jnp.int32)
    for _ in range(2):
        m = jnp.minimum(prime, 31)
        val, win = read_bits(win, m)
        z0 = (z0 << m.astype(wdt)) | val
        prime = prime - m

    def scan_step(carry, t):
        low, high, z, state, win = carry
        active = t < lens

        rng = high - low + one
        count = model.total(state).astype(wdt)
        value = ((z + one) * count - one) // rng  # codec.rs:131, z = pending-low
        value = jnp.minimum(value, count - one)  # garbage-input guard
        sym, flo, fhi = model.decode_val(state, value.astype(jnp.int32))
        state = model.update(state, sym, active)
        flo = flo.astype(wdt)
        fhi = fhi.astype(wdt)

        dlo = (rng * flo) // count
        nhigh = low + (rng * fhi) // count - one
        nlow = low + dlo
        z = jnp.where(active, z - dlo, z)
        low = jnp.where(active, nlow, low)
        high = jnp.where(active, nhigh, high)

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

        n = n1 + n3
        for _ in range(n_reads):
            m = jnp.minimum(n, 31)
            val, win = read_bits(win, m)
            mw = m.astype(wdt)
            z = jnp.where(m > 0, (z << mw) | val, z)
            n = n - m

        return (low, high, z, state, win), jnp.where(active, sym, 0)

    init = (
        jnp.full((B,), params.code_min, wdt),
        jnp.full((B,), params.code_max, wdt),
        z0,
        model.init(B),
        win,
    )
    ts = jnp.arange(k, dtype=jnp.int32)
    _, syms = jax.lax.scan(scan_step, init, ts)
    return syms.T  # (B, k)


def make_generic_coders(model: JaxModel, params: Parameters):
    """Jitted ``(encode, decode)`` closures over a fixed model + params.

    ``encode(syms, lens, n_words)`` → ``(words, byte_lens)``;
    ``decode(words, lens, k)`` → ``(B, k)`` symbols.  ``n_words``/``k``
    are static (recompile per distinct value, like the dense path).
    """
    enc = functools.partial(encode_blocks_generic, model=model, params=params)
    dec = functools.partial(decode_blocks_generic, model=model, params=params)
    return (
        jax.jit(lambda syms, lens, n_words: enc(syms, lens, n_words=n_words),
                static_argnames=("n_words",)),
        jax.jit(lambda words, lens, k: dec(words, lens, k=k),
                static_argnames=("k",)),
    )
