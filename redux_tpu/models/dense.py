"""Dense cumulative-row model — the data-parallel formulation.

On a vector machine the reference's Fenwick tree (O(log n) pointer chasing
per op, adaptive_tree.rs:63-92) is the wrong shape: dependent scalar loads
leave the vector lanes idle.  Instead the model state is ONE dense row of
``symbol_count + 1`` cumulative frequencies per block (the same array the
reference's linear model keeps, adaptive_linear.rs:26-28), on which every
model operation is a wide vector op:

* ``get_frequency`` → two gathers into the row;
* ``get_symbol``    → vectorized rank: count entries ``<= value``;
* ``update``        → masked suffix add ``row += (iota > symbol)``;
* adaptation freeze → multiply the update mask by ``total < freq_max``
  (the reference freeze, adaptive_linear.rs:34 / adaptive_tree.rs:84).

Batched over thousands of blocks (one row per block/lane) these become
(lanes, 258)-shaped vector ops — the core of the decoders.  The
encode path does not even need the row: because the update is always
"+1 above the symbol", the cumulative frequency of symbol ``v`` at time
``t`` has the closed form::

    cum_t[i] = init_cum[i] + #{s < min(t, t_freeze) : sym_s < i}

so per-symbol ``(low, high, total)`` are precomputable in parallel for the
whole block (see :mod:`redux_tpu.ops.ranks`).

This module provides the init vectors (uniform and warm-start prior) and a
numpy :class:`DenseModel` used for differential testing against the
reference-semantics linear/Fenwick oracles.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..errors import InvalidInputError
from ..params import Parameters
from .base import Model


def uniform_init_cum(params: Parameters) -> np.ndarray:
    """Uniform initial cumulative row: ``init_cum[i] = i``.

    Identical to the reference init — one count per symbol including EOF
    (adaptive_linear.rs:26-28; tree[i]=last_one(i) encodes the same,
    adaptive_tree.rs:43-45).  Shape ``(symbol_count + 1,)``, int64.
    """
    return np.arange(params.symbol_count + 1, dtype=np.int64)


def quantize_prior(hist: np.ndarray, params: Parameters, budget: int) -> np.ndarray:
    """Quantize a byte histogram into per-symbol extra counts for warm start.

    Returns ``extra`` (shape ``(symbol_count,)``, int64, ``extra >= 0``) such
    that the initial frequency of symbol ``i`` is ``1 + extra[i]`` and the
    initial total ``symbol_count + sum(extra)`` is exactly ``budget`` (when
    the histogram is nonempty).  Largest-remainder apportionment: floor the
    ideal shares, then hand the leftover counts to the largest fractional
    remainders — deterministic and budget-exact (floor-only scaling wasted
    up to 256 counts of prior mass).  The EOF symbol always keeps frequency
    exactly 1 (it occurs once per block).

    This is a redux_tpu extension (no reference counterpart): blocks reset
    their model, so seeding each block with the archive-global distribution
    removes most of the per-block learning cost and beats the reference's
    cold uniform start on the head of every file.
    """
    n = params.symbol_count
    extra = np.zeros(n, dtype=np.int64)
    total = int(hist.sum())
    if total <= 0:
        return extra
    head = max(0, budget - n)
    if head <= 0:
        return extra
    ideal = hist.astype(np.float64) * head / total
    fl = np.floor(ideal).astype(np.int64)
    short = head - int(fl.sum())
    if short > 0:
        order = np.argsort(-(ideal - fl), kind="stable")[:short]
        fl[order] += 1
    # The archive stores extras as u16 — clamp heavily skewed histograms
    # (the foregone mass just lowers the effective budget; the decoder
    # reconstructs the identical init row from the stored table).
    extra[: hist.shape[0]] = np.minimum(fl, 0xFFFF)
    return extra


def prior_init_cum(extra: np.ndarray, params: Parameters) -> np.ndarray:
    """Initial cumulative row from warm-start counts: ``cum[i] = i + Σ_{j<i} extra[j]``."""
    n = params.symbol_count
    cum = np.zeros(n + 1, dtype=np.int64)
    cum[1:] = np.cumsum(1 + extra)
    return cum


class DenseModel(Model):
    """Numpy dense-row model with exact reference adaptation semantics.

    With ``init_cum = uniform_init_cum(params)`` this is observably identical
    to the reference linear/tree models (verified by the differential tests,
    the same way model/tests.rs proves linear ≡ tree).  With a warm-start
    ``init_cum`` it is the per-block model of the redux_tpu container format.
    """

    def __init__(
        self,
        params: Parameters,
        init_cum: np.ndarray | None = None,
        delta: int = 1,
    ):
        self.params = params
        if init_cum is None:
            init_cum = uniform_init_cum(params)
        if init_cum.shape != (params.symbol_count + 1,):
            raise InvalidInputError()
        if int(init_cum[-1]) >= params.freq_max:
            # Prior so heavy adaptation would be frozen from the start —
            # reject: priors must leave adaptation headroom.
            raise InvalidInputError()
        if delta < 1:
            raise InvalidInputError()
        # Adaptation increment (redux_tpu extension; the reference always
        # uses +1, adaptive_tree.rs:86-89).  delta > 1 re-adapts faster
        # after each block's model reset.
        self.delta = delta
        self.cum = init_cum.astype(np.int64).copy()
        self._iota = np.arange(params.symbol_count + 1, dtype=np.int64)

    def _update(self, symbol: int) -> None:
        if self.total_frequency() < self.params.freq_max:  # freeze (adaptive_linear.rs:34)
            self.cum += self.delta * (self._iota > symbol)  # masked suffix add

    def total_frequency(self) -> int:
        return int(self.cum[self.params.symbol_count])

    def get_frequency(self, symbol: int) -> Tuple[int, int]:
        if symbol > self.params.symbol_eof:
            raise InvalidInputError()
        res = (int(self.cum[symbol]), int(self.cum[symbol + 1]))
        self._update(symbol)
        return res

    def get_symbol(self, value: int) -> Tuple[int, int, int]:
        # Vectorized rank: first i with value < cum[i+1].
        if value >= self.total_frequency():
            raise InvalidInputError()
        i = int(np.sum(self.cum[1:] <= value))
        res = (i, int(self.cum[i]), int(self.cum[i + 1]))
        self._update(i)
        return res

    def get_freq_table(self) -> List[Tuple[int, int]]:
        return [
            (int(self.cum[i]), int(self.cum[i + 1]))
            for i in range(self.params.symbol_count)
        ]
