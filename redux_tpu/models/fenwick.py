"""Adaptive Fenwick-tree (binary indexed tree) frequency model.

Semantics-exact counterpart of the reference's production model
``AdaptiveTreeModel`` (``/root/reference/src/model/adaptive_tree.rs``):

* tree of ``symbol_count + 1`` nodes with 1-based Fenwick indexing;
  init ``tree[i] = last_one(i)`` which encodes the uniform
  one-count-per-symbol start (adaptive_tree.rs:43-45);
* running total cached in ``count`` (adaptive_tree.rs:14-16) and
  cross-checked against the tree in debug (adaptive_tree.rs:101);
* ``get_frequency_range`` walks the shared tree path once for both bounds
  (adaptive_tree.rs:63-80);
* ``get_symbol`` is a top-down binary descent from mask ``symbol_eof``
  (adaptive_tree.rs:115-136), rejecting ``value >= high``;
* ``update(symbol + 1)``: +1 Fenwick walk, frozen at ``freq_max``
  (adaptive_tree.rs:83-92); note the 1-based index vs. the linear model's
  0-based update (adaptive_tree.rs:110,133 vs adaptive_linear.rs:56,65) —
  identical results by construction, proven by the differential tests.

On the device the pointer-chasing Fenwick walk loses to a dense cumulative
row per block (see :mod:`redux_tpu.models.dense`); this class exists for the host
compat path and to reproduce the reference's linear-vs-tree differential
test tier (model/tests.rs) in our own test suite.
"""

from __future__ import annotations

from typing import List, Tuple

from ..errors import InvalidInputError
from ..params import Parameters
from .base import Model


def _last_one(x: int) -> int:
    """Lowest set bit: ``10110100 -> 00000100`` (adaptive_tree.rs:23-32)."""
    return x & (-x)


class AdaptiveFenwickModel(Model):
    """Fenwick/BIT cumulative-frequency model (reference adaptive_tree.rs:11-146)."""

    def __init__(self, params: Parameters):
        self.params = params
        n = params.symbol_count
        # tree[i] = last_one(i): uniform init (adaptive_tree.rs:43-45).
        self.tree = [_last_one(i) for i in range(n + 1)]
        self.count = n  # cached total (adaptive_tree.rs:14-16)

    def _get_frequency_single(self, symbol: int) -> int:
        i = symbol
        s = self.tree[0]
        while i > 0:
            s += self.tree[i]
            i -= _last_one(i)
        return s

    def _get_frequency_range(self, symbol: int) -> Tuple[int, int]:
        # Shared-path walk (adaptive_tree.rs:63-80).
        sumh = suml = 0
        h, low = symbol + 1, symbol
        while h != low:
            if h > low:
                sumh += self.tree[h]
                h -= _last_one(h)
            else:
                suml += self.tree[low]
                low -= _last_one(low)
        sumr = self._get_frequency_single(h)
        return (suml + sumr, sumh + sumr)

    def _update(self, symbol: int) -> None:
        # 1-based +1 walk, frozen at freq_max (adaptive_tree.rs:83-92).
        if self.total_frequency() < self.params.freq_max:
            i = symbol
            while i <= self.params.symbol_count:
                self.tree[i] += 1
                i += _last_one(i)
            self.count += 1

    def total_frequency(self) -> int:
        return self.count

    def get_frequency(self, symbol: int) -> Tuple[int, int]:
        if symbol > self.params.symbol_eof:
            raise InvalidInputError()
        result = self._get_frequency_range(symbol)
        self._update(symbol + 1)
        return result

    def get_symbol(self, value: int) -> Tuple[int, int, int]:
        # Top-down binary descent (adaptive_tree.rs:115-136).
        m = self.params.symbol_eof
        i = 0
        v = value
        while m > 0 and i < self.params.symbol_eof:
            ti = i + m
            tv = self.tree[ti]
            if v >= tv:
                i = ti
                v -= tv
            m >>= 1
        low, high = self._get_frequency_range(i)
        if value >= high:
            raise InvalidInputError()
        self._update(i + 1)
        return (i, low, high)

    def get_freq_table(self) -> List[Tuple[int, int]]:
        return [
            (self._get_frequency_single(i), self._get_frequency_single(i + 1))
            for i in range(self.params.symbol_count)
        ]
