"""Adaptive linear (dense-array) frequency model — the test oracle.

Semantics-exact counterpart of the reference ``AdaptiveLinearModel``
(``/root/reference/src/model/adaptive_linear.rs``):

* state: array ``freq`` of ``symbol_count + 1`` cumulative frequencies,
  initialized ``freq[i] = i`` — i.e. every symbol (including EOF) starts
  with frequency 1 (adaptive_linear.rs:26-28);
* ``get_frequency(symbol)`` returns ``(freq[sym], freq[sym+1])`` then
  updates (adaptive_linear.rs:52-59);
* ``get_symbol(value)`` linear-scans for the first ``i`` with
  ``value < freq[i+1]`` then updates (adaptive_linear.rs:61-70);
* ``update`` adds 1 to every entry above the symbol, but only while
  ``total_frequency() < freq_max`` — the adaptation freeze
  (adaptive_linear.rs:33-39).

This model is deliberately simple and slow: it is the oracle against which
both the Fenwick model and the dense-row formulation are differentially
tested, exactly how the reference uses it (lib.rs:8-9, model/tests.rs).
"""

from __future__ import annotations

from typing import List, Tuple

from ..errors import InvalidInputError
from ..params import Parameters
from .base import Model


class AdaptiveLinearModel(Model):
    """Dense cumulative-frequency model (reference adaptive_linear.rs:12-80)."""

    def __init__(self, params: Parameters):
        self.params = params
        # freq[i] = i : uniform init, one count per symbol (adaptive_linear.rs:26-28).
        self.freq = list(range(params.symbol_count + 1))

    def _update(self, symbol: int) -> None:
        # Adaptation freeze at freq_max (adaptive_linear.rs:34).
        if self.total_frequency() < self.params.freq_max:
            for i in range(symbol + 1, len(self.freq)):
                self.freq[i] += 1

    def total_frequency(self) -> int:
        return self.freq[self.params.symbol_count]

    def get_frequency(self, symbol: int) -> Tuple[int, int]:
        if symbol > self.params.symbol_eof:
            raise InvalidInputError()
        res = (self.freq[symbol], self.freq[symbol + 1])
        self._update(symbol)
        return res

    def get_symbol(self, value: int) -> Tuple[int, int, int]:
        for i in range(len(self.freq) - 1):
            if value < self.freq[i + 1]:
                res = (i, self.freq[i], self.freq[i + 1])
                self._update(i)
                return res
        raise InvalidInputError()

    def get_freq_table(self) -> List[Tuple[int, int]]:
        return [
            (self.freq[i], self.freq[i + 1]) for i in range(self.params.symbol_count)
        ]
