"""Probability models for the arithmetic coder.

Reference parity (``/root/reference/src/model/``):

* :class:`~redux_tpu.models.linear.AdaptiveLinearModel` — dense
  cumulative-frequency array, O(n) ops; the differential-test oracle
  (reference ``adaptive_linear.rs``, kept "mainly for tasting and
  benchmarking", lib.rs:8-9).
* :class:`~redux_tpu.models.fenwick.AdaptiveFenwickModel` — Fenwick/BIT
  model, O(log n) ops; the reference's production model
  (``adaptive_tree.rs``, lib.rs:11-12).
* :mod:`~redux_tpu.models.dense` — the data-parallel formulation: model state
  as a dense cumulative row, batched per block; plus warm-start priors.

All models share the 4-method contract of the reference ``Model`` trait
(``model/mod.rs:17-29``): ``total_frequency()``, ``get_frequency(symbol)``,
``get_symbol(value)`` (both of which adapt), and debug ``get_freq_table()``.
"""

from .base import Model
from .linear import AdaptiveLinearModel
from .fenwick import AdaptiveFenwickModel
from .dense import DenseModel, uniform_init_cum, prior_init_cum

__all__ = [
    "Model",
    "AdaptiveLinearModel",
    "AdaptiveFenwickModel",
    "DenseModel",
    "uniform_init_cum",
    "prior_init_cum",
]
