"""Differential (oracle) model tests.

The reference proves its optimized Fenwick model against the slow linear
model by driving both with identical random streams and asserting identical
ranges, inverse lookups, and (debug) full frequency tables
(``/root/reference/src/model/tests.rs``).  We extend the same tier to a
three-way check: linear oracle ≡ Fenwick ≡ dense-row (the data-parallel formulation).

Grid: a subset of the reference's {4,8,12}-bit × (freq,code) grid
(model/tests.rs:95-251) with iteration counts sized for CI.
"""

import random

import pytest

from redux_tpu.errors import InvalidInputError
from redux_tpu.models import (
    AdaptiveFenwickModel,
    AdaptiveLinearModel,
    DenseModel,
)
from redux_tpu.params import Parameters

GRID = [
    # (symbol_bits, freq_bits, code_bits, iterations)
    (4, 10, 16, 3000),  # small freq_max: exercises adaptation freeze
    (4, 14, 16, 2000),
    (4, 30, 32, 2000),
    (8, 14, 16, 2000),  # doc-example config
    (8, 15, 17, 2000),  # 32-bit config
    (8, 30, 32, 2000),  # production config
    (12, 22, 24, 1500),
]


def _models(p: Parameters):
    return [AdaptiveLinearModel(p), AdaptiveFenwickModel(p), DenseModel(p)]


@pytest.mark.parametrize("bits,freq,code,iters", GRID)
def test_compare_models_encode(bits, freq, code, iters):
    # model/tests.rs:50-70 generalized to 3 implementations.
    p = Parameters(bits, freq, code)
    models = _models(p)
    rng = random.Random(0xC0DEC + bits * 1000 + freq)
    for _ in range(iters):
        totals = [m.total_frequency() for m in models]
        assert len(set(totals)) == 1
        symbol = rng.randrange(p.symbol_eof + 1)  # valid symbols incl. EOF
        results = [m.get_frequency(symbol) for m in models]
        assert len(set(results)) == 1, (symbol, results)

    tables = [tuple(m.get_freq_table()) for m in models]
    assert len(set(tables)) == 1

    invalid = p.symbol_eof + 1  # model/tests.rs:15-17
    for m in models:
        with pytest.raises(InvalidInputError):
            m.get_frequency(invalid)
        with pytest.raises(InvalidInputError):
            m.get_frequency(invalid + 1)


@pytest.mark.parametrize("bits,freq,code,iters", GRID)
def test_compare_models_decode(bits, freq, code, iters):
    # model/tests.rs:72-93 generalized to 3 implementations.
    p = Parameters(bits, freq, code)
    models = _models(p)
    rng = random.Random(0xDEC0DE + bits * 1000 + freq)
    for _ in range(iters):
        totals = [m.total_frequency() for m in models]
        assert len(set(totals)) == 1
        value = rng.randrange(totals[0])
        results = [m.get_symbol(value) for m in models]
        assert len(set(results)) == 1, (value, results)

    tables = [tuple(m.get_freq_table()) for m in models]
    assert len(set(tables)) == 1

    invalid = models[0].total_frequency()  # model/tests.rs:23-25
    for m in models:
        with pytest.raises(InvalidInputError):
            m.get_symbol(invalid)
        with pytest.raises(InvalidInputError):
            m.get_symbol(invalid + 1)


def test_adaptation_freeze():
    # Adaptation must stop exactly when total hits freq_max
    # (adaptive_linear.rs:34, adaptive_tree.rs:84).
    p = Parameters(4, 6, 8)  # freq_max = 63, symbol_count = 17
    models = _models(p)
    for m in models:
        for _ in range(200):
            m.get_frequency(3)
        assert m.total_frequency() == p.freq_max
    tables = [tuple(m.get_freq_table()) for m in models]
    assert len(set(tables)) == 1


def test_initial_state_uniform():
    # init freq[i]=i (adaptive_linear.rs:26-28) == tree[i]=last_one(i)
    # (adaptive_tree.rs:43-45): every symbol starts with frequency 1.
    p = Parameters(8, 14, 16)
    for m in _models(p):
        assert m.total_frequency() == p.symbol_count
        table = m.get_freq_table()
        assert table == [(i, i + 1) for i in range(p.symbol_count)]


# ---------------------------------------------------------------------------
# Reference-depth differential tier (model/tests.rs:95-251 parity): the
# exact {4,8,12}-bit x (freq,code) grid at the reference's 10k-200k
# iteration counts.  Gated behind --runslow like the corpus grid (the
# reference gates these to release builds, tests.rs cfg_attr(debug, ignore)).
# ---------------------------------------------------------------------------

REF_GRID = [
    # (symbol_bits, freq_bits, code_bits, iterations) — tests.rs:96-251
    (4, 10, 16, 10_000),
    (4, 14, 16, 10_000),
    (4, 22, 24, 100_000),
    (4, 24, 30, 100_000),
    (4, 30, 32, 200_000),
    (8, 10, 16, 10_000),
    (8, 14, 16, 10_000),
    (8, 22, 24, 100_000),
    (8, 24, 30, 100_000),
    (8, 30, 32, 200_000),
    (12, 14, 16, 10_000),
    (12, 22, 24, 100_000),
    (12, 24, 30, 100_000),
    (12, 30, 32, 200_000),
]


@pytest.mark.slow
@pytest.mark.parametrize("bits,freq,code,iters", REF_GRID)
def test_compare_models_encode_reference_depth(bits, freq, code, iters):
    p = Parameters(bits, freq, code)
    models = _models(p)
    rng = random.Random(0xC0DEC + bits * 1000 + freq)
    for i in range(iters):
        totals = [m.total_frequency() for m in models]
        assert len(set(totals)) == 1, i
        symbol = rng.randrange(p.symbol_eof + 1)
        results = [m.get_frequency(symbol) for m in models]
        assert len(set(results)) == 1, (i, symbol, results)
    tables = [tuple(m.get_freq_table()) for m in models]
    assert len(set(tables)) == 1


@pytest.mark.slow
@pytest.mark.parametrize("bits,freq,code,iters", REF_GRID)
def test_compare_models_decode_reference_depth(bits, freq, code, iters):
    p = Parameters(bits, freq, code)
    models = _models(p)
    rng = random.Random(0xDEC0DE + bits * 1000 + freq)
    for i in range(iters):
        totals = [m.total_frequency() for m in models]
        assert len(set(totals)) == 1, i
        value = rng.randrange(totals[0])
        results = [m.get_symbol(value) for m in models]
        assert len(set(results)) == 1, (i, value, results)
    tables = [tuple(m.get_freq_table()) for m in models]
    assert len(set(tables)) == 1
