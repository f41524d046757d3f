"""Host-testable pieces of the GPU coder kernels (ops/triton_coder.py).

The float64 division is checked against Python's integer division over
the full operand range of the configs the kernels take, with the quotient
boundaries (``q*y - 1``, ``q*y``, ``q*y + y - 1``) where a rounded
quotient could be off by one: through XLA, through a Pallas kernel in
interpret mode, and (``gpu`` marker) through the Triton route compiled for
the card, which is the division the kernels run.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl

from redux_tpu.ops import triton_coder
from redux_tpu.params import Parameters

# Configs the kernels take and the adaptation increments at their ends.
CONFIGS = pytest.mark.parametrize(
    "params,delta",
    [(Parameters.tpu_wide(), 16), (Parameters.tpu_wide(), 255),
     (Parameters.tpu32(), 1), (Parameters(8, 22, 24), 16),
     (Parameters(8, 22, 30), 255)],
    ids=lambda v: str(v) if isinstance(v, int) else f"{v.symbol_bits}_{v.freq_bits}_{v.code_bits}",
)


def _operands(params: Parameters, delta: int, n: int, seed: int):
    """Dividends and divisors of the kernels' three divisions: the symbol
    locate ``((z + 1) * tot - 1) // rng`` and the narrowing
    ``rng * f // tot``, at their extremes and around quotient boundaries."""
    rng = np.random.default_rng(seed)
    cb = params.code_bits
    tot_max = params.freq_max + delta - 1  # the freeze may overshoot
    rng_ = rng.integers(1, 1 << cb, n, dtype=np.int64)
    tot = rng.integers(1, tot_max + 1, n, dtype=np.int64)
    z1 = rng.integers(1, (1 << cb) + 1, n, dtype=np.int64)
    f = rng.integers(0, tot_max + 1, n, dtype=np.int64)
    xs = [z1 * tot - 1, rng_ * f]
    ys = [rng_, np.maximum(tot, 1)]
    # Quotient boundaries at the top of the range.
    y = rng.integers(1, 1 << cb, n, dtype=np.int64)
    q = rng.integers(0, tot_max + 1, n, dtype=np.int64)
    for off in (-1, 0, 1):
        xs.append(np.maximum(q * y + np.where(off == 1, y - 1, off), 0))
        ys.append(y)
    big_y = np.array([1, 2, 3, (1 << cb) - 1, 1 << (cb - 1)], np.int64)
    big_x = ((1 << cb) * (tot_max + 1) - 1) // big_y * big_y
    xs += [big_x, big_x - 1, ((1 << cb) * (tot_max + 1) - 1) + 0 * big_y]
    ys += [big_y, big_y, big_y]
    return np.concatenate(xs), np.concatenate(ys)


def _div_kernel(x_ref, y_ref, o_ref):
    o_ref[...] = triton_coder._div64(x_ref[...], y_ref[...])


def _div64_pallas(x, y, interpret: bool, blk: int = 4096):
    """:func:`triton_coder._div64` inside a Pallas kernel on the Triton
    route, ``blk`` operands per program."""
    n = len(x)
    m = -(-n // blk) * blk
    spec = pl.BlockSpec((blk,), lambda i: (i,))
    out = pl.pallas_call(
        _div_kernel,
        out_shape=jax.ShapeDtypeStruct((m,), jnp.int64),
        grid=(m // blk,),
        in_specs=[spec, spec],
        out_specs=spec,
        backend="triton",
        interpret=interpret,
    )(jnp.asarray(np.pad(x, (0, m - n))),
      jnp.asarray(np.pad(y, (0, m - n), constant_values=1)))
    return np.asarray(out)[:n]


def _check_div64(params, delta, divide):
    assert triton_coder.supports(params)
    x, y = _operands(params, delta, 20000, params.code_bits * 1000 + delta)
    assert (x + y).max() < 2**53
    np.testing.assert_array_equal(divide(x, y), x // y)


@CONFIGS
def test_div64_exact_over_the_kernel_operand_range(params, delta):
    _check_div64(params, delta, lambda x, y: np.asarray(
        triton_coder._div64(jnp.asarray(x), jnp.asarray(y))))


@CONFIGS
def test_div64_exact_in_a_pallas_kernel(params, delta):
    _check_div64(params, delta, functools.partial(_div64_pallas, interpret=True))


@pytest.mark.gpu
@CONFIGS
def test_div64_exact_compiled_for_the_gpu(gpu, params, delta):
    _check_div64(params, delta, functools.partial(_div64_pallas, interpret=False))


def test_supports_only_configs_the_kernels_take():
    assert triton_coder.supports(Parameters.tpu_wide())
    assert triton_coder.supports(Parameters.tpu32())
    assert not triton_coder.supports(Parameters.default())  # code_bits 32
    assert not triton_coder.supports(Parameters(8, 24, 31))  # code_bits 31
    assert not triton_coder.supports(Parameters(8, 26, 28))  # 54-bit products
    assert not triton_coder.supports(Parameters(4, 10, 16))  # nibble symbols
