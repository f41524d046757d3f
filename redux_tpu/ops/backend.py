"""The one place that picks the coder implementation for a backend.

* ``"gpu"`` -- the Pallas kernels of :mod:`redux_tpu.ops.triton_coder`
  (Triton route) for the coder loops, after the XLA rank precompute of
  :mod:`redux_tpu.ops.ranks`.  Configs wider than the kernels take
  (:func:`redux_tpu.ops.triton_coder.supports`) run the XLA scans.
* ``"cpu"`` -- the XLA scans of :mod:`redux_tpu.ops.coder`.
* anything else is an error; nothing falls back to another device.

Both implementations take and return the same layouts, so the api, the
mesh wrappers and the tests are written once against :class:`Coder`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import ClassVar, Optional

import jax
import jax.numpy as jnp

from ..params import Parameters
from . import coder, triton_coder
from .ranks import precompute_encode_model


@dataclasses.dataclass(frozen=True)
class Coder:
    """A block coder.  ``lane_quantum`` is the lane count its programs are
    built from; ``with_tot`` says whether its encoder reads the rank
    stage's running totals (the kernel computes them itself)."""

    name: ClassVar[str]
    lane_quantum: ClassVar[int]
    with_tot: ClassVar[bool]

    def encode(self, syms, lens, init_cum, params: Parameters, n_words: int,
               delta: int):
        """``(B, K)`` symbols -> ``(words (B, n_words) u32, byte_lens, ovf)``.

        Two XLA programs: the rank stage, then the coder.  Compiled as one,
        XLA lays the rank stage's outputs out for the coder and materializes
        its compare masks (41.5 GB instead of 6.4 GB of temporaries at a
        128 MiB chunk on an H100, PERF.md).
        """
        planes = ranks(syms, lens, init_cum, params, delta, self.with_tot)
        return self.code(planes, lens, init_cum, params, n_words, delta)

    def code(self, planes, lens, init_cum, params: Parameters, n_words: int,
             delta: int):
        """Rank-stage ``planes`` (lo, hi, tot) -> the coded words (see
        :meth:`encode`)."""
        raise NotImplementedError

    def decode(self, words, lens, init_cum, params: Parameters, k: int,
               delta: int):
        """``(B, W)`` u32 streams -> ``(B, k)`` uint8 symbols."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class XlaCoder(Coder):
    """The XLA scans of :mod:`redux_tpu.ops.coder`."""

    name = "xla"
    lane_quantum = 1
    with_tot = True

    def code(self, planes, lens, init_cum, params, n_words, delta):
        lo, hi, tot = planes
        return coder.encode_blocks_v2(lo, hi, tot, lens, params, n_words)

    def decode(self, words, lens, init_cum, params, k, delta):
        return coder.decode_blocks(words, lens, init_cum, params, k, delta=delta)


@dataclasses.dataclass(frozen=True)
class KernelCoder(Coder):
    """The Pallas kernels of :mod:`redux_tpu.ops.triton_coder`;
    ``interpret`` runs them in the Pallas interpreter (CPU tests)."""

    interpret: bool = False
    name = "triton"
    lane_quantum = triton_coder.TB
    with_tot = False

    def code(self, planes, lens, init_cum, params, n_words, delta):
        lo, hi, _ = planes
        return triton_coder.encode_blocks(
            lo, hi, lens, jnp.asarray(init_cum, jnp.int32)[-1], params,
            n_words, delta, interpret=self.interpret,
        )

    def decode(self, words, lens, init_cum, params, k, delta):
        return triton_coder.decode_blocks(
            words, lens, init_cum, params, k, delta, interpret=self.interpret
        )


@functools.partial(jax.jit, static_argnames=("params", "delta", "with_tot"))
def ranks(syms, lens, init_cum, params: Parameters, delta: int, with_tot: bool):
    """The rank stage as its own program: ``(lo, hi, tot)`` model planes of
    ``(B, K)`` uint8 symbols (``tot`` None unless ``with_tot``)."""
    lo, hi, tot, _, _, _ = precompute_encode_model(
        syms, lens, init_cum, params.freq_max, delta=delta, with_tot=with_tot
    )
    return lo, hi, tot


XLA = XlaCoder()
TRITON = KernelCoder()


def select(params: Parameters, backend: Optional[str] = None) -> Coder:
    """The coder for ``params`` on ``backend`` (default: JAX's backend)."""
    backend = backend or jax.default_backend()
    if backend == "gpu":
        return TRITON if triton_coder.supports(params) else XLA
    if backend == "cpu":
        return XLA
    raise RuntimeError(f"no block coder for the {backend!r} backend")
