"""Device data-path ops: parallel model precompute, block coders, bit packing.

This package is the redux_tpu counterpart of the reference's hot loops
(codec.rs:55-176, adaptive_tree.rs:63-136) re-derived for SPMD execution:

* :mod:`ranks` — closed-form parallel precompute of per-symbol model values
  for the encoder (replaces sequential model adaptation on encode);
* :mod:`coder` — the vectorized Witten–Neal–Cleary interval coder: scans
  over symbol positions with thousands of independent blocks in the lane
  dimension;
* :mod:`triton_coder` — the same coder as Pallas GPU kernels (one program
  per tile of blocks, the symbol loop inside it);
* :mod:`backend` — the one place that picks the coder for the backend;
* :mod:`bitpack` — host-side packing between per-lane u32 word buffers and
  byte streams;
* :mod:`generic` — user-defined models (the reference's ``Model`` trait,
  lib.rs:14-15) on the jit device path: :class:`~generic.JaxModel` +
  :func:`~generic.make_generic_coders`.
"""

from .ranks import precompute_encode_model
from .coder import encode_blocks, decode_blocks, CoderConfig
from .bitpack import streams_to_words, words_to_stream
from .generic import (
    JaxModel,
    dense_jax_model,
    static_jax_model,
    encode_blocks_generic,
    decode_blocks_generic,
    make_generic_coders,
)

__all__ = [
    "precompute_encode_model",
    "encode_blocks",
    "decode_blocks",
    "CoderConfig",
    "streams_to_words",
    "words_to_stream",
    "JaxModel",
    "dense_jax_model",
    "static_jax_model",
    "encode_blocks_generic",
    "decode_blocks_generic",
    "make_generic_coders",
]
