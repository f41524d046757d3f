"""redux_tpu — a block-parallel adaptive arithmetic-coding (lossless codec) framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
Rust library (peterbudai/redux): order-0 adaptive arithmetic coding with
pluggable probability models, bit-exact round-trip, corpus benchmarking,
and a CLI — rebuilt block-parallel so that thousands of independent
streams encode/decode concurrently across accelerator lanes, devices, and
hosts.

Layering (cf. the reference layer map, SURVEY.md §1):

* :mod:`redux_tpu.errors`, :mod:`redux_tpu.params` — error/Result types and
  the validated ``Parameters`` numerology (reference lib.rs:57-98,
  model/mod.rs:33-81).
* :mod:`redux_tpu.bitio` — host bit I/O defining the bitstream format
  (reference src/bitio/mod.rs), verified against its golden vectors.
* :mod:`redux_tpu.models` — probability models: linear + Fenwick oracles
  (reference src/model/*) and the dense-row formulation.
* :mod:`redux_tpu.oracle` — sequential reference-semantics codec
  (reference src/codec.rs): test oracle + reference-format compat.
* :mod:`redux_tpu.ops` — the device data path: parallel model precompute,
  vectorized interval coder (XLA scans, Pallas GPU kernels), bit packing.
* :mod:`redux_tpu.container` / :mod:`redux_tpu.api` — the block-parallel
  archive format and the high-level compress/decompress API.
* :mod:`redux_tpu.parallel` — device mesh / sharding (multi-device,
  multi-host data parallelism over blocks).
* :mod:`redux_tpu.cli` — ``redux-tpu (-c|-d) [-i F] [-o F]`` (reference
  src/main.rs parity plus container extensions).

64-bit integer support: the reference production config (8, 30, 32) needs
exact u64 products (codec.rs:59-60); JAX x64 mode is enabled at import.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Persistent XLA compile cache: the coder scans and kernels take seconds to
# compile; caching makes every process after the first start fast.  JAX
# reads JAX_COMPILATION_CACHE_DIR itself; without it the cache lives at a
# fixed path inside the checkout (a fixed path is part of the cache key).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"),
    )
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .errors import EofError, InvalidInputError, ReduxError, ReduxIOError
from .params import Parameters
from .oracle import compress, decompress, compress_bytes, decompress_bytes

__version__ = "0.1.0"

__all__ = [
    "EofError",
    "InvalidInputError",
    "ReduxError",
    "ReduxIOError",
    "Parameters",
    "compress",
    "decompress",
    "compress_bytes",
    "decompress_bytes",
    "__version__",
]
