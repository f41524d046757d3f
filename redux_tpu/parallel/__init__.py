"""Multi-chip / multi-host data parallelism over blocks.

The reference is strictly single-threaded (SURVEY.md §2: no threads, SIMD,
processes, or network anywhere in ``src/``).  redux_tpu scales the one
parallel axis an order-0 block codec has — the block axis — across
devices with ``shard_map`` over a 1-D ``Mesh`` and across hosts with
``jax.distributed`` (TP/PP/SP/EP/CP do not apply to a codec; this is the
deliberate mapping documented in SURVEY.md §2).
"""

from .mesh import (
    data_parallel_mesh,
    encode_symbols_sharded,
    decode_blocks_sharded,
    pad_to_devices,
)

__all__ = [
    "data_parallel_mesh",
    "encode_symbols_sharded",
    "decode_blocks_sharded",
    "pad_to_devices",
]
