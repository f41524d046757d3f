"""Multi-host (DCN) data-parallel codec demo/verification.

The codec's multi-host story (SURVEY §2): blocks are sharded across all
hosts of a pod slice over the ``dp`` mesh axis; each host encodes its
local shard with zero collectives in the hot path; per-block compressed
outputs are reassembled in original block order by an ordered all-gather
(``multihost_utils.process_allgather``).  Scaling is embarrassing by
construction — DCN traffic is exactly the gathered compressed bytes.

:func:`run_multihost_roundtrip` is the process entry used by the
multi-process CPU test (tests/test_multihost.py) and by real pod-slice
jobs alike: only the coordinator address and process count differ.
"""

from __future__ import annotations

import numpy as np

from ..params import Parameters


def run_multihost_roundtrip(
    coordinator: str,
    num_processes: int,
    process_id: int,
    n_blocks_per_host: int = 4,
    k: int = 1024,
    seed: int = 0,
) -> str:
    """Initialize jax.distributed, encode sharded, gather, verify.

    Returns "MULTIHOST OK ..." on success; raises on any mismatch.
    """
    import jax

    from .mesh import data_parallel_mesh, encode_symbols_sharded, initialize_multihost

    initialize_multihost(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..models.dense import uniform_init_cum
    from ..ops.coder import max_block_words
    from .. import oracle

    params = Parameters.tpu_wide()
    delta = 16
    b = n_blocks_per_host * num_processes
    rng = np.random.default_rng(seed)
    # Same global input on every host (deterministic): mixed entropy.
    data = (rng.integers(0, 256, b * k // 2, dtype=np.uint8).tobytes()
            + (b"multihost block parallel coding " * ((b * k) // 64 + 1)))[: b * k]
    syms_np = np.frombuffer(data, np.uint8).reshape(b, k)
    lens_np = np.full(b, k, np.int32)
    ic = uniform_init_cum(params).astype(np.int32)

    mesh = data_parallel_mesh()
    assert mesh.devices.size == num_processes * jax.local_device_count()
    shard = NamedSharding(mesh, P("dp"))

    # Each process materializes only its own block shard (global arrays
    # from process-local data — the DCN-friendly input path).
    def local_piece(x):
        return jax.make_array_from_callback(x.shape, shard, lambda idx: x[idx])

    syms = local_piece(syms_np)
    lens = local_piece(lens_np)

    # Full worst-case buffer bound: this demo asserts oracle bit-equality
    # on every block (incl. the incompressible ones the api would instead
    # store raw), so capacity must cover arithmetic-coding expansion.
    n_words = max_block_words(
        min(257 + delta * k, params.freq_max), params.symbol_count, params, k
    )
    words, byte_lens, ovf = encode_symbols_sharded(
        syms, lens, jnp.asarray(ic), params, n_words, mesh, delta
    )

    # Ordered all-gather of the compressed shards over DCN: every host
    # reconstructs the full archive in original block order.
    words_all = multihost_utils.process_allgather(words, tiled=True)
    blens_all = multihost_utils.process_allgather(byte_lens, tiled=True)
    ovf_any = bool(np.asarray(multihost_utils.process_allgather(ovf, tiled=True)).any())
    assert not ovf_any

    words_np = np.asarray(words_all)
    blens = np.asarray(blens_all)
    assert words_np.shape[0] == b and blens.shape[0] == b

    # Verify every block against the sequential oracle (bit-exactness is
    # host-count invariant).
    for i in range(b):
        exp = oracle.compress_block(
            data[i * k : (i + 1) * k], params, ic.astype(np.int64), delta
        )
        got = words_np[i].astype(">u4").tobytes()[: blens[i]]
        assert got == exp, f"block {i} mismatch on process {process_id}"

    return (
        f"MULTIHOST OK p{process_id}/{num_processes} "
        f"blocks={b} devices={mesh.devices.size} "
        f"compressed={int(blens.sum())}B"
    )


def run_scaling_worker(
    coordinator: str,
    num_processes: int,
    process_id: int,
    bytes_per_host: int = 3 << 20,
    k: int = 4096,
    delta: int = 16,
    iters: int = 3,
) -> str:
    """Weak-scaling measurement worker: one REAL process per host.

    Unlike the virtual-device mesh (whose N>1 points time-share the host
    cores inside one runtime and mostly measure the scheduler), each
    worker here is an independent OS process with its own XLA runtime
    and one CPU device, exchanging only the jax.distributed barriers and
    the output gather — the actual multi-host execution model.  Timing:
    ``iters`` encode+decode rounds over the process-local shard with a
    global barrier before/after; the reported time is the max across
    processes by construction (everyone waits at the barrier).
    """
    import json
    import time

    import jax

    from .mesh import (
        data_parallel_mesh,
        decode_blocks_sharded,
        encode_symbols_sharded,
        initialize_multihost,
    )

    initialize_multihost(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .. import corpus
    from ..models.dense import uniform_init_cum
    from ..ops.coder import max_block_words

    params = Parameters.tpu_wide()
    # Lane-chunked dispatch, mirroring api.encode's production chunking:
    # one monolithic 3 MB/host call gives the XLA rank path a ~200 MB
    # working set that is DRAM-bandwidth-bound on CPU hosts, so N=2
    # would measure shared-memory contention instead of the codec.
    # 96-block slices stay cache-resident per process.
    bpc = 96  # blocks per host per chunk
    bph = max(bpc, (bytes_per_host // k) // bpc * bpc)
    n_chunks = bph // bpc
    data = corpus.mixed(bph * num_processes * k, 1)
    ic = uniform_init_cum(params).astype(np.int32)
    mesh = data_parallel_mesh()
    shard = NamedSharding(mesh, P("dp"))

    def local_piece(x):
        return jax.make_array_from_callback(x.shape, shard, lambda idx: x[idx])

    # Chunk c holds rows [c*bpc, (c+1)*bpc) of every host's shard.
    bc = bpc * num_processes
    chunks_np = []
    for c in range(n_chunks):
        rows = []
        for p in range(num_processes):
            start = (p * bph + c * bpc) * k
            rows.append(
                np.frombuffer(data[start : start + bpc * k], np.uint8)
                .reshape(bpc, k)
            )
        chunks_np.append(np.concatenate(rows, axis=0))
    lens_np = np.full(bc, k, np.int32)
    syms_c = [local_piece(x) for x in chunks_np]
    lens = local_piece(lens_np)
    icj = jnp.asarray(ic)
    n_words = max_block_words(
        min(257 + delta * k, params.freq_max), params.symbol_count, params, k
    )

    def enc(chunk):
        return encode_symbols_sharded(chunk, lens, icj, params, n_words, mesh,
                                      delta)

    words_c = [jax.block_until_ready(enc(s)) for s in syms_c[:1]]  # warmup
    multihost_utils.sync_global_devices("enc-start")
    t0 = time.perf_counter()
    for _ in range(iters):
        words_c = [jax.block_until_ready(enc(s))[:2] for s in syms_c]
    multihost_utils.sync_global_devices("enc-end")
    t_enc = (time.perf_counter() - t0) / iters

    def dec_all_chunks():
        return [
            jax.block_until_ready(
                decode_blocks_sharded(w, lens, icj, params, k, mesh, delta=delta)
            )
            for w, _bl in words_c
        ]

    dec_c = dec_all_chunks()  # warmup
    multihost_utils.sync_global_devices("dec-start")
    t0 = time.perf_counter()
    for _ in range(iters):
        dec_c = dec_all_chunks()
    multihost_utils.sync_global_devices("dec-end")
    t_dec = (time.perf_counter() - t0) / iters

    # Ordered gather + global verification (untimed).
    ok = True
    for c, d in enumerate(dec_c):
        dall = multihost_utils.process_allgather(d, tiled=True)
        ok = ok and bool(
            np.array_equal(
                np.asarray(dall)[:, :k],
                chunks_np[c],
            )
        )
    data = data[: bph * num_processes * k]
    return json.dumps(
        {
            "process": process_id,
            "n_procs": num_processes,
            "bytes": len(data),
            "t_enc": t_enc,
            "t_dec": t_dec,
            "verified": ok,
        }
    )


def main():  # pragma: no cover - exercised via subprocess in tests
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--scaling", action="store_true",
                    help="run the weak-scaling worker instead of the demo")
    ap.add_argument("--bytes-per-host", type=int, default=3 << 20)
    args = ap.parse_args()
    if args.scaling:
        print(
            run_scaling_worker(
                args.coordinator, args.num_processes, args.process_id,
                bytes_per_host=args.bytes_per_host,
            ),
            flush=True,
        )
    else:
        print(
            run_multihost_roundtrip(
                args.coordinator, args.num_processes, args.process_id
            ),
            flush=True,
        )


if __name__ == "__main__":  # pragma: no cover
    main()
