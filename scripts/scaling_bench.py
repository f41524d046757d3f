"""CPU scaling-efficiency sweep of the sharded XLA coders (BASELINE configs[5]).

Weak scaling: fixed blocks-per-device, mesh sizes 1..8 (virtual CPU
devices, and separate CPU processes joined by jax.distributed).
Efficiency(N) = throughput(N) / (N * throughput(1)).  CPU only: several
JAX processes on one GPU host would each reserve the same card.

Round-5 artifact upgrades: the multiprocess axis (the only section
presented as scaling evidence) runs >= 5 trials at >= 8 MB/host and
reports the median/min/max of the trial efficiencies; the in-process
virtual-mesh sections moved under an explicit "not_scaling_evidence"
key.  Round-4 upgrades kept:

* >= 3 MB/device virtual sections so the measurement amortizes dispatch
  and scheduler noise into real codec work;
* per-phase times (rank precompute / encode / decode / output gather).

Round-3 methodology fixes (the round-2 artifact showed 0.58 at N=2):

* The rank precompute now runs INSIDE the shard (the production
  composition, parallel/mesh.py) — round 2 ran it outside, so XLA
  resharded its outputs between program segments.
* XLA:CPU intra-op threading is pinned to one thread per device
  (--xla_cpu_multi_thread_eigen=false, 1 intra-op thread): otherwise the
  N=1 "single device" silently uses every host core and the weak-scaling
  denominator is wrong on a 2-core host.

Writes SCALING.json at the repo root (not tracked).

Run:  python scripts/scaling_bench.py
"""

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
if "intra_op_parallelism" not in flags:
    flags += (" --xla_cpu_multi_thread_eigen=false"
              " intra_op_parallelism_threads=1")
os.environ["XLA_FLAGS"] = flags.strip()
os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from redux_tpu import corpus
from redux_tpu.models.dense import uniform_init_cum
from redux_tpu.ops.coder import encode_blocks_v2, max_block_words
from redux_tpu.ops.ranks import precompute_encode_model
from redux_tpu.parallel import data_parallel_mesh, decode_blocks_sharded
from redux_tpu.params import Parameters

ITERS = int(os.environ.get("SCALING_ITERS", "2"))


@functools.partial(jax.jit, static_argnames=("params", "delta", "mesh"))
def _ranks_sharded(syms, lens, ic, params, delta, mesh):
    def fn(s, l, icum):
        lo, hi, _, _, _, _ = precompute_encode_model(
            s, l, icum, params.freq_max, delta=delta, with_tot=False
        )
        return lo, hi

    spec = P("dp")
    return jax.shard_map(
        fn, mesh=mesh, in_specs=(spec, spec, P()), out_specs=(spec, spec),
        check_vma=False,
    )(syms, lens, ic)


@functools.partial(jax.jit, static_argnames=("params", "n_words", "delta", "mesh"))
def _enc_sharded(syms, lens, ic, params, n_words, delta, mesh):
    # Production composition: ranks + coder per shard, zero collectives.
    def fn(s, l, icum):
        lo, hi, tot, _, _, _ = precompute_encode_model(
            s, l, icum, params.freq_max, delta=delta
        )
        return encode_blocks_v2.__wrapped__(
            lo, hi, tot, l, params=params, n_words=n_words
        )

    spec = P("dp")
    return jax.shard_map(
        fn, mesh=mesh, in_specs=(spec, spec, P()), out_specs=(spec, spec, spec),
        check_vma=False,
    )(syms, lens, ic)


def run(n_dev, blocks_per_dev=384, k=8192, delta=16):
    """XLA scan path at >= 3 MB/device, with per-phase timings."""
    params = Parameters.tpu_wide()
    mesh = data_parallel_mesh(n=n_dev)
    b = blocks_per_dev * n_dev
    data = corpus.mixed(b * k, 1)
    syms = np.frombuffer(data, np.uint8).reshape(b, k).astype(np.int32)
    lens = np.full(b, k, np.int32)
    ic = uniform_init_cum(params).astype(np.int32)
    shard = NamedSharding(mesh, P("dp"))
    sj = jax.device_put(jnp.asarray(syms), shard)
    lj = jax.device_put(jnp.asarray(lens), shard)
    icj = jnp.asarray(ic)
    n_words = max_block_words(
        min(257 + delta * k, params.freq_max), params.symbol_count, params, k
    )

    def timed(fn):
        out = jax.block_until_ready(fn())
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = jax.block_until_ready(fn())
        return (time.perf_counter() - t0) / ITERS, out

    # Per-phase: rank precompute alone, the fused rank+coder encode, the
    # decode, and the host gather of the compressed words.
    t_rank, _ = timed(lambda: _ranks_sharded(sj, lj, icj, params, delta, mesh))
    t_enc, (words, blens, _) = timed(
        lambda: _enc_sharded(sj, lj, icj, params, n_words, delta, mesh)
    )
    t_dec, dec = timed(
        lambda: decode_blocks_sharded(words, lj, icj, params, k, mesh, delta=delta)
    )
    t0 = time.perf_counter()
    w_np = np.asarray(words)
    t_gather = time.perf_counter() - t0

    ok = np.array_equal(
        np.asarray(dec)[:, :k].astype(np.uint8), syms.astype(np.uint8)
    )
    return {"n_dev": n_dev, "bytes": len(data), "t_rank": t_rank,
            "t_enc": t_enc, "t_dec": t_dec, "t_gather": t_gather,
            "gbps": 2 * len(data) / (t_enc + t_dec) / 1e9, "verified": bool(ok)}


def run_multiprocess(n_procs, bytes_per_host=8 << 20):
    """TRUE weak scaling: one OS process per host, pinned to its own
    physical core, own XLA runtime, jax.distributed barriers — the
    actual multi-host execution model (the virtual-device mesh times
    the in-process scheduler at N>1, not the codec)."""
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {
        k: v for k, v in os.environ.items()
        if not k.startswith(("JAX_", "XLA_"))
    }
    env.update(
        PYTHONPATH=repo,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                  "intra_op_parallelism_threads=1",
        OMP_NUM_THREADS="1",
    )
    procs = [
        subprocess.Popen(
            ["taskset", "-c", str(pid % (os.cpu_count() or 1)),
             sys.executable, "-m", "redux_tpu.parallel.multihost",
             "--scaling", "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", str(n_procs), "--process-id", str(pid),
             "--bytes-per-host", str(bytes_per_host)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(n_procs)
    ]
    outs = [p.communicate(timeout=1200) for p in procs]
    for p, (o, e) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"scaling worker failed: {e[-2000:]}")
    r = json.loads(outs[0][0].strip().splitlines()[-1])
    r["gbps"] = 2 * r["bytes"] / (r["t_enc"] + r["t_dec"]) / 1e9
    return r


def main():
    ncores = os.cpu_count() or 1

    def sweep(fn, sizes):
        results = [fn(n) for n in sizes if n <= len(jax.devices())]
        per_dev0 = results[0]["gbps"] / results[0]["n_dev"]
        for r in results:
            r["efficiency"] = r["gbps"] / (r["n_dev"] * per_dev0)
            # virtual devices beyond the physical cores time-share them;
            # the honest denominator is the deliverable parallel hardware
            r["efficiency_vs_cores"] = r["gbps"] / (
                min(r["n_dev"], ncores) * per_dev0
            )
        return results

    # >= 5 trials at >= 8 MB/host (round-5 evidence hardening): this is a
    # shared VM with visible steal-time outliers, so the artifact reports
    # the full trial distribution (median/min/max), not one number.
    n_trials = int(os.environ.get("SCALING_TRIALS", "5"))
    trials = []
    for _ in range(n_trials):
        pair = [run_multiprocess(n) for n in (1, 2) if n <= ncores]
        for r in pair:
            r["efficiency"] = (pair[0]["t_enc"] + pair[0]["t_dec"]) / (
                r["t_enc"] + r["t_dec"]
            )
        trials.append(pair)
    trials.sort(key=lambda pr: pr[-1]["efficiency"])
    mp = trials[len(trials) // 2]
    mp_all = sorted(round(pr[-1]["efficiency"], 3) for pr in trials)
    # Virtual sizes beyond the 2 physical cores only measure runtime
    # time-sharing (recorded in round 3); keep the physical range.
    results = sweep(run, (1, 2))
    out = {
        "mode": "weak-scaling; the ONLY scaling evidence here is "
                "multiprocess_*: real multi-process jax.distributed, one "
                "pinned core per host process, %d MB/host, %d trials"
                % ((8 << 20) >> 20, n_trials),
        "note": "host has %d physical cores.  multiprocess_results is the "
                "honest axis: independent OS processes (one per core, own XLA "
                "runtime, jax.distributed barriers + ordered gather) — the "
                "real multi-host execution model; efficiency = t(1)/t(N) at "
                "fixed bytes/host." % ncores,
        "physical_cores": ncores,
        "multiprocess_results": mp,
        "multiprocess_efficiency_n2": mp[-1]["efficiency"] if len(mp) > 1 else None,
        "multiprocess_trial_efficiencies": mp_all,
        "multiprocess_efficiency_median": mp_all[len(mp_all) // 2],
        "multiprocess_efficiency_min": mp_all[0],
        "multiprocess_efficiency_max": mp_all[-1],
        # Phase-level data from the in-process virtual mesh — NOT scaling
        # evidence: all N share one runtime and even N=2 pays in-process
        # scheduler + cache contention that real pods do not.
        "not_scaling_evidence": {
            "why": "virtual CPU mesh shares one runtime/scheduler across "
                   "shards; kept only for per-phase composition data",
            "bytes_per_device": results[0]["bytes"] // results[0]["n_dev"],
            "results": results,
        },
    }
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "SCALING.json",
    )
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
