"""Benchmark: encode + decode throughput of the block codec on one GPU.

    python bench.py [--bytes N] [--seed S]

Input: ``redux_tpu.corpus.mixed(N, S)``, seeded stand-ins of the reference
corpora's files (default: one round, the corpora's 18.5 MB, so every class
has its byte share there).  Timing
is device-resident (see ``redux_tpu.bench``); end-to-end api times are
reported beside it.  Prints ONE JSON line, which names the device; exits
non-zero when JAX finds no GPU.
"""

import argparse
import json
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bytes", type=int, default=None,
                    help="input bytes (default: corpus.ROUND_BYTES)")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import jax

    import redux_tpu  # noqa: F401  (x64, compile cache)
    from redux_tpu import corpus
    from redux_tpu.bench import run_device_benchmark

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {jax.devices()}", file=sys.stderr)
        return 1
    r = run_device_benchmark(corpus.mixed(args.bytes or corpus.ROUND_BYTES, args.seed))
    print(
        f"encode {r['encode_gbps']:.3f} GB/s, decode {r['decode_gbps']:.3f} GB/s "
        f"(device-resident, {r['coder']} coder); e2e {r['encode_e2e_gbps']:.3f}"
        f"/{r['decode_e2e_gbps']:.3f} GB/s; ratio {r['ratio']:.4f}; "
        f"verified={r['verified']}; {r['device']}",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "mixed-corpus aggregate encode+decode throughput (device-resident)",
        "value": round(r["aggregate_gbps"], 4),
        "unit": "GB/s",
        "device": r["device"],
        "ratio": round(r["ratio"], 4),
        "verified": r["verified"],
    }))
    return 0 if r["verified"] else 1


if __name__ == "__main__":
    sys.exit(main())
