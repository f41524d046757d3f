"""Size-contract study: RXT-only candidates vs reference size, per file.

For every calgary/canterbury file (seeded stand-ins, redux_tpu.corpus),
compares the reference stream size
((8,30,32) uniform Fenwick — what `redux -c` emits, main.rs:108) against
RXT v2 archive sizes for candidate configs, using the sequential oracle
(bit-identical to the device coders) so it runs on CPU.

Usage: JAX_PLATFORMS=cpu python scripts/contract_study.py [--quick]
Writes results to contract_study.json in the working directory.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from redux_tpu import corpus, native, oracle
from redux_tpu.models.dense import prior_init_cum, quantize_prior, uniform_init_cum
from redux_tpu.params import Parameters

REF_P = Parameters.default()
WIDE_P = Parameters.tpu_wide()


def rxt_size(data, block_size, delta, use_prior, budget=1 << 17):
    """Exact RXT v2 archive size via the oracle coder."""
    n_blocks = (len(data) + block_size - 1) // block_size
    prior_extra = None
    ic = uniform_init_cum(WIDE_P).astype(np.int64)
    header = 32 + 4 * n_blocks
    if use_prior:
        hist = np.bincount(np.frombuffer(data, dtype=np.uint8), minlength=256)
        b = min(budget, WIDE_P.freq_max // 2)
        prior_extra = quantize_prior(hist, WIDE_P, b)[:256]
        if prior_extra.max(initial=0) > 0:
            full = np.zeros(WIDE_P.symbol_count, dtype=np.int64)
            full[:256] = prior_extra
            ic = prior_init_cum(full, WIDE_P).astype(np.int64)
            header += 512
    total = header
    for i in range(n_blocks):
        blk = data[i * block_size : (i + 1) * block_size]
        total += min(len(blk), len(oracle.compress_block(blk, WIDE_P, ic, delta)))
    return total


def main():
    files = [
        (c, name) for c in ("calgary", "canterbury")
        for name in sorted(corpus.REFERENCE_FILES[c])
    ]
    if "--quick" in sys.argv:
        files = [f for f in files if corpus.REFERENCE_FILES[f[0]][f[1]][1] < 200_000]
    out = {}
    for c, name in files:
        data = corpus.reference_file(c, name)
        ref = len(native.compress_bytes(data, REF_P))
        cands = {
            "32k_prior": rxt_size(data, 1 << 15, 16, True),
            "8k_prior": rxt_size(data, 1 << 13, 16, True),
        }
        if len(data) <= (1 << 19):
            cands["1blk_prior"] = rxt_size(data, max(len(data), 1), 16, True)
            cands["1blk_uniform"] = rxt_size(data, max(len(data), 1), 16, False)
            cands["1blk_prior_d32"] = rxt_size(data, max(len(data), 1), 32, True)
        best_k, best = min(cands.items(), key=lambda kv: kv[1])
        verdict = "WIN" if best <= ref else f"LOSE+{best - ref}"
        print(f"{c}/{name}: ref={ref} best={best} ({best_k}) {verdict} "
              f"{ {k: v - ref for k, v in cands.items()} }", flush=True)
        out[f"{c}/{name}"] = {"ref": ref, **cands}
    with open("contract_study.json", "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
