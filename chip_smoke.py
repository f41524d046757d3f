"""Smoke test of the block codec on one NVIDIA GPU (or four, see below).

    python chip_smoke.py                      # one card
    python chip_smoke.py --four-cards [--expect-sha256 HEX]

Phases, in order; any failure exits non-zero and no phase carries on past
an error:

1. Device: JAX's backend must be a GPU.  Prints ``device_kind``, the
   device count and ``nvidia-smi``'s name and power limit.
2. Kernels vs references at real widths: ~2,600 blocks of 4 KiB, 10 MB
   of ``corpus.mixed`` and 16 blocks of every data class of
   ``corpus.CLASSES`` (incompressible and constant ones included).  The
   Pallas encode and decode kernels must equal the XLA scans on every
   block and the native C++ twin on sampled blocks of every class.
3. Main path: ``api.encode`` -> ``api.decode`` of two encode chunks of
   ``corpus.mixed`` (256 MiB), byte-exact with the crc verified; prints
   the ratio, the archive's sha256 and peak device memory.  Then 16 MiB
   through ``cli.main`` (``-c`` and ``-d``, in-process: a second JAX
   process would not find the card's memory free), and 4 MiB with the
   CLI's default parameters.
4. Timing: each kernel against the XLA scan it replaces and the rank
   stage, device-resident, after warm-up; ms per stage, and the compiled
   memory analysis of the rank stage and the decode kernel at one chunk.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

``--four-cards`` runs phase 3 alone on four cards (the api shards lanes
over all of them), checks sampled blocks against the native twin, checks
that the coder outputs are partitioned across all four devices, and (with
``--expect-sha256``) that the archive equals the one-card run's.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

K = 4096  # the shipped block size
DELTA = 16  # the shipped adaptation increment
CLI_BYTES = 16 << 20
KERNEL_BYTES = 10_000_000


def log(*args):
    print(*args, flush=True)


def device_info(expect_count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's devices are {devs}")
    if len(devs) != expect_count:
        raise SystemExit(f"expected {expect_count} GPU(s), found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"device_kind: {devs[0].device_kind}; devices: {len(devs)}")
    log(f"nvidia-smi: {smi}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def _prior(data, params):
    """The api's warm-start prior and initial cumulative row for ``data``."""
    import numpy as np

    from redux_tpu import api
    from redux_tpu.container import DEFAULT_PRIOR_BUDGET
    from redux_tpu.models.dense import quantize_prior

    hist = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    budget = min(DEFAULT_PRIOR_BUDGET, params.freq_max // 2)
    prior = quantize_prior(hist, params, budget)[:256]
    return prior, api._init_cum(params, prior)


def sample_blocks(segments, k: int, required, per_class: int = 3):
    """Indices of ``k``-byte blocks lying wholly inside a segment
    (``corpus.mixed_segments``' tuples), ``per_class`` of each data class;
    every class in ``required`` must have some."""
    picked = {}
    for _, cls, start, size, _ in segments:
        first = -(-start // k)
        last = (start + size) // k  # exclusive
        for b in range(first, min(last, first + per_class)):
            if len(picked.setdefault(cls, [])) < per_class:
                picked[cls].append(b)
    missing = set(required) - {c for c, idx in picked.items() if idx}
    if missing:
        raise AssertionError(f"no sampled blocks of {missing}")
    return picked


def kernel_input(n_bytes: int, seed: int, per_class: int = 16):
    """Whole blocks of ``corpus.mixed(n_bytes, seed)``, then ``per_class``
    blocks of every class of ``corpus.CLASSES``: the incompressible class,
    which no reference file holds, and the artificial files, which a 10 MB
    prefix of the mix may lack, get blocks too.  Returns (data, segments)."""
    from redux_tpu import corpus

    n = n_bytes // K * K
    segs = list(corpus.mixed_segments(n, seed))
    parts = [corpus.mixed(n, seed)]
    for i, (cls, make) in enumerate(corpus.CLASSES.items()):
        segs.append((cls, cls, n + i * per_class * K, per_class * K, seed + i))
        parts.append(make(per_class * K, seed + i))
    return b"".join(parts), segs


def check_native(data: bytes, picked, params, prior, streams, decoded):
    """Sampled blocks against the native C++ twin: encoded streams
    (``streams[b]``, full or cut at the kernel's word buffer) and decoded
    symbols (``decoded[b]``; None to skip)."""
    from redux_tpu import native

    native.get_lib()  # the C++ twin, never the Python fallback
    n = 0
    for cls, idx in picked.items():
        for b in idx:
            blk = data[b * K : (b + 1) * K]
            ref = native.compress_block_v2(blk, params, prior, DELTA)
            got, full_len = streams(b)
            assert full_len == len(ref), (cls, b, full_len, len(ref))
            assert got == ref[: len(got)], (cls, b)
            assert native.decompress_block_v2(ref, K, params, prior, DELTA) == blk
            if decoded is not None and decoded(b) is not None:
                assert decoded(b) == blk, (cls, b)
            n += 1
    return n


def check_kernels(n_bytes: int = KERNEL_BYTES, seed: int = 1):
    """Phase 2: kernels vs the XLA scans (all blocks) and the native twin."""
    import jax.numpy as jnp
    import numpy as np

    from redux_tpu import corpus
    from redux_tpu.ops import coder, triton_coder
    from redux_tpu.ops.ranks import precompute_encode_model
    from redux_tpu.params import Parameters

    params = Parameters.tpu_wide()
    data, segs = kernel_input(n_bytes, seed)
    b = len(data) // K
    prior, ic = _prior(data, params)
    syms = jnp.asarray(np.frombuffer(data, np.uint8).reshape(b, K))
    lens = jnp.full((b,), K, jnp.int32)
    icj = jnp.asarray(ic)
    n_words = K // 4 + 16  # the api's per-lane capacity
    lo, hi, tot, _, _, _ = precompute_encode_model(
        syms, lens, icj, params.freq_max, delta=DELTA
    )
    wk, bk, ok = triton_coder.encode_blocks(lo, hi, lens, icj[-1], params,
                                            n_words, DELTA)
    wx, bx, ox = coder.encode_blocks_v2(lo, hi, tot, lens, params, n_words)
    wk, bk, ok = np.asarray(wk), np.asarray(bk), np.asarray(ok)
    wx, bx, ox = np.asarray(wx), np.asarray(bx), np.asarray(ox)
    assert (bk == bx).all() and (ok == ox).all(), "encode lengths/ovf differ"
    nbytes = np.minimum(bx, 4 * n_words)
    kb = wk.astype(">u4").view(np.uint8).reshape(b, -1)
    xb = wx.astype(">u4").view(np.uint8).reshape(b, -1)
    used = np.arange(4 * n_words)[None, :] < nbytes[:, None]
    assert (np.where(used, kb, 0) == np.where(used, xb, 0)).all(), "encode words differ"

    coded = (bx <= 4 * n_words) & ~ox  # the rest the api stores raw
    words = jnp.pad(jnp.asarray(wx), ((0, 0), (0, 2)))  # zero past each stream
    dlens = jnp.asarray(np.where(coded, K, 0).astype(np.int32))
    dk = np.asarray(triton_coder.decode_blocks(words, dlens, icj, params, K, DELTA))
    dx = np.asarray(coder.decode_blocks(words, dlens, icj, params, K, delta=DELTA))
    assert (dk == dx).all(), "decode differs from the XLA scan"
    src = np.frombuffer(data, np.uint8).reshape(b, K)
    assert (dk[coded] == src[coded]).all(), "decode differs from the input"

    picked = sample_blocks(segs, K, corpus.CLASSES)
    n = check_native(
        data, picked, params, prior,
        lambda i: (kb[i, : nbytes[i]].tobytes(), int(bk[i])),
        lambda i: dk[i].tobytes() if coded[i] else None,
    )
    log(f"kernels: {b} blocks of {K} B equal the XLA scans "
        f"({int(coded.sum())} coded, {int((~coded).sum())} raw-bound); "
        f"{n} sampled blocks of {len(picked)} classes equal the native twin")


def _dp_sharding_check():
    """The sharded coders' outputs span every device (one small chunk)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from redux_tpu import corpus
    from redux_tpu.ops import backend
    from redux_tpu.params import Parameters
    from redux_tpu.parallel.mesh import (
        data_parallel_mesh,
        decode_blocks_sharded,
        encode_symbols_sharded,
    )

    params = Parameters.tpu_wide()
    mesh = data_parallel_mesh()
    kc = backend.select(params)
    nd = mesh.devices.size
    b = kc.lane_quantum * nd
    data = corpus.mixed(b * K, 7)
    prior, ic = _prior(data, params)
    syms = jnp.asarray(np.frombuffer(data, np.uint8).reshape(b, K))
    lens = jnp.full((b,), K, jnp.int32)
    w, bl, _ = encode_symbols_sharded(syms, lens, jnp.asarray(ic), params,
                                      K // 4 + 16, mesh, DELTA, kc)
    d = decode_blocks_sharded(jnp.pad(w, ((0, 0), (0, 2))), lens,
                              jnp.asarray(ic), params, K, mesh, DELTA, kc)
    for name, x in (("encode", w), ("decode", d)):
        n = len(x.sharding.device_set)
        assert n == nd == len(jax.devices()), f"{name} output on {n} devices"
    log(f"sharding: {kc.name} coder outputs partitioned over {nd} devices")


def main_path(cli_bytes: int = CLI_BYTES, seed: int = 1, expect_sha256=None,
              with_cli: bool = True):
    """Phase 3: api round trip of two encode chunks and a CLI round trip."""
    import numpy as np

    from redux_tpu import api, cli, container, corpus

    n_bytes = 2 * api._ENC_CHUNK_BYTES
    data = corpus.mixed(n_bytes, seed)
    te, td = {}, {}
    t0 = time.perf_counter()
    arc = api.encode(data, _timings=te)
    t1 = time.perf_counter()
    out = api.decode(arc, _timings=td)  # verifies the stored crc32
    t2 = time.perf_counter()
    assert out == data, "api round trip differs"
    header, _ = container.parse_archive(arc, with_streams=False)
    k = header.block_size
    chunks_e = -(-header.n_blocks // (api._ENC_CHUNK_BYTES // k))
    chunks_d = -(-header.n_blocks // (api._DEC_CHUNK_BYTES // k))
    assert chunks_e >= 2, chunks_e
    sha = hashlib.sha256(arc).hexdigest()
    peak = peak_bytes_in_use()
    n_raw = int(np.sum(header.block_raw)) if header.block_raw else 0
    log(f"api: {n_bytes} B -> {len(arc)} B, ratio {n_bytes / len(arc):.4f}; "
        f"{header.n_blocks} blocks of {k} B ({n_raw} stored raw), "
        f"{chunks_e} encode / {chunks_d} decode chunks; "
        f"encode {t1 - t0:.3f} s, decode {t2 - t1:.3f} s (host clock, first call)")
    log("api stages (s): encode " + ", ".join(f"{k} {v:.3f}" for k, v in te.items())
        + "; decode " + ", ".join(f"{k} {v:.3f}" for k, v in td.items()))
    log(f"archive sha256: {sha}")
    log(f"peak_bytes_in_use: {peak}")
    if expect_sha256 is not None:
        assert sha == expect_sha256, f"archive sha256 {sha} != {expect_sha256}"

    # Sampled blocks of the archive against the native twin.
    _, streams = container.parse_archive(arc)
    prior = header.prior_extra
    raw = header.block_raw or [False] * header.n_blocks
    segs = corpus.mixed_segments(n_bytes, seed)
    picked = sample_blocks(segs, k, {cls for _, cls, _, size, _ in segs if size >= 2 * k})
    n = 0
    from redux_tpu import native

    native.get_lib()
    for cls, idx in picked.items():
        for b in idx:
            blk = data[b * k : (b + 1) * k]
            if raw[b]:
                assert streams[b] == blk, (cls, b)
            else:
                ref = native.compress_block_v2(blk, header.params, prior, header.delta)
                assert streams[b] == ref, (cls, b)
            n += 1
    log(f"archive: {n} sampled blocks of {len(picked)} classes equal the "
        f"native twin's streams (raw blocks verbatim)")

    if with_cli:
        with tempfile.TemporaryDirectory() as tmp:
            src, comp, back = (os.path.join(tmp, n) for n in ("in", "in.rxt", "out"))
            # The shipped config runs the kernels; the CLI's own default,
            # the reference's (8, 30, 32), runs the XLA scans on the GPU.
            for size, extra in ((cli_bytes, ["--params", "8,20,22"]), (cli_bytes // 4, [])):
                with open(src, "wb") as f:
                    f.write(data[:size])
                assert cli.main(["-c", "-i", src, "-o", comp, *extra]) == 0
                assert cli.main(["-d", "-i", comp, "-o", back]) == 0
                subprocess.run(["cmp", src, back], check=True)
                log(f"cli {' '.join(extra) or '(default params)'}: {size} B round trip, "
                    f"{os.path.getsize(comp)} B archive, cmp equal")
    return sha


def peak_bytes_in_use() -> int:
    import jax

    return max(d.memory_stats()["peak_bytes_in_use"] for d in jax.devices())


def _timed(f, n=5):
    import jax

    jax.block_until_ready(f())  # warm-up (compile)
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        ts.append(time.perf_counter() - t0)
    return min(ts)


def time_stages(seed: int = 1):
    """Phase 4: kernel vs XLA per stage, device-resident, ms (min of 5;
    the XLA scans min of 3)."""
    import jax.numpy as jnp
    import numpy as np

    from redux_tpu import api, corpus
    from redux_tpu.ops import backend, triton_coder
    from redux_tpu.params import Parameters

    params = Parameters.tpu_wide()
    kc, xc = backend.TRITON, backend.XLA
    n_words = K // 4 + 16
    chunk = api._ENC_CHUNK_BYTES
    for n_bytes in (KERNEL_BYTES, chunk):
        data = corpus.mixed(n_bytes, seed)
        b = len(data) // K
        data = data[: b * K]
        _, ic = _prior(data, params)
        icj = jnp.asarray(ic)
        syms = jnp.asarray(np.frombuffer(data, np.uint8).reshape(b, K))
        lens = jnp.full((b,), K, jnp.int32)

        def ranks(c):
            return backend.ranks(syms, lens, icj, params, DELTA, c.with_tot)

        pk, px = ranks(kc), ranks(xc)
        t_rk = _timed(lambda: ranks(kc))
        t_rx = _timed(lambda: ranks(xc))
        t_ek = _timed(lambda: kc.code(pk, lens, icj, params, n_words, DELTA))
        t_ex = _timed(lambda: xc.code(px, lens, icj, params, n_words, DELTA), n=3)
        w, bl, ov = kc.code(pk, lens, icj, params, n_words, DELTA)
        w = jnp.pad(w, ((0, 0), (0, 2)))
        dl = jnp.where((bl <= 4 * n_words) & ~ov, K, 0).astype(jnp.int32)
        t_dk = _timed(lambda: kc.decode(w, dl, icj, params, K, DELTA))
        t_dx = _timed(lambda: xc.decode(w, dl, icj, params, K, DELTA), n=3)
        mb = b * K / 1e6
        log(f"timing {b} blocks ({mb:.1f} MB): rank {t_rk * 1e3:.3f} ms "
            f"(with totals, for the XLA coder: {t_rx * 1e3:.3f} ms); "
            f"encode kernel {t_ek * 1e3:.3f} ms vs XLA {t_ex * 1e3:.3f} ms; "
            f"decode kernel {t_dk * 1e3:.3f} ms vs XLA {t_dx * 1e3:.3f} ms")
        if n_bytes != chunk:
            continue
        n_in = b * K
        for c in (kc, xc):
            m = backend.ranks.lower(syms, lens, icj, params, DELTA,
                                    c.with_tot).compile().memory_analysis()
            tot = m.argument_size_in_bytes + m.temp_size_in_bytes + m.output_size_in_bytes
            log(f"rank stage for the {c.name} coder at one {chunk >> 20} MiB chunk: "
                f"argument {m.argument_size_in_bytes} B, temp {m.temp_size_in_bytes} B, "
                f"output {m.output_size_in_bytes} B; {tot / n_in:.2f} B per input byte")
        m = triton_coder.decode_blocks.lower(
            w, dl, icj, params, K, DELTA).compile().memory_analysis()
        staged = w.size * w.dtype.itemsize  # the u8 staging matrix
        tot = staged + m.argument_size_in_bytes + m.temp_size_in_bytes + m.output_size_in_bytes
        log(f"decode kernel at one {n_in >> 20} MiB chunk: argument "
            f"{m.argument_size_in_bytes} B, temp {m.temp_size_in_bytes} B, output "
            f"{m.output_size_in_bytes} B, staged stream bytes {staged} B; "
            f"{tot / n_in:.2f} B per decoded byte")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run the main path alone on four cards")
    ap.add_argument("--expect-sha256", default=None,
                    help="archive sha256 the main path must give (the one-card run's)")
    args = ap.parse_args(argv)

    import redux_tpu  # noqa: F401  (x64, compile cache)

    count = 4 if args.four_cards else 1
    device = device_info(count)
    if args.four_cards:
        main_path(expect_sha256=args.expect_sha256, with_cli=False)
        _dp_sharding_check()
    else:
        check_kernels()
        log(f"peak_bytes_in_use after the kernel checks: {peak_bytes_in_use()}")
        main_path(expect_sha256=args.expect_sha256)
        time_stages()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
