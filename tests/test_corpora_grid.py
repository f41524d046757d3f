"""Corpus round-trip integration grid — the port of tests/corpora.rs.

The reference runs every corpus x {Linear, Tree} x freq bits {14, 22, 30}
(code = freq + 2), asserting bit-exact round-trips and byte-count
consistency while printing ratio and MiB/s (tests/corpora.rs:24-41,
87-259).  This tier mirrors it for the block-parallel pipeline:

* seeded stand-ins for the corpora (:mod:`redux_tpu.corpus`) x configs
  through the block-parallel api (XLA scans on the CPU, the coder kernels
  on the GPU — bit-identical by the differential tiers);
* round-trip bit-exactness and container length consistency;
* per-corpus ratio + MiB/s printed (run pytest with -s);
* the artificial/ corpus runs ungated (the reference's debug-build
  subset, corpora.rs:87-115); everything else needs --runslow (the
  analog of the reference's release-build gate).

The size contract (BASELINE.md: compressed <= reference's on Calgary /
Canterbury) is asserted by test_size_contract_vs_reference.
"""

import os
import tempfile
import time

import numpy as np
import pytest

from redux_tpu import api, container
from redux_tpu.params import Parameters

from redux_tpu import corpus

# The reference grid uses freq {14, 22, 30} with code = freq + 2
# (corpora.rs:35).  (8,14,16) and (8,22,24) run through the vectorized
# path; (8,30,32) exceeds the 62-bit product bound only in priors —
# it runs via the int64 XLA path.
GRID_PARAMS = [
    Parameters(8, 14, 16),
    Parameters(8, 22, 24),
    Parameters(8, 30, 32),
    Parameters.tpu_wide(),
]


def _corpus_files(name):
    return [
        (n, corpus.reference_file(name, n))
        for n in sorted(corpus.REFERENCE_FILES[name])
    ]


def _run_corpus(name, params, block_size=32768, delta=8):
    files = _corpus_files(name)
    total_in = total_out = 0
    t_enc = t_dec = 0.0
    corpus_name = name
    for fname, data in files:
        t0 = time.perf_counter()
        arch = api.encode(data, params=params, block_size=block_size, delta=delta)
        t_enc += time.perf_counter() - t0
        # Container length consistency (corpora.rs:40-41's analog: the
        # returned byte counts must equal the actual stream lengths).
        # Header bytes + the per-block payload lengths must tile the
        # archive exactly, and the offset table must agree end-to-end —
        # this FAILS if lens/offsets ever drift from the real payload.
        header, streams = container.parse_archive(arch)
        assert [len(s) for s in streams] == header.block_byte_lens
        head_bytes = (
            container.HEADER_BYTES
            + 4 * header.n_blocks
            + (512 if header.prior_extra is not None else 0)
        )
        assert head_bytes + sum(header.block_byte_lens) == len(arch)
        if header.n_blocks:
            assert header.stream_offs[0] == head_bytes
            assert header.stream_offs[-1] + header.block_byte_lens[-1] == len(arch)
        assert header.orig_len == len(data)
        t0 = time.perf_counter()
        out = api.decode(arch)
        t_dec += time.perf_counter() - t0
        assert out == data, f"{corpus_name}/{fname} round-trip mismatch"
        total_in += len(data)
        total_out += len(arch)
    ratio = total_in / max(1, total_out)
    mibs_e = total_in / max(t_enc, 1e-9) / (1 << 20)
    mibs_d = total_in / max(t_dec, 1e-9) / (1 << 20)
    print(
        f"\n{corpus_name:11s} ({params.symbol_bits},{params.freq_bits},{params.code_bits}) "
        f"d{delta}: AvgRatio {ratio:.3f}  Enc {mibs_e:.1f} MiB/s  Dec {mibs_d:.1f} MiB/s"
    )


# ---- ungated: artificial corpus, every grid config (corpora.rs:87-115) ----


@pytest.mark.parametrize("params", GRID_PARAMS, ids=lambda p: f"f{p.freq_bits}")
def test_artificial_grid(params):
    _run_corpus("artificial", params, block_size=8192, delta=4)


# ---- gated full grid (reference release-build tier, corpora.rs:118-259) ---


@pytest.mark.slow
@pytest.mark.parametrize("corpus", ["calgary", "canterbury", "large", "misc"])
@pytest.mark.parametrize("params", GRID_PARAMS, ids=lambda p: f"f{p.freq_bits}")
def test_corpus_grid(corpus, params):
    _run_corpus(corpus, params)


_REF_SIZE_CACHE = os.path.join(tempfile.gettempdir(), "redux_tpu_ref_sizes.json")


def _reference_sizes(corpora):
    """Per-file reference stream sizes, cached across runs (one native
    pass of the whole corpus set takes ~a minute; sizes are deterministic)."""
    import json

    from redux_tpu import native

    try:
        cache = json.load(open(_REF_SIZE_CACHE))
    except (OSError, ValueError):
        cache = {}
    ref_params = Parameters.default()
    dirty = False
    for c in corpora:
        for name, data in _corpus_files(c):
            key = f"{c}/{name}:{len(data)}"
            if key not in cache:
                cache[key] = len(native.compress_bytes(data, ref_params))
                dirty = True
            yield c, name, data, cache[key]
    if dirty:
        json.dump(cache, open(_REF_SIZE_CACHE, "w"))


@pytest.mark.slow
def test_size_contract_vs_reference():
    """Every encode_auto candidate is an RXT format (block container or
    compact single-block — no reference-format serial fallback since round
    3), and the winner never exceeds the reference's stream size on ANY
    calgary/canterbury/large file; for files > 256 KiB the block-parallel
    container wins on its own (BASELINE.md size target; reference stream =
    the main.rs:108 config)."""
    for cname, name, data, ref in _reference_sizes(("calgary", "canterbury", "large")):
        ours = api.encode_auto(data)
        assert len(ours) <= ref, f"{cname}/{name}: {len(ours)} > reference {ref}"
        # The chosen candidate must be one of OUR formats.
        assert container.is_rxt_archive(ours) or container.is_compact_archive(ours)
        assert api.decode_auto(ours) == data, f"{cname}/{name}: round-trip"
        if len(data) > api._COMPACT_MAX:
            # Beyond the compact range the block-parallel container must
            # win on its own (encode_auto's only candidates there are the
            # container at the default and at 16 KiB blocks).
            rxt = min(
                len(api.encode(data)), len(api.encode(data, block_size=1 << 14))
            )
            assert rxt <= ref, (
                f"{cname}/{name}: block container {rxt} > reference "
                f"{ref} (must win without the compact candidate)"
            )


def test_determinism_same_archive():
    """Same input ⇒ byte-identical archive across runs (the race-detector
    analog of SURVEY §5: XLA + the codec are deterministic)."""
    data = corpus.reference_file("calgary", "paper1")
    a = api.encode(data)
    b = api.encode(data)
    assert a == b
