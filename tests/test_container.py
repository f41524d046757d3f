"""RXT1 container format and high-level encode/decode API tests."""

import numpy as np
import pytest

from redux_tpu import api, container
from redux_tpu.errors import InvalidInputError
from redux_tpu.params import Parameters

from conftest import corpus_file


@pytest.mark.parametrize("block_size", [512, 4096])
def test_roundtrip_corpus_file(block_size):
    data = corpus_file("calgary", "paper5").read_bytes()
    arc = api.encode(data, block_size=block_size)
    assert api.decode(arc) == data


def test_roundtrip_degenerate_inputs():
    for data in [b"", b"x", b"a" * 10000, bytes(range(256)) * 8]:
        arc = api.encode(data, block_size=1024)
        assert api.decode(arc) == data


def test_roundtrip_incompressible():
    data = np.random.default_rng(0).integers(0, 256, 8192, dtype=np.uint8).tobytes()
    arc = api.encode(data, block_size=2048)
    assert api.decode(arc) == data


def test_roundtrip_tpu32_params():
    data = corpus_file("calgary", "paper4").read_bytes()
    arc = api.encode(data, params=Parameters.tpu32(), block_size=2048)
    assert api.decode(arc) == data


def test_prior_improves_payload():
    # With the production adaptation increment (delta=16) the model
    # re-learns fast, so the warm-start prior pays off against small
    # blocks / larger inputs (at 32 KiB blocks the break-even is ~1 MB).
    data = corpus_file("calgary", "book1").read_bytes()[:200000]
    with_prior = api.encode(data, block_size=4096, use_prior=True)
    without = api.encode(data, block_size=4096, use_prior=False)
    # Prior must shrink the payload by more than the 512-byte table on
    # ordinary text at this size.
    assert len(with_prior) < len(without)
    assert api.decode(with_prior) == data
    assert api.decode(without) == data


def test_header_parse_and_fields():
    data = b"hello world " * 400
    arc = api.encode(data, block_size=1024)
    header, streams = container.parse_archive(arc)
    assert header.orig_len == len(data)
    assert header.block_size == 1024
    assert header.n_blocks == len(streams) == (len(data) + 1023) // 1024
    assert sum(header.block_lens) == len(data)
    assert container.is_rxt_archive(arc)


def test_corrupt_archives_rejected():
    data = b"payload payload payload" * 100
    arc = api.encode(data, block_size=512)
    with pytest.raises(InvalidInputError):
        container.parse_archive(b"NOPE" + arc[4:])
    with pytest.raises(InvalidInputError):
        container.parse_archive(arc[:20])  # truncated header
    with pytest.raises(InvalidInputError):
        container.parse_archive(arc[:-5])  # truncated payload


def test_decode_auto_dispatch():
    from redux_tpu.oracle import compress_bytes

    data = b"auto-detect me " * 50
    arc = api.encode(data, block_size=512)
    ref = compress_bytes(data)
    assert api.decode_auto(arc) == data
    assert api.decode_auto(ref) == data  # bare reference-format stream


def test_raw_blocks_incompressible():
    """Adversarial (random) data: blocks store raw — archive stays ~input
    size + header instead of expanding, and round-trips bit-exactly."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    arch = api.encode(data, block_size=16384)
    header, streams = container.parse_archive(arch)
    assert any(header.block_raw), "random blocks should be stored raw"
    # raw storage bounds the archive near the input size
    assert len(arch) <= len(data) + 64 + 4 * header.n_blocks + 512
    assert api.decode(arch) == data


def test_raw_blocks_mixed_with_coded():
    """Compressible and incompressible blocks in one archive."""
    rng = np.random.default_rng(8)
    data = (
        b"a" * 16384
        + rng.integers(0, 256, 16384, dtype=np.uint8).tobytes()
        + b"hello world " * 1400
    )
    arch = api.encode(data, block_size=16384)
    header, _ = container.parse_archive(arch)
    assert any(header.block_raw) and not all(header.block_raw)
    assert api.decode(arch) == data


def _kernel_coder(monkeypatch):
    """Route the api to the GPU coder kernels, in interpret mode."""
    from redux_tpu.ops import backend
    kc = backend.KernelCoder(interpret=True)
    monkeypatch.setattr(backend, "select", lambda params: kc)
    return kc


def test_api_pallas_branch_roundtrip(monkeypatch):
    """The api's GPU branch (the coder kernels) via interpret mode on the
    CPU: lane sorting, raw splice, crc — all exercised, and the archive
    is byte-identical to the XLA branch's."""
    rng = np.random.default_rng(11)
    data = (
        corpus_file("calgary", "paper5").read_bytes()[:6000]
        + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()  # raw block mix
        + b"tail" * 700
    )
    want = api.encode(data, block_size=2048)
    _kernel_coder(monkeypatch)
    arch = api.encode(data, block_size=2048)
    assert arch == want
    assert api.decode(arch) == data


def test_api_pallas_decode_lane_chunking(monkeypatch):
    """Decode-side lane chunking (large-archive path) on the interpreter.

    Forces the single-device kernel branch with the minimum chunk (one
    lane quantum) so a ~300-block archive decodes across many dispatches:
    per-chunk word capacities, the sorted-lane slab boundaries, the
    all-raw slab skip, and the chunk reassembly all run.
    """
    _kernel_coder(monkeypatch)
    monkeypatch.setattr(api, "_DEC_CHUNK_BYTES", 0)  # floor: one quantum
    monkeypatch.setattr(api, "_dp_mesh", lambda: None)
    rng = np.random.default_rng(23)
    data = (
        (corpus_file("calgary", "paper5").read_bytes() * 10)[:100_000]
        + rng.integers(0, 256, 30_000, dtype=np.uint8).tobytes()  # raw mix
        + b"tail" * 4000
    )
    arch = api.encode(data, block_size=512)
    header, _ = container.parse_archive(arch)
    assert header.n_blocks > 256 and any(header.block_raw)
    assert api.decode(arch) == data


def test_coders_say_what_the_rank_stage_owes_them():
    """The XLA scan reads the running totals, the kernel computes them; an
    interpreted kernel is a different jit key from the compiled one."""
    from redux_tpu.ops import backend

    assert backend.XLA.with_tot and not backend.TRITON.with_tot
    assert backend.XLA.lane_quantum == 1
    kc = backend.KernelCoder(interpret=True)
    assert kc != backend.TRITON and kc.lane_quantum == backend.TRITON.lane_quantum
    assert backend.XLA != backend.TRITON
    assert len({backend.XLA, backend.TRITON, kc}) == 3


def test_chunk_sizes_follow_the_device_budget():
    """Each direction's chunk is the largest power of two whose measured
    device working set fits the budget."""
    for chunk, per_byte in ((api._ENC_CHUNK_BYTES, api._ENC_DEVICE_BYTES_PER_BYTE),
                            (api._DEC_CHUNK_BYTES, api._DEC_DEVICE_BYTES_PER_BYTE)):
        assert chunk & (chunk - 1) == 0
        assert chunk * per_byte <= api._CHUNK_DEVICE_BYTES < 2 * chunk * per_byte
    # Whole 4 KiB blocks and whole lane tiles on four cards per chunk.
    assert api._ENC_CHUNK_BYTES % (4096 * api._BLOCK_QUANTUM) == 0


def test_selector_picks_the_coder_per_backend(monkeypatch):
    """One selector: the CPU runs the XLA scans, the GPU the kernels (XLA
    for configs the kernels do not take), any other backend is an error."""
    import jax as _jax

    from redux_tpu.ops import backend

    wide = Parameters.tpu_wide()
    assert backend.select(wide, "cpu") is backend.XLA
    assert backend.select(wide, "gpu") is backend.TRITON
    assert backend.select(Parameters.default(), "gpu") is backend.XLA
    with pytest.raises(RuntimeError):
        backend.select(wide, "metal")
    monkeypatch.setattr(_jax, "default_backend", lambda: "gpu")
    assert backend.select(wide) is backend.TRITON
    monkeypatch.setattr(_jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError):
        api.encode(b"x" * 5000)


def test_lane_padding_follows_the_coder_quantum():
    from redux_tpu.ops.triton_coder import TB

    assert api._pad_lanes(1) == 4 and api._pad_lanes(100) == 128
    assert api._pad_lanes(129) == 256
    assert api._pad_lanes(1, TB) == TB
    assert api._pad_lanes(300, 4 * TB) % (4 * TB) == 0
    assert api._pad_lanes(300, 8) == 384
    # Auto block sizes: 256-aligned, >= 1024, block count just under a
    # multiple of the fixed quantum — the same on every backend.
    n = 10_000_000
    k = api._auto_block_size(n)
    assert k % 256 == 0 and k >= 1024
    assert -(-n // k) <= -(-(-(-n // 4096)) // api._BLOCK_QUANTUM) * api._BLOCK_QUANTUM


def test_compact_orig_len_dos_bound():
    """A crafted tiny compact archive cannot claim an absurd orig_len.

    Round-3 advisor: a ~6-byte input claiming a multi-exabyte orig_len
    reached np.empty(orig_len) / an unbounded decode loop before any CRC
    check.  parse_compact now bounds orig_len by the information-theoretic
    maximum the payload could encode (container.max_decoded_len)."""
    # varint for 2**62: 9 bytes of 0x80|.. + terminator
    huge = container._varint(1 << 62)
    arc = bytes([container.COMPACT_MAGIC, (container.COMPACT_VERSION << 4) | 4])
    arc += huge + b"\x00\x00" + b"\xab"  # crc16 + 1 payload byte
    with pytest.raises(InvalidInputError):
        container.parse_compact(arc)
    # decode_auto must also reject it (not attempt the allocation).
    with pytest.raises(InvalidInputError):
        api.decode_compact(arc)


def test_compact_orig_len_bound_admits_extreme_compression():
    """The DoS bound must not reject legitimately extreme archives:
    1 MiB of zeros compresses to a handful of payload bytes."""
    data = b"\x00" * (1 << 20)
    arc = api.encode_compact(data, 4)
    assert len(arc) < 600
    assert api.decode_compact(arc) == data


def test_archive_orig_len_dos_bound():
    """Same cap for the block container: header orig_len is bounded by
    what the payload bytes could possibly decode to."""
    arc = bytearray(api.encode(b"hello world" * 100, block_size=4096))
    header, _ = container.parse_archive(bytes(arc))
    assert header.n_blocks == 1
    # Keep n_blocks = 1 consistent (expect_blocks check) but claim a
    # 2 GiB block_size and orig_len from a ~100-byte payload.
    import struct as _s

    _s.pack_into("<I", arc, 12, 1 << 31)  # block_size
    _s.pack_into("<Q", arc, 16, 1 << 31)  # orig_len
    with pytest.raises(InvalidInputError):
        container.parse_archive(bytes(arc))


def test_archive_rejects_non_byte_symbols():
    """The container is byte-only by design (symbol_bits = 8): crafted
    headers with other widths are rejected up front (the kernels' dense
    model rows are sized for the 257-symbol alphabet)."""
    arc = bytearray(api.encode(b"abc" * 500))
    arc[6] = 12  # symbol_bits field
    with pytest.raises(InvalidInputError):
        container.parse_archive(bytes(arc))


def test_encode_auto_structural_size_contract():
    """In the compact range the reference-format stream itself is a
    candidate (when the native coder is present), so encode_auto output
    is structurally <= the reference stream size."""
    pytest.importorskip("redux_tpu.native")
    from redux_tpu import native

    rng = np.random.default_rng(21)
    # Incompressible data where compact framing overhead could otherwise
    # exceed the bare reference stream.
    for n in (1, 7, 64, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        auto = api.encode_auto(data)
        ref = native.compress_bytes(data, Parameters.default())
        assert len(auto) <= len(ref), (n, len(auto), len(ref))
        assert api.decode_auto(auto) == data


def test_chunked_encode_matches_single_dispatch(monkeypatch):
    """Lane-chunked encode (large-input path: bounded rank planes per
    kernel dispatch) must produce archives that decode identically —
    forced here with a tiny chunk budget so 3 chunks cover the input,
    including a stored-raw block in the middle chunk."""
    rng = np.random.default_rng(3)
    base = corpus_file("calgary", "paper5").read_bytes()
    data = (
        base[:40000]
        + rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()  # raw blocks
        + base[40000:80000]
    )
    single = api.encode(data, block_size=256)
    monkeypatch.setattr(api, "_ENC_CHUNK_BYTES", 128 * 256)
    chunked = api.encode(data, block_size=256)
    # The wire bytes are identical (chunking is invisible), and decode.
    assert chunked == single
    assert api.decode(chunked) == data
