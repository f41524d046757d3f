"""RXT block-parallel archive format (version 2).

The reference emits one bare stream per file with no framing (lib.rs:102-120)
— inherently sequential to decode.  The redux_tpu container splits input
into fixed-size blocks, each encoded independently with a freshly
initialized model, so encode AND decode are data-parallel across device lanes,
devices, and hosts.

Version 2 (this round) diverges from the reference's per-stream framing
deliberately — the container's stored lengths subsume it:

* **No per-block EOF symbol / drain** (codec.rs:91-99): each payload ends
  with a minimal 2-bit terminator (see redux_tpu.oracle.compress_block),
  saving ~3-5 bytes per block; the decoder stops at the stored count.
* **Adaptation increment ``delta``** generalizes the reference's +1
  (adaptive_tree.rs:86-89): after each block's model reset, larger
  increments re-learn the local distribution faster.
* **crc32 of the original data**: decode verifies it and raises
  InvalidInputError instead of silently returning garbage on corrupt
  payloads (the reference's analog is Error::Eof on truncation,
  bitio/mod.rs:106-108; bit flips were silent there too).

Layout (all integers little-endian):

====== ====== ==========================================================
offset size   field
====== ====== ==========================================================
0      4      magic ``b"RXT1"`` (family tag)
4      1      version (2)
5      1      flags: bit0 = has_prior
6      1      symbol_bits   (Parameters, model/mod.rs:63-81)
7      1      freq_bits
8      1      code_bits
9      1      delta: adaptation increment (>= 1)
10     2      reserved (0)
12     4      block_size: symbols per block
16     8      orig_len: total decoded byte count
24     4      n_blocks
28     4      crc32 (zlib) of the original data
32     4*n    per-block compressed byte lengths
...    512    warm-start prior: 256 x u16 extra counts (if has_prior)
...    —      payload: concatenated per-block streams (byte-aligned)
====== ====== ==========================================================

The warm-start prior is a redux_tpu extension: a quantized global byte
histogram seeds every block's adaptive model (see
:func:`redux_tpu.models.dense.quantize_prior`), recovering the per-block
model-reset cost and beating the reference's cold uniform start.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import List, Optional

import numpy as np

from .errors import InvalidInputError
from .params import Parameters

MAGIC = b"RXT1"
VERSION = 2
FLAG_PRIOR = 1
HEADER_BYTES = 32

# Production configuration (chosen by the measured config studies,
# docs/DESIGN_NOTES.md): (8,20,22) wide-u32 interval math, 4 KiB blocks,
# adaptation increment 16, prior budget 128k counts.  Beats the
# reference's compressed size on every corpus file > 256 KiB; interval
# products stay below 2**42.
DEFAULT_BLOCK_SIZE = 1 << 12  # 4 KiB of symbols per block (round 3: more
# lanes in flight = higher kernel throughput at ~1.5-4% ratio cost vs 32 KiB;
# the warm-start prior absorbs most of the extra model-reset cost, and the
# size contract vs the reference still holds at every file size)
DEFAULT_DELTA = 16
DEFAULT_PRIOR_BUDGET = 1 << 17


RAW_BIT = 1 << 31  # stored-length top bit: block stored raw (uncompressed)


@dataclasses.dataclass(frozen=True)
class ArchiveHeader:
    params: Parameters
    block_size: int
    orig_len: int
    block_byte_lens: List[int]
    prior_extra: Optional[np.ndarray]  # (256,) int64 extra counts, or None
    delta: int = 1
    crc32: int = 0
    # Per-block stored-raw flags: arithmetic coding can expand adversarial
    # data by up to code_bits/8 per symbol; blocks whose coded stream would
    # reach their raw size are stored uncompressed instead (top bit of the
    # stored length).  This also caps the coders' per-lane output
    # buffers at ~block_size bytes.
    block_raw: tuple = ()
    # Absolute archive offset of each block's payload bytes ((n_blocks,)
    # int64) — lets decoders gather payload slices straight from the
    # archive buffer with numpy offset tables instead of per-block
    # Python slicing.
    stream_offs: Optional[np.ndarray] = None

    @property
    def n_blocks(self) -> int:
        return len(self.block_byte_lens)

    @property
    def block_lens(self) -> List[int]:
        """Per-block symbol counts derived from orig_len and block_size."""
        out = []
        remaining = self.orig_len
        for _ in range(self.n_blocks):
            n = min(self.block_size, remaining)
            out.append(n)
            remaining -= n
        return out


def build_archive(
    header_params: Parameters,
    block_size: int,
    orig_len: int,
    block_streams: List[bytes],
    prior_extra: Optional[np.ndarray],
    delta: int = 1,
    crc: int = 0,
    block_raw: Optional[List[bool]] = None,
    payload: Optional[bytes] = None,
    stream_lens: Optional[List[int]] = None,
) -> bytes:
    """Serialize an RXT v2 archive.

    Per-block bytes come either as ``block_streams`` (list form) or as a
    single pre-joined ``payload`` with ``stream_lens`` — the vectorized
    encode path assembles the payload with numpy offset tables and must
    not be forced through a per-block Python list.
    """
    p = header_params
    if not 1 <= delta <= 255:
        raise InvalidInputError()
    if payload is not None:
        if stream_lens is None or sum(stream_lens) != len(payload):
            raise InvalidInputError()
        n_streams = len(stream_lens)
    else:
        stream_lens = [len(s) for s in block_streams]
        n_streams = len(block_streams)
    flags = FLAG_PRIOR if prior_extra is not None else 0
    head = bytearray()
    head += MAGIC
    head += struct.pack(
        "<BBBBBB2x", VERSION, flags, p.symbol_bits, p.freq_bits, p.code_bits, delta
    )
    head += struct.pack("<IQII", block_size, orig_len, n_streams, crc)
    raw = block_raw or [False] * n_streams
    lens = [n | (RAW_BIT if r else 0) for n, r in zip(stream_lens, raw)]
    head += struct.pack(f"<{n_streams}I", *lens)
    if prior_extra is not None:
        if prior_extra.shape != (256,) or prior_extra.max(initial=0) > 0xFFFF:
            raise InvalidInputError()
        head += prior_extra.astype("<u2").tobytes()
    return bytes(head) + (payload if payload is not None else b"".join(block_streams))


def parse_archive(
    archive: bytes, with_streams: bool = True
) -> tuple[ArchiveHeader, Optional[List[bytes]]]:
    """Parse an RXT archive into its header and per-block payload streams.

    ``with_streams=False`` skips materializing the per-block bytes list
    (the vectorized decode path gathers payload slices directly from the
    archive buffer via ``header.stream_offs``)."""
    if len(archive) < HEADER_BYTES or archive[:4] != MAGIC:
        raise InvalidInputError()
    version, flags, sb, fb, cb, delta = struct.unpack_from("<BBBBBB", archive, 4)
    if version != VERSION or delta < 1:
        raise InvalidInputError()
    # The RXT container is byte-oriented BY DESIGN (symbol_bits = 8): the
    # coder kernels' model rows are sized for the 257-symbol alphabet
    # (triton_coder.supports) and encode() rejects other widths up front
    # (see README "Deliberate non-generalities"; generic symbol widths
    # live on the host/oracle path, model/mod.rs:63-71).
    if sb != 8:
        raise InvalidInputError()
    block_size, orig_len, n_blocks, crc = struct.unpack_from("<IQII", archive, 12)
    params = Parameters(sb, fb, cb)
    off = HEADER_BYTES
    if len(archive) < off + 4 * n_blocks:
        raise InvalidInputError()
    packed = struct.unpack_from(f"<{n_blocks}I", archive, off)
    byte_lens = [n & ~RAW_BIT for n in packed]
    block_raw = tuple(bool(n & RAW_BIT) for n in packed)
    off += 4 * n_blocks
    prior = None
    if flags & FLAG_PRIOR:
        if len(archive) < off + 512:
            raise InvalidInputError()
        prior = (
            np.frombuffer(archive, dtype="<u2", count=256, offset=off)
            .astype(np.int64)
            .copy()
        )
        off += 512
    lens_np = np.asarray(byte_lens, dtype=np.int64)
    offs = off + np.cumsum(lens_np) - lens_np  # exclusive prefix (empty-safe)
    total = int(lens_np.sum())
    if len(archive) < off + total:
        raise InvalidInputError()
    off += total
    streams = (
        [archive[o : o + n] for o, n in zip(offs, byte_lens)]
        if with_streams
        else None
    )
    header = ArchiveHeader(
        params, block_size, orig_len, byte_lens, prior, delta, crc, block_raw,
        offs,
    )
    if block_size == 0 and orig_len > 0:
        raise InvalidInputError()
    expect_blocks = (orig_len + block_size - 1) // block_size if orig_len else 0
    if expect_blocks != n_blocks:
        raise InvalidInputError()
    # Untrusted-header sanity: a crafted header cannot demand more decode
    # work/allocation than its payload could possibly encode (raw blocks
    # are 1:1; coded blocks are bounded by max_decoded_len) — same DoS cap
    # as parse_compact.
    if orig_len > max_decoded_len(params, sum(byte_lens)) + HEADER_BYTES * 8:
        raise InvalidInputError()
    return header, streams


def verify_crc(header: ArchiveHeader, data: bytes) -> None:
    """Raise InvalidInputError if decoded ``data`` fails the stored crc32."""
    if zlib.crc32(data) & 0xFFFFFFFF != header.crc32:
        raise InvalidInputError()


def compute_crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def is_rxt_archive(data: bytes) -> bool:
    return data[:4] == MAGIC


# ---------------------------------------------------------------------------
# Compact single-block variant ("RXT compact").
#
# The 32-byte container header + 4-byte block length would erase the coding
# win on small inputs (an RXT v2 stream at (8,20,22) beats the reference's
# (8,30,32) stream by only a handful of bytes on high-entropy files).  The
# compact variant frames ONE v2 block payload with a 5-7 byte header:
#
#   [0xB3][ver<<4 | cfg][varint orig_len][crc16][payload]
#
# cfg indexes COMPACT_CONFIGS (params + adaptation delta; uniform init —
# the 512-byte prior never pays at compact sizes).  crc16 is the low half
# of the same zlib crc32 the container stores: 2 bytes buys corruption
# detection while keeping the header inside the measured ~7-byte budget
# that lets the compact archive match or beat the reference stream on
# EVERY corpus file (scripts/contract_study.py).
# ---------------------------------------------------------------------------

COMPACT_MAGIC = 0xB3
COMPACT_VERSION = 1
# (freq_bits, code_bits, delta) at symbol_bits 8; index = wire cfg id.
COMPACT_CONFIGS = [
    (20, 22, 2), (20, 22, 4), (20, 22, 8), (20, 22, 12),
    (20, 22, 16), (20, 22, 32), (20, 22, 1), (20, 22, 64),
]


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_varint(data: bytes, off: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        if off >= len(data) or shift > 56:
            raise InvalidInputError()
        b = data[off]
        off += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, off


def compact_config(cfg: int) -> tuple[Parameters, int]:
    if not 0 <= cfg < len(COMPACT_CONFIGS):
        raise InvalidInputError()
    fb, cb, delta = COMPACT_CONFIGS[cfg]
    return Parameters(8, fb, cb), delta


def build_compact(cfg: int, orig_len: int, payload: bytes, crc: int) -> bytes:
    compact_config(cfg)  # validates
    head = bytes([COMPACT_MAGIC, (COMPACT_VERSION << 4) | cfg])
    head += _varint(orig_len)
    head += struct.pack("<H", crc & 0xFFFF)
    return head + payload


def is_compact_archive(data: bytes) -> bool:
    return len(data) >= 2 and data[0] == COMPACT_MAGIC


def max_decoded_len(params: Parameters, payload_bytes: int) -> int:
    """Upper bound on symbols decodable from a payload of that many bytes.

    Even with the model frozen at ``freq_max``, one symbol costs at least
    ``-log2((freq_max - S + 1)/freq_max) >= (S-1)/(freq_max*ln2)`` bits,
    i.e. at most ``freq_max*ln2/(S-1) ~= freq_max/369`` symbols ride on
    each payload bit (S = 257 at symbol_bits 8).  ``freq_max >> 8`` plus
    one is a ~1.44x-margin integer form of that bound.  Untrusted headers
    claiming more are corrupt — rejecting them caps the allocation and
    decode work a crafted tiny archive can demand (round-3 advisor: a
    ~6-byte compact archive could claim a multi-exabyte orig_len).
    """
    per_bit = (params.freq_max >> (params.symbol_bits)) + 1
    return 8 * payload_bytes * per_bit


def parse_compact(archive: bytes) -> tuple[Parameters, int, int, int, bytes]:
    """-> (params, delta, orig_len, crc16, payload); raises InvalidInputError."""
    if len(archive) < 4 or archive[0] != COMPACT_MAGIC:
        raise InvalidInputError()
    if archive[1] >> 4 != COMPACT_VERSION:
        raise InvalidInputError()
    params, delta = compact_config(archive[1] & 0x0F)
    orig_len, off = _read_varint(archive, 2)
    if len(archive) < off + 2:
        raise InvalidInputError()
    (crc16,) = struct.unpack_from("<H", archive, off)
    payload = archive[off + 2 :]
    if orig_len > max_decoded_len(params, len(payload)):
        raise InvalidInputError()
    return params, delta, orig_len, crc16, payload


def verify_crc16(crc16: int, data: bytes) -> None:
    if zlib.crc32(data) & 0xFFFF != crc16:
        raise InvalidInputError()
