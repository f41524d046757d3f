"""Host-side bit packing: per-lane byte streams ↔ u32 word matrices.

The device coders read and write compressed bits as big-endian u32 words
(bit ``i`` of a stream is bit ``31 - (i & 31)`` of word ``i >> 5``), which
is exactly the reference's MSB-first byte order (bitio/mod.rs:78-181)
extended to 32-bit lanes.  These numpy helpers convert between the
word-matrix layout and ordinary byte strings for archive splicing.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def streams_to_words(streams: Sequence[bytes], n_words: int) -> np.ndarray:
    """Pack per-lane byte streams into a ``(len(streams), n_words)`` uint32 matrix.

    Each stream is zero-padded to ``4 * n_words`` bytes and read as
    big-endian u32, preserving MSB-first bit order.
    """
    n = len(streams)
    buf = np.zeros((n, n_words * 4), dtype=np.uint8)
    for i, s in enumerate(streams):
        if len(s) > n_words * 4:
            raise ValueError(f"stream {i} longer than word buffer")
        buf[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    return buf.view(">u4").astype(np.uint32).reshape(n, n_words)


def words_to_stream(words: np.ndarray, byte_len: int) -> bytes:
    """Extract the first ``byte_len`` bytes of one lane's big-endian word row."""
    raw = np.ascontiguousarray(words, dtype=np.uint32).astype(">u4").tobytes()
    return raw[:byte_len]


def words_to_streams(words: np.ndarray, byte_lens: Sequence[int]) -> List[bytes]:
    """Extract every lane's byte stream from a ``(B, W)`` word matrix."""
    raw = np.ascontiguousarray(words, dtype=np.uint32).astype(">u4").tobytes()
    w4 = words.shape[1] * 4
    return [raw[i * w4 : i * w4 + n] for i, n in enumerate(byte_lens)]
