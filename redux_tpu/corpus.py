"""Seeded test and benchmark inputs standing in for the reference corpora.

The reference tests and benchmarks run over the Calgary, Canterbury,
artificial, large and misc corpora (tests/corpora.rs).  Those files are not
shipped with this repository, so inputs are generated from a seed, one
class per kind of data the corpora hold:

* ``text`` -- English-like prose (calgary ``book*``, ``paper*``, ``news``):
  words drawn Zipf-like from a fixed vocabulary of letter strings, with
  punctuation and line breaks.  Order-0 statistics are what the codec sees;
  those follow the vocabulary's letter mix.
* ``source`` -- program text (``progc``, ``grammar.lsp``): keywords,
  identifiers, numbers, operators, indentation.
* ``records`` -- binary tables (``geo``, ``obj*``, ``kennedy.xls``):
  fixed-width little-endian records with counters, slowly drifting
  float32 columns, small codes and zero padding.
* ``tiny`` -- a four-letter alphabet with skewed frequencies (``E.coli``,
  ``pic``, ``ptt5``).
* ``constant`` -- one byte repeated (``aaa.txt``).
* ``random64`` -- uniform over 64 printable symbols (``random.txt``).
* ``digits`` -- uniform decimal digits (``pi.txt``).
* ``random`` -- incompressible bytes, which no reference file holds; such
  blocks take the container's stored-raw path.

``a.txt`` and ``alphabet.txt`` are generated exactly (``b"a"`` and
``abc...z`` repeated to 100,000 bytes).  :func:`reference_file` gives a
file of the same name, class and size as one of the reference corpora's,
and :func:`mixed` concatenates such files, so its classes have the byte
shares they have in the corpora.
"""

from __future__ import annotations

import functools
import zlib

import numpy as np

A_TXT = b"a"
_ALPHABET_LEN = 100_000


def alphabet(n: int = _ALPHABET_LEN) -> bytes:
    """``abc...z`` repeated to ``n`` bytes (artificial/alphabet.txt)."""
    return (b"abcdefghijklmnopqrstuvwxyz" * (n // 26 + 1))[:n]


@functools.lru_cache(maxsize=None)
def _vocab(kind: str):
    """(flat bytes, offsets, lengths, Zipf weights) of a fixed vocabulary."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    if kind == "text":
        letters = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
        freq = 1.0 / np.arange(1, 27) ** 0.9
        lens = rng.integers(1, 11, 4000)
        words = [
            bytes(rng.choice(letters, n, p=freq / freq.sum())) for n in lens
        ]
        words += [b"the", b"of", b"and", b"to", b"a", b"in", b"that", b"is"]
    else:  # source
        words = [
            b"int", b"return", b"if", b"else", b"for", b"while", b"char",
            b"struct", b"void", b"static", b"(", b")", b"{", b"}", b";",
            b"=", b"==", b"+", b"-", b"*", b"->", b",", b"0", b"1", b"NULL",
            b"(define", b"(lambda", b"'", b"\"",
        ]
        alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz_", np.uint8)
        for n in rng.integers(2, 12, 600):
            words.append(bytes(rng.choice(alpha, n)))
        words += [str(int(v)).encode() for v in rng.integers(0, 4096, 100)]
    rng.shuffle(words)
    lens = np.array([len(w) for w in words], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    weights = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    return (np.frombuffer(b"".join(words), np.uint8), offs, lens,
            weights / weights.sum())


def _gather(flat, offs, lens, ids, n):
    """Concatenate vocabulary entries ``ids`` and cut at ``n`` bytes."""
    ls = lens[ids]
    starts = offs[ids]
    total = int(ls.sum())
    idx = np.repeat(starts - (np.cumsum(ls) - ls), ls) + np.arange(total)
    return flat[idx][:n]


def _tokens(kind: str, n: int, rng, seps: bytes, sep_p) -> np.ndarray:
    """Words of ``kind``'s vocabulary, each followed by a separator."""
    flat, offs, lens, p = _vocab(kind)
    seps_v = [bytes([c]) for c in seps]
    n_words = n // int(max(2, (lens * p).sum() + 1)) + 16
    while True:
        ids = rng.choice(len(lens), n_words, p=p)
        sep_ids = rng.choice(len(seps_v), n_words, p=sep_p)
        ls = lens[ids] + 1
        if ls.sum() >= n:
            break
        n_words *= 2
    seq = np.empty(2 * n_words, np.int64)
    seq[0::2] = ids
    seq[1::2] = len(lens) + sep_ids
    flat_all = np.concatenate([flat, np.frombuffer(seps, np.uint8)])
    offs_all = np.concatenate([offs, len(flat) + np.arange(len(seps))])
    lens_all = np.concatenate([lens, np.ones(len(seps), np.int64)])
    return _gather(flat_all, offs_all, lens_all, seq, n)


def text(n: int, seed: int = 0) -> bytes:
    """English-like prose."""
    rng = np.random.default_rng(seed)
    out = _tokens("text", n, rng, b" ,.\n", [0.82, 0.07, 0.06, 0.05])
    return out.tobytes()


def source(n: int, seed: int = 0) -> bytes:
    """Program text: tokens, spaces, indented lines."""
    rng = np.random.default_rng(seed)
    out = _tokens("source", n, rng, b" \n\t", [0.80, 0.13, 0.07])
    return out.tobytes()


def records(n: int, seed: int = 0) -> bytes:
    """Fixed-width binary records: counter, two drifting float32 columns,
    a small code and zero padding (24 bytes each)."""
    rng = np.random.default_rng(seed)
    m = n // 24 + 1
    rec = np.zeros(m, dtype=[("id", "<u4"), ("x", "<f4"), ("y", "<f4"),
                             ("code", "<u2"), ("pad", "V10")])
    rec["id"] = np.arange(m, dtype=np.uint32) + np.uint32(rng.integers(0, 1 << 20))
    rec["x"] = np.cumsum(rng.normal(0, 0.01, m)).astype(np.float32)
    rec["y"] = (1000 + np.cumsum(rng.normal(0, 1.0, m))).astype(np.float32)
    rec["code"] = rng.integers(0, 16, m)
    return rec.tobytes()[:n]


def random_bytes(n: int, seed: int = 0) -> bytes:
    """Incompressible bytes."""
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def random64(n: int, seed: int = 0) -> bytes:
    """Uniform over 64 printable symbols."""
    sym = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789! ",
        np.uint8,
    )
    return np.random.default_rng(seed).choice(sym, n).tobytes()


def digits(n: int, seed: int = 0) -> bytes:
    """Uniform decimal digits."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 10, n, dtype=np.uint8) + ord("0")).tobytes()


def tiny(n: int, seed: int = 0) -> bytes:
    """A skewed four-letter alphabet."""
    rng = np.random.default_rng(seed)
    sym = np.frombuffer(b"acgt", np.uint8)
    return rng.choice(sym, n, p=[0.3, 0.2, 0.2, 0.3]).tobytes()


def constant(n: int, seed: int = 0) -> bytes:
    """One byte, repeated."""
    return bytes([int(np.random.default_rng(seed).integers(0, 256))]) * n


CLASSES = {
    "text": text,
    "source": source,
    "records": records,
    "tiny": tiny,
    "constant": constant,
    "random64": random64,
    "digits": digits,
    "random": random_bytes,
}


# Name, class and size of the reference corpora's files.
REFERENCE_FILES = {
    "artificial": {
        "a.txt": ("exact", 1),
        "aaa.txt": ("constant", 100_000),
        "alphabet.txt": ("exact", _ALPHABET_LEN),
        "random.txt": ("random64", 100_000),
    },
    "calgary": {
        "bib": ("text", 111_261), "book1": ("text", 768_771),
        "book2": ("text", 610_856), "geo": ("records", 102_400),
        "news": ("text", 377_109), "obj1": ("records", 21_504),
        "obj2": ("records", 246_814), "paper1": ("text", 53_161),
        "paper2": ("text", 82_199), "paper3": ("text", 46_526),
        "paper4": ("text", 13_286), "paper5": ("text", 11_954),
        "paper6": ("text", 38_105), "pic": ("tiny", 513_216),
        "progc": ("source", 39_611), "progl": ("source", 71_646),
        "progp": ("source", 49_379), "trans": ("source", 93_695),
    },
    "canterbury": {
        "alice29.txt": ("text", 152_089), "asyoulik.txt": ("text", 125_179),
        "cp.html": ("source", 24_603), "fields.c": ("source", 11_150),
        "grammar.lsp": ("source", 3_721), "kennedy.xls": ("records", 1_029_744),
        "lcet10.txt": ("text", 426_754), "plrabn12.txt": ("text", 481_861),
        "ptt5": ("tiny", 513_216), "sum": ("records", 38_240),
        "xargs.1": ("text", 4_227),
    },
    "large": {
        "E.coli": ("tiny", 4_638_690), "bible.txt": ("text", 4_047_392),
        "world192.txt": ("text", 2_473_400),
    },
    "misc": {"pi.txt": ("digits", 1_000_000)},
}


# Bytes of one round of :func:`mixed`: the reference corpora's total.
ROUND_BYTES = sum(size for names in REFERENCE_FILES.values() for _, size in names.values())


def reference_file(corpus: str, name: str, seed: int | None = None) -> bytes:
    """A seeded stand-in for ``corpus/name`` of the reference corpora: the
    same size, and the class of data the original holds.  ``seed``
    defaults to one derived from the name."""
    cls, size = REFERENCE_FILES[corpus][name]
    if cls == "exact":
        return A_TXT if name == "a.txt" else alphabet(size)
    if seed is None:
        seed = zlib.crc32(f"{corpus}/{name}".encode())
    return CLASSES[cls](size, seed)


def mixed_segments(n_bytes: int, seed: int = 0):
    """The layout of :func:`mixed`: ``(file, class, start, size, seed)``
    per file stand-in, ``file`` being ``"corpus/name"``.

    The reference corpora's files, each round in its own seeded order and
    with its own seeds, for as many rounds as ``n_bytes`` takes; the last
    file is cut at ``n_bytes``.  Each round is the corpora's 18.5 MB
    (``ROUND_BYTES``), so
    over whole rounds every class has its byte share there: text 53 %,
    tiny alphabet 31 %, records 7.8 %, digits 5.4 %, source 1.6 %, and the
    artificial files (alphabet, constant, random64) 0.5 % each.
    """
    files = [(c, n) for c, names in REFERENCE_FILES.items() for n in names]
    segs, pos, rnd = [], 0, 0
    while pos < n_bytes:
        rng = np.random.default_rng([seed, rnd])
        for i in rng.permutation(len(files)):
            if pos >= n_bytes:
                break
            c, name = files[i]
            cls, size = REFERENCE_FILES[c][name]
            size = min(size, n_bytes - pos)
            segs.append((f"{c}/{name}", cls, pos, size, int(rng.integers(1 << 62))))
            pos += size
        rnd += 1
    return segs


def mixed(n_bytes: int, seed: int = 0) -> bytes:
    """``n_bytes`` of reference-file stand-ins, laid out by
    :func:`mixed_segments`."""
    out = np.empty(n_bytes, np.uint8)
    for f, _, start, size, s in mixed_segments(n_bytes, seed):
        data = reference_file(*f.split("/"), seed=s)[:size]
        out[start : start + size] = np.frombuffer(data, np.uint8)
    return out.tobytes()
