"""ctypes bindings for the native sequential codec.

Builds ``redux_native.cpp`` on first use with g++ (cached as
``_redux_native.so`` next to the source, which is not tracked; the binding
layer is a small C ABI + ctypes).  Concurrent first uses (pytest-xdist
workers, several processes) serialize on a file lock and build under a
unique temporary name, so no process ever loads a half-written library.
The native codec is the fast host-side path for reference-format single
streams and the independent twin the device coders are checked against.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..errors import EofError, InvalidInputError
from ..params import Parameters

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "redux_native.cpp")
_SO = os.path.join(_DIR, "_redux_native.so")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailable(f"native build failed: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _stale() -> bool:
    return not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC)


def _load() -> ctypes.CDLL:
    """Build if missing or stale, then load; a library that does not load
    here (built on another machine) is rebuilt once."""
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _stale():
            _build()
        try:
            return ctypes.CDLL(_SO)
        except OSError:
            _build()
            return ctypes.CDLL(_SO)


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native codec library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = _load()
        lib.rdx_compress.restype = ctypes.c_int64
        lib.rdx_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.rdx_decompress.restype = ctypes.c_int64
        lib.rdx_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.rdx_compress_v2.restype = ctypes.c_int64
        lib.rdx_compress_v2.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.rdx_decompress_v2.restype = ctypes.c_int64
        lib.rdx_decompress_v2.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
        ]
        _LIB = lib
        return lib


def _prior_ptr(prior_extra):
    if prior_extra is None:
        return None, None
    arr = np.ascontiguousarray(prior_extra, dtype=np.uint16)
    assert arr.shape == (256,)
    return arr, arr.ctypes.data_as(ctypes.c_void_p)


def compress_bytes(
    data: bytes, params: Optional[Parameters] = None, prior_extra=None
) -> bytes:
    """Reference-format compress (byte-identical to the reference CLI)."""
    p = params or Parameters.default()
    lib = get_lib()
    cap = len(data) * 2 + 4096 + len(data) // 2
    out = np.empty(cap, dtype=np.uint8)
    arr, ptr = _prior_ptr(prior_extra)
    n = lib.rdx_compress(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), cap,
        p.symbol_bits, p.freq_bits, p.code_bits, ptr,
    )
    if n == -1:
        raise InvalidInputError()
    if n == -2:  # pragma: no cover - capacity bound generous
        raise InvalidInputError()
    return out[:n].tobytes()


def compress_block_v2(
    data: bytes, params: Parameters, prior_extra=None, delta: int = 1
) -> bytes:
    """Native RXT v2 block payload encode (oracle.compress_block semantics).

    Fast host path for single-block/compact archives; bit-identical to
    the oracle and the device coders (differential-tested).
    """
    lib = get_lib()
    cap = len(data) * 2 + 4096 + len(data) // 2
    out = np.empty(cap, dtype=np.uint8)
    arr, ptr = _prior_ptr(prior_extra)
    n = lib.rdx_compress_v2(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), cap,
        params.symbol_bits, params.freq_bits, params.code_bits, ptr, delta,
    )
    if n < 0:
        raise InvalidInputError()
    return out[:n].tobytes()


def decompress_block_v2(
    payload: bytes, n_symbols: int, params: Parameters, prior_extra=None,
    delta: int = 1,
) -> bytes:
    """Native RXT v2 block payload decode (stored-length termination)."""
    lib = get_lib()
    out = np.empty(max(n_symbols, 1), dtype=np.uint8)
    arr, ptr = _prior_ptr(prior_extra)
    n = lib.rdx_decompress_v2(
        payload, len(payload), out.ctypes.data_as(ctypes.c_void_p),
        max(n_symbols, 1), params.symbol_bits, params.freq_bits,
        params.code_bits, ptr, delta, n_symbols,
    )
    if n < 0:
        raise EofError() if n == -1 else InvalidInputError()
    return out[:n].tobytes()


def decompress_bytes(
    data: bytes,
    params: Optional[Parameters] = None,
    prior_extra=None,
    nsyms: int = -1,
    max_out: Optional[int] = None,
) -> bytes:
    """Reference-format decompress; ``nsyms >= 0`` decodes exactly that many
    symbols (stored-length container termination)."""
    p = params or Parameters.default()
    lib = get_lib()
    cap = max_out if max_out is not None else max(len(data) * 8 + 4096, 1 << 20)
    # Retry growth is bounded: a valid stream decodes at most
    # ~8 * freq_bits expansion per input bit (each symbol consumes >= 1/256
    # of a bit once the model saturates); cap the total allocation at 4 GiB
    # so an adversarial stream fails with InvalidInputError instead of
    # forcing unbounded allocations.
    hard_cap = min(max(len(data), 1) * 4096 + (1 << 20), 4 << 30)
    arr, ptr = _prior_ptr(prior_extra)
    while True:
        out = np.empty(cap, dtype=np.uint8)
        n = lib.rdx_decompress(
            data, len(data), out.ctypes.data_as(ctypes.c_void_p), cap,
            p.symbol_bits, p.freq_bits, p.code_bits, ptr, nsyms,
        )
        if n == -1:
            raise EofError()
        if n == -2:  # output larger than guess: grow and retry
            if max_out is not None or cap >= hard_cap:
                raise InvalidInputError()
            cap = min(cap * 8, hard_cap)
            continue
        return out[:n].tobytes()
