"""Native (C++) entropy coding, loaded via ctypes: the rANS part of the
reference's ``native`` package (``rans.cpp``: RLE0 + order-0 rANS, plain and
context-banded).

The shared library is built at first use with g++ into ``build/native/`` at
the root of the checkout (never beside the source); everything degrades to
the pure-Python zlib backend when no compiler is available
(``available()`` is False then), as in the reference.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "rans.cpp")]
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "native")
_LIB = os.path.join(_BUILD_DIR, "librbv_rans.so")

_lib = None


def _build() -> bool:
    # build under a per-process name, then rename: test workers and plane
    # threads of several processes may build at once
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *_SRCS,
             "-o", tmp],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB)
        return True
    except Exception as e:  # compiler missing / failed
        print(f"rabbit native build failed ({e}); using zlib fallback",
              file=sys.stderr)
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < max(
        os.path.getmtime(s) for s in _SRCS
    ):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    lib.rbv_compress_i16.restype = ctypes.c_int64
    lib.rbv_compress_i16.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.rbv_decompress_i16.restype = ctypes.c_int64
    lib.rbv_decompress_i16.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.rbv_compress_i16_bands.restype = ctypes.c_int64
    lib.rbv_compress_i16_bands.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,          # data, n
        ctypes.c_void_p, ctypes.c_void_p,         # seg_off, seg_len
        ctypes.c_void_p, ctypes.c_int64,          # seg_band, n_segs
        ctypes.c_int32,                           # n_bands
        ctypes.c_void_p, ctypes.c_int64,          # out, cap
    ]
    lib.rbv_decompress_i16_bands.restype = ctypes.c_int64
    lib.rbv_decompress_i16_bands.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,          # in, in_len
        ctypes.c_void_p, ctypes.c_int64,          # out, n
        ctypes.c_void_p, ctypes.c_void_p,         # seg_off, seg_len
        ctypes.c_void_p, ctypes.c_int64,          # seg_band, n_segs
        ctypes.c_int32,                           # n_bands
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def compress_i16(arr) -> bytes:
    """np.int16 array -> rANS blob (raises RuntimeError if native missing)."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native entropy library unavailable")
    a = np.ascontiguousarray(arr, dtype=np.int16)
    cap = a.nbytes + 4096 + (a.nbytes >> 2)
    # np.empty, NOT ctypes.create_string_buffer: the latter zero-fills the
    # whole capacity (~20 MB memset per bench plane, measured ~half the
    # wrapper's total cost)
    out = np.empty(cap, np.uint8)
    n = lib.rbv_compress_i16(
        a.ctypes.data_as(ctypes.c_void_p), a.size,
        out.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if n < 0:
        raise RuntimeError("rbv_compress_i16 failed")
    return out[:n].tobytes()


def decompress_i16(blob: bytes, n_elements: int):
    """rANS blob -> np.int16 array of n_elements."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native entropy library unavailable")
    out = np.empty(n_elements, np.int16)
    consumed = lib.rbv_decompress_i16(
        blob, len(blob), out.ctypes.data_as(ctypes.c_void_p), n_elements
    )
    if consumed < 0:
        raise RuntimeError("rbv_decompress_i16 failed (corrupt stream?)")
    return out


def _seg_arrays(segments):
    import numpy as np

    off = np.ascontiguousarray([s[0] for s in segments], np.int64)
    length = np.ascontiguousarray([s[1] for s in segments], np.int64)
    band = np.ascontiguousarray([s[2] for s in segments], np.int32)
    return off, length, band


def compress_i16_bands(arr, segments, n_bands: int) -> bytes:
    """Context-banded rANS: `segments` is an ordered list of
    (offset_elements, length_elements, band_id); each band gets its own
    RLE0 token streams and frequency tables.  Zero-runs continue across
    segment boundaries within a band."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native entropy library unavailable")
    a = np.ascontiguousarray(arr, dtype=np.int16)
    off, length, band = _seg_arrays(segments)
    cap = a.nbytes + 8192 + (a.nbytes >> 2) + 2048 * n_bands
    out = np.empty(cap, np.uint8)
    n = lib.rbv_compress_i16_bands(
        a.ctypes.data_as(ctypes.c_void_p), a.size,
        off.ctypes.data_as(ctypes.c_void_p),
        length.ctypes.data_as(ctypes.c_void_p),
        band.ctypes.data_as(ctypes.c_void_p), len(segments),
        n_bands,
        out.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if n < 0:
        raise RuntimeError("rbv_compress_i16_bands failed")
    return out[:n].tobytes()


def decompress_i16_bands(blob: bytes, n_elements: int, segments,
                         n_bands: int):
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native entropy library unavailable")
    out = np.empty(n_elements, np.int16)
    off, length, band = _seg_arrays(segments)
    consumed = lib.rbv_decompress_i16_bands(
        blob, len(blob), out.ctypes.data_as(ctypes.c_void_p), n_elements,
        off.ctypes.data_as(ctypes.c_void_p),
        length.ctypes.data_as(ctypes.c_void_p),
        band.ctypes.data_as(ctypes.c_void_p), len(segments),
        n_bands,
    )
    if consumed < 0:
        raise RuntimeError("rbv_decompress_i16_bands failed (corrupt?)")
    return out
