"""Native (C++) runtime components, loaded via ctypes: the reference's
``native`` package. ``rans.cpp`` is the entropy coder (RLE0 + order-0 rANS,
plain and context-banded), ``knn_grid.cpp`` the exact KNN over integer voxel
clouds, ``normals_tree.cpp`` the spanning-tree orientation of normals,
``eigh3.cpp`` the batched 3x3 ``ssyevd`` loop of the normals' PCA.

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
_SRCS = [os.path.join(_DIR, "rans.cpp"),
         os.path.join(_DIR, "normals_tree.cpp"),
         os.path.join(_DIR, "knn_grid.cpp"),
         os.path.join(_DIR, "eigh3.cpp")]
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "native")
_LIB = os.path.join(_BUILD_DIR, "librbv_native.so")

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
    lib.rbv_knn_grid.restype = ctypes.c_int64
    lib.rbv_knn_grid.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,          # query, nq
        ctypes.c_void_p, ctypes.c_int64,          # data, nd
        ctypes.c_int64, ctypes.c_int32,           # k, cell_shift
        ctypes.c_void_p, ctypes.c_void_p,         # out_idx, out_d2
    ]
    lib.rbv_orient_normals_tree.restype = ctypes.c_int64
    lib.rbv_orient_normals_tree.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,         # normals, points
        ctypes.c_void_p, ctypes.c_void_p,         # nbr_idx, nbr_ok
        ctypes.c_int64, ctypes.c_int64,           # n, k
        ctypes.c_void_p,                          # viewpoint
    ]
    lib.rbv_ssyevd3_batch.restype = ctypes.c_int64
    lib.rbv_ssyevd3_batch.argtypes = [
        ctypes.c_void_p,                          # ssyevd
        ctypes.c_void_p, ctypes.c_int64,          # cov, n
        ctypes.c_void_p, ctypes.c_void_p,         # w, v
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


def knn_grid(query, data, k: int, cell_shift: int = -1):
    """Exact KNN over integer voxel clouds (native/knn_grid.cpp) ->
    (idx (nq,k) int32 with -1 padding, d2 (nq,k) float32 with inf
    padding), distance-sorted, ties toward the smaller index.  Raises
    RuntimeError when the native library is unavailable — callers fall
    back to scipy's cKDTree."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    q = np.ascontiguousarray(query, np.int32)
    d = np.ascontiguousarray(data, np.int32)
    if q.ndim != 2 or q.shape[1] != 3 or d.ndim != 2 or d.shape[1] != 3:
        raise ValueError("query/data must be (N, 3)")
    idx = np.empty((len(q), k), np.int32)
    d2 = np.empty((len(q), k), np.float32)
    rc = lib.rbv_knn_grid(
        q.ctypes.data_as(ctypes.c_void_p), len(q),
        d.ctypes.data_as(ctypes.c_void_p), len(d),
        k, cell_shift,
        idx.ctypes.data_as(ctypes.c_void_p),
        d2.ctypes.data_as(ctypes.c_void_p),
    )
    if rc < 0:
        raise RuntimeError("rbv_knn_grid failed (bad arguments?)")
    return idx, d2


def orient_normals_tree(normals, points, nbr_idx, nbr_ok, viewpoint) -> int:
    """Spanning-tree sign orientation IN PLACE on `normals` (float32 C
    array).  Returns the connected-component count.  Raises when the
    native library is unavailable — callers fall back to the sweep
    orientation (encoder/normals.py)."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if not (normals.flags.c_contiguous and normals.dtype == np.float32):
        raise ValueError("normals must be C-contiguous float32")
    pts = np.ascontiguousarray(points, np.float32)
    idx = np.ascontiguousarray(nbr_idx, np.int32)
    ok = np.ascontiguousarray(nbr_ok, np.uint8)
    vp = np.ascontiguousarray(viewpoint, np.float32)
    n, k = idx.shape
    rc = lib.rbv_orient_normals_tree(
        normals.ctypes.data_as(ctypes.c_void_p),
        pts.ctypes.data_as(ctypes.c_void_p),
        idx.ctypes.data_as(ctypes.c_void_p),
        ok.ctypes.data_as(ctypes.c_void_p),
        n, k,
        vp.ctypes.data_as(ctypes.c_void_p),
    )
    if rc < 0:
        raise RuntimeError("rbv_orient_normals_tree failed (bad indices?)")
    return int(rc)


_ssyevd_ptr = None


def ssyevd_pointer() -> int:
    """Address of scipy's LAPACK ``ssyevd`` (``scipy.linalg.cython_lapack``,
    the routine jaxlib's CPU ``eigh`` calls), taken once per process."""
    global _ssyevd_ptr
    if _ssyevd_ptr is None:
        from scipy.linalg import cython_lapack

        capsule = cython_lapack.__pyx_capi__["ssyevd"]
        api = ctypes.pythonapi
        get_name = ctypes.PYFUNCTYPE(ctypes.c_char_p, ctypes.py_object)(
            ("PyCapsule_GetName", api))
        get_pointer = ctypes.PYFUNCTYPE(
            ctypes.c_void_p, ctypes.py_object, ctypes.c_char_p)(
            ("PyCapsule_GetPointer", api))
        _ssyevd_ptr = get_pointer(capsule, get_name(capsule))
    return _ssyevd_ptr


def ssyevd3_batch(cov):
    """(N, 3, 3) float32 symmetric matrices -> (w (N, 3) ascending, v
    (N, 3, 3) with ``v[i, :, j]`` the j-th eigenvector), LAPACK ``ssyevd``
    with jobz 'V' and uplo 'L' per matrix (native/eigh3.cpp): the bits of
    ``jnp.linalg.eigh`` on the CPU.  A matrix that ssyevd fails on gets NaN
    values and vectors.  Raises RuntimeError when the native library is
    unavailable."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    c = np.ascontiguousarray(cov, np.float32)
    if c.ndim != 3 or c.shape[1:] != (3, 3):
        raise ValueError("cov must be (N, 3, 3)")
    w = np.empty((len(c), 3), np.float32)
    v = np.empty((len(c), 3, 3), np.float32)
    rc = lib.rbv_ssyevd3_batch(
        ssyevd_pointer(), c.ctypes.data_as(ctypes.c_void_p), len(c),
        w.ctypes.data_as(ctypes.c_void_p), v.ctypes.data_as(ctypes.c_void_p),
    )
    if rc < 0:
        raise RuntimeError("rbv_ssyevd3_batch failed (bad arguments?)")
    return w, v
