"""Build and load the package's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` source (with the
headers beside them) into one shared library with a plain C interface (no PyTorch headers, so the build takes
seconds), which is loaded with ``ctypes``.  The library lives in
``build/torch_kernels/`` at the root of the checkout and is rebuilt when a
source is newer than it.  A failed build or load raises; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "librbv_torch_kernels.so"
BUILD_LOG = BUILD_DIR / "build.log"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    return any(s.stat().st_mtime > built for s in sources() + headers())


def build(force: bool = False) -> float:
    """Compile the kernels if needed -> seconds spent (0.0 when current).
    nvcc's output, with ptxas's register and shared-memory report, is kept
    in ``BUILD_LOG``."""
    if not force and not _stale():
        return 0.0
    return compile_library(sources(), LIBRARY, BUILD_LOG)


def compile_library(srcs, library: Path, log: Path) -> float:
    """nvcc ``srcs`` into the shared library ``library`` -> seconds spent;
    nvcc's output goes to ``log``.  The package's headers are on the
    include path, for a copy of a source kept elsewhere.  Raises when nvcc
    fails."""
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, library)
    return seconds


def ptxas_report(log: Path) -> dict:
    """{kernel name: {"registers": n, "spill_stores": bytes, "spill_loads":
    bytes}} from the ``-Xptxas -v`` lines of a build log."""
    import re

    out, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  Thread-safe: the
    transcoder calls kernels from one worker thread per plane."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = _load()
        return _lib


def _load() -> ctypes.CDLL:
    return bind(ctypes.CDLL(str(LIBRARY)))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a kernel library on ``lib`` (also used
    for a library built from another version of the sources, which may
    lack ``rbv_transcode_mc_intra``)."""
    lib.rbv_transcode_gops.restype = ctypes.c_int
    lib.rbv_transcode_gops.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # in, out, dmat
        ctypes.c_int, ctypes.c_int,                          # frames, n_blocks
        ctypes.c_int, ctypes.c_int,                          # gop_in, gop_out
        ctypes.c_float, ctypes.c_float, ctypes.c_float,      # qs_in, qs_out, maxval
        ctypes.c_float, ctypes.c_float,                      # dz_intra, dz_inter
        ctypes.c_int, ctypes.c_void_p,                       # device, stream
    ]
    lib.rbv_transcode_gops_batched.restype = ctypes.c_int
    lib.rbv_transcode_gops_batched.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # in, out, dmat
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # streams, frames, n_blocks
        ctypes.c_int, ctypes.c_int,                          # gop_in, gop_out
        ctypes.c_void_p, ctypes.c_void_p,                    # qs_in, qs_out (S,)
        ctypes.c_float, ctypes.c_float, ctypes.c_float,      # maxval, dz_intra, dz_inter
        ctypes.c_int, ctypes.c_void_p,                       # device, stream
    ]
    if hasattr(lib, "rbv_transcode_mc_intra"):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rbv_transcode_mc_intra.restype = i32
        lib.rbv_transcode_mc_intra.argtypes = [
            ptr, ptr, ptr, ptr, ptr,  # q_in, q_out, mode_out, mv, imode
            ptr, ptr, ptr, ptr,       # dcq, planes, taps_h, taps_w
            i32, i32, i32, i32,       # frames, nby, nbx, gop
            i32, i32,                 # h_first, fused
            ptr, ptr, f32, f32,       # qs_in_f, qs_out_f, qs_in, qs_out
            f32, f32, f32,            # maxval, dz_intra, dz_inter
            i32, ptr,                 # device, stream
        ]
    lib.rbv_cuda_error_string.restype = ctypes.c_char_p
    lib.rbv_cuda_error_string.argtypes = [ctypes.c_int]
    return lib
