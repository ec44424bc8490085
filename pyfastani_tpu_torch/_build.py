"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes``.  The library lands in
``build/pyfastani_tpu_torch/`` at the root of the checkout, named by a
hash of the sources and flags, so a changed source builds anew and an
unchanged one loads at once.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["build_log", "load_library"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pyfastani_tpu_torch")
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _library_path() -> str:
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu"))):
        with open(src, "rb") as fh:
            digest.update(os.path.basename(src).encode() + b"\0" + fh.read())
    return os.path.join(_BUILD_DIR, f"libpyfastani_tpu_torch_{digest.hexdigest()[:16]}.so")


def _compile(lib_path: str) -> None:
    sources = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", tmp, *sources],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        with open(lib_path + ".log", "w") as fh:
            fh.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers and shared memory per
    kernel) from the build of the current sources, or ``""``."""
    try:
        with open(_library_path() + ".log") as fh:
            return fh.read()
    except FileNotFoundError:
        return ""


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    path = _library_path()
    if not os.path.exists(path):
        _compile(path)
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    operands = [
        ptr, ptr, i32,  # q, s_sizes, S
        ptr, ptr, ptr,  # mini_hash, mini_wpos, mini_prev
        ptr, ptr, ptr, ptr, ptr, i32,  # lo, rlen, frag, c0, clen, N
        i32, i32, i32, i32,  # cmw, rmax, M, F
        ptr, ptr, ptr, ptr,  # best, first, last, range_bad
    ]
    lib.l2_chunks_error_string.argtypes = [i32]
    lib.l2_chunks_error_string.restype = ctypes.c_char_p
    lib.l2_chunks_fits_shared.argtypes = [i32, i32, i32]  # device, S, rmax
    lib.l2_chunks_fits_shared.restype = i32
    lib.l2_chunks_scratch_words.argtypes = [i32, i32, i32, i32]  # device, S, rmax, N
    lib.l2_chunks_scratch_words.restype = i64
    lib.l2_chunks_launch.argtypes = operands + [ptr]  # stream
    lib.l2_chunks_launch.restype = i32
    lib.l2_chunks_launch_scratch.argtypes = operands + [ptr, i64, ptr]  # scratch, words, stream
    lib.l2_chunks_launch_scratch.restype = i32
    return lib
