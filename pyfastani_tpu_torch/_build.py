"""Build and load the port's CUDA kernels.

Each of ``csrc/*.cu`` compiles with its own ``nvcc``, all started
together, and one more links the objects into a shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def _run_all(commands) -> str:
    """Runs the commands side by side; their joined output, or raises with
    the output of the first that failed."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in commands
    ]
    outs = [p.communicate()[0] for p in procs]
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}")
    return "".join(outs)


def _compile(lib_path: str) -> None:
    sources = sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu")))
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_BUILD_DIR)
    try:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o") for src in sources]
        log = _run_all(
            [_nvcc(), *_NVCC_FLAGS, "-c", "-o", obj, src] for obj, src in zip(objs, sources)
        )
        lib_tmp = os.path.join(tmp, "lib.so")
        log += _run_all([[_nvcc(), *_NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs]])
        with open(lib_path + ".log", "w") as fh:
            fh.write(log)
        os.replace(lib_tmp, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    lib.cuda_error_string.argtypes = [i32]
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.l2_chunks_fits_shared.argtypes = [i32, i32, i32]  # device, S, rmax
    lib.l2_chunks_fits_shared.restype = i32
    lib.l2_chunks_scratch_words.argtypes = [i32, i32, i32, i32]  # device, S, rmax, N
    lib.l2_chunks_scratch_words.restype = i64
    lib.l2_chunks_launch.argtypes = operands + [ptr]  # stream
    lib.l2_chunks_launch.restype = i32
    lib.l2_chunks_launch_scratch.argtypes = operands + [ptr, i64, ptr]  # scratch, words, stream
    lib.l2_chunks_launch_scratch.restype = i32
    lib.winnow_fragments_store_bytes.argtypes = [i32, i64, i32, i32]  # device, length, k, w
    lib.winnow_fragments_store_bytes.restype = i64
    lib.winnow_fragments_tile_route.argtypes = [i64, i32, i32]  # length, k, w
    lib.winnow_fragments_tile_route.restype = i32
    lib.winnow_fragments_launch.argtypes = [
        ptr, i64, i32, i64, i32, i32, i32, i32, i64,  # frags, stride, F, length, k, w, protein, kc, wout
        ptr, ptr, ptr, ptr,  # comp, q, s, ovf
        ptr, i64, ptr,  # scratch, scratch bytes, stream
    ]
    lib.winnow_fragments_launch.restype = i32
    lib.l1_probe_launch.argtypes = [
        ptr, i64, ptr, i32, i32,  # q, its row stride, s_sizes, F, S
        ptr, ptr, ptr, i64,  # uniq_hash, row_start, row_len, U
        ptr, i32, i32, i64,  # hash_bucket, bits, steps, freq threshold
        ptr, ptr, ptr, ptr,  # probe_len, probe_start, counts, stream
    ]
    lib.l1_probe_launch.restype = i32
    lib.l1_intervals_capacity.argtypes = [i32, i64, i32]  # device, hmax, S
    lib.l1_intervals_capacity.restype = i64
    lib.l1_intervals_launch.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32,  # probe_len, probe_start, counts, ends, F, S
        ptr, ptr, i32, ptr, i64,  # s_sizes, min_hits_table, its length, post_gpos, M
        i64, i32, i32, i64,  # T, ivmax, l, shared slots
        ptr, ptr, ptr, ptr, ptr, ptr,  # iv_g0, iv_g1, iv_valid, flags, scratch, stream
    ]
    lib.l1_intervals_launch.restype = i32
    lib.l2_plan_tiles.argtypes = [i64]  # NI
    lib.l2_plan_tiles.restype = i64
    lib.l2_plan_launch.argtypes = [
        ptr, ptr, ptr, i64, i64,  # iv_g0, iv_g1, iv_valid, NI, ivmax
        ptr, i64, ptr, ptr, i64,  # contig_offset, its length, cof_idx, mini_gpos, M
        ptr, i64, i32, i32, i64, i64, i64, i64,  # gpos_bucket, its length, shift, steps, cmw, cmax, rcap, ch_max
        ptr, ptr, ptr,  # tile totals, iv_seq, ends
        ptr, ptr, ptr, ptr, ptr, ptr, ptr,  # lo, rlen, frag, c0, len, flags, stream
    ]
    lib.l2_plan_launch.restype = i32
    lib.cgi_bins_launch.argtypes = [
        ptr, ptr, ptr, ptr, i64,  # cbest, cfirst, clast, ends, ch_max
        ptr, ptr, ptr, ptr,  # valid, seq, s_sizes, frag_qg
        ptr, i64, ptr, i64, i64,  # gate, its length, ident, smax_tab, its row stride
        ptr, i64, i64, i64, i64, i64, i64,  # seq_to_genome, C, F, ivmax, cmw, l, bin_max
        ctypes.POINTER(ptr), ctypes.POINTER(i32), i32, ptr,  # flag pointers, sizes, count, row
        ptr, ptr, ptr,  # slot_bin, slot_ident, stream
    ]
    lib.cgi_bins_launch.restype = i32
    lib.fold_bins_launch.argtypes = [
        ptr, ptr, i64, ptr, ptr,  # slot_bin, slot_ident, NS, scratch, seq_to_genome
        i64, i64, i64, i64, ptr, i64,  # q_count, C, bin_max, g_max, out, its limb stride
        ptr, i64, i64, ptr, ptr,  # flags, their rows, flags a row, out_flags, stream
    ]
    lib.fold_bins_launch.restype = i32
    return lib
