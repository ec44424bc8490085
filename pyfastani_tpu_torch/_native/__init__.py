"""The port's host C extension (``fastamod.c``), built at first use.

``fastamod.c`` is a copy of the JAX package's host runtime: FASTA reading,
uppercase and reverse complement, Murmur3, the reference winnow, and the
threaded radix sort, gather, CSR bounds, prefix histogram and densest
window of the index build.  The first call that needs it compiles it with
the host C compiler (``-O3 -pthread``, Python's include directory) into
``build/pyfastani_tpu_torch/`` at the root of the checkout, named by a hash
of the source and flags, and loads it with ``importlib``; an unchanged
source loads at once.  Several processes may build at once: each writes a
temporary file and renames it into place.  A failed build raises with the
compiler's output; there is no NumPy fallback.

The raw C functions are this module's attributes (``copy_upper``,
``csr_bounds``, ``hist_prefix``, ``max_window_count``, ``murmur3_32``,
``parse_fasta``, ``position_ordered``, ``reverse_complement``,
``sort_u32_perm``, ``take32``, ``winnow``); the other functions wrap them
for NumPy arrays.  The sort, the gather and the CSR bounds hold their
element counts and positions in int32: past 2^31 - 1 elements they raise
``OverflowError``.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import shlex
import shutil
import subprocess
import sysconfig
import tempfile

import numpy as np

__all__ = [
    "argsort_u32_stable",
    "csr_groups",
    "densest_window",
    "load",
    "position_ordered",
    "prefix_hist",
    "take_4byte",
]

_C_FUNCTIONS = frozenset(
    [
        "copy_upper", "csr_bounds", "hist_prefix", "max_window_count", "murmur3_32",
        "parse_fasta", "position_ordered", "reverse_complement", "sort_u32_perm",
        "take32", "winnow",
    ]
)
_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "fastamod.c")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "pyfastani_tpu_torch")
_CFLAGS = ["-O3", "-pthread", "-shared", "-fPIC"]


def _compiler() -> list:
    """The C compiler Python was built with, else ``cc``."""
    cmd = shlex.split(os.environ.get("CC") or sysconfig.get_config_var("CC") or "cc")
    if not cmd or shutil.which(cmd[0]) is None:
        cmd = ["cc"]
    return cmd


def _library_path() -> str:
    include = sysconfig.get_paths()["include"]
    digest = hashlib.sha256(" ".join(_CFLAGS + [include]).encode())
    with open(_SOURCE, "rb") as fh:
        digest.update(fh.read())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_BUILD_DIR, f"_native_{digest.hexdigest()[:16]}{suffix}")


def _compile(path: str) -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        cmd = [*_compiler(), *_CFLAGS, "-I", sysconfig.get_paths()["include"],
               "-o", tmp, _SOURCE]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the host C extension failed ({proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.cache
def load():
    """The compiled extension module, built on first use."""
    path = _library_path()
    if not os.path.exists(path):
        _compile(path)
    # the init function is PyInit__native, so the module's last name is _native
    name = f"{__name__}._native"
    loader = importlib.machinery.ExtensionFileLoader(name, path)
    spec = importlib.util.spec_from_file_location(name, path, loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def __getattr__(name: str):
    if name in _C_FUNCTIONS:
        return getattr(load(), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def argsort_u32_stable(keys):
    """Stable argsort of a uint32 array (threaded C radix sort)."""
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    return np.frombuffer(load().sort_u32_perm(keys.data), dtype=np.int32)


def take_4byte(values, idx):
    """values[idx] for 4-byte-element arrays (threaded C gather).

    The gather reads raw 4-byte lanes, so any other element size raises
    `TypeError`; ``idx`` is taken as int32, and an index outside int32
    raises `ValueError` rather than wrapping."""
    v = np.ascontiguousarray(values)
    if v.dtype.itemsize != 4:
        raise TypeError(f"take_4byte needs 4-byte elements, got {v.dtype}")
    ix = np.asarray(idx)
    if ix.dtype != np.int32:
        if ix.dtype.kind not in "iu":
            raise TypeError(f"take_4byte needs integer indices, got {ix.dtype}")
        info = np.iinfo(np.int32)
        if ix.size and (ix.min() < info.min or ix.max() > info.max):
            raise ValueError("take_4byte indices lie outside int32")
    ix = np.ascontiguousarray(ix, dtype=np.int32)
    return np.frombuffer(load().take32(v.data, ix.data), dtype=v.dtype)


def csr_groups(sorted_keys):
    """(uniq u32, row_start i32, row_len i32) of an ascending u32 array
    (threaded C two-pass)."""
    k = np.ascontiguousarray(sorted_keys, dtype=np.uint32)
    uq, rs, rl = load().csr_bounds(k.data)
    return (
        np.frombuffer(uq, dtype=np.uint32),
        np.frombuffer(rs, dtype=np.int32),
        np.frombuffer(rl, dtype=np.int32),
    )


def position_ordered(seqid, wpos) -> bool:
    """Whether a minimizer store lies in nondecreasing ``(seqid, wpos)``
    order (one C pass over the two int32 planes)."""
    s = np.ascontiguousarray(seqid, dtype=np.int32)
    w = np.ascontiguousarray(wpos, dtype=np.int32)
    return load().position_ordered(s.data, w.data)


def prefix_hist(keys, shift, bits):
    """Histogram of ``keys >> shift`` into 2^bits i32 bins."""
    k = np.ascontiguousarray(keys, dtype=np.uint32)
    return np.frombuffer(load().hist_prefix(k.data, shift, bits), dtype=np.int32)


def densest_window(sorted_vals, window):
    """Max count of an ascending i32 array in any [v, v+window)."""
    v = np.ascontiguousarray(sorted_vals, dtype=np.int32)
    return int(load().max_window_count(v.data, int(window)))
