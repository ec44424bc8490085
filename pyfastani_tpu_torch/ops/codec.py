"""Sequence byte codecs: ASCII uppercase and IUPAC reverse complement.

Behavioral parity with the reference SIMD sequence utilities
(``pyfastani: src/pyfastani/_sequtils/``):

* ``toupper`` is C-locale: only ``a``-``z`` are changed (``sequtils.cpp:21-35``).
* the complement lookup table is the 128-entry IUPAC-complete table of
  ``complement.h:5-26`` -- transcribed verbatim below, including its two
  literal quirks (positions 0x0B and 0x1B map to ``\\x00`` and ``\\x01``) --
  indexed by ``byte & 0x7F`` (``complement.h:28-30``).
* hashing operates on raw uppercased ASCII bytes (``_fastani.pyx:144-153``):
  sequences are NOT 2-bit packed, so ``N``/degenerate codes flow through
  the hash like any other byte.

Input polymorphism (str / bytes / bytearray / memoryview / numpy buffers)
matches ``_fastani.pyx:629-645``: buffers are viewed as contiguous uint8;
``str`` is read code point by code point, uppercased with C ``toupper``
semantics, and truncated to the low byte exactly like the reference's
``fwd[j] = toupper(<int> PyUnicode_READ(...))`` cast to ``char``.

A copy of ``pyfastani_tpu/ops/codec.py``, so that the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["to_bytes", "upper_inplace", "complement_table", "reverse_complement"]

# C-locale toupper for all 256 byte values
_UPPER_LUT = np.arange(256, dtype=np.uint8)
_UPPER_LUT[ord("a") : ord("z") + 1] -= 32

# verbatim transcription of COMPLEMENT_LOOKUP (complement.h:5-26)
_COMPLEMENT_128 = bytes(
    [
        0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07,
        0x08, 0x09, 0x0A, 0x00, 0x0C, 0x0D, 0x0E, 0x0F,
        0x10, 0x11, 0x12, 0x13, 0x14, 0x15, 0x16, 0x17,
        0x18, 0x19, 0x1A, 0x01, 0x1C, 0x1D, 0x1E, 0x1F,
    ]
) + b" !\"#$%&'()*+,-./0123456789:;<=>?" + b"@TVGHEFCDIJMLKNOPQYSAUBWXRZ[\\]^_" + b"`tvghefcdijmlknopqysaubwxrz{|}~\x7f"

assert len(_COMPLEMENT_128) == 128

# full 256-entry table implementing LUT[b & 0x7F]
_COMPLEMENT_LUT = np.frombuffer(_COMPLEMENT_128 * 2, dtype=np.uint8).copy()


def complement_table() -> np.ndarray:
    """The 256-entry complement table (uint8), indexed by raw byte value."""
    return _COMPLEMENT_LUT


def to_bytes(sequence) -> np.ndarray:
    """Convert any accepted sequence object into an uppercased uint8 array.

    Mirrors the reference's input handling + eager uppercase: the reference
    uppercases while filling its hash buffers (``_fastani.pyx:144-148``);
    here the whole array is uppercased once up front.
    """
    if isinstance(sequence, str):
        # match PyUnicode_READ + C toupper + (char) cast for any code point
        if sequence.isascii():
            raw = np.frombuffer(sequence.encode("ascii"), dtype=np.uint8)
            return _UPPER_LUT[raw]
        cps = np.frombuffer(sequence.encode("utf-32-le"), dtype=np.uint32)
        lower = (cps >= ord("a")) & (cps <= ord("z"))
        cps = np.where(lower, cps - 32, cps)
        return (cps & 0xFF).astype(np.uint8)
    if isinstance(sequence, np.ndarray):
        view = np.ascontiguousarray(sequence).view(np.uint8).ravel()
        return _UPPER_LUT[view]
    raw = np.frombuffer(bytes(memoryview(sequence)), dtype=np.uint8)
    return _UPPER_LUT[raw]


def upper_inplace(data: np.ndarray) -> np.ndarray:
    """C-locale uppercase of a uint8 array (``copy_upper`` equivalent)."""
    return _UPPER_LUT[data]


def reverse_complement(data: np.ndarray) -> np.ndarray:
    """IUPAC reverse complement of an (already uppercased) uint8 array.

    Equivalent to the reference ``reverse_complement`` (``sequtils.cpp:66-90``)
    applied to the uppercased forward buffer.
    """
    return _COMPLEMENT_LUT[data[::-1]]
