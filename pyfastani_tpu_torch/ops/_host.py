"""Host NumPy k-mer hashing and winnowing for the host engine.

The NumPy (``xp=np``) paths of ``pyfastani_tpu/ops/murmur3.py::kmer_hashes``
and ``pyfastani_tpu/ops/winnow.py::{nucl_canonical, prot_hashes, winnow}``,
which ``models/_engine_np.py`` calls, copied so that the port imports
nothing of the JAX package.  The JAX package documents the semantics in
full: MurmurHash3_x86_32 (seed 42) of every k-mer, palindromic k-mers
skipped, the canonical hash ``min(fwd, bwd)``, window minima with ties to
the latest position, a record when the chosen occurrence changes, and the
reference's window-0 suppression quirk.  Arithmetic is wrapping uint32.
The port's torch versions (`ops.murmur3`, `ops.winnow`) run the same
semantics on a device.
"""

from __future__ import annotations

import numpy as np

from .codec import complement_table

__all__ = ["kmer_hashes", "nucl_canonical", "prot_hashes", "winnow"]

_HASH_SENTINEL = np.uint32(0xFFFFFFFF)
_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)


def _rotl32(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def kmer_hashes(data: np.ndarray, k: int, seed: int = 42, out_len: int | None = None):
    """Murmur3_x86_32 of ``data[i:i+k]`` for every position ``i``
    (``out_len`` positions, ``L - k + 1`` by default); positions whose
    k-mer reads padding give garbage hashes that callers mask."""
    n = data.shape[0] - k + 1 if out_len is None else out_len
    if n <= 0:
        return np.zeros(0, np.uint32)
    u8 = data.astype(np.uint32)

    def word_at(off):
        # little-endian uint32 at byte offset `off`, for n positions
        return (
            u8[off : off + n]
            | (u8[off + 1 : off + 1 + n] << np.uint32(8))
            | (u8[off + 2 : off + 2 + n] << np.uint32(16))
            | (u8[off + 3 : off + 3 + n] << np.uint32(24))
        )

    h1 = np.full(n, seed, dtype=np.uint32)
    nblocks = k // 4
    for j in range(nblocks):
        k1 = _rotl32(word_at(4 * j) * _C1, 15) * _C2
        h1 = _rotl32(h1 ^ k1, 13) * np.uint32(5) + np.uint32(0xE6546B64)
    tail = k & 3
    if tail:
        base = 4 * nblocks
        k1 = np.zeros(n, dtype=np.uint32)
        if tail >= 3:
            k1 = k1 ^ (u8[base + 2 : base + 2 + n] << np.uint32(16))
        if tail >= 2:
            k1 = k1 ^ (u8[base + 1 : base + 1 + n] << np.uint32(8))
        k1 = k1 ^ u8[base : base + n]
        h1 = h1 ^ (_rotl32(k1 * _C1, 15) * _C2)
    h = h1 ^ np.uint32(k)
    h = (h ^ (h >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    h = (h ^ (h >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def nucl_canonical(data: np.ndarray, n: int, k: int, n_positions: int):
    """``(canon, valid)``: canonical nucleotide k-mer hashes and validity at
    ``n_positions`` positions of an uppercased sequence of length ``n``,
    padded so that ``len(data) >= n_positions + k - 1 + 4``.

    The reverse-complement k-mer at ``i`` is the complemented, reversed
    buffer at ``L_pad - k - i``, so both strands hash with one pass each.
    """
    L_pad = data.shape[0]
    crev = complement_table()[data][::-1]
    fwd = kmer_hashes(data, k, out_len=n_positions)
    bwd = kmer_hashes(crev, k, out_len=L_pad - k + 1)[::-1][:n_positions]
    idx = np.arange(n_positions, dtype=np.int32)
    valid = (idx <= np.int32(n) - np.int32(k)) & (fwd != bwd)
    return np.minimum(fwd, bwd), valid


def prot_hashes(data: np.ndarray, n: int, k: int, n_positions: int):
    """Forward-only hashes and validity (the protein path)."""
    fwd = kmer_hashes(data, k, out_len=n_positions)
    idx = np.arange(n_positions, dtype=np.int32)
    return fwd, idx <= np.int32(n) - np.int32(k)


def _shift_left(arr, d: int, fill):
    if d == 0:
        return arr
    return np.concatenate([arr[d:], np.full(d, fill, dtype=arr.dtype)])


def _pair_min(h_a, p_a, h_b, p_b):
    """(hash, pos) min: smaller hash wins; equal hash -> larger pos wins."""
    take_b = (h_b < h_a) | ((h_b == h_a) & (p_b > p_a))
    return np.where(take_b, h_b, h_a), np.where(take_b, p_b, p_a)


def winnow(canon: np.ndarray, valid: np.ndarray, w: int):
    """``(record, win_hash)`` of length ``P = N - w + 1``: ``record[p]``
    means window ``p`` appends ``(win_hash[p], wpos=p)``."""
    N = canon.shape[0]
    P = N - w + 1
    if P <= 0:
        return np.zeros(0, bool), np.zeros(0, np.uint32)

    g_h = np.where(valid, canon, _HASH_SENTINEL)
    # invalid entries carry pos 0 so a (real) sentinel-valued hash beats them
    g_p = np.where(valid, np.arange(N, dtype=np.uint32), np.uint32(0))
    # log-doubling sliding minimum: g covers windows of size `size`
    size = 1
    while size * 2 <= w:
        sh, sp = _shift_left(g_h, size, _HASH_SENTINEL), _shift_left(g_p, size, 0)
        g_h, g_p = _pair_min(g_h, g_p, sh, sp)
        size *= 2
    rem = w - size
    win_h, win_p = _pair_min(
        g_h, g_p, _shift_left(g_h, rem, _HASH_SENTINEL), _shift_left(g_p, rem, 0)
    )
    win_h, win_p = win_h[:P], win_p[:P]

    # window p is evaluated iff its last k-mer (p + w - 1) is valid
    evaluated = valid[w - 1 : w - 1 + P]
    # the previous evaluated window's chosen position
    idx = np.arange(P, dtype=np.int32)
    marked = np.where(evaluated, idx, np.int32(-1))
    prev = np.concatenate([[np.int32(-1)], np.maximum.accumulate(marked)[:-1]])
    prev_pos = win_p[np.clip(prev, 0, P - 1)]
    is_new = evaluated & ((prev < 0) | (win_p != prev_pos))

    # window-0 suppression quirk: if the contig's first evaluated window is
    # p == 0, equal-hash occurrence changes are swallowed while every
    # evaluated window so far carried the same hash h0
    same_h0 = (~evaluated) | (win_h == win_h[0])
    prefix_ok = np.minimum.accumulate(same_h0.astype(np.int32)).astype(bool)
    suppress = evaluated[0] & (idx > 0) & prefix_ok
    return is_new & ~suppress, win_h
