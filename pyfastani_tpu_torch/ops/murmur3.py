"""MurmurHash3_x86_32 of every k-mer position, batched, in int64 torch.

Port of ``pyfastani_tpu/ops/murmur3.py::kmer_hashes``: the byte stream is
read as rolling little-endian 32-bit words ``W[i]`` and the Murmur block
loop for position ``i`` reads ``W[i + 4*j]`` -- shifted slices along the
last axis, so a whole batch of fragments hashes in ``k/4`` rounds of
elementwise math.  Hashes are int64 values in ``[0, 2^32)`` (see
`pyfastani_tpu_torch._common`); every step that can leave that range is
masked back into it.
"""

from __future__ import annotations

import torch

from .._common import MASK32

__all__ = ["kmer_hashes"]

_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for ``x`` in [0, 2^32), without int64 overflow:
    the constant is split into 16-bit halves so no product exceeds 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def kmer_hashes(
    data: torch.Tensor, k: int, seed: int = 42, out_len: int | None = None
) -> torch.Tensor:
    """Murmur3_x86_32 of ``data[..., i:i+k]`` for every position ``i``.

    Args:
        data: uint8 tensor of shape ``(..., L)``; positions whose k-mer
            reads padding give garbage hashes that callers mask.
        k: k-mer length.
        seed: murmur seed (42 in FastANI).
        out_len: positions to emit; defaults to ``L - k + 1``.

    Returns:
        int64 tensor of shape ``(..., out_len)`` with values in [0, 2^32).
    """
    L = data.shape[-1]
    n = L - k + 1 if out_len is None else out_len
    lead = data.shape[:-1]
    if n <= 0:
        return torch.zeros(lead + (0,), dtype=torch.int64, device=data.device)

    u8 = data.to(torch.int64)

    def word_at(off):
        return (
            u8[..., off : off + n]
            | (u8[..., off + 1 : off + 1 + n] << 8)
            | (u8[..., off + 2 : off + 2 + n] << 16)
            | (u8[..., off + 3 : off + 3 + n] << 24)
        )

    h1 = torch.full(lead + (n,), seed, dtype=torch.int64, device=data.device)
    nblocks = k // 4
    for j in range(nblocks):
        k1 = _mul32(word_at(4 * j), _C1)
        k1 = _mul32(_rotl32(k1, 15), _C2)
        h1 = _rotl32(h1 ^ k1, 13)
        h1 = (h1 * 5 + 0xE6546B64) & MASK32

    tail = k & 3
    if tail:
        base = 4 * nblocks
        k1 = u8[..., base : base + n].clone()
        if tail >= 2:
            k1 = k1 ^ (u8[..., base + 1 : base + 1 + n] << 8)
        if tail >= 3:
            k1 = k1 ^ (u8[..., base + 2 : base + 2 + n] << 16)
        k1 = _mul32(k1, _C1)
        k1 = _mul32(_rotl32(k1, 15), _C2)
        h1 = h1 ^ k1

    return _fmix32(h1 ^ k)
