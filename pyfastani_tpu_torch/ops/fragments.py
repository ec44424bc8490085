"""Batched fragment winnowing and sketch construction, and the chunked
winnow of long sequences.

Port of ``pyfastani_tpu/ops/fragments.py``.  `winnow_fragments`
(``_winnow_fragments_impl``): every query fragment of a dispatch is
winnowed, then each fragment's recorded minimizer hashes are sorted and
compacted to its sketch -- the sorted unique hashes, ``UMAX``-padded.  For
CUDA tensors it launches the hand-written CUDA kernel
(``csrc/winnow_fragments.cu``: one block a fragment; up to 3072 k-mer
positions the tile route, keys in registers and the window minimum as
prefix and suffix minima over blocks of ``w``; a longer fragment the long
route, its store in shared memory or, past it, in global scratch), for
CPU tensors it takes the plain version, `winnow_fragments_reference`,
which winnows the batch with the fragment axis as the leading dimension
(where the JAX package ``vmap``s); any other device raises.  ``launches``
counts kernel launches and ``reference_calls`` runs of the plain version.
`winnow_fragments_blocked` is the plain torch twin of the kernel's tile
route (the blocked window minimum); nothing on the card path calls it.

`winnow_long_sequence`: a whole contig is winnowed on the device in
fixed-size chunks of windows with the boundary state carried between
them, in the 1-D form (the JAX package's ``(R, 128)`` layout is a TPU
tiling workaround).  All outputs are integers, so the
port and the JAX package agree bitwise.
"""

from __future__ import annotations

import functools

import torch

from .._common import UMAX
from ._cuda import cuda_device, current_stream, ptr, raise_on
from .winnow import (
    _complement_lut, nucl_canonical, prot_hashes, record_rule, winnow, winnow_chunk,
)

__all__ = [
    "winnow_fragments", "winnow_fragments_blocked", "winnow_fragments_reference",
    "winnow_long_sequence",
]

_CHUNK_WINDOWS = 1 << 21  # windows winnowed per chunk
_SCRATCH_BUDGET = 1 << 30  # global scratch of the long route's grid, at most

launches = 0
reference_calls = 0


@functools.cache
def _store_bytes(device: int, length: int, k: int, w: int) -> int:
    """Global scratch bytes a block of the kernel's long route needs at
    ``(length, k, w)`` on ``device`` (0: none), asked once."""
    from .._build import load_library

    need = load_library().winnow_fragments_store_bytes(device, length, k, w)
    if need < 0:
        raise RuntimeError("winnow_fragments: the CUDA device could not be queried")
    return need


@functools.cache
def _sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def winnow_fragments(
    frags: torch.Tensor, k: int, w: int, length: int, protein: bool, kc: int
):
    """Sketch every fragment of a batch.

    Args:
        frags: ``(F, length + pad)`` uint8 fragments (``pad >= 4``).
        k, w: k-mer and window size.
        length: fragment length in bases.
        protein: forward-only hashing (no canonical strand).
        kc: width of the returned sketch axis.

    Returns:
        ``(rec_ovf, q_sorted, s)``: a 0-d bool flagging a fragment with
        more than ``kc`` sketch hashes, the ``(F, min(kc, P))`` int64
        sorted sketches (``UMAX`` pad) and the ``(F,)`` int32 sketch sizes.

    CUDA tensors launch the kernel, CPU tensors take
    `winnow_fragments_reference`, anything else raises.  Neither falls
    back to the other.
    """
    global launches
    if frags.dim() != 2 or frags.dtype != torch.uint8:
        raise TypeError("frags must be a (F, length + pad) uint8 tensor")
    if frags.shape[1] < length:
        raise ValueError(f"frags rows hold {frags.shape[1]} bytes, fewer than length {length}")
    dev = cuda_device("winnow_fragments", frags)
    if dev is None:
        return winnow_fragments_reference(frags, k, w, length, protein, kc)

    from .._build import load_library

    lib = load_library()
    F = frags.shape[0]
    wout = max(0, min(kc, length - k - w + 2))  # the reference's min(kc, P) columns
    q_sorted = torch.empty((F, wout), dtype=torch.int64, device=dev)
    s = torch.empty(F, dtype=torch.int32, device=dev)
    ovf = torch.zeros(1, dtype=torch.int32, device=dev)
    if F == 0:
        return ovf[0] != 0, q_sorted, s
    if frags.stride(1) != 1:
        frags = frags.contiguous()
    comp = _complement_lut(dev)
    stream = current_stream(dev)
    # a fragment too long for shared memory takes the long route's scratch
    # variant: a persistent grid of at most two blocks an SM, each with its
    # own store in a global scratch buffer from the caching allocator
    store = _store_bytes(dev.index, length, k, w)
    need, scratch = 0, None
    if store:
        need = store * max(1, min(F, 2 * _sm_count(dev.index), _SCRATCH_BUDGET // store))
        scratch = torch.empty(need, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):  # the launch goes to the current device
        raise_on("winnow_fragments", lib.winnow_fragments_launch(
            ptr(frags), frags.stride(0), F, length, k, w, int(protein), kc, wout, ptr(comp),
            ptr(q_sorted), ptr(s), ptr(ovf), ptr(scratch) if need else None, need, stream,
        ))
    launches += 1
    return ovf[0] != 0, q_sorted, s


def winnow_fragments_reference(
    frags: torch.Tensor, k: int, w: int, length: int, protein: bool, kc: int
):
    """The plain torch version of `winnow_fragments` (same arguments and
    result): the batch winnowed as ``(F, P)`` tensors, then sorted twice,
    around a first-occurrence mask."""
    global reference_calls
    reference_calls += 1
    n_pos = length - k + 1
    hashes = prot_hashes if protein else nucl_canonical
    canon, valid = hashes(frags, length, k, n_pos)
    record, win_hash = winnow(canon, valid, w)
    return _sketch(record, win_hash, kc)


def _sketch(record, win_hash, kc: int):
    """``(rec_ovf, q_sorted, s)`` from the windows' record flags and
    hashes: the recorded hashes sorted twice, around a first-occurrence
    mask."""
    masked = torch.where(record, win_hash, UMAX)
    s_sorted = torch.sort(masked, dim=1).values
    # first occurrence of each hash; the UMAX padding collapses into the tail
    first = torch.ones_like(record)
    first[:, 1:] = s_sorted[:, 1:] != s_sorted[:, :-1]
    first &= s_sorted != UMAX
    q_sorted = torch.sort(torch.where(first, s_sorted, UMAX), dim=1).values
    s = first.sum(dim=1).to(torch.int32)
    rec_ovf = (s > kc).any()
    return rec_ovf, q_sorted[:, : min(kc, q_sorted.shape[1])], s


_POS = (1 << 31) - 1  # positions below 2^31: the key's low bits are _POS - pos


def _blocked_window_min(canon: torch.Tensor, valid: torch.Tensor, w: int):
    """``(hash, pos)`` minimum of every ``w``-wide window (ties to the
    later position), as the kernel's tile route computes it: one key a
    position, ``hash << 31 | (2^31 - 1 - pos)`` (an invalid position is
    ``(UMAX, 0)``), its prefix and suffix minima over blocks of ``w``
    (van Herk / Gil-Werman), and window ``p`` the smaller of
    ``suffix[p]`` and ``prefix[p + w - 1]``."""
    B, N = canon.shape
    pos = torch.arange(N, device=canon.device)
    top = (UMAX << 31) | _POS
    key = torch.where(valid, (canon << 31) | (_POS - pos), top)
    nb = -(-N // w)
    pad = torch.full((B, nb * w - N), top, dtype=torch.int64, device=canon.device)
    blocks = torch.cat([key, pad], dim=1).view(B, nb, w)
    prefix = torch.cummin(blocks, dim=2).values.reshape(B, -1)[:, :N]
    suffix = torch.cummin(blocks.flip(2), dim=2).values.flip(2).reshape(B, -1)[:, :N]
    P = N - w + 1
    m = torch.minimum(suffix[:, :P], prefix[:, w - 1 : w - 1 + P])
    return m >> 31, _POS - (m & _POS)


def winnow_fragments_blocked(
    frags: torch.Tensor, k: int, w: int, length: int, protein: bool, kc: int
):
    """The plain torch twin of the kernel's tile route (same arguments
    and result as `winnow_fragments_reference`): the window minimum by
    `_blocked_window_min` in place of log doubling, then the same record
    rule and sketch.  Held against the plain version and the JAX package
    by the CPU tests; nothing on the card path calls it."""
    n_pos = length - k + 1
    hashes = prot_hashes if protein else nucl_canonical
    canon, valid = hashes(frags, length, k, n_pos)
    if n_pos - w + 1 <= 0:
        return _sketch(*winnow(canon, valid, w), kc)
    win_h, win_p = _blocked_window_min(canon, valid, w)
    return _sketch(record_rule(win_h, win_p, valid, w), win_h, kc)


def _compact(record, rank, values, cap: int):
    """The ``values`` where ``record`` holds, in order, in a ``(cap,)``
    buffer (``rank`` is the inclusive cumsum of ``record``); records past
    ``cap`` land in a dump slot that is cut off."""
    tgt = torch.where(record & (rank <= cap), rank - 1, cap)
    out = torch.zeros(cap + 1, dtype=values.dtype, device=values.device)
    return out.scatter_(0, tgt, values)[:cap]


def winnow_long_sequence(
    data: torch.Tensor, k: int, w: int, protein: bool, chunk: int | None = None
):
    """Winnow one long sequence on its device, ``chunk`` windows at a time.

    Args:
        data: ``(n,)`` uint8 uppercased sequence on the device.
        k, w: k-mer and window size.
        protein: forward-only hashing.
        chunk: windows per chunk (default ``2**21``); any size works, also
            one smaller than ``w``.

    Returns:
        ``(hashes, wpos)`` on the device: int64 hashes in ``[0, 2^32)`` and
        int32 window positions, equal to the host ``winnow_sequence``.

    Each chunk's records are compacted on the device (cumsum + scatter)
    into a buffer sized twice the expected minimizer density; the count
    is the one host read per chunk, and a denser chunk is compacted again
    into a buffer that fits.
    """
    dev = data.device
    n = int(data.shape[0])
    n_pos = n - k + 1
    n_windows = n_pos - w + 1
    if n_pos < 1 or n_windows < 1:
        return (
            torch.zeros(0, dtype=torch.int64, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev),
        )
    B = chunk or _CHUNK_WINDOWS
    N = B + w - 1  # k-mer positions the chunk's windows read
    L = N + k - 1 + 4  # bytes, with the hashes' padding
    # minimizer density is ~2/(w+1): the buffer holds twice that
    density = -(-4 * B // (w + 1))
    cap = max(1024, -(-density // 128) * 128)
    hashes = prot_hashes if protein else nucl_canonical

    def zero(dtype):
        return torch.zeros((), dtype=dtype, device=dev)

    carry = (zero(torch.bool), zero(torch.int64), zero(torch.bool), zero(torch.int64))
    out_h, out_p = [], []
    for base in range(0, n_windows, B):
        piece = torch.zeros(L, dtype=torch.uint8, device=dev)
        avail = data[base : base + L]
        piece[: avail.shape[0]] = avail
        canon, valid = hashes(piece[None], n - base, k, N)
        record, win_h, carry = winnow_chunk(canon[0], valid[0], w, carry, base, base == 0)
        rank = torch.cumsum(record, dim=0)
        wpos = base + torch.arange(B, dtype=torch.int32, device=dev)
        chunk_cap = cap
        while True:
            h = _compact(record, rank, win_h, chunk_cap)
            p = _compact(record, rank, wpos, chunk_cap)
            count = int(rank[-1])
            if count <= chunk_cap:
                break
            chunk_cap = -(-count // 128) * 128  # pathologically dense: retry bigger
        out_h.append(h[:count])
        out_p.append(p[:count])
    return torch.cat(out_h), torch.cat(out_p)
