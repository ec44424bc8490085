"""L2 chunk evaluator: the shared-sketch curve of one candidate chunk.

Port of ``pyfastani_tpu/ops/l2_pallas.py`` (the Pallas kernel ``_kernel``)
with the semantics of ``pyfastani_tpu/ops/l2.py::l2_event_curve``.  For
chunk ``i``, every reference minimizer ``j`` of the range
``[lo, lo + rlen)`` whose hash is in fragment ``frag[i]``'s sketch makes
that hash present on the window offsets

    [start_j, p_j],   start_j = max(p_j - cmw + 1, prev_j + 1)

where ``prev_j`` is the previous same-hash occurrence in the contig
(`compute_mini_prev`; clipping there keeps per-hash intervals disjoint
without changing their union).  The shared count at a record anchor
``a`` -- a range position with ``c0 <= p_a < c0 + clen`` -- is the number
of intervals that contain ``p_a``.  A chunk outputs ``best``, the largest
count, and ``first``/``last``, the lowest and highest anchor that reach
it; with no anchor the output is ``(-1, c0, c0)``.  A chunk whose range
leaves the store or whose fragment row does not exist is read as empty and
raises the returned range flag, which the caller reads with the pass's
other flags: the check costs no host sync.

`l2_chunks` launches the hand-written CUDA kernel
(``csrc/l2_chunks.cu``; a range too long for shared memory takes its
scratch variant, with every ``rmax`` served) for CUDA tensors and takes
the plain version,
`l2_chunks_reference`, for CPU tensors; any other device raises.
``launches`` counts kernel launches and ``reference_calls`` counts runs of
the plain version, so a caller can show which one a run went through.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _native
from .._common import BIG, hash_to_i32, i32_to_hash
from ._cuda import cuda_device, current_stream, ptr, raise_on

__all__ = [
    "compute_mini_prev",
    "l2_chunks",
    "l2_chunks_reference",
    "mini_prev_from_index",
]

launches = 0
reference_calls = 0

# elements of one (chunks x range) gather in the plain version: bounds the
# memory of a slab of chunks
_REF_SLAB_ELEMS = 1 << 21


def compute_mini_prev(
    mini_hash: np.ndarray, mini_seqid: np.ndarray, mini_wpos: np.ndarray
) -> np.ndarray:
    """Per-minimizer previous same-hash occurrence (same contig), as a
    contig-local window position; ``-2**30`` where none exists."""
    m = mini_hash.shape[0]
    if m == 0:
        return np.zeros(0, np.int32)
    order = np.lexsort((mini_wpos, mini_seqid, mini_hash))
    h = mini_hash[order]
    s = mini_seqid[order]
    p = mini_wpos[order]
    prev = np.full(m, -BIG, np.int32)
    same = (h[1:] == h[:-1]) & (s[1:] == s[:-1])
    prev[1:][same] = p[:-1][same]
    out = np.empty(m, np.int32)
    out[order] = prev
    return out


def mini_prev_from_index(sub, ordered: bool | None = None) -> np.ndarray:
    """`compute_mini_prev` without the lexsort, from a ``PostingIndex``
    whose CSR sort permutation was kept (``sub.order``).

    The stable hash sort of a store in (seqid, wpos) order puts the
    postings in (hash, seqid, wpos) order, so the previous same-hash,
    same-contig occurrence is the preceding posting unless a CSR row or a
    contig starts between them.  Falls back to `compute_mini_prev` when
    the permutation is absent (an index rebuilt through live posting
    edits) or the store is not in position order; ``ordered`` is that
    order if the caller has checked it (`_native.position_ordered`).
    """
    m = int(sub.mini_hash.shape[0])
    if m == 0:
        return np.zeros(0, np.int32)
    order = getattr(sub, "order", None)
    if order is None or order.shape[0] != m or sub.post_seqid.shape[0] != m:
        return compute_mini_prev(sub.mini_hash, sub.mini_seqid, sub.mini_wpos)
    if ordered is None:
        ordered = _native.position_ordered(sub.mini_seqid, sub.mini_wpos)
    if not ordered:
        return compute_mini_prev(sub.mini_hash, sub.mini_seqid, sub.mini_wpos)
    newrow = np.zeros(m, bool)
    newrow[np.asarray(sub.row_start, dtype=np.int64)] = True
    same = ~newrow[1:] & (sub.post_seqid[1:] == sub.post_seqid[:-1])
    prev = np.full(m, -BIG, np.int32)
    prev[1:][same] = sub.post_wpos[:-1][same]
    out = np.empty(m, np.int32)
    out[order] = prev
    return out


def _check_operands(q_sorted, s_sizes, planes, chunks):
    dev = q_sorted.device
    if q_sorted.dim() != 2 or q_sorted.dtype != torch.int64:
        raise TypeError("q_sorted must be a (F, S) int64 tensor of hashes")
    named = [("s_sizes", s_sizes)] + list(planes.items()) + list(chunks.items())
    for name, t in named:
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q_sorted on {dev}")
    m = {t.shape[0] for t in planes.values()}
    n = {t.shape[0] for t in chunks.values()}
    if len(m) != 1 or len(n) != 1:
        raise ValueError("minimizer planes / chunk arrays differ in length")


def l2_chunks(
    q_sorted, s_sizes, mini_hash, mini_wpos, mini_prev,
    lo, rlen, frag, c0, clen, cmw: int, rmax: int,
):
    """``(best, first, last, range_bad)``: the first three ``(N,)`` int32
    per chunk, and a 0-d int32 flag that is 1 when some chunk's range
    leaves ``[0, M)`` or its fragment row is not in ``[0, F)``; such a
    chunk is not read and gives ``(-1, c0, c0)``.

    Args:
        q_sorted: ``(F, S)`` int64 sorted sketches (``UMAX`` pad).
        s_sizes: ``(F,)`` int32 sketch sizes; membership is searched in
            the first ``min(s, S)`` entries of a row.
        mini_hash: ``(M,)`` int32 bit patterns of the position-ordered
            minimizer hashes.
        mini_wpos, mini_prev: ``(M,)`` int32 window positions and
            previous same-hash occurrences (`compute_mini_prev`).
        lo, rlen: ``(N,)`` int32 range of each chunk.  A range lies inside
            one contig, so its positions ascend.
        frag, c0, clen: ``(N,)`` int32 fragment and window offsets.
        cmw: window width in k-mer positions.
        rmax: range capacity; a chunk sees the first ``min(rlen, rmax)``
            entries of its range.

    CUDA tensors launch the kernel, CPU tensors take `l2_chunks_reference`,
    anything else raises.  Neither falls back to the other.
    """
    global launches
    planes = dict(mini_hash=mini_hash, mini_wpos=mini_wpos, mini_prev=mini_prev)
    chunks = dict(lo=lo, rlen=rlen, frag=frag, c0=c0, clen=clen)
    _check_operands(q_sorted, s_sizes, planes, chunks)
    dev = cuda_device("l2_chunks", q_sorted)
    if dev is None:
        return l2_chunks_reference(
            q_sorted, s_sizes, mini_hash, mini_wpos, mini_prev,
            lo, rlen, frag, c0, clen, cmw, rmax,
        )

    from .._build import load_library

    lib = load_library()
    S = q_sorted.shape[1]
    N = lo.shape[0]
    best = torch.empty(N, dtype=torch.int32, device=dev)
    first = torch.empty_like(best)
    last = torch.empty_like(best)
    range_bad = torch.zeros(1, dtype=torch.int32, device=dev)
    if N == 0:
        return best, first, last, range_bad[0]
    # the kernel reads sketches as uint32: int32 tensors with the same bits
    ops = [hash_to_i32(q_sorted), s_sizes, mini_hash, mini_wpos, mini_prev]
    ops = [t.contiguous() for t in ops + [lo, rlen, frag, c0, clen]]
    op_ptr = [ptr(t) for t in ops]
    out_ptr = [ptr(t) for t in (best, first, last, range_bad)]
    stream = current_stream(dev)
    M, F = mini_hash.shape[0], q_sorted.shape[0]
    with torch.cuda.device(dev):  # the launch goes to the current device
        # ranges too long for shared memory take the scratch variant, whose
        # global scratch comes from the caching allocator
        fits = lib.l2_chunks_fits_shared(dev.index, S, rmax)
        words = 0 if fits else lib.l2_chunks_scratch_words(dev.index, S, rmax, N)
        if fits < 0 or words < 0:
            raise RuntimeError("l2_chunks: the CUDA device could not be queried")
        if fits:
            err = lib.l2_chunks_launch(
                *op_ptr[:2], S, *op_ptr[2:], N, cmw, rmax, M, F, *out_ptr, stream
            )
        else:
            scratch = torch.empty(words, dtype=torch.int32, device=dev)
            err = lib.l2_chunks_launch_scratch(
                *op_ptr[:2], S, *op_ptr[2:], N, cmw, rmax, M, F, *out_ptr,
                ptr(scratch), words, stream,
            )
    raise_on("l2_chunks", err)
    launches += 1
    return best, first, last, range_bad[0]


def l2_chunks_reference(
    q_sorted, s_sizes, mini_hash, mini_wpos, mini_prev,
    lo, rlen, frag, c0, clen, cmw: int, rmax: int,
):
    """The plain torch version of `l2_chunks` (same arguments and result).

    Each slab of chunks gathers its ranges into ``(B, R)``, tests sketch
    membership with ``torch.searchsorted`` and counts the intervals that
    contain each anchor with two searches over the sorted interval
    endpoints: ``#{start_j <= p_a} - #{p_j < p_a}``.  Chunks with an empty
    range, and chunks that raise the range flag, never reach the gather.
    """
    global reference_calls
    reference_calls += 1
    dev = q_sorted.device
    i64 = torch.int64
    N = lo.shape[0]
    M = mini_hash.shape[0]
    S = q_sorted.shape[1]
    c0_64 = c0.to(i64)
    best = torch.full((N,), -1, dtype=i64, device=dev)
    first = c0_64.clone()
    last = c0_64.clone()
    n_all = rlen.to(i64).clamp(0, rmax)
    lo64 = lo.to(i64)
    bad = (lo64 < 0) | (lo64 + n_all > M) | (frag < 0) | (frag >= q_sorted.shape[0])
    range_bad = bad.any().to(torch.int32)
    live = torch.nonzero((n_all > 0) & (clen > 0) & ~bad).reshape(-1)
    if live.numel() == 0:
        return best.to(torch.int32), first.to(torch.int32), last.to(torch.int32), range_bad
    R = int(n_all[live].max())
    B = max(1, _REF_SLAB_ELEMS // R)
    j = torch.arange(R, device=dev)[None, :]
    for s0 in range(0, live.numel(), B):
        ids = live[s0 : s0 + B]
        n = n_all[ids]
        valid = j < n[:, None]
        gidx = (lo64[ids][:, None] + j).clamp(0, M - 1)
        rh = i32_to_hash(mini_hash[gidx])
        rp = mini_wpos[gidx].to(i64)
        rv = mini_prev[gidx].to(i64)

        fr = frag[ids].to(i64)
        q = q_sorted[fr]
        s_eff = s_sizes[fr].to(i64).clamp(max=S)[:, None]
        at = torch.searchsorted(q, rh)
        in_q = (at < s_eff) & (q.gather(1, at.clamp(max=S - 1)) == rh)
        cond = in_q & valid
        start = torch.maximum(rp - (cmw - 1), rv + 1)
        starts_s = torch.sort(torch.where(cond, start, BIG), dim=1).values
        ends_s = torch.sort(torch.where(cond, rp, BIG), dim=1).values

        cc0 = c0_64[ids][:, None]
        anchor_ok = valid & (rp >= cc0) & (rp < cc0 + clen[ids].to(i64)[:, None])
        n_started = torch.searchsorted(starts_s, rp, right=True)
        n_ended = torch.searchsorted(ends_s, rp)
        shared = torch.where(anchor_ok, n_started - n_ended, -1)
        b = shared.max(dim=1).values
        is_best = shared == b[:, None]
        f = torch.where(is_best, rp, BIG).min(dim=1).values
        t = torch.where(is_best, rp, -BIG).max(dim=1).values
        none = b < 0
        best[ids] = b
        first[ids] = torch.where(none, cc0[:, 0], f)
        last[ids] = torch.where(none, cc0[:, 0], t)
    return best.to(torch.int32), first.to(torch.int32), last.to(torch.int32), range_bad
