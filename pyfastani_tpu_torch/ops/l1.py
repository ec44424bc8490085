"""Device L1 stage: posting probes, seed gathering, candidate intervals.

Port of ``pyfastani_tpu/ops/l1.py::l1_candidates_device``.  The algorithm
and its static budgets are the JAX package's (see its module docstring):

* ``hmax``: seed hits per fragment on average -- one flat hit axis of
  ``F * hmax`` slots is shared by the whole fragment batch, and overflow
  of the total is reported, never silent;
* ``ivmax``: merged candidate intervals per fragment.

Hits carry one coordinate, the global position (``post_gpos``); contigs
are laid out with at least ``l + 8`` of dead space between them, so "same
contig and within ``l``" is a single difference of global positions.

`l1_candidates` launches two hand-written CUDA kernels for CUDA tensors
(``csrc/l1_candidates.cu``: the probe, then one block a fragment for its
hits, sort, candidates and merged intervals, with a fragment past the
block's shared memory in a global scratch slice), and takes the plain
version, `l1_candidates_reference`, for CPU tensors; any other device
raises.  ``launches`` counts kernel-route calls (one a call of the two
kernels) and ``reference_calls`` runs of the plain version.  In the plain version the TPU-shaped pieces
become their plain torch counterparts: the 2-level scans are
``torch.cumsum``/``torch.cummax``, ``.at[].max`` is
``scatter_reduce_(..., "amax")`` and the two-key ``lax.sort`` is one sort
of the int64 key ``frag << 32 | gpos``.
"""

from __future__ import annotations

import functools

import torch

from .._common import GBIG, i32_to_hash
from ._cuda import check, cuda_device, current_stream, ptr, raise_on

__all__ = ["l1_candidates", "l1_candidates_reference"]

launches = 0
reference_calls = 0


@functools.cache
def _shared_slots(device: int, hmax: int) -> int:
    """Hit slots of the intervals kernel's shared buffer on ``device`` at
    budget ``hmax`` (``l1_intervals_capacity``), asked once."""
    from .._build import load_library

    cap = load_library().l1_intervals_capacity(device, hmax)
    if cap < 0:
        raise RuntimeError("l1_candidates: the CUDA device could not be queried")
    return cap


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def l1_candidates(
    q_sorted: torch.Tensor,
    s_sizes: torch.Tensor,
    uniq_hash: torch.Tensor,
    row_start: torch.Tensor,
    row_len: torch.Tensor,
    post_gpos: torch.Tensor,
    freq_threshold: int,
    min_hits_table: torch.Tensor,
    hash_bucket: torch.Tensor,
    hmax: int,
    ivmax: int,
    l: int,
    bucket_steps: int,
    m_values: tuple,
):
    """Candidate intervals in global coordinates for every fragment.

    Args:
        q_sorted: ``(F, S)`` int64 ascending sketch hashes, ``UMAX`` pad.
        s_sizes: ``(F,)`` int32 sketch sizes.
        uniq_hash: ``(U,)`` int32 bit patterns of the ascending posting
            row hashes.
        row_start, row_len: ``(U,)`` int32 CSR rows.
        post_gpos: ``(M,)`` int32 global positions of the hash-sorted
            postings.
        freq_threshold: rows at least this long are skipped.
        min_hits_table: ``(T,)`` int32 minimum hits by sketch size.
        hash_bucket: ``(2^bits + 1,)`` int32 hash-prefix table.
        hmax, ivmax: the static budgets above.
        l: fragment length.
        bucket_steps: binary-search depth inside a bucket.
        m_values: every reachable minimum-hit value (static).

    Returns:
        ``(iv_g0, iv_g1, iv_valid, ovf_hits, ovf_iv)``: two ``(F, ivmax)``
        int32 interval bounds (``iv_g0`` unclamped at contig starts), the
        ``(F, ivmax)`` bool validity and two 0-d bool overflow flags.

    CUDA tensors launch the kernels, CPU tensors take
    `l1_candidates_reference`, anything else raises; neither falls back
    to the other.  The two routes agree exactly: the flags always,
    ``iv_valid`` whenever ``ovf_iv`` is clear, and ``iv_g0``/``iv_g1``
    wherever ``iv_valid`` holds.  The columns past a fragment's intervals
    hold 0 on the kernel route (the plain version leaves other
    fragments' bounds there); nothing reads them.
    """
    global launches
    dev = cuda_device("l1_candidates", q_sorted)
    if dev is None:
        return l1_candidates_reference(
            q_sorted, s_sizes, uniq_hash, row_start, row_len, post_gpos, freq_threshold,
            min_hits_table, hash_bucket, hmax, ivmax, l, bucket_steps, m_values,
        )
    if q_sorted.dim() != 2 or q_sorted.dtype != torch.int64:
        raise TypeError("q_sorted must be an (F, S) int64 tensor")
    F, S = q_sorted.shape
    for name, t, n in (
        ("s_sizes", s_sizes, F), ("uniq_hash", uniq_hash, None), ("row_start", row_start, None),
        ("row_len", row_len, None), ("post_gpos", post_gpos, None),
        ("min_hits_table", min_hits_table, None), ("hash_bucket", hash_bucket, None),
    ):
        check(name, dev, torch.int32, t, n)
    U = uniq_hash.shape[0]
    if row_start.shape[0] != U or row_len.shape[0] != U:
        raise ValueError("uniq_hash, row_start and row_len must have one length")
    if hash_bucket.shape[0] < 2 or min_hits_table.shape[0] < 1:
        raise ValueError("hash_bucket needs 2 entries or more, min_hits_table 1 or more")

    from .._build import load_library

    lib = load_library()
    T = F * hmax
    iv_g0 = torch.empty((F, ivmax), dtype=torch.int32, device=dev)
    iv_g1 = torch.empty((F, ivmax), dtype=torch.int32, device=dev)
    iv_valid = torch.empty((F, ivmax), dtype=torch.bool, device=dev)
    flags = torch.zeros(2, dtype=torch.int32, device=dev)  # ovf_hits, ovf_iv
    if F == 0:
        ovf = flags != 0
        return iv_g0, iv_g1, iv_valid, ovf[0], ovf[1]
    if q_sorted.stride(1) != 1:  # the session's column slice keeps unit stride: no copy
        q_sorted = q_sorted.contiguous()
    s_sizes, post_gpos = s_sizes.contiguous(), post_gpos.contiguous()
    uniq_hash, row_start, row_len = uniq_hash.contiguous(), row_start.contiguous(), row_len.contiguous()
    min_hits_table, hash_bucket = min_hits_table.contiguous(), hash_bucket.contiguous()
    probe_len = torch.empty((F, S), dtype=torch.int32, device=dev)
    probe_start = torch.empty((F, S), dtype=torch.int32, device=dev)
    counts = torch.empty(F, dtype=torch.int64, device=dev)
    bits = int(hash_bucket.shape[0] - 1).bit_length() - 1
    stream = current_stream(dev)
    with torch.cuda.device(dev):  # the launches go to the current device
        raise_on("l1_probe", lib.l1_probe_launch(
            ptr(q_sorted), q_sorted.stride(0), ptr(s_sizes), F, S, ptr(uniq_hash),
            ptr(row_start), ptr(row_len), U, ptr(hash_bucket), bits, bucket_steps,
            min(int(freq_threshold), 2**62),
            ptr(probe_len), ptr(probe_start), ptr(counts), stream,
        ))
        ends = torch.cumsum(counts, dim=0)  # each fragment's slots end at min(ends[f], T)
        cap = _shared_slots(dev.index, hmax)
        # a fragment past the block's shared memory sorts in its own slots
        scratch = torch.empty(max(T, 1), dtype=torch.int32, device=dev)
        raise_on("l1_intervals", lib.l1_intervals_launch(
            ptr(probe_len), ptr(probe_start), ptr(counts), ptr(ends), F, S, ptr(s_sizes),
            ptr(min_hits_table), min_hits_table.shape[0], ptr(post_gpos), post_gpos.shape[0],
            T, ivmax, l, cap, ptr(iv_g0), ptr(iv_g1), ptr(iv_valid), ptr(flags), ptr(scratch),
            stream,
        ))
    launches += 1
    ovf = flags != 0
    return iv_g0, iv_g1, iv_valid, ovf[0], ovf[1]


def l1_candidates_reference(
    q_sorted: torch.Tensor,
    s_sizes: torch.Tensor,
    uniq_hash: torch.Tensor,
    row_start: torch.Tensor,
    row_len: torch.Tensor,
    post_gpos: torch.Tensor,
    freq_threshold: int,
    min_hits_table: torch.Tensor,
    hash_bucket: torch.Tensor,
    hmax: int,
    ivmax: int,
    l: int,
    bucket_steps: int,
    m_values: tuple,
):
    """The plain torch version of `l1_candidates` (same arguments and
    result): whole-array ops over the flat ``F * hmax`` hit axis."""
    global reference_calls
    reference_calls += 1
    dev = q_sorted.device
    F, S = q_sorted.shape
    M = post_gpos.shape[0]
    U = uniq_hash.shape[0]
    T = F * hmax
    i64 = torch.int64

    # --- probe the CSR index: binary search inside the hash-prefix bucket --
    bits = int(hash_bucket.shape[0] - 1).bit_length() - 1
    b = q_sorted >> (32 - bits)
    lo = hash_bucket[b].to(i64)
    hi = hash_bucket[b + 1].to(i64)
    for _ in range(bucket_steps):
        active = lo < hi
        mid = (lo + hi) // 2
        go_right = i32_to_hash(uniq_hash[mid.clamp(0, max(U - 1, 0))]) < q_sorted
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    rows = lo
    rows_c = rows.clamp(0, max(U - 1, 0))
    i_idx = torch.arange(S, device=dev)[None, :]
    found = (
        (rows < U)
        & (i32_to_hash(uniq_hash[rows_c]) == q_sorted)
        & (i_idx < s_sizes[:, None])
    )
    at_len = row_len[rows_c].to(i64)
    lens = torch.where(found & (at_len < freq_threshold), at_len, 0)

    # --- gather posting rows into one flat hit buffer ----------------------
    lens_flat = lens.reshape(-1)  # probe order == fragment order
    off_end = torch.cumsum(lens_flat, dim=0)
    total = off_end[-1]
    ovf_hits = total > T
    off_begin = off_end - lens_flat

    m_frag = min_hits_table[
        s_sizes.clamp(0, min(S, min_hits_table.shape[0] - 1)).to(i64)
    ].to(i64).clamp(min=1)  # (F,)
    delta = row_start[rows_c].to(i64).reshape(-1) - off_begin
    m_probe = m_frag[:, None].expand(F, S).reshape(-1)

    # probe owning each output slot: scatter every non-empty probe's id at
    # its begin offset, then fill forward with a running max
    probe_ids = torch.arange(F * S, device=dev)
    scat = torch.where(lens_flat > 0, off_begin.clamp(max=T), T)
    seg = torch.zeros(T + 1, dtype=i64, device=dev).scatter_reduce_(
        0, scat, probe_ids, "amax"
    )
    seg = _cummax(seg[:T])
    t_idx = torch.arange(T, device=dev)
    src = delta[seg] + t_idx
    valid_t = t_idx < torch.clamp(total, max=T)
    hit_frag = torch.where(valid_t, seg // S, F)
    m_t = torch.where(valid_t, m_probe[seg], 1)
    hit_gpos = torch.where(
        valid_t, post_gpos[src.clamp(0, max(M - 1, 0))].to(i64), GBIG
    )

    # --- sort hits by (fragment, gpos) as one int64 key ---------------------
    # the sort permutes only inside each fragment's fixed slot range, so
    # the per-slot m_t above is already in sorted order
    key = torch.sort((hit_frag << 32) | hit_gpos).values
    hit_frag = key >> 32
    hit_gpos = key & 0xFFFFFFFF

    # --- m-consecutive-hit candidate windows: hits[t + m_t - 1] ------------
    mmax = max(m_values)
    pad_f = torch.cat([hit_frag, torch.full((mmax,), GBIG, dtype=i64, device=dev)])
    pad_g = torch.cat([hit_gpos, torch.full((mmax,), GBIG, dtype=i64, device=dev)])
    v0 = m_values[0]
    frag_j2 = pad_f[v0 - 1 : v0 - 1 + T]
    gpos_j2 = pad_g[v0 - 1 : v0 - 1 + T]
    for v in m_values[1:]:
        sel = m_t == v
        frag_j2 = torch.where(sel, pad_f[v - 1 : v - 1 + T], frag_j2)
        gpos_j2 = torch.where(sel, pad_g[v - 1 : v - 1 + T], gpos_j2)
    cand_ok = (
        (hit_frag < F)
        & (hit_gpos < GBIG)
        & (t_idx + m_t - 1 < T)
        & (frag_j2 == hit_frag)
        & (gpos_j2 - hit_gpos < l)  # same contig implied: gaps >= l + 8
    )
    cand_gstart = gpos_j2 - l + 1
    cand_gend = hit_gpos

    # --- merge overlapping candidates ---------------------------------------
    cand_idx = torch.where(cand_ok, t_idx, -1)
    lastc = _cummax(cand_idx)
    prev_idx = torch.cat([torch.full((1,), -1, dtype=i64, device=dev), lastc[:-1]])
    p_c = prev_idx.clamp(0, T - 1)
    boundary = cand_ok & (
        (prev_idx < 0) | (hit_frag[p_c] != hit_frag) | (cand_gstart > hit_gpos[p_c])
    )
    b_cum = torch.cumsum(boundary.to(i64), dim=0)
    b_ext = torch.cat([b_cum - boundary.to(i64), b_cum[-1:]])  # (T + 1,)
    frag_start = off_begin.reshape(F, S)[:, 0]
    frag_next = torch.cat([frag_start[1:], torch.clamp(total, max=T)[None]])
    base = b_ext[frag_start.clamp(0, T)]
    n_iv = b_ext[frag_next.clamp(0, T)] - base
    ovf_iv = (n_iv > ivmax).any()

    # interval j spans slots [pos_b[j], pos_b[j+1]); its first member is the
    # boundary slot and its last member the last candidate before the next
    NI = F * ivmax
    targets = torch.arange(1, NI + 2, dtype=i64, device=dev)
    pos_b = torch.searchsorted(b_cum, targets, side="left")
    e = (pos_b[1:] - 1).clamp(0, T - 1)
    last_slot = lastc[e].clamp(0, T - 1)
    g0_flat = cand_gstart[pos_b[:NI].clamp(0, T - 1)]
    g1_flat = cand_gend[last_slot]
    take = (base[:, None] + torch.arange(ivmax, device=dev)[None, :]).clamp(0, NI - 1)
    iv_g0 = g0_flat[take].to(torch.int32)
    iv_g1 = g1_flat[take].to(torch.int32)
    iv_valid = torch.arange(ivmax, device=dev)[None, :] < n_iv.clamp(max=ivmax)[:, None]
    return iv_g0, iv_g1, iv_valid, ovf_hits, ovf_iv
