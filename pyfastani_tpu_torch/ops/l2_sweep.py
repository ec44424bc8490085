"""The L2 sweep around its chunk evaluator: the chunk plan and the merge.

Port of ``pyfastani_tpu/parallel/sharded.py::_l2_interval_scan`` without
its evaluator (`ops.l2.l2_chunks`), in the structure of its
``use_pallas`` branch:

* `l2_plan` cuts every valid candidate interval into chunks of at most
  ``cmax`` window offsets, compacted to the front of a ``ch_max``-slot
  axis, and gives each chunk its range of the position-ordered minimizer
  store: two lower-bound searches of ``mini_gpos`` through the
  prefix-bucket table, clamped to the contig's block (``cof_idx``), so a
  range holds one contig and its positions ascend.  A range longer than
  ``rcap`` is cut there and flagged, and so is a chunk total past
  ``ch_max``;
* `l2_merge` merges the chunk results back per interval: the largest
  ``best``, then the first and last anchor at it.

Each wrapper launches a hand-written CUDA kernel for CUDA tensors
(``csrc/l2_sweep.cu``: the plan as a count pass, a ``torch.cumsum`` and a
slot pass; the merge as one pass) and takes its plain version,
`l2_plan_reference` or `l2_merge_reference`, for CPU tensors; any other
device raises.  ``<wrapper>_launches`` and ``<wrapper>_reference_calls``
count kernel-route calls and runs of the plain version.  The plan's routes
agree on every slot below ``min(total, ch_max)``, where ``total`` is the
chunk count, and on both flags; past it both hold ``rlen = ch_len = ch_c0
= 0`` (the kernel 0 in all five operands).
The merge's agree on every interval while no flag is raised.  No
operation waits for the device.
"""

from __future__ import annotations

import torch

from .._common import BIG
from ._cuda import check, cuda_device, current_stream, ptr, raise_on

__all__ = ["l2_merge", "l2_merge_reference", "l2_plan", "l2_plan_reference"]

l2_plan_launches = l2_plan_reference_calls = 0
l2_merge_launches = l2_merge_reference_calls = 0

I32_MIN = -(2**31)
I32_MAX = 2**31 - 1


def segment(values, seg, n_seg: int, reduce: str, identity):
    """``jax.ops.segment_max/min``: ``reduce`` ("amax"/"amin") of
    ``values`` by ``seg`` into ``n_seg`` slots, empty slots = identity."""
    out = torch.full((n_seg,), identity, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, seg, values, reduce)


def bucketed_gpos_search(mini_gpos, keys, bucket, shift: int, steps: int):
    """``searchsorted(mini_gpos, keys, 'left')`` through the prefix-bucket
    table: ``steps`` rounds inside one bucket instead of log2(M)."""
    b = (keys >> shift).clamp(0, bucket.shape[0] - 2)
    lo = bucket[b].to(torch.int64)
    hi = bucket[b + 1].to(torch.int64)
    M = mini_gpos.shape[0]
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) // 2
        go_right = mini_gpos[mid.clamp(0, max(M - 1, 0))] < keys
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def l2_plan(
    frag_of_iv, iv_seq, iv_c0, iv_c1, iv_valid,
    contig_offset, cof_idx, mini_gpos, gpos_bucket,
    gpos_shift: int, gpos_steps: int, cmw: int, cmax: int, rcap: int, ch_max: int,
):
    """The chunk plan of an L2 sweep.

    Args:
        frag_of_iv, iv_seq, iv_c0, iv_c1: ``(NI,)`` int64 per interval: its
            fragment row, its contig and its first and last window offset.
        iv_valid: ``(NI,)`` bool.
        contig_offset, cof_idx: ``(C + 1,)`` int32 global offset and first
            minimizer index of each contig (and the ends).
        mini_gpos: ``(M,)`` int32 ascending global positions of the store.
        gpos_bucket: ``(2^B + 1,)`` int32 prefix-bucket table of
            ``mini_gpos`` by ``gpos >> gpos_shift``.
        gpos_shift, gpos_steps: its shift and the search depth inside a
            bucket.
        cmw: window positions a fragment spans (``l - k + 1``).
        cmax: window offsets a chunk holds at most.
        rcap: range entries a chunk holds at most.
        ch_max: chunk slots.

    Returns:
        ``(lo, rlen, ch_frag, ch_c0, ch_len, ends, overflow, rovf)``: the
        five ``(ch_max,)`` int32 chunk operands of `ops.l2.l2_chunks`,
        ``(NI,)`` int64 ``ends`` (the cumulative chunk counts, which
        `l2_merge` reads), and two 0-d bool flags: the chunk total passes
        ``ch_max``, a range passes ``rcap``.
    """
    global l2_plan_launches
    dev = cuda_device("l2_plan", iv_seq)
    if dev is None:
        return l2_plan_reference(
            frag_of_iv, iv_seq, iv_c0, iv_c1, iv_valid, contig_offset, cof_idx, mini_gpos,
            gpos_bucket, gpos_shift, gpos_steps, cmw, cmax, rcap, ch_max,
        )
    NI = iv_seq.shape[0]
    for name, t in (("frag_of_iv", frag_of_iv), ("iv_seq", iv_seq), ("iv_c0", iv_c0),
                    ("iv_c1", iv_c1)):
        check(name, dev, torch.int64, t, NI)
    check("iv_valid", dev, torch.bool, iv_valid, NI)
    for name, t in (("contig_offset", contig_offset), ("cof_idx", cof_idx),
                    ("mini_gpos", mini_gpos), ("gpos_bucket", gpos_bucket)):
        check(name, dev, torch.int32, t)
    if cof_idx.shape[0] != contig_offset.shape[0] or contig_offset.shape[0] < 2:
        raise ValueError("contig_offset and cof_idx need one length, 2 or more")
    if gpos_bucket.shape[0] < 2 or NI < 1 or ch_max < 1 or cmax < 1:
        raise ValueError("l2_plan needs 2 bucket entries, an interval, a slot and cmax >= 1")

    from .._build import load_library

    lib = load_library()
    frag_of_iv, iv_seq, iv_c0, iv_c1, iv_valid, contig_offset, cof_idx, mini_gpos, gpos_bucket = (
        t.contiguous() for t in (frag_of_iv, iv_seq, iv_c0, iv_c1, iv_valid, contig_offset,
                                 cof_idx, mini_gpos, gpos_bucket)
    )
    n_ch = torch.empty(NI, dtype=torch.int64, device=dev)
    out = torch.empty((5, ch_max), dtype=torch.int32, device=dev)
    flags = torch.zeros(2, dtype=torch.bool, device=dev)  # chunk, range overflow
    stream = current_stream(dev)
    with torch.cuda.device(dev):  # the launches go to the tensors' device
        raise_on("l2_plan count", lib.l2_plan_count_launch(
            ptr(iv_c0), ptr(iv_c1), ptr(iv_valid), NI, cmax, ptr(n_ch), stream,
        ))
        ends = torch.cumsum(n_ch, dim=0)
        raise_on("l2_plan", lib.l2_plan_launch(
            ptr(ends), NI, ch_max, ptr(iv_seq), ptr(iv_c0), ptr(iv_c1), ptr(frag_of_iv),
            ptr(contig_offset), contig_offset.shape[0], ptr(cof_idx), ptr(mini_gpos),
            mini_gpos.shape[0], ptr(gpos_bucket), gpos_bucket.shape[0], gpos_shift, gpos_steps, cmw, cmax, rcap,
            *(ptr(row) for row in out), ptr(flags), stream,
        ))
    l2_plan_launches += 1
    return (*out.unbind(0), ends, flags[0], flags[1])


def l2_plan_reference(
    frag_of_iv, iv_seq, iv_c0, iv_c1, iv_valid,
    contig_offset, cof_idx, mini_gpos, gpos_bucket,
    gpos_shift: int, gpos_steps: int, cmw: int, cmax: int, rcap: int, ch_max: int,
):
    """The plain torch version of `l2_plan` (same arguments and result)."""
    global l2_plan_reference_calls
    l2_plan_reference_calls += 1
    dev = iv_seq.device
    i64 = torch.int64
    NI = iv_seq.shape[0]
    span = torch.where(iv_valid, iv_c1 - iv_c0 + 1, 0)
    n_ch = (span + cmax - 1) // cmax
    ends = torch.cumsum(n_ch, dim=0)
    total = ends[-1]
    starts = ends - n_ch

    j = torch.arange(ch_max, device=dev)
    # owning interval per chunk slot: scatter each non-empty interval's id
    # at its first slot, then fill forward with a running max
    scat0 = torch.where(n_ch > 0, starts.clamp(max=ch_max), ch_max)
    iv_of = torch.zeros(ch_max + 1, dtype=i64, device=dev).scatter_reduce_(
        0, scat0, torch.arange(NI, device=dev), "amax"
    )
    iv_of_c = torch.cummax(iv_of[:ch_max], dim=0).values.clamp(0, NI - 1)
    ch_valid = j < total
    overflow = total > ch_max
    ch_c0 = torch.where(ch_valid, iv_c0[iv_of_c] + (j - starts[iv_of_c]) * cmax, 0)
    ch_len = torch.where(ch_valid, (iv_c1[iv_of_c] - ch_c0 + 1).clamp(0, cmax), 0)
    ch_frag = frag_of_iv[iv_of_c]
    seq_c = iv_seq[iv_of_c].clamp(0, contig_offset.shape[0] - 2)
    ch_base = contig_offset[seq_c].to(i64)

    key_lo = ch_base + ch_c0
    key_hi = ch_base + (ch_c0 + ch_len - 1 + cmw).clamp(max=BIG)
    lo = bucketed_gpos_search(mini_gpos, key_lo, gpos_bucket, gpos_shift, gpos_steps)
    hi = bucketed_gpos_search(mini_gpos, key_hi, gpos_bucket, gpos_shift, gpos_steps)
    cof = cof_idx.to(i64)
    lo = torch.maximum(lo, cof[seq_c])
    hi = torch.minimum(hi, cof[seq_c + 1])
    rlen = torch.where(ch_valid, (hi - lo).clamp(min=0), 0)
    rovf = (rlen > rcap).any()
    rlen = rlen.clamp(0, rcap)

    i32 = torch.int32
    return (
        lo.to(i32), rlen.to(i32), ch_frag.to(i32), ch_c0.to(i32), ch_len.to(i32),
        ends, overflow, rovf,
    )


def l2_merge(cbest, cfirst, clast, ends, iv_valid):
    """``(best, first, last)``, each ``(NI,)`` int64, per interval from the
    ``(ch_max,)`` int32 chunk results of `ops.l2.l2_chunks` and the plan's
    ``ends`` (`l2_plan`): the largest chunk ``best``, the smallest
    ``first`` and largest ``last`` among the chunks at it; ``I32_MIN``,
    ``I32_MAX``, ``I32_MIN`` for an interval without a chunk slot, and
    ``best = -1`` unless ``iv_valid`` and the interval has chunks.  The
    kernel walks each interval's own slots; the plain version finds each
    slot's interval in ``ends``."""
    global l2_merge_launches
    dev = cuda_device("l2_merge", ends)
    if dev is None:
        return l2_merge_reference(cbest, cfirst, clast, ends, iv_valid)
    NI, ch_max = ends.shape[0], cbest.shape[0]
    for name, t in (("cbest", cbest), ("cfirst", cfirst), ("clast", clast)):
        check(name, dev, torch.int32, t, ch_max)
    check("ends", dev, torch.int64, ends)
    check("iv_valid", dev, torch.bool, iv_valid, NI)

    from .._build import load_library

    lib = load_library()
    cbest, cfirst, clast, ends, iv_valid = (
        t.contiguous() for t in (cbest, cfirst, clast, ends, iv_valid)
    )
    out = torch.empty((3, NI), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        raise_on("l2_merge", lib.l2_merge_launch(
            ptr(cbest), ptr(cfirst), ptr(clast), ptr(ends), ptr(iv_valid), NI, ch_max,
            *(ptr(row) for row in out), current_stream(dev),
        ))
    l2_merge_launches += 1
    return out.unbind(0)


def l2_merge_reference(cbest, cfirst, clast, ends, iv_valid):
    """The plain torch version of `l2_merge` (same arguments and result)."""
    global l2_merge_reference_calls
    l2_merge_reference_calls += 1
    i64 = torch.int64
    NI = ends.shape[0]
    n_ch = torch.diff(ends, prepend=ends.new_zeros(1))
    j = torch.arange(cbest.shape[0], device=ends.device)
    ch_valid = j < ends[-1]
    # each slot's interval: the first whose end passes it
    owner = torch.searchsorted(ends, j, right=True).clamp(max=NI - 1)
    cbest, cfirst, clast = cbest.to(i64), cfirst.to(i64), clast.to(i64)

    seg = torch.where(ch_valid, owner, NI)
    best = segment(cbest, seg, NI + 1, "amax", I32_MIN)[:NI]
    is_best = ch_valid & (cbest == best[owner])
    first = segment(torch.where(is_best, cfirst, BIG), seg, NI + 1, "amin", I32_MAX)[:NI]
    last = segment(torch.where(is_best, clast, -BIG), seg, NI + 1, "amax", I32_MIN)[:NI]
    best = torch.where(iv_valid & (n_ch > 0), best, -1)
    return best, first, last
