"""The L2 sweep around its chunk evaluator: the chunk plan and the merge.

Port of ``pyfastani_tpu/parallel/sharded.py::_l2_interval_scan`` without
its evaluator (`ops.l2.l2_chunks`), in the structure of its
``use_pallas`` branch, together with the contig lookup before it
(``_query_block_impl``):

* `l2_plan` takes the L1 stage's intervals as global positions, looks up
  each interval's contig (`contig_lookup`), cuts every valid interval into
  chunks of at most ``cmax`` window offsets, compacted to the front of a
  ``ch_max``-slot axis, and gives each chunk its range of the
  position-ordered minimizer store: two lower-bound searches of
  ``mini_gpos`` through the prefix-bucket table, clamped to the contig's
  block (``cof_idx``), so a range holds one contig and its positions
  ascend.  A range longer than ``rcap`` is cut there and flagged, and so
  is a chunk total past ``ch_max``;
* `l2_merge_reference` merges the chunk results back per interval: the
  largest ``best``, then the first and last anchor at it.  On the card
  the merge runs inside the gate + CGI kernel (`ops.cgi.cgi_bins`), so
  it has no wrapper of its own; this plain version is the first step of
  ``cgi_bins_reference``.

`l2_plan` launches a hand-written CUDA kernel for CUDA tensors
(``csrc/l2_sweep.cu``: two launches tiled by intervals) and takes its
plain version, `l2_plan_reference`, for CPU tensors; any other device
raises.  ``l2_plan_launches`` and ``l2_plan_reference_calls`` count
kernel-route calls and runs of the plain version.  The routes agree on
``iv_seq`` and ``ends`` everywhere, on every slot below ``min(total,
ch_max)``, where ``total`` is the chunk count, and on both flags; past it
both hold ``rlen = ch_len = ch_c0 = 0`` (the kernels 0 in all five
operands, as their twin `l2_plan_tiled` does).  No operation waits for
the device.
"""

from __future__ import annotations

import torch

from .._common import BIG
from ._cuda import check, cuda_device, current_stream, raise_on

__all__ = [
    "contig_lookup", "l2_merge_reference", "l2_plan", "l2_plan_reference", "l2_plan_tiled",
]

l2_plan_launches = l2_plan_reference_calls = 0

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
    iv_g0, iv_g1, iv_valid, ivmax: int,
    contig_offset, cof_idx, mini_gpos, gpos_bucket,
    gpos_shift: int, gpos_steps: int, cmw: int, cmax: int, rcap: int, ch_max: int,
):
    """The chunk plan of an L2 sweep, from the L1 stage's intervals.

    Args:
        iv_g0, iv_g1: ``(F, ivmax)`` int32 first and last global position
            of each candidate interval, as `ops.l1.l1_candidates` returns
            them (interval ``i`` of the flattened ``NI = F * ivmax`` is
            fragment ``i // ivmax``'s).
        iv_valid: ``(NI,)`` bool.
        ivmax: intervals a fragment.
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
        ``(lo, rlen, ch_frag, ch_c0, ch_len, ends, iv_seq, overflow,
        rovf)``: the five ``(ch_max,)`` int32 chunk operands of
        `ops.l2.l2_chunks`, ``(NI,)`` int64 ``ends`` (the cumulative chunk
        counts, which `ops.cgi.cgi_bins` reads), ``(NI,)`` int64 ``iv_seq`` (each
        interval's contig, which `ops.cgi.cgi_bins` reads), and two 0-d
        bool flags: the chunk total passes ``ch_max``, a range passes
        ``rcap``.
    """
    global l2_plan_launches
    dev = cuda_device("l2_plan", iv_g1)
    if dev is None:
        return l2_plan_reference(
            iv_g0, iv_g1, iv_valid, ivmax, contig_offset, cof_idx, mini_gpos, gpos_bucket,
            gpos_shift, gpos_steps, cmw, cmax, rcap, ch_max,
        )
    NI = iv_valid.shape[0]
    for name, t in (("iv_g0", iv_g0), ("iv_g1", iv_g1)):
        if t.dim() != 2 or t.dtype != torch.int32 or t.device != dev or t.shape[1] != ivmax:
            raise TypeError(f"{name} must be a (F, ivmax) torch.int32 tensor on {dev}")
        if t.numel() != NI:
            raise ValueError(f"{name} holds {t.numel()} intervals, iv_valid {NI}")
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
    iv_g0, iv_g1, iv_valid, contig_offset, cof_idx, mini_gpos, gpos_bucket = (
        t.contiguous() for t in (iv_g0, iv_g1, iv_valid, contig_offset, cof_idx, mini_gpos,
                                 gpos_bucket)
    )
    n_tiles = lib.l2_plan_tiles(NI)
    # contigs, ends and the tiles' chunk totals (a workspace the call rewrites)
    iv_seq, ends, tiles = torch.empty(2 * NI + n_tiles, dtype=torch.int64, device=dev).split(
        [NI, NI, n_tiles])
    out = torch.empty((5, ch_max), dtype=torch.int32, device=dev)
    flags = torch.empty(2, dtype=torch.bool, device=dev)  # chunk, range overflow
    rows = [out.data_ptr() + 4 * ch_max * r for r in range(5)]  # the five operands' rows
    with torch.cuda.device(dev):  # the launches go to the tensors' device
        raise_on("l2_plan", lib.l2_plan_launch(
            iv_g0.data_ptr(), iv_g1.data_ptr(), iv_valid.data_ptr(), NI, ivmax,
            contig_offset.data_ptr(), contig_offset.shape[0], cof_idx.data_ptr(),
            mini_gpos.data_ptr(), mini_gpos.shape[0], gpos_bucket.data_ptr(),
            gpos_bucket.shape[0], gpos_shift, gpos_steps, cmw, cmax, rcap, ch_max,
            tiles.data_ptr(), iv_seq.data_ptr(), ends.data_ptr(), *rows,
            flags.data_ptr(), current_stream(dev),
        ))
    l2_plan_launches += 1
    return (*out.unbind(0), ends, iv_seq, *flags.unbind(0))


def contig_lookup(iv_g0, iv_g1, ivmax: int, contig_offset):
    """``(frag_of_iv, iv_seq, iv_c0, iv_c1)``, each ``(NI,)`` int64: each
    interval's fragment row, its contig and its first and last window
    offset in it.  ``iv_g1`` is a real minimizer's position; ``iv_g0`` may
    precede the contig's base and is clamped to it."""
    i64 = torch.int64
    coff = contig_offset
    g0f = iv_g0.reshape(-1).to(i64)
    g1f = iv_g1.reshape(-1).to(i64)
    iv_seq = (torch.searchsorted(coff.to(i64), g1f, right=True) - 1).clamp(
        0, coff.shape[0] - 2
    )
    iv_base = coff[iv_seq].to(i64)
    iv_c0 = torch.maximum(g0f, iv_base) - iv_base
    iv_c1 = g1f - iv_base
    frag_of_iv = torch.arange(g1f.shape[0], device=g1f.device) // ivmax
    return frag_of_iv, iv_seq, iv_c0, iv_c1


def l2_plan_reference(
    iv_g0, iv_g1, iv_valid, ivmax: int,
    contig_offset, cof_idx, mini_gpos, gpos_bucket,
    gpos_shift: int, gpos_steps: int, cmw: int, cmax: int, rcap: int, ch_max: int,
):
    """The plain torch version of `l2_plan` (same arguments and result):
    `contig_lookup`, then the plan of the JAX package's sweep."""
    global l2_plan_reference_calls
    l2_plan_reference_calls += 1
    frag_of_iv, iv_seq, iv_c0, iv_c1 = contig_lookup(iv_g0, iv_g1, ivmax, contig_offset)
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
        ends, iv_seq, overflow, rovf,
    )


_TILE = 512  # intervals a tile of the kernels (kTile of csrc/l2_sweep.cu)
_WIN = 16  # store positions the kernels read around the interpolated place


def gpos_search_window(mini_gpos, keys, bucket, shift: int, steps: int):
    """`bucketed_gpos_search` as the kernels' ``search_pair`` takes it:
    the key's place interpolated inside its bucket, the `_WIN` positions
    from the 4-aligned index 6 before it, the lower bound inside that
    window when the window brackets the key, else in the part of the
    bucket it names; a bucket that ``steps`` halvings do not exhaust takes
    the halvings."""
    b = (keys >> shift).clamp(0, bucket.shape[0] - 2)
    lo = bucket[b].to(torch.int64)
    hi = bucket[b + 1].to(torch.int64)
    M = mini_gpos.shape[0]
    if M == 0:
        return lo
    within = (keys - (b << shift)).clamp(0, (1 << shift) - 1)
    g = lo + ((within * (hi - lo)) >> shift)
    ws = torch.maximum(lo, torch.minimum(g - 6, hi - _WIN))
    wa = ws & ~3
    a = torch.maximum(wa, lo)
    e = torch.minimum(wa + _WIN, hi)
    idx = wa[..., None] + torch.arange(_WIN, device=keys.device)
    inside = (idx >= a[..., None]) & (idx < e[..., None])
    pos = mini_gpos.to(torch.int64)
    below = (inside & (pos[idx.clamp(0, M - 1)] < keys[..., None])).sum(-1)
    first = pos[a.clamp(0, M - 1)]
    last = pos[(e - 1).clamp(0, M - 1)]
    bound = torch.searchsorted(pos, keys)  # the lower bound over the whole store
    found = a + below
    found = torch.where((e < hi) & (last < keys), bound.clamp(e, hi), found)
    found = torch.where((a > lo) & (first >= keys), bound.clamp(lo, a), found)
    found = torch.where(lo >= hi, lo, found)
    deep = (hi - lo) >> steps != 0
    return torch.where(deep, bucketed_gpos_search(mini_gpos, keys, bucket, shift, steps), found)


def l2_plan_tiled(
    iv_g0, iv_g1, iv_valid, ivmax: int,
    contig_offset, cof_idx, mini_gpos, gpos_bucket,
    gpos_shift: int, gpos_steps: int, cmw: int, cmax: int, rcap: int, ch_max: int,
):
    """The plain torch twin of the kernels' design (same arguments and
    result as `l2_plan_reference`): the tiles' chunk totals, each tile
    rescanned behind the totals before it, each chunk placed from its
    interval's running count, each range found by `gpos_search_window`,
    and 0 in all five chunk operands past the live slots.  Held against
    the plain version by the CPU tests; nothing on the card path calls
    it."""
    i64 = torch.int64
    dev = iv_g1.device
    _, iv_seq, c0, c1 = contig_lookup(iv_g0, iv_g1, ivmax, contig_offset)
    NI = iv_seq.shape[0]
    n_ch = torch.where(iv_valid, torch.div(c1 - c0 + cmax, cmax, rounding_mode="floor"), 0)
    # launch A: each tile's chunk total
    n_tiles = -(-NI // _TILE)
    tiled = torch.zeros(n_tiles * _TILE, dtype=i64, device=dev)
    tiled[:NI] = n_ch
    tiled = tiled.view(n_tiles, _TILE)
    tile_total = tiled.sum(1)
    # launch B: the totals before each tile, its rescan, the emission
    before = torch.cumsum(tile_total, 0) - tile_total
    total = int(tile_total.sum())
    ends = (before[:, None] + torch.cumsum(tiled, 1)).reshape(-1)[:NI]
    count = torch.where(iv_valid, n_ch.clamp(min=0), 0)
    owner = torch.repeat_interleave(torch.arange(NI, device=dev), count)
    c = torch.arange(owner.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(count, 0) - count, count)
    j = (ends - n_ch)[owner] + c
    keep = (j >= 0) & (j < ch_max)
    owner, c, j = owner[keep], c[keep], j[keep]
    seq = iv_seq[owner]
    base = contig_offset.to(i64)[seq]
    ch_c0 = c0[owner] + c * cmax
    ch_len = (c1[owner] - ch_c0 + 1).clamp(0, cmax)
    key_lo = base + ch_c0
    key_hi = base + (ch_c0 + ch_len - 1 + cmw).clamp(max=BIG)
    cof = cof_idx.to(i64)
    lo = torch.maximum(
        gpos_search_window(mini_gpos, key_lo, gpos_bucket, gpos_shift, gpos_steps), cof[seq])
    hi = torch.minimum(
        gpos_search_window(mini_gpos, key_hi, gpos_bucket, gpos_shift, gpos_steps), cof[seq + 1])
    rlen = (hi - lo).clamp(min=0)
    out = torch.zeros((5, ch_max), dtype=torch.int32, device=dev)
    for row, v in enumerate((lo, rlen.clamp(max=rcap), owner // ivmax, ch_c0, ch_len)):
        out[row, j] = v.to(torch.int32)
    return (*out.unbind(0), ends, iv_seq, torch.tensor(total > ch_max, device=dev),
            (rlen > rcap).any())


def l2_merge_reference(cbest, cfirst, clast, ends, iv_valid):
    """``(best, first, last)``, each ``(NI,)`` int64, per interval from the
    ``(ch_max,)`` int32 chunk results of `ops.l2.l2_chunks` and the plan's
    ``ends`` (`l2_plan`): the largest chunk ``best``, the smallest
    ``first`` and largest ``last`` among the chunks at it; ``I32_MIN``,
    ``I32_MAX``, ``I32_MIN`` for an interval without a chunk slot, and
    ``best = -1`` unless ``iv_valid`` and the interval has chunks.  Each
    slot's interval is found in ``ends``."""
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
