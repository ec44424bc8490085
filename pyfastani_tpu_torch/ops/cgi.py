"""The L2 sweep's merge, the identity gate, the two CGI reductions and the
identity fold.

Port of the merge of ``pyfastani_tpu/parallel/sharded.py::_l2_interval_scan``,
of the tail of ``_query_block_impl`` (the gate, the identity and the two
CGI steps) and of the fold of ``ShardedSession``'s ``block_fn``:

* `cgi_bins` merges each candidate interval's L2 chunk results (the
  largest ``best``, then the first and last anchor at it), gates the
  interval on that best shared count,
  looks up its float32 identity in the host-exact ``(smax+1)^2`` table and
  keeps one best mapping per (fragment, genome) -- the largest identity,
  ties to the first interval in (seqId, pos) order, the rule of the host
  ``compute_cgi``.  It returns one slot an interval: a kept mapping's flat
  (query genome, contig, bin) index and identity, ``-1`` and ``-inf``
  elsewhere, and the pass's flags as one int32 row.  The JAX package's
  dense best identity per bin is the max of the slots into ``-inf`` bins;
* `fold_bins` reduces the slots of a shard's data rows per (query genome,
  genome) to the occupied-bin count and the identity sum as exact
  fixed-point integers (the 2^17 grid of ``_engine_np.mean_identity``) in
  two 12-bit limbs, so the sum cannot depend on the reduction order.  It
  works through a persistent ``-inf`` scratch of the dense bins: the slots'
  max goes in, each touched bin is read once by its first visitor and left
  ``-inf`` again, so no dense pass is made.

Each wrapper launches a hand-written CUDA kernel for CUDA tensors
(``csrc/cgi.cu``: one warp a fragment, which merges each interval's chunks
in registers; the fold's scatter and visit, one thread a slot) and takes
its plain version, `cgi_bins_reference` (`ops.l2_sweep.l2_merge_reference`,
then the gate and CGI) or `fold_bins_reference`, for CPU tensors; any
other device raises.  ``<wrapper>_launches`` and
``<wrapper>_reference_calls`` count kernel-route calls and runs of the
plain version.  Both routes agree bitwise: the slots whenever the pass
raised no flag, the flags row and the fold always.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._cuda import check, cuda_device, current_stream, ptr, raise_on
from .l2_sweep import I32_MAX, l2_merge_reference, segment

__all__ = ["cgi_bins", "cgi_bins_reference", "fold_bins", "fold_bins_reference"]

cgi_bins_launches = cgi_bins_reference_calls = 0
fold_bins_launches = fold_bins_reference_calls = 0

MAX_FLAGS = 8  # the flags a row can hold (csrc/cgi.cu, kMaxFlags)


def cgi_bins(
    cbest, cfirst, clast, ends, iv_valid, iv_seq, s_sizes, frag_qg,
    gate_table, ident_table, seq_to_genome,
    cmw: int, l: int, ivmax: int, bin_max: int, g_max: int, q_count: int, flags,
):
    """``(slot_bin, slot_ident, flag_row)``: each interval's kept mapping
    after the reciprocal filter, ``(F * ivmax,)`` each, the int64 flat bin
    ``qg * C * bin_max + c * bin_max + b`` (query genome, contig, bin) and
    the float32 identity, ``-1`` and ``-inf`` where the interval keeps
    nothing; and ``flags`` as one ``(len(flags),)`` int32 row.

    Args:
        cbest, cfirst, clast: ``(ch_max,)`` int32 chunk results
            (`ops.l2.l2_chunks`).
        ends: ``(F * ivmax,)`` int64 cumulative chunk counts
            (`ops.l2_sweep.l2_plan`): interval ``i`` owns the chunk slots
            ``[ends[i - 1], ends[i])`` cut at ``ch_max``; fragment ``f``
            owns intervals ``[f * ivmax, (f + 1) * ivmax)``.
        iv_valid: ``(F * ivmax,)`` bool.
        iv_seq: ``(F * ivmax,)`` int64 contig of each interval.
        s_sizes: ``(F,)`` int32 sketch sizes.
        frag_qg: ``(F,)`` int32 query genome of each fragment row, in
            ``[0, q_count)``.
        gate_table: ``(T,)`` int32 smallest mapped shared count by sketch size.
        ident_table: ``(smax + 1, smax + 1)`` float32 identity by (sketch
            size, shared count).
        seq_to_genome: ``(C,)`` int32 genome of each contig.
        cmw: window positions a fragment spans (``l - k + 1``).
        l: fragment length (the bin width).
        ivmax, bin_max, g_max, q_count: the static budgets.
        flags: 1 to `MAX_FLAGS` 0-d bool or int32 tensors (the pass's
            overflow flags), read in stream order.
    """
    global cgi_bins_launches
    dev = cuda_device("cgi_bins", ends)
    if dev is None:
        return cgi_bins_reference(
            cbest, cfirst, clast, ends, iv_valid, iv_seq, s_sizes, frag_qg, gate_table,
            ident_table, seq_to_genome, cmw, l, ivmax, bin_max, g_max, q_count, flags,
        )
    F, ch_max = s_sizes.shape[0], cbest.shape[0]
    for name, t in (("cbest", cbest), ("cfirst", cfirst), ("clast", clast)):
        check(name, dev, torch.int32, t, ch_max)
    for name, t in (("ends", ends), ("iv_seq", iv_seq)):
        check(name, dev, torch.int64, t, F * ivmax)
    check("iv_valid", dev, torch.bool, iv_valid, F * ivmax)
    for name, t, n in (("s_sizes", s_sizes, F), ("frag_qg", frag_qg, F),
                       ("gate_table", gate_table, None), ("seq_to_genome", seq_to_genome, None)):
        check(name, dev, torch.int32, t, n)
    if (ident_table.dim() != 2 or ident_table.dtype != torch.float32
            or ident_table.device != dev or ident_table.shape[0] != ident_table.shape[1]):
        raise TypeError(f"ident_table must be a square float32 tensor on {dev}")
    C = seq_to_genome.shape[0]
    if gate_table.shape[0] < 1 or ident_table.shape[0] < 1 or C < 1 or l < 1 or bin_max < 1:
        raise ValueError("cgi_bins needs a gate and identity table, a contig, l and bin_max >= 1")
    flags = tuple(flags)
    if not 1 <= len(flags) <= MAX_FLAGS or any(
            f.numel() != 1 or f.dtype not in (torch.bool, torch.int32) or f.device != dev
            for f in flags):
        raise TypeError(f"flags must be 1 to {MAX_FLAGS} one-element bool or int32 tensors "
                        f"on {dev}")

    from .._build import load_library

    lib = load_library()
    cbest, cfirst, clast, ends, iv_valid, iv_seq, s_sizes, frag_qg, gate_table, ident_table, \
        s2g = (t.contiguous() for t in (cbest, cfirst, clast, ends, iv_valid, iv_seq, s_sizes,
                                        frag_qg, gate_table, ident_table, seq_to_genome))
    n = len(flags)
    flag_src = (ctypes.c_void_p * n)(*(f.data_ptr() for f in flags))
    flag_bytes = (ctypes.c_int * n)(*(f.element_size() for f in flags))
    flag_row = torch.empty(n, dtype=torch.int32, device=dev)
    slot_bin = torch.empty(F * ivmax, dtype=torch.int64, device=dev)
    slot_ident = torch.empty(F * ivmax, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        raise_on("cgi_bins", lib.cgi_bins_launch(
            ptr(cbest), ptr(cfirst), ptr(clast), ptr(ends), ch_max, ptr(iv_valid), ptr(iv_seq),
            ptr(s_sizes), ptr(frag_qg), ptr(gate_table), gate_table.shape[0], ptr(ident_table),
            ident_table.shape[0] - 1, ident_table.shape[1], ptr(s2g), C, F, ivmax, cmw, l,
            bin_max, flag_src, flag_bytes, n, ptr(flag_row), ptr(slot_bin), ptr(slot_ident),
            current_stream(dev),
        ))
    cgi_bins_launches += 1
    return slot_bin, slot_ident, flag_row


def cgi_bins_reference(
    cbest, cfirst, clast, ends, iv_valid, iv_seq, s_sizes, frag_qg,
    gate_table, ident_table, seq_to_genome,
    cmw: int, l: int, ivmax: int, bin_max: int, g_max: int, q_count: int, flags,
):
    """The plain torch version of `cgi_bins` (same arguments and result):
    `ops.l2_sweep.l2_merge_reference`, then the gate and CGI."""
    global cgi_bins_reference_calls
    cgi_bins_reference_calls += 1
    best, first, last = l2_merge_reference(cbest, cfirst, clast, ends, iv_valid)
    dev = best.device
    i64 = torch.int64
    F = s_sizes.shape[0]
    frag_of_iv = torch.arange(F * ivmax, device=dev) // ivmax
    s_iv = s_sizes[frag_of_iv].to(i64)
    gate = gate_table[s_iv.clamp(0, gate_table.shape[0] - 1)]
    mapped = iv_valid & (best > 0) & (best >= gate)

    # plateau midpoint of the best anchors, reported at the window end
    mean_pos = torch.div(first + last, 2, rounding_mode="floor") + (cmw - 1)
    rbin = torch.div(mean_pos, l, rounding_mode="floor").clamp(0, bin_max - 1)
    s2g = seq_to_genome
    C = s2g.shape[0]
    seq_c = iv_seq.clamp(0, C - 1)
    gid = s2g[seq_c].to(i64)

    smax_tab = ident_table.shape[0] - 1
    ident = ident_table[s_iv.clamp(0, smax_tab), best.clamp(0, smax_tab)]

    # CGI step 1: one best mapping per (genome, fragment), the max float32
    # identity, ties to the first interval in (seqId, pos) order
    NIV = best.shape[0]
    iv_arange = torch.arange(NIV, device=dev)
    n_seg = F * (g_max + 1) + g_max + 1
    fg = frag_of_iv * (g_max + 1) + torch.where(mapped, gid, g_max)
    best_fg = segment(torch.where(mapped, ident, -1.0), fg, n_seg, "amax", -np.inf)
    tied = mapped & (ident == best_fg[fg])
    first_iv = segment(torch.where(tied, iv_arange, NIV), fg, n_seg, "amin", I32_MAX)
    keep1 = tied & (iv_arange == first_iv[fg])

    # CGI step 2: each kept mapping's (query genome, contig, bin)
    qg_of_iv = frag_qg[frag_of_iv].to(i64)
    cbin = qg_of_iv * (C * bin_max) + seq_c * bin_max + rbin
    flag_row = torch.stack([f.reshape(()).to(torch.int32) for f in flags])
    return torch.where(keep1, cbin, -1), torch.where(keep1, ident, -np.inf), flag_row


def _fold_outputs(dev, out, flags, out_flags, q_count: int, g_max: int):
    """The flags' row length, after checking ``out`` (``(3, q_count,
    g_max)`` int64 on ``dev`` whose rows are contiguous, any stride between
    the three), ``flags`` (int32, rows of ``out_flags``'s length) and
    ``out_flags`` (1-D int64), both or neither."""
    if (out.shape != (3, q_count, g_max) or out.dtype != torch.int64 or out.device != dev
            or (q_count * g_max and (out.stride(2) != 1 or out.stride(1) != g_max))):
        raise TypeError(f"out must be a (3, {q_count}, {g_max}) int64 tensor on {dev} "
                        "with contiguous rows")
    if (flags is None) != (out_flags is None):
        raise ValueError("fold_bins takes flags and out_flags together")
    if flags is None:
        return 0
    n = out_flags.shape[0] if out_flags.dim() == 1 else -1
    if (out_flags.dtype != torch.int64 or out_flags.device != dev or n < 0
            or flags.dtype != torch.int32 or flags.device != dev or flags.shape[-1] != n
            or flags.dim() > 2 or not flags.is_contiguous()):
        raise TypeError(f"flags must be contiguous int32 rows and out_flags 1-D int64 of "
                        f"their length, on {dev}")
    return n


def fold_bins(slot_bin, slot_ident, scratch, seq_to_genome, q_count: int, bin_max: int,
              g_max: int, out, flags=None, out_flags=None):
    """Per-(query genome, genome) occupied-bin counts and identity sums
    of the slots (`cgi_bins`) of a shard's data rows: ``(counts, isum_hi,
    isum_lo)``, views of ``out``, each ``(q_count, g_max)`` int64, the sums
    of the high and low 12-bit limbs of ``round(b * 2^17)`` over the bins'
    maxima ``b > 0``.

    Args:
        slot_bin, slot_ident: ``(NS,)`` int64 and float32 slots.
        scratch: ``(q_count * C * bin_max,)`` float32 bins; a bin the
            slots touch enters its max and holds ``-inf`` again on return,
            so a scratch that is all ``-inf`` stays so.
        seq_to_genome: ``(C,)`` int32 genome of each contig.
        out: where the three outputs go, ``(3, q_count, g_max)`` int64
            with contiguous rows; zeroed first.
        flags, out_flags: optional; ``out_flags`` (1-D int64) receives the
            max over the rows of ``flags`` (int32) and 0, in the same launch.
    """
    global fold_bins_launches
    dev = cuda_device("fold_bins", slot_bin)
    if dev is None:
        return fold_bins_reference(slot_bin, slot_ident, scratch, seq_to_genome, q_count,
                                   bin_max, g_max, out, flags, out_flags)
    NS, C = slot_bin.shape[0], seq_to_genome.shape[0]
    check("slot_bin", dev, torch.int64, slot_bin)
    check("slot_ident", dev, torch.float32, slot_ident, NS)
    check("scratch", dev, torch.float32, scratch, q_count * C * bin_max)
    check("seq_to_genome", dev, torch.int32, seq_to_genome, C)
    if not scratch.is_contiguous():
        raise ValueError("scratch must be contiguous: the fold writes it in place")
    n_flags = _fold_outputs(dev, out, flags, out_flags, q_count, g_max)

    from .._build import load_library

    lib = load_library()
    slot_bin, slot_ident, s2g = (t.contiguous() for t in (slot_bin, slot_ident, seq_to_genome))
    with torch.cuda.device(dev):
        raise_on("fold_bins", lib.fold_bins_launch(
            ptr(slot_bin), ptr(slot_ident), NS, ptr(scratch), ptr(s2g), q_count, C, bin_max,
            g_max, ptr(out), out.stride(0),
            ptr(flags) if n_flags else None, flags.numel() // n_flags if n_flags else 0,
            n_flags, ptr(out_flags) if n_flags else None, current_stream(dev),
        ))
    fold_bins_launches += 1
    return out.unbind(0)


def fold_bins_reference(slot_bin, slot_ident, scratch, seq_to_genome, q_count: int,
                        bin_max: int, g_max: int, out, flags=None, out_flags=None):
    """The plain torch version of `fold_bins` (same arguments and result,
    the scratch left as the kernels leave it)."""
    global fold_bins_reference_calls
    fold_bins_reference_calls += 1
    dev = slot_bin.device
    n_flags = _fold_outputs(dev, out, flags, out_flags, q_count, g_max)
    out.zero_()
    if n_flags:
        out_flags.copy_(flags.reshape(-1, n_flags).amax(0).clamp(min=0))
    kept = slot_bin >= 0
    bins = slot_bin[kept]
    # the max over the slots (and the data rows) per bin, then each touched
    # bin read once and left -inf
    scratch.scatter_reduce_(0, bins, slot_ident[kept], "amax")
    bins = torch.unique(bins)
    v = scratch[bins]
    scratch[bins] = -np.inf
    occ = v > 0.0
    bins, v = bins[occ], v[occ]
    C = seq_to_genome.shape[0]
    row = torch.div(bins, bin_max, rounding_mode="floor")
    key = torch.div(row, C, rounding_mode="floor") * g_max + seq_to_genome[row % C].to(torch.int64)
    q17 = torch.round(v * 131072.0).to(torch.int64)
    for limb, x in zip(out, (torch.ones_like(q17), q17 >> 12, q17 & 0xFFF)):
        limb.view(-1).index_add_(0, key, x)
    return out.unbind(0)
