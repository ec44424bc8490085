"""The identity gate, the two CGI reductions and the identity fold.

Port of the tail of ``pyfastani_tpu/parallel/sharded.py::_query_block_impl``
(the gate, the identity and the two CGI steps) and of the fold of
``ShardedSession``'s ``block_fn``:

* `cgi_bins` gates every candidate interval on its best shared count,
  looks up its float32 identity in the host-exact ``(smax+1)^2`` table,
  keeps one best mapping per (fragment, genome) -- the largest identity,
  ties to the first interval in (seqId, pos) order, the rule of the host
  ``compute_cgi`` -- and reduces them into the dense per-(query genome,
  contig, bin) best identity, ``-inf`` where empty;
* `fold_bins` reduces those bins per (query genome, genome) to the
  occupied-bin count and the identity sum as exact fixed-point integers
  (the 2^17 grid of ``_engine_np.mean_identity``) in two 12-bit limbs, so
  the sum cannot depend on the reduction order.

Each wrapper launches a hand-written CUDA kernel for CUDA tensors
(``csrc/cgi.cu``: one warp a fragment; one block a (query genome, contig)
row) and takes its plain version, `cgi_bins_reference` or
`fold_bins_reference`, for CPU tensors; any other device raises.
``<wrapper>_launches`` and ``<wrapper>_reference_calls`` count
kernel-route calls and runs of the plain version.  Both routes agree bitwise: the bins
(``-inf`` included) whenever the pass raised no flag, the fold always.
"""

from __future__ import annotations

import numpy as np
import torch

from ._cuda import check, cuda_device, current_stream, ptr, raise_on
from .l2_sweep import I32_MAX, segment

__all__ = ["cgi_bins", "cgi_bins_reference", "fold_bins", "fold_bins_reference"]

cgi_bins_launches = cgi_bins_reference_calls = 0
fold_bins_launches = fold_bins_reference_calls = 0


def cgi_bins(
    best, first, last, iv_valid, iv_seq, s_sizes, frag_qg,
    gate_table, ident_table, seq_to_genome,
    cmw: int, l: int, ivmax: int, bin_max: int, g_max: int, q_count: int,
):
    """``(q_count * C * bin_max,)`` float32 best identity per (query genome,
    contig, bin) after the reciprocal filter, ``-inf`` where no mapping
    lands.

    Args:
        best, first, last: ``(F * ivmax,)`` int64 per interval (`ops.l2_sweep.l2_merge`);
            fragment ``f`` owns intervals ``[f * ivmax, (f + 1) * ivmax)``.
        iv_valid: ``(F * ivmax,)`` bool.
        iv_seq: ``(F * ivmax,)`` int64 contig of each interval.
        s_sizes: ``(F,)`` int32 sketch sizes.
        frag_qg: ``(F,)`` int32 query genome of each fragment row.
        gate_table: ``(T,)`` int32 smallest mapped shared count by sketch size.
        ident_table: ``(smax + 1, smax + 1)`` float32 identity by (sketch
            size, shared count).
        seq_to_genome: ``(C,)`` int32 genome of each contig.
        cmw: window positions a fragment spans (``l - k + 1``).
        l: fragment length (the bin width).
        ivmax, bin_max, g_max, q_count: the static budgets.
    """
    global cgi_bins_launches
    dev = cuda_device("cgi_bins", best)
    if dev is None:
        return cgi_bins_reference(
            best, first, last, iv_valid, iv_seq, s_sizes, frag_qg, gate_table, ident_table,
            seq_to_genome, cmw, l, ivmax, bin_max, g_max, q_count,
        )
    F = s_sizes.shape[0]
    for name, t in (("best", best), ("first", first), ("last", last), ("iv_seq", iv_seq)):
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

    from .._build import load_library

    lib = load_library()
    best, first, last, iv_valid, iv_seq, s_sizes, frag_qg, gate_table, ident_table, s2g = (
        t.contiguous() for t in (best, first, last, iv_valid, iv_seq, s_sizes, frag_qg,
                                 gate_table, ident_table, seq_to_genome)
    )
    best_bin = torch.full((q_count * C * bin_max,), -np.inf, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        raise_on("cgi_bins", lib.cgi_bins_launch(
            ptr(best), ptr(first), ptr(last), ptr(iv_valid), ptr(iv_seq), ptr(s_sizes),
            ptr(frag_qg), ptr(gate_table), gate_table.shape[0], ptr(ident_table),
            ident_table.shape[0] - 1, ident_table.shape[1], ptr(s2g), C, F, ivmax, cmw, l,
            bin_max, ptr(best_bin), current_stream(dev),
        ))
    cgi_bins_launches += 1
    return best_bin


def cgi_bins_reference(
    best, first, last, iv_valid, iv_seq, s_sizes, frag_qg,
    gate_table, ident_table, seq_to_genome,
    cmw: int, l: int, ivmax: int, bin_max: int, g_max: int, q_count: int,
):
    """The plain torch version of `cgi_bins` (same arguments and result)."""
    global cgi_bins_reference_calls
    cgi_bins_reference_calls += 1
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

    # CGI step 2: dense per-(query genome, contig, bin) best identity
    qg_of_iv = frag_qg[frag_of_iv].to(i64)
    n_bins = q_count * C * bin_max
    cbin = torch.where(keep1, qg_of_iv * (C * bin_max) + seq_c * bin_max + rbin, n_bins)
    best_bin = segment(torch.where(keep1, ident, -1.0), cbin, n_bins + 1, "amax", -np.inf)
    return best_bin[:n_bins]


def fold_bins(best_bin, seq_to_genome, q_count: int, bin_max: int, g_max: int):
    """Per-(query genome, genome) occupied-bin counts and identity sums
    of ``best_bin`` (`cgi_bins`, merged over the data rows), whose contigs'
    genomes ``seq_to_genome`` gives: ``(counts, isum_hi, isum_lo)``, each
    ``(q_count, g_max)`` int64, the sums of the high and low 12-bit limbs of
    ``round(b * 2^17)`` over the bins ``b > 0``."""
    global fold_bins_launches
    dev = cuda_device("fold_bins", best_bin)
    if dev is None:
        return fold_bins_reference(best_bin, seq_to_genome, q_count, bin_max, g_max)
    C = seq_to_genome.shape[0]
    check("best_bin", dev, torch.float32, best_bin, q_count * C * bin_max)
    check("seq_to_genome", dev, torch.int32, seq_to_genome, C)

    from .._build import load_library

    lib = load_library()
    best_bin, s2g = best_bin.contiguous(), seq_to_genome.contiguous()
    out = torch.zeros((3, q_count, g_max), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        raise_on("fold_bins", lib.fold_bins_launch(
            ptr(best_bin), ptr(s2g), q_count, C, bin_max, g_max, ptr(out), current_stream(dev),
        ))
    fold_bins_launches += 1
    return out.unbind(0)


def fold_bins_reference(best_bin, seq_to_genome, q_count: int, bin_max: int, g_max: int):
    """The plain torch version of `fold_bins` (same arguments and result)."""
    global fold_bins_reference_calls
    fold_bins_reference_calls += 1
    dev = best_bin.device
    C = seq_to_genome.shape[0]
    bb3 = best_bin.reshape(q_count, C, bin_max)
    occ = bb3 > 0.0
    q17 = torch.round(torch.where(occ, bb3, 0.0) * 131072.0).to(torch.int64)
    key = (
        torch.arange(q_count, device=dev)[:, None] * g_max + seq_to_genome.to(torch.int64)
    ).reshape(-1)

    def fold(x_qc):
        out = torch.zeros(q_count * g_max, dtype=torch.int64, device=dev)
        return out.index_add_(0, key, x_qc.reshape(-1)).reshape(q_count, g_max)

    return (
        fold(occ.sum(dim=2)),
        fold((q17 >> 12).sum(dim=2)),
        fold((q17 & 0xFFF).sum(dim=2)),
    )
