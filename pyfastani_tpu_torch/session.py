"""Batched query sessions: the port of ``ShardedSession``.

The reference index is split by genome over the ``shard`` axis of a
`parallel.mesh.Mesh` and parked once on the devices of each mesh column.
Every query genome is cut into ``l``-long fragments, and groups of query
genomes run through one pass each.  A pass splits the group's fragment
block over the ``data`` axis and runs `_query_block` on every cell, which
has four stages:

1. the batched fragment winnow and sketch (`ops.fragments`);
2. the L1 candidate intervals (`ops.l1`);
3. the L2 chunk sweep (`_l2_interval_scan`): the chunk plan
   (`ops.l2_sweep.l2_plan`), the per-chunk evaluator `ops.l2.l2_chunks`
   and the merge per interval (`ops.l2_sweep.l2_merge`);
4. the identity gate and the two CGI reductions (`ops.cgi.cgi_bins`).

Each stage's wrapper launches a CUDA kernel for CUDA tensors and runs its
plain torch version for CPU tensors.  The cells' per-bin best identities
merge by an elementwise max over the data rows of each shard (the JAX
package's ``pmax``; across processes one ``all_reduce(MAX)``), and an
exact fixed-point identity fold (`_fold`, `ops.cgi.fold_bins`) reduces
each shard to per-genome sums.

Passes are pipelined: fragments stage as the raw bytes of the input
into two recycled host slots (pinned for CUDA devices) and copy to the
devices without blocking, where `_toupper` uppercases them; no
operation inside a pass waits for the device, and the outputs of every
group are read back behind one event at the end of an attempt.  Budgets
are static and pre-sized from index statistics
(`index._presize_budgets`); an overflow is flagged on the device, and the
session doubles the budget and runs the batch again.  Every output is an
integer and the identity mean is an exact fixed-point sum, so hits equal
the JAX package's and the host NumPy engine's bitwise.

Port of ``pyfastani_tpu/parallel/sharded.py`` (`_l2_interval_scan` in
the structure of its ``use_pallas`` branch, `_query_block_impl`, the fold
of ``block_fn`` and ``ShardedSession``).
"""

from __future__ import annotations

import threading
import time
import warnings

import numpy as np
import torch

from . import stats
from ._common import resolve_device
from .parallel.mesh import Mesh, make_mesh
from .index import (
    ShardedIndex,
    _l2_kernel_rows,
    _presize_budgets,
    _round_up,
    build_sharded_index,
    fill_missing,
    index_to_device,
)
from .models._params import Parameters
from .models._types import Hit
from .ops import codec
from .ops.cgi import cgi_bins, fold_bins
from .ops.fragments import winnow_fragments
from .ops.l1 import l1_candidates
from .ops.l2 import l2_chunks
from .ops.l2_sweep import l2_merge, l2_plan

__all__ = ["ShardedSession", "Session"]

_CH_SLAB = 256  # the chunk budget is a multiple of this
_BUDGET_NAMES = ["smax", "hmax", "ivmax", "t_chunks", "rmax"]
_N_FLAGS = len(_BUDGET_NAMES) + 1  # the budget overflows, then the L2 range flag


def _toupper(frags):
    """C-locale ``toupper`` of a uint8 tensor, on its device: bytes
    ``a``-``z`` less 32, every other byte as it is (``codec.to_bytes``'s
    table on all 256 values).  Returns a new tensor."""
    return frags - ((frags - 97) < 26).to(torch.uint8) * 32


def _l2_interval_scan(
    q_sorted, s_sizes, frag_of_iv, iv_seq, iv_c0, iv_c1, iv_valid, idx,
    gpos_shift: int, gpos_steps: int, cmw: int, cmax: int, rmax: int, ch_max: int,
):
    """``(best, first, last)`` per candidate interval, and the flags
    ``(ovf_chunks, ovf_r, range_bad)``.

    Intervals are cut into chunks of at most ``cmax`` window offsets,
    compacted to the front of a ``ch_max``-slot axis.  Each chunk's range
    of reference minimizers is clamped to its contig's block (``cof_idx``),
    so ranges hold one contig and positions ascend; a range longer than
    ``R - 128`` (``R = _l2_kernel_rows(rmax)``) is flagged.  Chunk results
    merge back per interval: the max, then the first/last anchor at it.
    """
    R = _l2_kernel_rows(rmax)
    lo, rlen, ch_frag, ch_c0, ch_len, ends, overflow, rovf = l2_plan(
        frag_of_iv, iv_seq, iv_c0, iv_c1, iv_valid, idx["contig_offset"], idx["cof_idx"],
        idx["mini_gpos"], idx["gpos_bucket"], gpos_shift, gpos_steps, cmw, cmax, R - 128, ch_max,
    )
    cbest, cfirst, clast, range_bad = l2_chunks(
        q_sorted, s_sizes, idx["mini_hash"], idx["mini_wpos"], idx["mini_prev"],
        lo, rlen, ch_frag, ch_c0, ch_len, cmw, R - 128,
    )
    best, first, last = l2_merge(cbest, cfirst, clast, ends, iv_valid)
    return best, first, last, overflow, rovf, range_bad


def _query_block(
    frags, frag_qg, idx, freq_threshold: int,
    min_hits_table, gate_table, ident_table,
    k: int, w: int, l: int, protein: bool,
    hmax: int, ivmax: int, cmax: int, rmax: int, t_chunks: int,
    g_max: int, bin_max: int, smax: int, q_count: int,
    bucket_steps: int, m_values: tuple, gpos_shift: int, gpos_steps: int,
):
    """One device pass of a fragment block against the parked index.

    ``frag_qg`` assigns each fragment row to one of ``q_count`` query
    genomes, so a group of genomes maps in one pass.  Returns
    ``(best_bin, flags)``: the ``(q_count * C * bin_max,)`` float32 best
    identity per (query genome, contig, bin) after the reciprocal filter,
    and six 0/1 int32 flags: the budget overflows (smax, hmax, ivmax,
    t_chunks, rmax), then the L2 range flag (`ops.l2.l2_chunks`).  No
    operation waits for the device.
    """
    dev = frags.device
    i64 = torch.int64
    F = frags.shape[0]
    cmw = l - (k - 1)

    kc = min(smax + 128, l)
    rec_ovf, q_sorted, s_sizes = winnow_fragments(frags, k, w, l, protein, kc)
    s_overflow = (s_sizes > smax).any() | rec_ovf
    q_sorted = q_sorted[:, : min(smax, q_sorted.shape[1])]

    iv_g0, iv_g1, iv_valid, ovf_hits, ovf_iv = l1_candidates(
        q_sorted, s_sizes, idx["uniq_hash"], idx["row_start"], idx["row_len"],
        idx["post_gpos"], freq_threshold, min_hits_table, idx["hash_bucket"],
        hmax, ivmax, l, bucket_steps, m_values,
    )
    # contig id and contig-local coordinates per interval; iv_g1 is a real
    # minimizer's gpos, iv_g0 may precede the contig base and is clamped
    coff = idx["contig_offset"]
    g0f = iv_g0.reshape(-1).to(i64)
    g1f = iv_g1.reshape(-1).to(i64)
    iv_seq = (torch.searchsorted(coff.to(i64), g1f, right=True) - 1).clamp(
        0, coff.shape[0] - 2
    )
    iv_base = coff[iv_seq].to(i64)
    iv_c0 = torch.maximum(g0f, iv_base) - iv_base
    iv_c1 = g1f - iv_base

    frag_of_iv = torch.arange(F * ivmax, device=dev) // ivmax
    ch_max = _round_up(F * t_chunks, _CH_SLAB)
    iv_valid = iv_valid.reshape(-1)
    best, first, last, ovf_ch, ovf_r, range_bad = _l2_interval_scan(
        q_sorted, s_sizes, frag_of_iv, iv_seq, iv_c0, iv_c1, iv_valid, idx,
        gpos_shift, gpos_steps, cmw, cmax, rmax, ch_max,
    )
    flags = torch.stack(
        [f.to(torch.int32) for f in (s_overflow, ovf_hits, ovf_iv, ovf_ch, ovf_r, range_bad)]
    )

    best_bin = cgi_bins(
        best, first, last, iv_valid, iv_seq, s_sizes, frag_qg, gate_table, ident_table,
        idx["seq_to_genome"], cmw, l, ivmax, bin_max, g_max, q_count,
    )
    return best_bin, flags


def _fold(best_bin, seq_to_genome, q_count: int, bin_max: int, g_max: int):
    """Per-(query genome, genome) occupied-bin counts and identity sums.

    Identities accumulate as exact fixed-point integers (the 2^17 grid of
    ``_engine_np.mean_identity``) in 12-bit limbs, so the sum cannot
    depend on the reduction order.  Returns ``(counts, isum_hi, isum_lo)``,
    each ``(q_count, g_max)`` int64.
    """
    return fold_bins(best_bin, seq_to_genome, q_count, bin_max, g_max)


def _checkpoint_params(index: ShardedIndex, params):
    """The ``Parameters`` a restored checkpoint runs under: ``params``, or
    the checkpointed ones when ``None``; a mismatch raises, since another
    k/w/l would give wrong ANI without a sign.  Parameters compare by
    their pickled state, so the JAX package's equal values match."""
    saved = Parameters.from_state(index.params_state) if index.params_state else None
    if params is None:
        if saved is None:
            raise ValueError("checkpoint carries no Parameters; pass params= explicitly")
        return saved
    if saved is not None and params.to_state() != saved.to_state():
        raise ValueError(f"params mismatch: index was built under {saved}, got {params}")
    return params


class ShardedSession:
    """Reusable query session over a ("data", "shard") `Mesh`: the index
    is split by genome over the shard axis and parked once on every cell's
    device, and groups of query genomes run through `_query_block` one
    pass per group, the fragment block split over the data axis.

    Args:
        mapper: the ``Mapper`` whose index to query (``None`` with
            ``index=`` and ``params=``; see `from_index`).
        mesh: the `Mesh`; default `make_mesh()`, every visible CUDA device
            on the shard axis.
        hmax, ivmax, cmax, rmax, t_chunks, bin_max, smax: budget
            overrides; `index._presize_budgets` sizes the rest.
        q_capacity: query genomes per pass.
        frag_capacity: fragments per pass (a multiple of ``n_data``).
        index: a `ShardedIndex` with one shard per mesh column.
        params: the ``Parameters`` of ``index``.
    """

    def __init__(
        self,
        mapper,
        mesh: Mesh | None = None,
        hmax: int | None = None,
        ivmax: int | None = None,
        cmax: int | None = None,
        rmax: int | None = None,
        t_chunks: int | None = None,
        bin_max: int | None = None,
        smax: int | None = None,
        q_capacity: int = 16,
        frag_capacity: int = 4096,
        index: ShardedIndex | None = None,
        params=None,
    ):
        self.mapper = mapper
        self.mesh = mesh if mesh is not None else make_mesh()
        self.params = params if params is not None else mapper._param
        params = self.params
        l = params.min_read_length
        self.n_shard = self.mesh.shape["shard"]
        self.n_data = self.mesh.shape["data"]
        self.q_capacity = max(1, int(q_capacity))
        self.frag_capacity = _round_up(max(int(frag_capacity), self.n_data), self.n_data)
        if index is not None and index.n_shards != self.n_shard:
            raise ValueError(
                f"restored index has {index.n_shards} shards, mesh has {self.n_shard}"
            )
        sidx = index if index is not None else build_sharded_index(mapper, self.n_shard)
        self.sidx = fill_missing(sidx)
        self.budgets = _presize_budgets(
            sidx, params,
            dict(hmax=hmax, ivmax=ivmax, cmax=cmax, rmax=rmax,
                 t_chunks=t_chunks, bin_max=bin_max, smax=smax),
        )
        self._g_max = int(sidx.genome_lengths.shape[1])

        # this process's cells; each shard is parked once per device
        self._cells = self.mesh.local_cells()
        self._devices = list(dict.fromkeys(dev for _, _, dev in self._cells))
        self._idx = {
            (dev, sh): index_to_device(sidx, dev, sh)
            for dev, sh in dict.fromkeys((dev, sh) for _, sh, dev in self._cells)
        }
        # cells' outputs merge on one device; across processes through the
        # collective's device (the CPU for gloo)
        if self.mesh.distributed and torch.distributed.get_backend() != "nccl":
            self._merge_dev = torch.device("cpu")
        elif self._devices:
            self._merge_dev = self._devices[0]
        else:
            self._merge_dev = torch.device("cuda", torch.cuda.current_device())
        self._s2g = torch.from_numpy(sidx.seq_to_genome).to(self._merge_dev)
        # pinned host staging needs CUDA; a CPU-only mesh stages in plain
        # host tensors, which its cells read in place
        self._pinned = any(dev.type == "cuda" for dev in self._devices)
        self._slots = {}  # slot -> [frags, frag_qg, events of its last copies]

        tab_hi = max(l, 1)
        k, pid = params.kmer_size, params.percentage_identity
        self._mh_tab_np = np.asarray(stats.min_hits_relaxed_table(tab_hi, k, pid))
        gate_np = np.asarray(stats.l2_gate_table(tab_hi, k, pid))
        self._tabs = {
            dev: (torch.from_numpy(self._mh_tab_np).to(dev), torch.from_numpy(gate_np).to(dev))
            for dev in self._devices
        }
        self._ident_tab = {}  # device -> (smax+1)^2 f32, rebuilt when smax grows
        # queries from several threads serialize: the session mutates its
        # budgets and recycles its staging slots per call
        self._lock = threading.Lock()
        self.stats = {
            "dispatches": 0,
            "genomes_queried": 0,
            "fragments_dispatched": 0,
            "fragments_padded": 0,
            "budget_escalations": 0,
            "capacity_growths": 0,
        }

    @classmethod
    def from_index(cls, index: ShardedIndex, params=None, mesh: Mesh | None = None, **kwargs):
        """A session over a restored `ShardedIndex` checkpoint, whose shard
        count must equal the mesh's.

        ``params`` is the frozen ``Parameters`` the index was built under;
        ``None`` restores them from the checkpoint.  Explicit ``params``
        that differ from the checkpointed ones raise.  Every process of a
        multi-process mesh loads the same checkpoint.
        """
        return cls(None, mesh, index=index, params=_checkpoint_params(index, params), **kwargs)

    def _fragments(self, contigs):
        """Per-contig ``(n_i, l)`` uint8 fragment blocks, the totals of
        fragments and of sequence length, and whether the blocks are
        uppercase already.

        The blocks view the raw bytes of each contig (`codec.raw_bytes`, no
        copy of a buffer); the devices uppercase them after the staging
        copy.  A genome with a non-ASCII ``str`` contig is converted whole
        by `codec.to_bytes`, whose low-byte truncation leaves bytes that no
        later uppercase may touch."""
        params = self.params
        l = params.min_read_length
        contigs = list(contigs)
        seqs = [codec.raw_bytes(contig) for contig in contigs]
        upper = any(data is None for data in seqs)
        if upper:
            seqs = [codec.to_bytes(contig) for contig in contigs]
        blocks = []
        total_fragments = 0
        total_length = 0
        for data in seqs:
            slen = int(data.shape[0])
            if slen < min(params.window_size, params.kmer_size, l):
                warnings.warn(
                    "Mapper received a short sequence relative to "
                    "parameters, mapping will not be computed.",
                    UserWarning,
                    stacklevel=3,
                )
                continue
            n_frag = slen // l
            if n_frag:
                blocks.append(np.asarray(data[: n_frag * l]).reshape(n_frag, l))
            total_fragments += n_frag
            total_length += slen
        return blocks, total_fragments, total_length, upper

    def _frag_bucket(self, need: int) -> int:
        """Pass capacity for ``need`` fragments: powers of two from 256 up
        to 1024, then multiples of 1024, rounded to ``n_data`` and at most
        ``frag_capacity``.  The chunk budget scales with each cell's rows,
        so escalation decisions match the JAX package only if the padding
        does."""
        if need <= 1024:
            b = max(256, 1 << (max(need, 1) - 1).bit_length())
        else:
            b = _round_up(need, 1024)
        return max(1, min(_round_up(b, self.n_data), self.frag_capacity))

    def _prepare_tables(self):
        """(Re)build the identity tables when ``smax`` changed; returns the
        reachable minimum-hit values for the current sketch budget."""
        smax = self.budgets["smax"]
        ident = None
        for dev in self._devices:
            tab = self._ident_tab.get(dev)
            if tab is None or tab.shape[0] != smax + 1:
                if ident is None:
                    ident = torch.from_numpy(
                        np.asarray(stats.identity_table(smax, self.params.kmer_size))
                    )
                self._ident_tab[dev] = ident.to(dev)
        l = self.params.min_read_length
        return tuple(
            sorted({int(max(int(v), 1)) for v in self._mh_tab_np[: min(smax, l) + 1]})
        )

    def _stage(self, per_genome, group, slot: int, Fcap: int):
        """Fill host staging slot ``slot`` with one group's fragment block:
        rows of fragments, zero-padded to ``Fcap``, and each row's
        query-genome slot.  Waits first until the slot's previous copies to
        the devices have landed.  Returns ``(frags, frag_qg, rows,
        toupper)``: ``toupper`` is false when the rows are uppercase
        already, as in a group that holds a genome `_fragments` converted
        on the host, whose other genomes are uppercased here."""
        l = self.params.min_read_length
        buf = self._slots.get(slot)
        if buf is not None:
            for event in buf[2]:
                event.synchronize()
        if buf is None or buf[0].shape[0] < Fcap:
            pin = self._pinned
            buf = self._slots[slot] = [
                torch.zeros((Fcap, l + 4), dtype=torch.uint8, pin_memory=pin),
                torch.zeros(Fcap, dtype=torch.int32, pin_memory=pin),
                [],
            ]
        frags, frag_qg = buf[0][:Fcap], buf[1][:Fcap]
        fr, qg = frags.numpy(), frag_qg.numpy()
        host_upper = any(per_genome[gi][3] for gi in group)
        row = 0
        for qslot, gi in enumerate(group):
            blocks, _, _, upper = per_genome[gi]
            for block in blocks:
                n = block.shape[0]
                if host_upper and not upper:
                    block = codec.upper_inplace(block)
                fr[row : row + n, :l] = block
                qg[row : row + n] = qslot
                row += n
        fr[row:] = 0
        qg[row:] = 0
        return frags, frag_qg, row, not host_upper

    def _pass(self, frags, frag_qg, m_values, slot: int | None = None, toupper: bool = True):
        """Enqueue one pass of a staged ``(Fcap, l + 4)`` fragment block on
        every local cell (each device uppercases its rows unless
        ``toupper`` is false), merge the cells and fold each shard.  Returns
        the pass's outputs packed in one int64 tensor on the merge device,
        `_unpack` lays them out; nothing here waits for a device."""
        params = self.params
        b = self.budgets
        sidx = self.sidx
        Fd = frags.shape[0] // self.n_data
        inputs = {}
        for d, _, dev in self._cells:
            if (dev, d) not in inputs:
                rows = slice(d * Fd, (d + 1) * Fd)
                block = frags[rows].to(dev, non_blocking=True)
                inputs[dev, d] = (
                    _toupper(block) if toupper else block,
                    frag_qg[rows].to(dev, non_blocking=True),
                )
        if slot is not None:  # the slot may be rewritten once these land
            events = []
            for dev in self._devices:
                if dev.type == "cuda":
                    events.append(torch.cuda.Event())
                    events[-1].record(torch.cuda.current_stream(dev))
            self._slots[slot][2] = events

        C = sidx.seq_to_genome.shape[1]
        n_bins = self.q_capacity * C * b["bin_max"]
        merged = torch.full(
            (self.n_shard * n_bins + _N_FLAGS,), -np.inf, dtype=torch.float32,
            device=self._merge_dev,
        )
        merged[-_N_FLAGS:] = 0
        flags = merged[-_N_FLAGS:]
        for d, sh, dev in self._cells:
            best_bin, cell_flags = _query_block(
                *inputs[dev, d], self._idx[dev, sh], int(sidx.freq_threshold[sh]),
                *self._tabs[dev], self._ident_tab[dev],
                params.kmer_size, params.window_size, params.min_read_length,
                params.alphabet_size != 4,
                b["hmax"], b["ivmax"], b["cmax"], b["rmax"], b["t_chunks"],
                self._g_max, b["bin_max"], b["smax"], self.q_capacity,
                sidx.bucket_steps, m_values, sidx.gpos_shift, sidx.gpos_steps,
            )
            # the pmax over data rows: 0/1 flags merge by max too
            out = merged[sh * n_bins : (sh + 1) * n_bins]
            torch.maximum(out, best_bin.to(self._merge_dev, non_blocking=True), out=out)
            cell_flags = cell_flags.to(self._merge_dev, non_blocking=True)
            torch.maximum(flags, cell_flags.to(torch.float32), out=flags)
        if self.mesh.distributed:
            # cells this process does not run hold -inf: one collective is
            # both the pmax over data and the gather of the shards
            torch.distributed.all_reduce(merged, op=torch.distributed.ReduceOp.MAX)
        folds = [
            _fold(merged[sh * n_bins : (sh + 1) * n_bins], self._s2g[sh],
                  self.q_capacity, b["bin_max"], self._g_max)
            for sh in range(self.n_shard)
        ]
        return torch.cat(
            [torch.stack(part).reshape(-1) for part in zip(*folds)] + [flags.to(torch.int64)]
        )

    def _read_back(self, packed):
        """Copy every pass's packed outputs to host memory behind one event
        and wait for it; returns numpy arrays."""
        if self._merge_dev.type != "cuda":
            return [p.numpy() for p in packed]
        host = []
        for p in packed:
            host.append(torch.empty(p.shape, dtype=p.dtype, pin_memory=True))
            host[-1].copy_(p, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self._merge_dev))
        done.synchronize()
        return [h.numpy() for h in host]

    def _unpack(self, packed: np.ndarray):
        """``(counts, isum_q17, flags)``: the first two ``(n_shard,
        q_capacity, g_max)`` int64, the flags ``(6,)``."""
        shape = (3, self.n_shard, self.q_capacity, self._g_max)
        counts, isum_hi, isum_lo = packed[:-_N_FLAGS].reshape(shape)
        # the limb fold is exact while a genome holds < 2^31/32 occupied
        # bins; the bin count itself is a sound guard
        if counts.size and int(counts.max()) > 60_000_000:
            raise RuntimeError(
                "per-genome mapped-fragment count exceeds the "
                "int32-exact range of the identity fold"
            )
        return counts, isum_hi * 4096 + isum_lo, packed[-_N_FLAGS:]

    def _run_groups(self, per_genome, groups):
        """Pipeline every group through the mesh; on a budget overflow,
        double the blown budgets and run the whole batch again.  Returns
        ``[(group, counts, isum_q17)]`` with ``(n_shard, q_capacity,
        g_max)`` arrays."""
        for attempt in range(6):
            m_values = self._prepare_tables()
            # a batch of several groups runs at one capacity, the full one
            force_bucket = self.frag_capacity if len(groups) > 1 else None
            pending = []
            for g_i, group in enumerate(groups):
                need = sum(per_genome[gi][1] for gi in group)
                Fcap = force_bucket or self._frag_bucket(need)
                frags, frag_qg, row, toupper = self._stage(per_genome, group, g_i % 2, Fcap)
                self.stats["dispatches"] += 1
                packed = self._pass(frags, frag_qg, m_values, g_i % 2, toupper)
                pending.append((group, packed, row, Fcap))

            out = []
            flags = np.zeros(_N_FLAGS, np.int64)
            host = self._read_back([p[1] for p in pending])
            for (group, _, row, Fcap), packed in zip(pending, host):
                counts, isum_q17, group_flags = self._unpack(packed)
                flags = np.maximum(flags, group_flags)
                out.append((group, counts, isum_q17, row, Fcap))
            if flags[-1]:
                raise ValueError(
                    "an L2 chunk's range leaves the minimizer store or its "
                    "fragment row is missing (a corrupt index?)"
                )
            if not flags.any():
                for _, _, _, row, Fcap in out:
                    self.stats["fragments_dispatched"] += row
                    self.stats["fragments_padded"] += Fcap - row
                return [(g, c, i) for g, c, i, _, _ in out]
            blown = [_BUDGET_NAMES[i] for i in np.flatnonzero(flags[:-1])]
            if attempt == 5:
                raise RuntimeError(f"query budget overflow persists for {blown}")
            old = {name: self.budgets[name] for name in blown}
            for name in blown:
                self.budgets[name] *= 2
            self.stats["budget_escalations"] += 1
            warnings.warn(
                f"{type(self).__name__} budget overflow; escalating "
                + ", ".join(f"{n} {old[n]} -> {self.budgets[n]}" for n in blown),
                UserWarning,
                stacklevel=3,
            )

    def warmup(self, frag_counts=None, q_counts=None):
        """Run one zero-filled pass per capacity bucket (default: the full
        ``frag_capacity``), so the first real query pays no one-time cost
        (kernel build and load, allocator growth).  ``q_counts`` is
        ignored: the genome axis is always ``q_capacity``.  Returns a dict
        of bucket -> seconds."""
        l = self.params.min_read_length
        out = {}
        with self._lock:
            m_values = self._prepare_tables()
            for need in frag_counts or [self.frag_capacity]:
                Fcap = self._frag_bucket(int(need))
                if Fcap in out:
                    continue
                t0 = time.perf_counter()
                frags = torch.zeros((Fcap, l + 4), dtype=torch.uint8)
                self._read_back([self._pass(frags, torch.zeros(Fcap, dtype=torch.int32), m_values)])
                out[Fcap] = time.perf_counter() - t0
        return out

    def query_many(self, genomes, frag_bucket: int | None = None):
        """Query a batch of genomes, each an iterable of contigs.

        The batch is packed into as few passes as the fragment and genome
        capacities allow.  ``frag_bucket`` is an optional minimum fragment
        capacity (grows the session's capacity once).  Returns one list
        of `Hit` per genome, sorted by descending identity.
        """
        per_genome = [self._fragments(contigs) for contigs in genomes]
        if not per_genome:
            return []
        with self._lock:
            return self._query_many_locked(per_genome, frag_bucket)

    def _query_many_locked(self, per_genome, frag_bucket):
        params = self.params
        l = params.min_read_length
        self.stats["genomes_queried"] += len(per_genome)
        need = max(p[1] for p in per_genome)
        if frag_bucket:
            need = max(need, int(frag_bucket))
        if need > self.frag_capacity:
            new_cap = _round_up(need, self.n_data)
            warnings.warn(
                f"{type(self).__name__} fragment capacity grown {self.frag_capacity} -> {new_cap}",
                UserWarning,
                stacklevel=2,
            )
            self.frag_capacity = new_cap
            self.stats["capacity_growths"] += 1

        # balanced packing (LPT) into the fewest groups, so group sizes --
        # and the capacity buckets they pad to -- stay uniform
        total_f = sum(p[1] for p in per_genome)
        n_groups = max(
            1,
            -(-total_f // self.frag_capacity),
            -(-len(per_genome) // self.q_capacity),
        )
        order = sorted(range(len(per_genome)), key=lambda gi: -per_genome[gi][1])
        while True:
            bins = [[] for _ in range(n_groups)]
            loads = [0] * n_groups
            ok = True
            for gi in order:
                nf = per_genome[gi][1]
                cands = [b for b in range(n_groups) if len(bins[b]) < self.q_capacity]
                if not cands:
                    ok = False
                    break
                b = min(cands, key=lambda b: loads[b])
                if loads[b] + nf > self.frag_capacity:
                    ok = False
                    break
                bins[b].append(gi)
                loads[b] += nf
            if ok:
                break
            n_groups += 1  # LPT overflowed a bin; add one and repack
        groups = [g for g in bins if g and any(per_genome[gi][1] for gi in g)]

        sidx = self.sidx
        results = [[] for _ in per_genome]
        for group, counts, isum_q17 in self._run_groups(per_genome, groups):
            for slot, gi in enumerate(group):
                _, total_fragments, total_length, _ = per_genome[gi]
                hits = []
                for sh in range(sidx.n_shards):
                    for gj, name in enumerate(sidx.genome_names[sh]):
                        c = int(counts[sh, slot, gj])
                        if c == 0:
                            continue
                        # the exact arithmetic of _engine_np.mean_identity
                        identity = float(
                            np.float32(int(isum_q17[sh, slot, gj]) / (131072.0 * c))
                        )
                        min_length = min(total_length, int(sidx.genome_lengths[sh, gj]))
                        if np.float32(c * l) >= np.float32(min_length) * np.float32(
                            params.min_fraction
                        ):
                            hits.append(Hit(name, identity, c, total_fragments))
                hits.sort(key=lambda h: h.identity, reverse=True)
                results[gi] = hits
        return results

    def query(self, contigs, frag_bucket: int | None = None):
        """Query one genome; returns `Hit`s like ``Mapper.query_draft``."""
        return self.query_many([contigs], frag_bucket=frag_bucket)[0]


class Session(ShardedSession):
    """A `ShardedSession` on one device: the ``1 x 1`` mesh, local to this
    process even under ``torch.distributed``.

    ``device`` is ``"cuda"`` by default, which raises without a GPU; pass
    ``"cpu"`` to run the plain torch path on the CPU.  The other keyword
    arguments are `ShardedSession`'s.
    """

    def __init__(self, mapper, device=None, **kwargs):
        dev = resolve_device(device)
        super().__init__(mapper, Mesh(devices=((dev,),), ranks=((0,),)), **kwargs)
        self.device = dev

    @classmethod
    def from_index(cls, index: ShardedIndex, params=None, device=None, **kwargs):
        """A one-device session over a restored checkpoint (see
        `ShardedSession.from_index`)."""
        return cls(None, device, index=index, params=_checkpoint_params(index, params), **kwargs)
