"""The sharded reference index: host build, checkpoint and device park.

The NumPy parts of ``pyfastani_tpu/parallel/sharded.py`` -- `ShardedIndex`
with its ``.npz`` checkpoint, `build_sharded_index`, `_build_gpos_bucket`
and the budget presizer `_presize_budgets` -- copied so that importing the
port never loads JAX (that module configures JAX when imported).  The
arrays are the JAX package's, bit for bit, so an index built or saved by
either package feeds the other.  `index_to_device` parks one shard as the
torch tensors the query path reads.

Positions use a 32-bit global coordinate (per-shard cumulative contig
offsets, with at least ``l + 8`` of dead space between contigs), so
probes need no 64-bit keys.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from . import _native
from ._common import BIG, GBIG, bits_to_i32
from .models import _engine_np as np_engine
from .ops.l2 import mini_prev_from_index

__all__ = [
    "ShardedIndex",
    "build_sharded_index",
    "index_to_device",
]


@dataclasses.dataclass
class ShardedIndex:
    """Stacked per-shard reference index arrays (leading axis = shard)."""

    uniq_hash: np.ndarray  # (n, U) u32, UMAX pad
    row_start: np.ndarray  # (n, U) i32
    row_len: np.ndarray  # (n, U) i32
    post_seqid: np.ndarray  # (n, M) i32
    post_wpos: np.ndarray  # (n, M) i32
    mini_hash: np.ndarray  # (n, M) u32 position-ordered
    mini_wpos: np.ndarray  # (n, M) i32
    mini_seqid: np.ndarray  # (n, M) i32
    mini_gpos: np.ndarray  # (n, M) i32 global coords, strictly increasing
    mini_prev: np.ndarray  # (n, M) i32 previous same-hash occurrence (wpos)
    contig_offset: np.ndarray  # (n, C+1) i32 cumulative global offsets
    seq_to_genome: np.ndarray  # (n, C) i32 contig -> local genome id
    freq_threshold: np.ndarray  # (n,) i32
    hash_bucket: np.ndarray  # (n, 2^bits+1) i32 hash-prefix table per shard
    bucket_steps: int  # max binary-search depth across shards
    genome_names: list  # list per shard of genome names
    genome_lengths: np.ndarray  # (n, G) i64
    n_shards: int
    # the `Parameters.to_state` the index was built under, kept through
    # checkpoints so a restore can recover and check the sketch parameters
    params_state: dict | None = None
    # prefix-bucket table over mini_gpos; rebuilt for checkpoints without it
    gpos_bucket: np.ndarray | None = None  # (n, 2^B + 1) i32
    gpos_shift: int = 0
    gpos_steps: int = 0
    # global positions of the hash-sorted postings (the L1's only per-hit
    # coordinate); rebuilt for checkpoints without it
    post_gpos: np.ndarray | None = None  # (n, M) i32, GBIG pad

    @property
    def n_contig_slots(self) -> int:
        return int(self.seq_to_genome.shape[1])

    def save(self, path: str) -> None:
        """Checkpoint the index to ``path`` (one ``.npz`` file).

        The layout (partition, padding, global coordinates, previous
        occurrences) is already built, so `load` is pure I/O.
        """
        arrays = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), np.ndarray)
        }
        meta = {
            "bucket_steps": self.bucket_steps,
            "n_shards": self.n_shards,
            "genome_names": self.genome_names,
            "params_state": self.params_state,
            "gpos_shift": self.gpos_shift,
            "gpos_steps": self.gpos_steps,
        }
        if not path.endswith(".npz"):
            path += ".npz"  # savez appends it; keep load() symmetric
        np.savez_compressed(
            path,
            __meta__=np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8),
            **arrays,
        )

    @classmethod
    def load(cls, path: str) -> "ShardedIndex":
        """Restore a `save`d index (from either package)."""
        if not path.endswith(".npz") and not os.path.exists(path):
            path += ".npz"
        with np.load(path) as data:
            meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
            arrays = {k: data[k] for k in data.files if k != "__meta__"}
        return cls(**arrays, **meta)


def _round_up(n: int, m: int) -> int:
    return -(-int(n) // m) * m


def _l2_kernel_rows(rmax: int) -> int:
    """Row capacity ``R`` of the L2 range for an ``rmax`` budget: a range
    longer than ``R - 128`` is flagged and escalates ``rmax``."""
    return _round_up(rmax + 128, 1024)


def _build_gpos_bucket(mini_gpos: np.ndarray):
    """Per-shard prefix-bucket tables over the (sorted, GBIG-padded)
    global-position arrays: returns (bucket (n, 2^B+1) i32, shift, steps).

    Positions are near-uniform, so B is sized to ~16 entries per bucket,
    capped at 2^22."""
    n, M = mini_gpos.shape
    m_real = [
        int(np.searchsorted(mini_gpos[sh], np.int32(GBIG - 1))) for sh in range(n)
    ]
    max_gpos = 1
    for sh in range(n):
        if m_real[sh]:
            max_gpos = max(max_gpos, int(mini_gpos[sh, m_real[sh] - 1]))
    B = min(22, max(16, (max(m_real, default=16) // 16).bit_length()))
    shift = max(0, int(max_gpos).bit_length() - B)
    edges = (np.arange((1 << B) + 1, dtype=np.int64) << shift).clip(
        max=np.int64(2**31 - 1)
    )
    out = np.empty((n, (1 << B) + 1), np.int32)
    steps = 1
    for sh in range(n):
        g = mini_gpos[sh, : m_real[sh]].astype(np.int64)
        out[sh] = np.searchsorted(g, edges).astype(np.int32)
        mb = int(np.diff(out[sh]).max(initial=0))
        steps = max(steps, max(1, int(np.ceil(np.log2(mb + 1)))) if mb else 1)
    return out, shift, steps


def build_sharded_index(mapper, n_shards: int) -> ShardedIndex:
    """Partition a Mapper's reference set by genome into ``n_shards``
    balanced sub-indexes (greedy bin packing by minimizer count)."""
    idx = mapper._index
    sbf = np.asarray(mapper._sequences_by_file, dtype=np.int64)
    n_genomes = len(mapper._names)
    contig_lo = np.concatenate([[0], sbf[:-1]])
    if n_shards > 1:  # the 1-shard fast path never partitions by genome
        genome_of_mini = np.searchsorted(sbf, idx.mini_seqid, side="right")
        counts = np.bincount(genome_of_mini, minlength=n_genomes)
        # each genome's minimizers in store order: one stable sort by genome
        # instead of a mask over the whole store per genome
        by_genome = np.argsort(genome_of_mini, kind="stable")
        genome_start = np.concatenate([[0], np.cumsum(counts)])

        shard_of = np.zeros(n_genomes, dtype=np.int64)
        loads = np.zeros(n_shards, dtype=np.int64)
        for g in np.argsort(-counts, kind="stable"):
            tgt = int(np.argmin(loads))
            shard_of[g] = tgt
            loads[tgt] += counts[g]

    shards = []
    if n_shards == 1:
        # the whole Mapper index IS the single shard (contig ids are dense
        # and position order is kept): no re-partition, no re-sort
        n_ctg_total = int(sbf[-1]) if n_genomes else 0
        seq_to_genome = np.searchsorted(sbf, np.arange(n_ctg_total), side="right")
        shards.append(
            (
                idx,
                [int(g) for g in seq_to_genome],
                list(mapper._names),
                [int(x) for x in mapper._lengths],
            )
        )
    for sh in range(n_shards if n_shards > 1 else 0):
        genomes = np.flatnonzero(shard_of == sh)
        mh, ms, mw = [], [], []
        seq_to_genome = []
        names, lengths = [], []
        new_seq = 0
        for li, g in enumerate(genomes):
            sel = by_genome[genome_start[g] : genome_start[g + 1]]
            n_ctg = int(sbf[g] - contig_lo[g])
            local_seq = idx.mini_seqid[sel] - contig_lo[g] + new_seq
            mh.append(idx.mini_hash[sel])
            ms.append(local_seq.astype(np.int32))
            mw.append(idx.mini_wpos[sel])
            seq_to_genome.extend([li] * n_ctg)
            new_seq += n_ctg
            names.append(mapper._names[g])
            lengths.append(int(mapper._lengths[g]))
        if mh:
            sub = np_engine.build_index(
                np.concatenate(mh), np.concatenate(ms), np.concatenate(mw)
            )
        else:
            sub = np_engine.build_index(
                np.zeros(0, np.uint32), np.zeros(0, np.int32), np.zeros(0, np.int32)
            )
        shards.append((sub, seq_to_genome, names, lengths))

    def pad2(arrs, fill, dtype, min_width=1):
        width = max(max((a.shape[0] for a in arrs), default=1), min_width)
        if (
            n_shards == 1
            and len(arrs) == 1
            and arrs[0].shape[0] == width
            and arrs[0].dtype == np.dtype(dtype)
        ):
            # a (1, width) view instead of an allocate + copy pass
            return np.ascontiguousarray(arrs[0])[None]
        out = np.empty((n_shards, width), dtype=dtype)
        for i, a in enumerate(arrs):
            out[i, : a.shape[0]] = a
            out[i, a.shape[0] :] = fill
        return out

    subs = [s[0] for s in shards]
    # per-shard global coordinates: offset each contig past the previous one
    offsets, gpos = [], []
    n_ctg_max = max(max((len(s[1]) for s in shards), default=1), 1)
    for sub, s2g, _, _ in shards:
        C = len(s2g)
        max_wpos = np.zeros(C, dtype=np.int64)
        if sub.mini_seqid.shape[0]:
            np.maximum.at(max_wpos, sub.mini_seqid, sub.mini_wpos.astype(np.int64))
        spans = max_wpos + mapper._param.min_read_length + 8
        off = np.zeros(n_ctg_max + 1, dtype=np.int64)
        off[1 : C + 1] = np.cumsum(spans)
        off[C + 1 :] = off[C]
        if int(off[C]) > GBIG - 2 * mapper._param.min_read_length:
            raise ValueError(
                f"shard reference span {int(off[C])} bp exceeds the 32-bit "
                f"global-coordinate budget (~{GBIG/1e9:.1f} Gbp per "
                "shard); partition across more shards"
            )
        offsets.append(off.astype(np.int32))
        gpos.append(
            (off[sub.mini_seqid] + sub.mini_wpos).astype(np.int32)
            if sub.mini_seqid.shape[0]
            else np.zeros(0, np.int32)
        )

    # both shortcuts below read the CSR sort permutation, which is the
    # (hash, seqid, wpos) order only for a store in position order: one C
    # pass per shard checks it
    ordered = [_native.position_ordered(s.mini_seqid, s.mini_wpos) for s in subs]
    prev = [mini_prev_from_index(s, o) for s, o in zip(subs, ordered)]

    # global positions of the hash-sorted postings: the CSR sort permutation
    # maps the position-ordered gpos into posting order; offset arithmetic
    # for subs whose permutation is gone (live posting edits) or whose
    # store is out of position order
    post_gpos = []
    for (sub, _, _, _), gp, off, o in zip(shards, gpos, offsets, ordered):
        m = int(sub.post_seqid.shape[0])
        order = getattr(sub, "order", None)
        if o and order is not None and order.shape[0] == m == gp.shape[0]:
            post_gpos.append(_native.take_4byte(gp, order))
        else:
            post_gpos.append(
                (off[sub.post_seqid].astype(np.int64) + sub.post_wpos).astype(np.int32)
                if m
                else np.zeros(0, np.int32)
            )

    # bucket tables stack into one (n, 2^bits+1) array: rebuild every
    # shard's at the widest choice
    bits_all = [int(s.hash_bucket.shape[0] - 1).bit_length() - 1 for s in subs]
    common_bits = max(bits_all)
    bucket_tabs, bucket_steps_all = [], []
    for s in subs:
        tab, steps = np_engine.build_hash_bucket(s.uniq_hash, common_bits)
        bucket_tabs.append(tab)
        bucket_steps_all.append(steps)

    gpos2d = pad2(gpos, GBIG, np.int32)
    gpos_bucket, gpos_shift, gpos_steps = _build_gpos_bucket(gpos2d)

    return ShardedIndex(
        uniq_hash=pad2([s.uniq_hash for s in subs], 0xFFFFFFFF, np.uint32),
        row_start=pad2([s.row_start.astype(np.int32) for s in subs], 0, np.int32),
        row_len=pad2([s.row_len for s in subs], 0, np.int32),
        post_seqid=pad2([s.post_seqid for s in subs], BIG, np.int32),
        post_wpos=pad2([s.post_wpos for s in subs], BIG, np.int32),
        mini_hash=pad2([s.mini_hash for s in subs], 0xFFFFFFFF, np.uint32),
        mini_wpos=pad2([s.mini_wpos for s in subs], BIG, np.int32),
        mini_seqid=pad2([s.mini_seqid for s in subs], BIG, np.int32),
        mini_gpos=gpos2d,
        mini_prev=pad2(prev, -BIG, np.int32),
        contig_offset=np.stack(offsets),
        seq_to_genome=pad2(
            [np.asarray(s[1], np.int32) for s in shards], 0, np.int32,
            min_width=n_ctg_max,
        ),
        freq_threshold=np.asarray([s.freq_threshold for s in subs], np.int32),
        hash_bucket=np.stack(bucket_tabs).astype(np.int32),
        bucket_steps=max(bucket_steps_all),
        genome_names=[s[2] for s in shards],
        genome_lengths=pad2([np.asarray(s[3], np.int64) for s in shards], 0, np.int64),
        n_shards=n_shards,
        params_state=mapper._param.to_state(),
        gpos_bucket=gpos_bucket,
        gpos_shift=gpos_shift,
        gpos_steps=gpos_steps,
        post_gpos=pad2(post_gpos, GBIG, np.int32),
    )


def fill_missing(sidx: ShardedIndex) -> ShardedIndex:
    """Rebuild the planes a checkpoint from before their time lacks (the
    gpos prefix table and the posting global positions), in place."""
    if sidx.gpos_bucket is None:
        sidx.gpos_bucket, sidx.gpos_shift, sidx.gpos_steps = _build_gpos_bucket(
            sidx.mini_gpos
        )
    if sidx.post_gpos is None:
        pg = np.full_like(sidx.post_wpos, GBIG)
        for sh in range(sidx.n_shards):
            ps = sidx.post_seqid[sh]
            real = ps < sidx.contig_offset.shape[1] - 1
            off = sidx.contig_offset[sh].astype(np.int64)
            pg[sh, real] = (off[ps[real]] + sidx.post_wpos[sh, real]).astype(np.int32)
        sidx.post_gpos = pg
    return sidx


def _presize_budgets(sidx: ShardedIndex, params, overrides: dict) -> dict:
    """Static device budgets derived from index statistics, so typical
    workloads run with no overflow escalation (a copy of the JAX
    package's presizer; its comments there give each margin's history).

    * ``smax``: sketch hashes per fragment, ~2l/(w+1) with margin;
    * ``rmax``: reference minimizers per L2 chunk range -- exactly the
      densest ``cmax + cmw`` global-position window of the store, padded;
    * ``hmax``: seed hits per fragment on average (the hit axis is shared
      by the batch), from the size-biased posting-row length;
    * ``bin_max``: reference-position bins per contig, from the spans;
    * ``ivmax``, ``t_chunks``: candidate intervals and L2 chunks per
      fragment, from how many genomes share a fragment's minimizers.
    """
    l = params.min_read_length
    k, w = params.kmer_size, params.window_size
    cmw = l - (k - 1)

    cmax = overrides.get("cmax") or 3072
    smax = overrides.get("smax") or max(
        128,
        min(_round_up(3 * l // (w + 1), 128), _round_up(l - k + 1, 128)),
    )

    rmax = overrides.get("rmax")
    if not rmax:
        window = cmax + cmw
        worst = 1
        for sh in range(sidx.n_shards):
            gpos = sidx.mini_gpos[sh]
            m_real = int(np.searchsorted(gpos, np.int32(GBIG - 1)))
            if m_real == 0:
                continue
            worst = max(worst, _native.densest_window(gpos[:m_real], window))
        rmax = min(_round_up(worst + 8 + 128, 1024) - 128, 8192 - 128)

    n_post = sum(
        int(np.searchsorted(sidx.mini_gpos[sh], np.int32(GBIG - 1)))
        for sh in range(sidx.n_shards)
    )
    n_uniq = int((sidx.uniq_hash != np.uint32(0xFFFFFFFF)).sum())
    mean_row = (n_post / n_uniq) if n_uniq else 1.0
    # seed hits per query hash are size-biased: E[r^2] / E[r]
    rl64 = sidx.row_len.astype(np.float64)
    sum_r = float(rl64.sum())
    biased_row = float((rl64 * rl64).sum() / sum_r) if sum_r else 1.0
    biased_row = max(biased_row, mean_row, 1.0)

    hmax = overrides.get("hmax")
    if not hmax:
        s_hat = max(2 * l // (w + 1), 16)
        hmax = _round_up(max(1.2 * s_hat * biased_row, 384), 128)
        hmax = min(hmax, 16384)

    bin_max = overrides.get("bin_max")
    if not bin_max:
        max_span = 1
        for sh in range(sidx.n_shards):
            d = np.diff(sidx.contig_offset[sh].astype(np.int64))
            if d.size:
                max_span = max(max_span, int(d.max()))
        bin_max = min(max(_round_up(max_span // l + 2, 64), 64), 4096)

    ivmax = overrides.get("ivmax")
    if not ivmax:
        ivmax = min(max(_round_up(int(6 * biased_row) + 10, 8), 16), 256)

    t_chunks = overrides.get("t_chunks")
    if not t_chunks:
        t_chunks = max(12, int(np.ceil(8.0 * biased_row)) + 8)

    return dict(
        hmax=int(hmax),
        ivmax=int(ivmax),
        cmax=int(cmax),
        rmax=int(rmax),
        t_chunks=int(t_chunks),
        bin_max=int(bin_max),
        smax=int(smax),
    )


def index_to_device(sidx: ShardedIndex, device, shard: int = 0) -> dict:
    """Park shard ``shard`` of ``sidx`` on ``device`` as the query path's
    tensors.

    Hash planes become int32 tensors holding the uint32 bit patterns; the
    per-minimizer contig-id plane is not parked, because every L2 range is
    clamped to one contig's block through ``cof_idx`` (the first minimizer
    index of each contig).
    """

    def put(a):
        # torch shares the numpy buffer first, so it must be writable
        return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)

    cof_idx = np.searchsorted(sidx.mini_gpos[shard], sidx.contig_offset[shard]).astype(np.int32)
    return dict(
        uniq_hash=put(bits_to_i32(sidx.uniq_hash[shard])),
        row_start=put(sidx.row_start[shard]),
        row_len=put(sidx.row_len[shard]),
        post_gpos=put(sidx.post_gpos[shard]),
        mini_hash=put(bits_to_i32(sidx.mini_hash[shard])),
        mini_wpos=put(sidx.mini_wpos[shard]),
        mini_gpos=put(sidx.mini_gpos[shard]),
        mini_prev=put(sidx.mini_prev[shard]),
        contig_offset=put(sidx.contig_offset[shard]),
        cof_idx=put(cof_idx),
        seq_to_genome=put(sidx.seq_to_genome[shard]),
        hash_bucket=put(sidx.hash_bucket[shard]),
        gpos_bucket=put(sidx.gpos_bucket[shard]),
    )
