"""Trusted host (NumPy) implementation of the full FastANI pipeline.

This is the semantic reference of the framework: every stage reproduces
the observable behavior of pyfastani/FastANI, reconstructed from
``pyfastani: src/pyfastani/_fastani.pyx`` (winnowing ``:156-309``,
L1 ``:885-954``, query loop ``:1006-1136``) and the declared C++ API
(``include/fastani/**``, internals reconstructed from Jain et al. 2018 and
pinned by the reference golden tests).  The port's device engine is held
against this module, and this module is validated against the on-disk
protein golden test plus a literal deque-port oracle.

A copy of ``pyfastani_tpu/models/_engine_np.py``, so that the port imports
nothing of the JAX package; its outputs equal the original's bit for bit.

Array conventions (structure-of-arrays everywhere):
* minimizers: ``(hash u32, seq_id i32, wpos i32)`` in emission order, which
  is (contig, window) order -- exactly the order ``searchIndex`` binary
  searches ([reconstructed] ``winSketch.hpp``: the index never re-sorts).
* posting index: CSR over hash-sorted copies of the same minimizers
  (stable sort, so each posting row keeps (seq, wpos) order).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import stats
from ..ops import _host
from ._params import Parameters

__all__ = ["winnow_sequence", "PostingIndex", "build_index", "query_contigs_np"]

INT_MAX = 2**31 - 1


def winnow_sequence(data: np.ndarray, params: Parameters) -> tuple[np.ndarray, np.ndarray]:
    """Winnow one uppercased uint8 sequence; return (hashes u32, wpos i32).

    Caller is responsible for the min-length checks and seq-id assignment.
    """
    k, w = params.kmer_size, params.window_size
    n = int(data.shape[0])
    n_pos = n - k + 1
    if n_pos < 1 or n_pos - w + 1 < 1:
        return (np.zeros(0, np.uint32), np.zeros(0, np.int32))
    with np.errstate(over="ignore"):
        padded = np.concatenate([data, np.zeros(4, dtype=np.uint8)])
        if params.alphabet_size == 4:
            canon, valid = _host.nucl_canonical(padded, n, k, n_pos)
        else:
            canon, valid = _host.prot_hashes(padded, n, k, n_pos)
        record, win_hash = _host.winnow(canon, valid, w)
    wpos = np.flatnonzero(record).astype(np.int32)
    return win_hash[record], wpos


@dataclasses.dataclass
class PostingIndex:
    """CSR posting index + position-ordered minimizer store.

    Equivalent of ``skch::Sketch`` after ``index()`` + ``computeFreqHist()``
    (``win_sketch.pxd:17-42``): ``minimizerPosLookupIndex`` becomes
    (uniq_hash, row_start, row_len) over hash-sorted postings;
    ``freqThreshold`` is computed from the row-length histogram.
    """

    # position-ordered minimizer store (the reference's minimizerIndex)
    mini_hash: np.ndarray  # u32 (M,)
    mini_seqid: np.ndarray  # i32 (M,)
    mini_wpos: np.ndarray  # i32 (M,)
    # CSR posting lists, grouped by hash
    uniq_hash: np.ndarray  # u32 (U,) ascending
    row_start: np.ndarray  # i64 (U,)
    row_len: np.ndarray  # i32 (U,)
    post_seqid: np.ndarray  # i32 (M,)
    post_wpos: np.ndarray  # i32 (M,)
    freq_threshold: int
    # bucket prefix over uniq_hash's high 16 bits: hash_bucket[b] is the
    # first row whose hash >> 16 >= b (65537 entries).  Device probes
    # binary-search only within a bucket (~log2(M/2^16) steps vs ~21).
    hash_bucket: np.ndarray = None  # i32 (65537,)
    bucket_steps: int = 0
    # bumped on every live posting edit (set/delete_posting_row) so cached
    # device copies of the index (Mapper's lazy ShardedSession) invalidate
    version: int = 0
    # stable permutation from position order to hash order (the sort that
    # built the CSR).  Because the minimizer store is position-ordered,
    # this single order is also (hash, seqid, wpos)-lexicographic, which
    # gives the previous-occurrence table without a second sort
    # (`mini_prev_from_index`).  None on indexes rebuilt through live
    # posting edits.
    order: np.ndarray = None  # i32 (M,)

    @property
    def n_minimizers(self) -> int:
        return int(self.mini_hash.shape[0])

    @property
    def n_unique(self) -> int:
        return int(self.uniq_hash.shape[0])


def compute_freq_threshold(row_len: np.ndarray) -> int:
    """[reconstructed ``winSketch.hpp::computeFreqHist``]: ignore the most
    frequent ~0.001% of minimizers.  The histogram walk keeps lowering the
    threshold while the cumulative count stays *below* the ignore budget,
    includes the boundary bucket on exact equality, and leaves INT_MAX
    (no filtering) when the very first bucket overshoots."""
    total_unique = row_len.shape[0]
    if total_unique == 0:
        return INT_MAX
    # int64 * float -> C promotes to float (binary32): emulate
    to_ignore = int(
        np.float32(np.float32(total_unique) * np.float32(0.001) / np.float32(100.0))
    )
    # row lengths are small positive ints: bincount beats np.unique's
    # sort at bench scale (31M rows)
    bc = np.bincount(row_len)
    freqs = np.flatnonzero(bc)
    counts = bc[freqs]
    threshold = INT_MAX
    acc = 0
    for f, c in zip(freqs[::-1], counts[::-1]):
        acc += int(c)
        if acc < to_ignore:
            threshold = int(f)
        elif acc == to_ignore:
            threshold = int(f)
            break
        else:
            break
    return threshold


def build_index(
    mini_hash: np.ndarray, mini_seqid: np.ndarray, mini_wpos: np.ndarray
) -> PostingIndex:
    """Sort-based CSR construction of the posting index."""
    from .. import _native

    order = _native.argsort_u32_stable(mini_hash)
    sorted_hash = _native.take_4byte(np.asarray(mini_hash, np.uint32), order)
    post_seqid = _native.take_4byte(np.asarray(mini_seqid, np.int32), order)
    post_wpos = _native.take_4byte(np.asarray(mini_wpos, np.int32), order)
    # group boundaries on the already-sorted array (np.unique would sort
    # again); int64 row starts so the live posting-edit arithmetic
    # (`set_posting_row`) keeps its historical dtype
    uniq_hash, row_start32, row_len = _native.csr_groups(sorted_hash)
    row_start = row_start32.astype(np.int64)
    hash_bucket, bucket_steps = build_hash_bucket(uniq_hash)
    return PostingIndex(
        mini_hash=mini_hash,
        mini_seqid=mini_seqid,
        mini_wpos=mini_wpos,
        uniq_hash=uniq_hash,
        row_start=row_start,
        row_len=row_len,
        post_seqid=post_seqid,
        post_wpos=post_wpos,
        freq_threshold=compute_freq_threshold(row_len),
        hash_bucket=hash_bucket,
        bucket_steps=bucket_steps,
        order=np.asarray(order, np.int32),
    )


def build_hash_bucket(uniq_hash: np.ndarray, bits: int | None = None):
    """Prefix-bucket table over ``uniq_hash``'s high ``bits`` bits.

    Winnowed minimizer hashes are window MINIMA, so their distribution is
    skewed low (~Beta(1, w+1) scaled): a fixed 16-bit prefix leaves the
    crowded low buckets hundreds deep (10 binary-search steps on device).
    The width adapts until the deepest bucket is shallow (<= 48 rows,
    <= 2^24 entries / 64 MB), cutting the probe to ~6 gather rounds.

    Returns (hash_bucket (2^bits + 1,) i32, bucket_steps).
    """
    # one 24-bit-prefix histogram serves every candidate width: a width-b
    # table's bucket sizes are 2^(24-b)-group sums of it, and the table
    # itself is the cumulative sum (uniq_hash is ascending).  This
    # replaces up to nine 31M-element searchsorted passes at bench scale.
    u = int(uniq_hash.shape[0])
    if u < (1 << 20):
        # small index: searchsorted on the array directly.  Live posting
        # edits (`set_posting_row`/`delete_posting_row`) rebuild this
        # table per edit, so the small path must stay O(u log u) -- the
        # 16M-bin histogram below would turn an edit loop quadratic.
        if bits is None:
            bits = 16
            while bits < 24:
                shift = np.uint32(32 - bits)
                high = (uniq_hash >> shift).astype(np.int64)
                hb = np.searchsorted(high, np.arange((1 << bits) + 1))
                if int(np.diff(hb).max(initial=0)) <= 48 or (1 << bits) >= 4 * u:
                    break
                bits += 1
        shift = np.uint32(32 - bits)
        high = (uniq_hash >> shift).astype(np.int64)
        hash_bucket = np.searchsorted(
            high, np.arange((1 << bits) + 1)
        ).astype(np.int32)
        max_bucket = int(np.diff(hash_bucket).max(initial=0))
        bucket_steps = (
            max(1, int(np.ceil(np.log2(max_bucket + 1)))) if max_bucket else 1
        )
        return hash_bucket, bucket_steps

    from .. import _native

    # bench-scale index: one threaded 24-bit-prefix histogram serves every
    # candidate width (coarser levels by halving), and the table itself is
    # its cumulative sum -- no 31M-element searchsorted passes
    hist24 = _native.prefix_hist(uniq_hash, 8, 24)
    levels = {24: hist24}
    for b in range(23, 15, -1):
        levels[b] = levels[b + 1].reshape(-1, 2).sum(axis=1, dtype=np.int32)
    if bits is None:
        bits = 16
        # depth target 16 (vs 48 on the small path): each halving of the
        # max bucket depth removes one (F, S)-sized gather round from
        # every device probe, and at this scale the table cost is already
        # paid -- cap unchanged at 2^24 entries / 64 MB
        while bits < 24:
            if int(levels[bits].max(initial=0)) <= 16 or (1 << bits) >= 8 * u:
                break
            bits += 1
    agg = levels[bits]
    hash_bucket = np.zeros((1 << bits) + 1, np.int32)
    np.cumsum(agg, out=hash_bucket[1:], dtype=np.int32)
    max_bucket = int(agg.max(initial=0))
    bucket_steps = max(1, int(np.ceil(np.log2(max_bucket + 1)))) if max_bucket else 1
    return hash_bucket, bucket_steps


def _rebuild_bucket(index: PostingIndex) -> None:
    """Recompute the prefix-bucket table after a posting edit."""
    index.hash_bucket, index.bucket_steps = build_hash_bucket(index.uniq_hash)
    index.version += 1
    # the CSR sort permutation no longer describes the edited postings;
    # downstream consumers (mini_prev_from_index) fall back to a lexsort
    index.order = None


def set_posting_row(
    index: PostingIndex, h: int, seqids: np.ndarray, wpos: np.ndarray
) -> None:
    """Replace (or insert) the posting row of hash ``h`` in place.

    Mirrors ``MinimizerIndex.__setitem__`` on the reference's live
    ``minimizerPosLookupIndex`` view (``_fastani.pyx:1487-1500``): the
    edit changes what L1 probes see; the position-ordered minimizer store
    (used by L2's ``searchIndex``) and the frequency threshold are NOT
    touched, exactly like the reference.
    """
    h = np.uint32(h)
    u = int(np.searchsorted(index.uniq_hash, h))
    present = u < index.n_unique and index.uniq_hash[u] == h
    start = int(index.row_start[u]) if present else (
        int(index.row_start[u]) if u < index.n_unique else index.post_seqid.shape[0]
    )
    old_len = int(index.row_len[u]) if present else 0
    new_len = int(seqids.shape[0])

    index.post_seqid = np.concatenate(
        [index.post_seqid[:start], seqids.astype(np.int32),
         index.post_seqid[start + old_len:]]
    )
    index.post_wpos = np.concatenate(
        [index.post_wpos[:start], wpos.astype(np.int32),
         index.post_wpos[start + old_len:]]
    )
    if present:
        index.row_len = index.row_len.copy()
        index.row_len[u] = new_len
    else:
        index.uniq_hash = np.insert(index.uniq_hash, u, h)
        index.row_len = np.insert(index.row_len, u, new_len)
        index.row_start = np.insert(index.row_start, u, 0)
    delta = new_len - old_len
    index.row_start = index.row_start.copy()
    if present:
        index.row_start[u + 1:] += delta
    else:
        index.row_start[u] = start
        index.row_start[u + 1:] += delta
    _rebuild_bucket(index)


def delete_posting_row(index: PostingIndex, h: int) -> bool:
    """Remove the posting row of hash ``h``; returns False when absent.

    Mirrors ``MinimizerIndex.__delitem__`` (``_fastani.pyx:1502-1516``).
    """
    h = np.uint32(h)
    u = int(np.searchsorted(index.uniq_hash, h))
    if u >= index.n_unique or index.uniq_hash[u] != h:
        return False
    start = int(index.row_start[u])
    length = int(index.row_len[u])
    index.post_seqid = np.delete(
        index.post_seqid, slice(start, start + length)
    )
    index.post_wpos = np.delete(index.post_wpos, slice(start, start + length))
    index.uniq_hash = np.delete(index.uniq_hash, u)
    index.row_start = np.delete(index.row_start, u)
    index.row_len = np.delete(index.row_len, u)
    index.row_start = index.row_start.copy()
    index.row_start[u:] -= length
    _rebuild_bucket(index)
    return True


# --- L1: candidate regions ---------------------------------------------------


def _l1_candidates(
    q_uniq: np.ndarray,
    index: PostingIndex,
    params: Parameters,
    min_hits: int,
):
    """[reconstructed ``computeMap.hpp::computeL1CandidateRegions``] +
    the posting probes of ``Mapper._do_l1_mappings``
    (``_fastani.pyx:941-952``).

    Returns merged candidate intervals (seq_id, c0, c1) arrays.
    """
    l = params.min_read_length
    if index.n_unique == 0:
        return (np.zeros(0, np.int32),) * 3
    # probe the CSR index; skip rows at/above the frequency threshold
    pos = np.searchsorted(index.uniq_hash, q_uniq)
    found = pos < index.n_unique
    posc = np.minimum(pos, max(index.n_unique - 1, 0))
    found &= index.uniq_hash[posc] == q_uniq
    rows = posc[found]
    rows = rows[index.row_len[rows] < index.freq_threshold]
    if rows.size == 0:
        return (np.zeros(0, np.int32),) * 3

    # gather whole posting rows
    lens = index.row_len[rows].astype(np.int64)
    starts = index.row_start[rows]
    total = int(lens.sum())
    out_off = np.repeat(np.cumsum(lens) - lens, lens)
    flat = np.arange(total, dtype=np.int64) - out_off + np.repeat(starts, lens)
    hit_seq = index.post_seqid[flat]
    hit_pos = index.post_wpos[flat]

    # sort by (seqId, wpos)
    order = np.lexsort((hit_pos, hit_seq))
    hit_seq = hit_seq[order]
    hit_pos = hit_pos[order]

    m = max(int(min_hits), 1)
    H = hit_seq.shape[0]
    if H < m:
        return (np.zeros(0, np.int32),) * 3
    j = np.arange(H - m + 1)
    j2 = j + m - 1
    ok = (hit_seq[j2] == hit_seq[j]) & (hit_pos[j2] - hit_pos[j] < l)
    if not ok.any():
        return (np.zeros(0, np.int32),) * 3
    cand_seq = hit_seq[j][ok]
    cand_start = np.maximum(0, hit_pos[j2][ok] - l + 1).astype(np.int32)
    cand_end = hit_pos[j][ok].astype(np.int32)

    # merge overlapping candidates (ends are non-decreasing per seq run)
    new = np.ones(cand_seq.shape[0], dtype=bool)
    new[1:] = (cand_seq[1:] != cand_seq[:-1]) | (cand_start[1:] > cand_end[:-1])
    iv_id = np.cumsum(new) - 1
    n_iv = int(iv_id[-1]) + 1
    iv_seq = cand_seq[new]
    iv_start = cand_start[new]
    iv_end = np.zeros(n_iv, dtype=np.int32)
    np.maximum.at(iv_end, iv_id, cand_end)
    return iv_seq, iv_start, iv_end


# --- L2: sliding union-sketch intersection ----------------------------------


def _l2_shared_curve(
    q_uniq: np.ndarray,
    rh: np.ndarray,
    rp: np.ndarray,
    c0: int,
    c1: int,
    cmw: int,
):
    """Shared sketch count at every super-window anchored on a reference
    minimizer record: for each record position a in [c0, c1],
    ``shared(a) = |Sq ∩ {hashes of ref minimizers with wpos in [a, a+cmw)}|``.

    Two reconstructed choices here, both validated empirically:

    * Window anchors are the *reference minimizer records* inside the L1
      candidate range -- the reference slides ``searchIndex`` iterators one
      record at a time ([reconstructed] ``computeL2MappedRegions``,
      ``compute_map.pxd:35,41-42``), not one base at a time.
    * The count is *containment* (no displacement of query hashes by
      ref-only hashes from an s-smallest union cutoff): forced by the
      reference self-query goldens, which assert self-ANI of exactly 100.0
      (``test_ani.py:67-71,87-91``); the strict union-minhash estimator
      cannot reach shared == s for every fragment because boundary records
      shift up to w-1 windows left of the fragment.

    Returns (anchors, shared): the record positions and their counts.
    """
    s = int(q_uniq.shape[0])
    anchors = rp[(rp >= c0) & (rp <= c1)].astype(np.int64)
    if rh.shape[0] == 0 or s == 0 or anchors.shape[0] == 0:
        return np.zeros(0, np.int64), np.zeros(0, dtype=np.int32)

    qrank = np.searchsorted(q_uniq, rh).astype(np.int64)
    in_q = (qrank < s) & (q_uniq[np.minimum(qrank, s - 1)] == rh)

    c = anchors[:, None]
    in_win = (rp[None, :] >= c) & (rp[None, :] < c + cmw)  # (A, R)

    # P[j, i] = 1 iff ref mini j realizes query hash i
    P = np.zeros((rh.shape[0], s), dtype=np.float32)
    P[np.flatnonzero(in_q), qrank[in_q]] = 1.0

    present = (in_win.astype(np.float32) @ P) >= 1.0  # q_i in ref window
    return anchors, present.sum(axis=1).astype(np.int32)


def _search_pos(index: PostingIndex, seq_id: int, wpos: int) -> int:
    """``Sketch::searchIndex``: lower bound on (seqId, wpos) in the
    position-ordered minimizer store.

    The key is ``seqId << 32 | uint32(wpos)``; searching the contig's
    block and then its positions gives the same bound in O(log M), where
    building every key would cost O(M) per call.  Stored positions lie in
    [0, 2^31), so a ``wpos`` outside it (a low word of 2^31 or more) lies
    past the block.  The probes are int32 like the planes: a Python int
    would make numpy cast the whole plane to int64, O(M) again.
    """
    seqid = index.mini_seqid
    a = int(np.searchsorted(seqid, np.int32(seq_id), side="left"))
    b = int(np.searchsorted(seqid, np.int32(seq_id), side="right"))
    if not 0 <= wpos <= np.iinfo(np.int32).max:
        return b
    return a + int(np.searchsorted(index.mini_wpos[a:b], np.int32(wpos), side="left"))


@dataclasses.dataclass
class Mapping:
    """The subset of ``skch::MappingResult`` consumed by computeCGI."""

    query_seq_id: int
    ref_seq_id: int
    ref_start: int
    shared: int
    sketch_size: int
    identity: float  # float32 semantics


def _map_fragment(
    frag: np.ndarray,
    query_seq_id: int,
    index: PostingIndex,
    params: Parameters,
    out: list,
):
    """Map one fragment: winnow, sketch, L1, L2, identity gate.

    Mirrors ``Mapper._query_fragment`` (``_fastani.pyx:956-1004``) plus
    [reconstructed] ``doL2Mapping``/``computeL2MappedRegions``.
    """
    mh, _ = winnow_sequence(frag, params)
    if mh.shape[0] == 0:
        return
    q_uniq = np.unique(mh)  # sorted unique hashes = the fragment sketch
    s = int(q_uniq.shape[0])

    min_hits = stats.estimate_minimum_hits_relaxed(
        s, params.kmer_size, params.percentage_identity
    )
    iv_seq, iv_start, iv_end = _l1_candidates(q_uniq, index, params, min_hits)
    if iv_seq.shape[0] == 0:
        return

    # L2 sliding-window width in minimizer-window space.  This must be
    # l - k + 1 (the k-mer count of a fragment), NOT the window count
    # l - k - w + 2: minimizer *records* can precede the occurrence they
    # describe by up to w - 1 windows (dedup runs), and the reference's
    # self-query golden (identity exactly 100.0, test_ani.py:67-71) is only
    # achievable if a single window can span a fragment's records including
    # that shift; l - k + 1 is the minimal sufficient width.
    l = params.min_read_length
    cmw = l - (params.kmer_size - 1)
    for t in range(iv_seq.shape[0]):
        sid, c0, c1 = int(iv_seq[t]), int(iv_start[t]), int(iv_end[t])
        lo = _search_pos(index, sid, c0)
        hi = _search_pos(index, sid, c1 + cmw)
        anchors, shared = _l2_shared_curve(
            q_uniq, index.mini_hash[lo:hi], index.mini_wpos[lo:hi], c0, c1, cmw
        )
        best = int(shared.max(initial=0))
        if best <= 0:
            continue
        where_best = np.flatnonzero(shared == best)
        first_a = int(anchors[where_best[0]])
        last_a = int(anchors[where_best[-1]])
        # Reported position: plateau midpoint in window-END coordinates,
        # i.e. midpoint of the first/last best anchors plus (cmw - 1).
        # [reconstructed] The protein golden (matches == 130,
        # test_ani.py:109-115, the only runnable end-to-end golden) is
        # reproduced exactly by end-of-window reporting and by no other
        # offset family (validated bands: {25-27, 82-85, 125-127} of which
        # cmw-1 = 84 is the structurally consistent choice); the bacterial
        # self-query goldens (every fragment binned at its own locus)
        # remain satisfied since mid + cmw - 1 stays inside the aligned
        # fragment's bin for any record shift 0..w-1.
        mean_optimal = (first_a + last_a) // 2 + (cmw - 1)

        # identity + CI gate (doL2Mapping [reconstructed])
        jaccard = 1.0 * best / s
        mash = stats.j2md(jaccard, params.kmer_size)
        identity = float(np.float32(100.0 * (1.0 - mash)))
        d_lower = stats.md_lower_bound(
            mash, s, params.kmer_size, stats.CONFIDENCE_INTERVAL
        )
        identity_ub = float(np.float32(100.0 * (1.0 - d_lower)))
        if np.float32(identity_ub) >= np.float32(params.percentage_identity):
            out.append(
                Mapping(
                    query_seq_id=query_seq_id,
                    ref_seq_id=sid,
                    ref_start=mean_optimal,
                    shared=best,
                    sketch_size=s,
                    identity=identity,
                )
            )


# --- CGI: reciprocal-best aggregation ---------------------------------------


def compute_cgi(
    mappings: list,
    sequences_by_file: np.ndarray,
    total_fragments: int,
    params: Parameters,
):
    """[reconstructed ``cgi::computeCGI``]: map contig ids to genome ids,
    bin reference positions by fragment length, keep the best-identity
    mapping per (genome, query fragment), then per (ref contig, ref bin),
    and average identities per genome.

    Returns list of (ref_genome_id, count_seq, identity_f32) in genome order.
    """
    if not mappings:
        return []
    l = params.min_read_length
    qseq = np.array([m.query_seq_id for m in mappings], dtype=np.int64)
    rseq = np.array([m.ref_seq_id for m in mappings], dtype=np.int64)
    rstart = np.array([m.ref_start for m in mappings], dtype=np.int64)
    ident = np.array([m.identity for m in mappings], dtype=np.float32)
    rbin = rstart // l
    genome = np.searchsorted(sequences_by_file, rseq, side="right")

    # 1. best identity per (genome, query fragment), a SINGLE winner per
    # group (``cgi::computeCGI`` first pass).  The reference resolves exact
    # ties through std::sort instability over a thread-pool-ordered vector;
    # here ties go to the first mapping in enumeration order (fragments in
    # order, candidate intervals in (seqId, pos) order), which is
    # deterministic, order-independent, and reproduces the protein golden
    # under either tie polarity (see KNOWN_DEVIATIONS.md).
    order = np.arange(len(mappings), dtype=np.int64)
    o1 = np.lexsort((order, -ident, qseq, genome))
    g1, q1 = genome[o1], qseq[o1]
    grp_first = np.ones(o1.shape[0], dtype=bool)
    grp_first[1:] = (g1[1:] != g1[:-1]) | (q1[1:] != q1[:-1])
    keep1 = o1[grp_first]

    # 2. best per (ref contig, ref position bin) among the survivors; one
    # entry per bin (tied winners share the identity value, so the choice
    # does not affect the output)
    r2, b2, i2 = rseq[keep1], rbin[keep1], ident[keep1]
    o2 = np.lexsort((i2, b2, r2))
    r2s, b2s = r2[o2], b2[o2]
    is_last2 = np.ones(o2.shape[0], dtype=bool)
    is_last2[:-1] = (r2s[1:] != r2s[:-1]) | (b2s[1:] != b2s[:-1])
    keep2 = keep1[o2[is_last2]]  # ordered by (ref contig, bin)

    # 3. per-genome mean identity; groups are already genome-ordered since
    # genome id is monotone in ref contig id
    g3 = genome[keep2]
    i3 = ident[keep2]
    results = []
    for gid in np.unique(g3):
        sel = i3[g3 == gid]
        results.append(
            (int(gid), int(sel.shape[0]), mean_identity(sel))
        )
    return results


def mean_identity(idents_f32: np.ndarray) -> float:
    """Order-independent mean of float32 identities, shared by BOTH
    engines (the bitwise engine contract).

    Identities are quantized to a 2^-17 grid (exact for values >= 64 --
    every representable f32 there already lies on it; <= 7.6e-6 off
    otherwise, far inside the goldens' 1e-4 gate) and summed as exact
    integers, so any reduction order -- host loop, device segment
    reduction tree, multi-chip collective -- produces the identical
    float32 mean.  A sequential float32 sum (the reconstructed C
    semantics) is order-DEPENDENT, which no parallel reduction can
    reproduce bitwise; see KNOWN_DEVIATIONS.md.
    """
    q17 = np.rint(
        np.float32(idents_f32.astype(np.float32) * np.float32(131072.0))
    ).astype(np.int64)
    total = int(q17.sum())
    n = int(idents_f32.shape[0])
    return float(np.float32(total / (131072.0 * n)))


# --- whole-genome query ------------------------------------------------------


def query_contigs_np(
    contig_arrays: list,
    index: PostingIndex,
    params: Parameters,
):
    """Run the full per-genome query pipeline on uint8 contig arrays.

    Returns (mappings, total_fragments, total_length).
    Mirrors ``Mapper._query_draft`` (``_fastani.pyx:1006-1118``); the
    thread-pool fragment fan-out becomes a plain loop here and a batched
    device axis in the port's session.
    """
    l = params.min_read_length
    mappings: list = []
    total_fragments = 0
    total_length = 0
    for data in contig_arrays:
        slen = int(data.shape[0])
        n_frag = slen // l
        for i in range(n_frag):
            _map_fragment(
                data[i * l : (i + 1) * l], total_fragments + i, index, params, mappings
            )
        total_fragments += n_frag
        total_length += slen
    return mappings, total_fragments, total_length
