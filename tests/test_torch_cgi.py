"""Port parity: the L2 sweep's merge, the identity gate, the CGI
reductions and the fold (`ops.cgi`).

The port's ``_query_block`` runs on the CPU with its call of
``cgi_bins`` recorded (``tests/test_torch_l2_sweep.run_block``); the
plain versions, `cgi_bins_reference` on the recorded operands (the chunk
results, merged per interval, then the gate and CGI) and
`fold_bins_reference` on its slots, are held against the JAX package's
``_query_block`` (``use_pallas=False``) and its ``block_fn`` fold (its
statements, run from the package's source): the slots' max into ``-inf``
bins (``chip_smoke.densify``) against JAX's dense ``best_bin``, the fold's
counts and limb sums against JAX's, at ``q_count`` 1 and 2 on two panels,
and on a panel whose genome holds a repeat, so that a fragment maps twice
to one genome at one identity and the tie rule (the first interval)
decides its bin.  The synthetic cases of ``chip_smoke.CGI_CASES`` (chunks
tied at an interval's best, intervals without chunks and invalid ones
with chunks, a chunk total past the slots, more intervals than a warp
among them) are held against the JAX package's merge, gate and CGI (their
statements, run from its source) and against a NumPy transcription of the
same rules; the flags row against the flags passed.  The fold's own
cases (equal identities of two fragments in one bin, two data rows of one
shard, a flagged pass, a scratch left dirty by a stopped pass) check that
it leaves its scratch all ``-inf``.  Every comparison is exact.
"""

import inspect
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pyfastani_tpu.parallel import sharded as jsh

from chip_smoke import (
    CGI_CASES, cgi_bins_count, cgi_case, densify, fold_args, second_row, torch_args,
)
from pyfastani_tpu_torch.ops.cgi import cgi_bins_reference, fold_bins_reference
from pyfastani_tpu_torch.ops.l2_sweep import l2_merge_reference
from pyfastani_tpu_torch import session as S
from tests.test_torch_l2_sweep import draft_panel, run_block, tiny_panel


def _jax_fold(best_bin, s2g, q_count, bin_max, g_max):
    """The identity fold of ``ShardedSession``'s ``block_fn`` on one shard:
    its statements from ``bb3 = ...`` to ``isum_lo = ...``, read from the
    JAX package's source and run as they stand there, so an edit to them
    shows here."""
    src = inspect.getsource(jsh.ShardedSession)
    first, last = "bb3 = best_bin.reshape(q_count, C, bin_max)", "isum_lo = fold(lo_qc)"
    body = src[src.rindex("\n", 0, src.index(first)) + 1:src.index(last) + len(last)]
    ns = dict(jax=jax, jnp=jnp, best_bin=best_bin, s2g=s2g[None], C=s2g.shape[0],
              q_count=q_count, bin_max=bin_max, g_max=g_max)
    exec(textwrap.dedent(body), ns)
    return ns["counts"], ns["isum_hi"], ns["isum_lo"]


def _source(fn, first: str, last: str) -> str:
    """The statements of ``fn`` from the line that holds ``first`` to
    ``last``, dedented."""
    src = inspect.getsource(fn)
    return textwrap.dedent(src[src.rindex("\n", 0, src.index(first)) + 1:
                               src.index(last) + len(last)])


def _jax_merge_gate_cgi(args):
    """The JAX package's merge of ``_l2_interval_scan`` and gate and CGI of
    ``_query_block_impl``: their statements, read from its source and run
    as they stand there on a `cgi_bins` call's operands (each chunk slot's
    interval found in ``ends``).  Returns ``(best, first, last, best_bin)``."""
    (cbest, cfirst, clast, ends, valid, seq, s, qg, gate, ident, s2g, cmw, l, ivmax, bin_max,
     g_max, q, _) = (a.numpy() if isinstance(a, torch.Tensor) else a for a in args)
    NI, F = ends.shape[0], s.shape[0]
    j = np.arange(cbest.shape[0])
    ns = dict(
        jax=jax, jnp=jnp, _BIG=jsh._BIG, NI=NI, F=F, cmw=cmw, l=l, bin_max=bin_max, g_max=g_max,
        q_count=q, cbest=jnp.asarray(cbest), cfirst=jnp.asarray(cfirst),
        clast=jnp.asarray(clast), ch_valid=jnp.asarray(j < ends[-1]),
        iv_of_c=jnp.asarray(np.minimum(np.searchsorted(ends, j, "right"), NI - 1).astype(np.int32)),
        n_ch=jnp.asarray(np.diff(ends, prepend=0).astype(np.int32)), iv_valid=jnp.asarray(valid),
        s_sizes=jnp.asarray(s), frag_of_iv=jnp.repeat(jnp.arange(F, dtype=jnp.int32), ivmax),
        gate_table=jnp.asarray(gate), ident_table=jnp.asarray(ident),
        seq_to_genome=jnp.asarray(s2g), iv_seq=jnp.asarray(seq.astype(np.int32)),
        frag_qg=jnp.asarray(qg),
    )
    exec(_source(jsh._l2_interval_scan, "seg = jnp.where(ch_valid, iv_of_c, NI)",
                 "best = jnp.where(iv_valid & (n_ch > 0), best, -1)"), ns)
    merged = tuple(np.asarray(ns[k]).astype(np.int64) for k in ("best", "first", "last"))
    exec(_source(jsh._query_block_impl, "s_iv = s_sizes[frag_of_iv]",
                 ")[: q_count * C * bin_max]"), ns)
    return (*merged, np.asarray(ns["best_bin"]))


def _numpy_merge(cbest, cfirst, clast, ends, valid):
    """NumPy transcription of the merge: ``(best, first, last)`` per
    interval."""
    NI, ch_max = ends.shape[0], cbest.shape[0]
    start = np.concatenate([[0], ends[:-1]])
    best = np.full(NI, -(2**31), np.int64)
    first = np.full(NI, 2**31 - 1, np.int64)
    last = np.full(NI, -(2**31), np.int64)
    for i in range(NI):
        b = cbest[start[i]:min(ends[i], ch_max)].astype(np.int64)
        if b.size:
            at = b == b.max()
            best[i] = b.max()
            first[i] = cfirst[start[i]:start[i] + b.size][at].min()
            last[i] = clast[start[i]:start[i] + b.size][at].max()
    return np.where(valid & (ends > start), best, -1), first, last


def _kept(args):
    """NumPy transcription of the merge, the gate and CGI step 1:
    ``(mapped, ident, gid, kept)`` per interval."""
    cbest, cfirst, clast, ends, valid, seq, s, qg, gate, ident_t, s2g, cmw, l, ivmax, *_ = (
        a.numpy() if isinstance(a, torch.Tensor) else a for a in args
    )
    best, first, last = _numpy_merge(cbest, cfirst, clast, ends, valid)
    s_iv = np.repeat(s, ivmax).astype(np.int64)
    mapped = valid & (best > 0) & (best >= gate[np.clip(s_iv, 0, gate.shape[0] - 1)])
    smax = ident_t.shape[0] - 1
    ident = ident_t[np.clip(s_iv, 0, smax), np.clip(best, 0, smax)]
    gid = s2g[np.clip(seq, 0, s2g.shape[0] - 1)]
    kept = np.zeros_like(mapped)
    for f in range(s.shape[0]):
        for i in range(f * ivmax, (f + 1) * ivmax):
            rivals = [j for j in range(f * ivmax, (f + 1) * ivmax) if mapped[j] and gid[j] == gid[i]]
            kept[i] = mapped[i] and max(rivals, key=lambda j: (ident[j], -j)) == i
    return mapped, ident, gid, kept


def _numpy_slots(args):
    """NumPy transcription of `cgi_bins`: ``(slot_bin, slot_ident,
    flag_row)``."""
    (cbest, cfirst, clast, ends, valid, seq, s, qg, gate, ident_t, s2g, cmw, l, ivmax, bin_max, _,
     q, flags) = (a.numpy() if isinstance(a, torch.Tensor) else a for a in args)
    _, first, last = _numpy_merge(cbest, cfirst, clast, ends, valid)
    _, ident, _, kept = _kept(args)
    C = s2g.shape[0]
    rbin = np.clip(((first + last) // 2 + cmw - 1) // l, 0, bin_max - 1)
    cbin = np.repeat(qg, ivmax).astype(np.int64) * C * bin_max + np.clip(seq, 0, C - 1) * bin_max + rbin
    return (np.where(kept, cbin, -1), np.where(kept, ident, np.float32(-np.inf)),
            np.array([int(f) for f in flags], np.int32))


def _numpy_bins(args):
    """The dense bins of `_numpy_slots`: their max into ``-inf`` bins."""
    slot_bin, slot_ident, _ = _numpy_slots(args)
    out = np.full(cgi_bins_count(args), -np.inf, np.float32)
    kept = slot_bin >= 0
    np.maximum.at(out, slot_bin[kept], slot_ident[kept])
    return out


def _numpy_fold(bins, s2g, q, bin_max, g_max):
    """NumPy transcription of the dense fold: ``(counts, hi, lo)``."""
    bb = bins.reshape(q, -1, bin_max)
    occ = bb > 0
    q17 = np.where(occ, np.rint(np.where(occ, bb, 0) * np.float32(131072)), 0).astype(np.int64)
    key = (np.arange(q)[:, None] * g_max + s2g[None, :]).reshape(-1)
    out = []
    for part in (occ.sum(2), (q17 >> 12).sum(2), (q17 & 0xFFF).sum(2)):
        want = np.zeros(q * g_max, np.int64)
        np.add.at(want, key, part.reshape(-1))
        out.append(want.reshape(q, g_max))
    return out


def _assert_fold(fold, want):
    for name, g, w in zip(["counts", "isum_hi", "isum_lo"], fold, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("panel", ["tiny", "draft"])
@pytest.mark.parametrize("q_count", [1, 2])
def test_cgi_bins_and_fold_match_jax(monkeypatch, panel, q_count):
    mapper, frags = tiny_panel() if panel == "tiny" else draft_panel()
    sidx, b, calls, (best_bin, _) = run_block(monkeypatch, mapper, frags, q_count)
    args = calls["cgi_bins"]
    got = cgi_bins_reference(*args)
    for g, w in zip(got, _numpy_slots(args)):
        np.testing.assert_array_equal(g.numpy(), w)
    dense = densify(got, cgi_bins_count(args))
    np.testing.assert_array_equal(dense.numpy(), np.asarray(best_bin))
    assert int(torch.isfinite(dense).sum()) > 0
    g_max = int(sidx.genome_lengths.shape[1])
    want = _jax_fold(best_bin, jnp.asarray(sidx.seq_to_genome[0]), q_count, b["bin_max"], g_max)
    fargs = fold_args(got, args)
    fold = fold_bins_reference(*fargs)
    _assert_fold(fold, want)
    assert int(fold[0].sum()) > 0 and bool(torch.isneginf(fargs[2]).all())


def test_tied_intervals_match_jax(monkeypatch):
    """A fragment of a repeat maps twice to its genome at one identity:
    the first interval keeps the fragment, as in the JAX package."""
    mapper, frags = draft_panel(repeat=True)
    sidx, b, calls, (best_bin, _) = run_block(monkeypatch, mapper, frags, ivmax=8)
    args = calls["cgi_bins"]
    mapped, ident, gid, kept = _kept(args)
    ivmax = args[13]
    ties = 0
    for f in range(args[6].shape[0]):
        rows = slice(f * ivmax, (f + 1) * ivmax)
        m, i, g = mapped[rows], ident[rows], gid[rows]
        ties += sum(int(np.sum(m & (g == g0) & (i == i0)) > 1) for g0, i0 in zip(g[m], i[m]))
    assert ties > 0
    got = cgi_bins_reference(*args)
    dense = densify(got, cgi_bins_count(args))
    np.testing.assert_array_equal(dense.numpy(), np.asarray(best_bin))
    np.testing.assert_array_equal(dense.numpy(), _numpy_bins(args))


@pytest.mark.parametrize("name", [c for c in CGI_CASES if c != "main"])
def test_cgi_cases_match_jax_merge_gate_cgi(name):
    """The plain version on the synthetic cases against the JAX package's
    merge, gate and CGI: the merge bitwise on every interval, the slots'
    bins against JAX's ``best_bin`` bitwise."""
    args = torch_args(cgi_case(name), "cpu")
    best, first, last, best_bin = _jax_merge_gate_cgi(args)
    for g, w in zip(l2_merge_reference(*args[:5]), (best, first, last)):
        np.testing.assert_array_equal(g.numpy(), w)
    got = cgi_bins_reference(*args)
    np.testing.assert_array_equal(densify(got, cgi_bins_count(args)).numpy(), best_bin)
    assert np.isfinite(best_bin).sum() > 0
    if name == "chunk_ties":  # intervals whose anchors come from several tied chunks
        cb, cf, ends = args[0].numpy(), args[1].numpy(), args[3].numpy()
        start = np.concatenate([[0], ends[:-1]])
        multi = [i for i in range(ends.shape[0]) if best[i] > 0
                 and int((cb[start[i]:ends[i]] == best[i]).sum()) >= 3
                 and first[i] < cf[start[i]:ends[i]][cb[start[i]:ends[i]] == best[i]].max()]
        assert multi
    if name == "no_chunks":  # valid intervals without a slot, invalid ones with chunks
        ends, valid = args[3].numpy(), args[4].numpy()
        n_ch = np.diff(ends, prepend=0)
        assert (valid & (n_ch == 0)).any() and (~valid & (n_ch > 0)).any()
        assert (best[n_ch == 0] == -1).all() and (best[~valid] == -1).all()
    if name == "chunk_overflow":  # the last slot inside an interval's chunks
        ends, ch_max = args[3].numpy(), args[0].shape[0]
        assert ends[-1] > ch_max and not np.isin(ch_max, ends)
        assert got[2].tolist() == [0, 0, 0, 1, 0, 0]


@pytest.mark.parametrize("name", [c for c in CGI_CASES if c != "main"])
def test_cgi_cases_follow_the_rule(name):
    case = cgi_case(name)
    args = torch_args(case, "cpu")
    got = cgi_bins_reference(*args)
    for g, w in zip(got, _numpy_slots(args)):
        np.testing.assert_array_equal(g.numpy(), w)
    if name == "ties":  # fragment 0's intervals 1 and 3 tie on genome 0: 1 keeps it
        assert _kept(args)[3][:4].tolist() == [False, True, True, False]
    assert got[2].dtype == torch.int32 and got[2].shape == (6,)
    fargs = fold_args(got, args)
    _, _, scratch, s2g, q, bin_max, g_max = fargs[:7]
    _assert_fold(fold_bins_reference(*fargs),
                 _numpy_fold(_numpy_bins(args), s2g.numpy(), q, bin_max, g_max))
    assert bool(torch.isneginf(scratch).all())


@pytest.mark.parametrize("name", [c for c in CGI_CASES if c != "main"])
def test_fold_of_two_data_rows_is_their_pmax(name):
    """Two data rows of one shard whose identities differ in the same bins:
    the fold is JAX's over the ``pmax`` of the rows' dense bins, not
    either row's alone."""
    args = torch_args(cgi_case(name), "cpu")
    one = cgi_bins_reference(*args)[:2]
    two = second_row(one, 3)
    fargs = fold_args([torch.cat(pair) for pair in zip(one, two)], args)
    _, _, scratch, s2g, q, bin_max, g_max = fargs[:7]
    n_bins = cgi_bins_count(args)
    pmax = jnp.maximum(jnp.asarray(densify(one, n_bins).numpy()),
                       jnp.asarray(densify(two, n_bins).numpy()))
    fold = fold_bins_reference(*fargs)
    _assert_fold(fold, _jax_fold(pmax, jnp.asarray(s2g.numpy()), q, bin_max, g_max))
    assert bool(torch.isneginf(scratch).all())
    for row in (one, two):
        alone = fold_bins_reference(*fold_args(row, args))
        assert any(not torch.equal(f, a) for f, a in zip(fold[1:], alone[1:]))


def _slots(bins, idents):
    return torch.tensor(bins, dtype=torch.int64), torch.tensor(idents, dtype=torch.float32)


# (query genome, contig, bin) slots of q 2, 3 contigs of genomes (0, 0, 1),
# 4 bins a contig: bin 5 is (0, 1, 1), bin 17 (1, 1, 1)
_Q, _C, _BIN_MAX, _G_MAX = 2, 3, 4, 2
_S2G = torch.tensor([0, 0, 1], dtype=torch.int32)


def _out():
    return torch.empty((3, _Q, _G_MAX), dtype=torch.int64)

FOLD_CASES = {
    # two fragments' equal identities in one bin count it once
    "equal_in_one_bin": _slots([5, 5, 17, -1, 9], [0.97, 0.97, 0.912, -np.inf, 0.5]),
    # a bin's max over two data rows of one shard, each row its own slots
    "two_data_rows": _slots([5, 17, -1, 2, 17, 5, 23],
                            [0.91, 0.88, -np.inf, 0.99, 0.93, 0.97, 0.8]),
    # identities at or under 0 occupy no bin
    "not_positive": _slots([1, 1, 6], [0.0, -0.25, 0.75]),
    "none_kept": _slots([-1, -1], [-np.inf, -np.inf]),
}


@pytest.mark.parametrize("name", FOLD_CASES)
def test_fold_cases_leave_the_scratch_neg_inf(name):
    slots = FOLD_CASES[name]
    scratch = torch.full((_Q * _C * _BIN_MAX,), -np.inf)
    dense = densify(slots, scratch.shape[0])
    fold = fold_bins_reference(*slots, scratch, _S2G, _Q, _BIN_MAX, _G_MAX, _out())
    _assert_fold(fold, _numpy_fold(dense.numpy(), _S2G.numpy(), _Q, _BIN_MAX, _G_MAX))
    _assert_fold(fold, _jax_fold(jnp.asarray(dense.numpy()), jnp.asarray(_S2G.numpy()), _Q,
                                 _BIN_MAX, _G_MAX))
    assert bool(torch.isneginf(scratch).all())
    if name == "equal_in_one_bin":
        assert fold[0].tolist() == [[1, 1], [1, 0]]  # bins 5, 9; 17


def test_flagged_pass_folds_and_merges_its_flags(monkeypatch):
    """A pass whose chunk budget overflows still folds its slots, leaves the
    scratch ``-inf`` and merges its data rows' flags into ``out_flags``."""
    mapper, frags = draft_panel()
    sidx, b, calls, _ = run_block(monkeypatch, mapper, frags, 2, cmax=32, t_chunks=1)
    assert bool(S._l2_interval_scan(*calls["_l2_interval_scan"])[4])  # the chunk overflow
    args = calls["cgi_bins"]
    slots = cgi_bins_reference(*args)
    flags = torch.tensor([[0, 0, 0, 1, 0, 0], [0, 0, 0, 0, 0, 0]], dtype=torch.int32)
    fargs = fold_args(slots, args, flags)
    fold = fold_bins_reference(*fargs)
    g_max = int(sidx.genome_lengths.shape[1])
    _assert_fold(fold, _numpy_fold(densify(slots, cgi_bins_count(args)).numpy(),
                                   args[10].numpy(), 2, b["bin_max"], g_max))
    assert slots[2].tolist() == [0, 0, 0, 1, 0, 0]  # the pass's row: the chunk overflow
    assert fargs[9].tolist() == [0, 0, 0, 1, 0, 0]
    assert bool(torch.isneginf(fargs[2]).all())


def test_dirty_scratch_is_refilled_before_the_next_fold():
    """A pass stopped between the fold's max and its visit leaves maxima in
    the scratch, which a later fold would read; filled with ``-inf`` again
    (what the session does when it finds the scratch dirty), the next fold
    is the clean one's."""
    scratch = torch.full((_Q * _C * _BIN_MAX,), -np.inf)
    stale_bin, stale_ident = _slots([5, 17, 3], [0.99, 0.95, 0.9])
    scratch.scatter_reduce_(0, stale_bin, stale_ident, "amax")  # the stopped pass
    slots = FOLD_CASES["two_data_rows"]
    want = fold_bins_reference(*slots, torch.full_like(scratch, -np.inf), _S2G, _Q, _BIN_MAX,
                               _G_MAX, _out())
    dirty = fold_bins_reference(*slots, scratch.clone(), _S2G, _Q, _BIN_MAX, _G_MAX, _out())
    assert any(not torch.equal(d, w) for d, w in zip(dirty, want))
    scratch.fill_(-np.inf)
    _assert_fold(fold_bins_reference(*slots, scratch, _S2G, _Q, _BIN_MAX, _G_MAX, _out()), want)
    assert bool(torch.isneginf(scratch).all())
