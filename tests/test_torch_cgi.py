"""Port parity: the identity gate, the CGI reductions and the fold (`ops.cgi`).

The port's ``_query_block`` runs on the CPU with its call of
``cgi_bins`` recorded (``tests/test_torch_l2_sweep.run_block``); the
plain versions, `cgi_bins_reference` on the recorded operands and
`fold_bins_reference` on its bins, are held against the JAX package's
``_query_block`` (``use_pallas=False``) and its ``block_fn`` fold (its
statements, run from the package's source), at ``q_count`` 1 and 2, and
on a panel whose genome holds a repeat, so that a fragment maps twice to
one genome at one identity and the tie rule (the first interval) decides
its bin.  The synthetic cases of
``chip_smoke.CGI_CASES`` are held against a NumPy transcription of the
same rules.  Every comparison is exact.
"""

import inspect
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from pyfastani_tpu.parallel import sharded as jsh

from chip_smoke import CGI_CASES, cgi_case, fold_args, torch_args
from pyfastani_tpu_torch.ops.cgi import cgi_bins_reference, fold_bins_reference
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


def _kept(args):
    """NumPy transcription of the gate and CGI step 1: ``(mapped, ident,
    gid, kept)`` per interval."""
    best, first, last, valid, seq, s, qg, gate, ident_t, s2g, cmw, l, ivmax, *_ = (
        a.numpy() if isinstance(a, torch.Tensor) else a for a in args
    )
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


def _numpy_bins(args):
    """NumPy transcription of `cgi_bins`."""
    best, first, last, valid, seq, s, qg, gate, ident_t, s2g, cmw, l, ivmax, bin_max, _, q = (
        a.numpy() if isinstance(a, torch.Tensor) else a for a in args
    )
    _, ident, _, kept = _kept(args)
    C = s2g.shape[0]
    rbin = np.clip(((first + last) // 2 + cmw - 1) // l, 0, bin_max - 1)
    cbin = np.repeat(qg, ivmax).astype(np.int64) * C * bin_max + np.clip(seq, 0, C - 1) * bin_max + rbin
    out = np.full(q * C * bin_max, -np.inf, np.float32)
    np.maximum.at(out, cbin[kept], ident[kept])
    return out


@pytest.mark.parametrize("q_count", [1, 2])
def test_cgi_bins_and_fold_match_jax(monkeypatch, q_count):
    mapper, frags = tiny_panel()
    sidx, b, calls, (best_bin, _) = run_block(monkeypatch, mapper, frags, q_count)
    args = calls["cgi_bins"]
    got = cgi_bins_reference(*args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(best_bin))
    assert int(torch.isfinite(got).sum()) > 0
    g_max = int(sidx.genome_lengths.shape[1])
    want = _jax_fold(best_bin, jnp.asarray(sidx.seq_to_genome[0]), q_count, b["bin_max"], g_max)
    fold = fold_bins_reference(got, args[9], q_count, b["bin_max"], g_max)
    for name, g, w in zip(["counts", "isum_hi", "isum_lo"], fold, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(fold[0].sum()) > 0


def test_tied_intervals_match_jax(monkeypatch):
    """A fragment of a repeat maps twice to its genome at one identity:
    the first interval keeps the fragment, as in the JAX package."""
    mapper, frags = draft_panel(repeat=True)
    sidx, b, calls, (best_bin, _) = run_block(monkeypatch, mapper, frags, ivmax=8)
    args = calls["cgi_bins"]
    mapped, ident, gid, kept = _kept(args)
    ivmax = args[12]
    ties = 0
    for f in range(args[5].shape[0]):
        rows = slice(f * ivmax, (f + 1) * ivmax)
        m, i, g = mapped[rows], ident[rows], gid[rows]
        ties += sum(int(np.sum(m & (g == g0) & (i == i0)) > 1) for g0, i0 in zip(g[m], i[m]))
    assert ties > 0
    got = cgi_bins_reference(*args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(best_bin))
    np.testing.assert_array_equal(got.numpy(), _numpy_bins(args))


@pytest.mark.parametrize("name", [c for c in CGI_CASES if c != "main"])
def test_cgi_cases_follow_the_rule(name):
    case = cgi_case(name)
    args = torch_args(case, "cpu")
    got = cgi_bins_reference(*args)
    np.testing.assert_array_equal(got.numpy(), _numpy_bins(args))
    if name == "ties":  # fragment 0's intervals 1 and 3 tie on genome 0: 1 keeps it
        assert _kept(args)[3][:4].tolist() == [False, True, True, False]
    best_bin, s2g, q, bin_max, g_max = fold_args(got, args)
    counts, hi, lo = fold_bins_reference(best_bin, s2g, q, bin_max, g_max)
    bb = best_bin.numpy().reshape(q, -1, bin_max)
    occ = bb > 0
    q17 = np.where(occ, np.rint(np.where(occ, bb, 0) * np.float32(131072)), 0).astype(np.int64)
    key = (np.arange(q)[:, None] * g_max + s2g.numpy()[None, :]).reshape(-1)
    for x, part in ((counts, occ.sum(2)), (hi, (q17 >> 12).sum(2)), (lo, (q17 & 0xFFF).sum(2))):
        want = np.zeros(q * g_max, np.int64)
        np.add.at(want, key, part.reshape(-1))
        np.testing.assert_array_equal(x.numpy().reshape(-1), want)
