"""Port parity: the L2 sweep around its chunk evaluator (`ops.l2_sweep`).

A fragment block goes through the port's ``_query_block`` on the CPU,
whose call of ``_l2_interval_scan`` is recorded; the recorded operands (the
L1 stage's intervals as global positions) then go through the port's
``_l2_interval_scan`` -- the contig lookup and chunk plan (`l2_plan`, the
plain version on the CPU) and `l2_chunks` -- whose chunk results the
merge's plain version (`l2_merge_reference`, the first step of
``ops.cgi.cgi_bins``' plain version; on the card the merge runs inside
its kernel) merges per interval, and through the JAX package's contig
lookup (``_query_block_impl``'s, in ``jnp``) and ``_l2_interval_scan``
with ``use_pallas=False``, whose outputs its own tests pin as
bit-identical to its Pallas branch.  Best, first, last, both budget flags
and the contigs must be equal, with tolerance 0, on the tiny panel of
``tests/test_torch_query.py`` and on a panel of multi-contig genomes,
also at a chunk budget that overflows.

The plain plan (`l2_plan_reference`) is held bitwise against the
composition it replaced (the session's contig lookup, then the plain plan
of the looked-up intervals; a frozen copy below), and the plain twin of
the kernels' design (`l2_plan_tiled`) against the plain plan under the
kernels' contract (``chip_smoke._plan_err``), on ``chip_smoke``'s cases
and on hypothesis-drawn ones.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

import __graft_entry__
import pyfastani_tpu
from chip_smoke import SWEEP_CASES, _plan_err, _positions, sweep_case, torch_args
from pyfastani_tpu import stats
from pyfastani_tpu.parallel import sharded as jsh
from pyfastani_tpu_torch import index as tidx
from pyfastani_tpu_torch import session as S
from pyfastani_tpu_torch._common import BIG
from pyfastani_tpu_torch.index import _build_gpos_bucket
from pyfastani_tpu_torch.ops import l2_sweep

_ACGT = np.frombuffer(b"ACGT", np.uint8)
# the static budgets of __graft_entry__.entry()
BUDGETS = dict(hmax=1024, ivmax=32, cmax=128, rmax=512, t_chunks=16, bin_max=256, smax=512)


def _frags(query: bytes, l: int) -> np.ndarray:
    q = np.frombuffer(query, np.uint8)
    n_frag = q.shape[0] // l
    frags = np.zeros((n_frag, l + 4), np.uint8)
    frags[:, :l] = q[: n_frag * l].reshape(n_frag, l)
    return frags


def tiny_panel():
    """The tiny panel of ``tests/test_torch_query.py``: its mapper and the
    query's fragment rows."""
    refs, query, frag_len = __graft_entry__._tiny_workload()
    sk = pyfastani_tpu.Sketch(fragment_length=frag_len, backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    return mapper, _frags(query, mapper._param.min_read_length)


def draft_panel(repeat: bool = False):
    """Three genomes of three contigs each and a query mutated from genome
    1 (its contigs back to back, so fragments cross contig ends); with
    ``repeat`` a 1,500-base segment of genome 1's first contig is copied
    into its third, so fragments of it map twice to genome 1 at one
    identity."""
    rng = np.random.default_rng(23)
    genomes = [[rng.choice(_ACGT, n).tobytes() for n in (5_000, 3_200, 4_100)] for _ in range(3)]
    if repeat:
        c = genomes[1]
        c[2] = c[2][:1000] + c[0][1200:2700] + c[2][1000:]
    query = np.frombuffer(b"".join(genomes[1]), np.uint8).copy()
    mut = rng.random(query.shape[0]) < 0.02
    if repeat:
        mut[1200:2700] = False  # the repeat stays exact in the query
    query[mut] = rng.choice(_ACGT, int(mut.sum()))
    sk = pyfastani_tpu.Sketch(fragment_length=500, backend="numpy")
    for i, g in enumerate(genomes):
        sk.add_draft(f"g{i}", g)
    mapper = sk.index()
    return mapper, _frags(query.tobytes(), mapper._param.min_read_length)


def run_block(monkeypatch, mapper, frags, q_count: int = 1, **budgets):
    """The port's ``_query_block`` (CPU) and the JAX package's on the same
    block, its rows assigned to ``q_count`` query genomes in turn.

    Returns ``(sidx, b, calls, jax_out)``: the port's sharded index, the
    budgets, the recorded operands of the port's ``_l2_interval_scan``
    and ``cgi_bins`` calls, and the JAX ``(best_bin, ovf)``."""
    b = dict(BUDGETS, **budgets)
    params = mapper._param
    l, k = params.min_read_length, params.kmer_size
    sidx = tidx.build_sharded_index(mapper, 1)
    frag_qg = (np.arange(frags.shape[0]) % q_count).astype(np.int32)
    tab = np.asarray(stats.min_hits_relaxed_table(l, k, params.percentage_identity))
    gate = np.asarray(stats.l2_gate_table(l, k, params.percentage_identity))
    ident = np.asarray(stats.identity_table(b["smax"], k))
    m_values = tuple(sorted({int(max(int(v), 1)) for v in tab[: b["smax"] + 1]}))
    g_max = int(sidx.genome_lengths.shape[1])
    hb = sidx.hash_bucket[0]
    jax_out = jsh._query_block(
        jnp.asarray(frags), jnp.asarray(frag_qg),
        *(jnp.asarray(getattr(sidx, f)[0]) for f in (
            "uniq_hash", "row_start", "row_len", "post_gpos", "mini_hash", "mini_wpos",
            "mini_seqid", "mini_gpos", "mini_prev", "contig_offset", "seq_to_genome",
            "freq_threshold",
        )),
        jnp.asarray(np.stack([hb[:-1], hb[1:]], axis=-1)),
        jnp.asarray(tab), jnp.asarray(gate), jnp.asarray(ident),
        k=k, w=params.window_size, length=l, protein=False, l=l,
        hmax=b["hmax"], ivmax=b["ivmax"], cmax=b["cmax"], rmax=b["rmax"],
        t_chunks=b["t_chunks"], g_max=g_max, bin_max=b["bin_max"], smax=b["smax"],
        q_count=q_count, bucket_steps=sidx.bucket_steps, use_pallas=False,
        m_values=m_values,
    )

    calls = {}
    for name in ("_l2_interval_scan", "cgi_bins"):
        def record(*args, _name=name, _fn=getattr(S, name)):
            calls[_name] = args
            return _fn(*args)

        monkeypatch.setattr(S, name, record)
    idx = tidx.index_to_device(sidx, "cpu")
    S._query_block(
        torch.from_numpy(frags), torch.from_numpy(frag_qg), idx, int(sidx.freq_threshold[0]),
        torch.from_numpy(tab), torch.from_numpy(gate), torch.from_numpy(ident),
        k, params.window_size, l, False,
        b["hmax"], b["ivmax"], b["cmax"], b["rmax"], b["t_chunks"], g_max, b["bin_max"],
        b["smax"], q_count, sidx.bucket_steps, m_values, sidx.gpos_shift, sidx.gpos_steps,
    )
    monkeypatch.undo()
    return sidx, b, calls, jax_out


def _jax_scan(sidx, args):
    """The JAX package's contig lookup (``_query_block_impl``'s, in
    ``jnp``) and ``_l2_interval_scan`` (its XLA branch) on the port's
    recorded operands; ``rmax`` is the port's range capacity.  Returns the
    sweep's outputs and the contigs."""
    q_sorted, s_sizes, iv_g0, iv_g1, iv_valid, _, ivmax, _, _, cmw, cmax, rmax, ch_max = args

    def j(t, dtype):
        return jnp.asarray(t.numpy().astype(dtype))

    contig_offset = jnp.asarray(sidx.contig_offset[0])
    C1 = contig_offset.shape[0]
    g0f = j(iv_g0, np.int32).reshape(-1)
    g1f = j(iv_g1, np.int32).reshape(-1)
    iv_seq = jnp.clip(
        jnp.searchsorted(contig_offset, g1f, side="right").astype(jnp.int32) - 1, 0, C1 - 2
    )
    iv_base = contig_offset[iv_seq]
    iv_c0 = jnp.maximum(g0f, iv_base) - iv_base
    iv_c1 = g1f - iv_base
    frag_of_iv = jnp.repeat(jnp.arange(iv_g0.shape[0], dtype=jnp.int32), ivmax)

    planes = (jnp.asarray(getattr(sidx, f)[0]) for f in (
        "mini_hash", "mini_wpos", "mini_seqid", "mini_gpos", "mini_prev", "contig_offset"))
    out = jsh._l2_interval_scan(
        j(q_sorted, np.uint32), j(s_sizes, np.int32), frag_of_iv, iv_seq, iv_c0, iv_c1,
        jnp.asarray(iv_valid.numpy()), *planes, cmw, cmax, tidx._l2_kernel_rows(rmax) - 128,
        ch_max, use_pallas=False,
    )
    return out, iv_seq


@pytest.mark.parametrize("panel,budgets,overflows", [
    ("tiny", {}, False),
    ("draft", dict(cmax=128, t_chunks=16), False),
    ("draft", dict(cmax=32, t_chunks=1), True),
])
def test_l2_interval_scan_matches_jax(monkeypatch, panel, budgets, overflows):
    mapper, frags = tiny_panel() if panel == "tiny" else draft_panel()
    sidx, _, calls, _ = run_block(monkeypatch, mapper, frags, **budgets)
    args = calls["_l2_interval_scan"]
    cbest, cfirst, clast, ends, *flags, iv_seq = S._l2_interval_scan(*args)
    got = (*l2_sweep.l2_merge_reference(cbest, cfirst, clast, ends, args[4]), *flags[:2])
    want, want_seq = _jax_scan(sidx, args)
    names = ["best", "first", "last", "ovf_chunks", "ovf_r"]
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64), err_msg=name)
    np.testing.assert_array_equal(iv_seq.numpy(), np.asarray(want_seq).astype(np.int64))
    assert bool(flags[0]) == overflows and not bool(flags[1]) and not bool(flags[2])
    assert int((got[0] > 0).sum()) > 0
    assert cbest.dtype == torch.int32 and cbest.shape == (args[12],) and ends.shape == args[4].shape
    if panel == "draft":  # the lookup finds several contigs
        assert len(set(iv_seq[args[4]].tolist())) > 1


def test_plan_and_merge_route_through_their_wrappers(monkeypatch):
    """The sweep calls the plan once, and the block's merge runs in
    ``cgi_bins`` once, their plain versions on the CPU."""
    from pyfastani_tpu_torch.ops import cgi

    mapper, frags = tiny_panel()
    _, _, calls, _ = run_block(monkeypatch, mapper, frags)
    def counts(kind):
        return {"l2_plan": getattr(l2_sweep, f"l2_plan_{kind}"),
                "cgi_bins": getattr(cgi, f"cgi_bins_{kind}")}

    before, launched = counts("reference_calls"), counts("launches")
    scan = S._l2_interval_scan(*calls["_l2_interval_scan"])
    cgi.cgi_bins(*calls["cgi_bins"])
    assert counts("launches") == launched
    after = counts("reference_calls")
    assert {k: after[k] - before[k] for k in before} == {"l2_plan": 1, "cgi_bins": 1}
    # the block hands the sweep's chunk results and ends to cgi_bins unmerged
    for g, w in zip(scan[:4], calls["cgi_bins"][:4]):
        assert torch.equal(g, w)


def _old_composition(iv_g0, iv_g1, iv_valid, ivmax, contig_offset, cof_idx, mini_gpos,
                     gpos_bucket, gpos_shift, gpos_steps, cmw, cmax, rcap, ch_max):
    """The plan as the session ran it before the lookup moved into it: the
    contig lookup of ``_query_block`` on L1's intervals, then the plain
    plan of the looked-up intervals (frozen copies of both)."""
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
    F = iv_g0.shape[0]
    frag_of_iv = torch.arange(F * ivmax) // ivmax

    NI = iv_seq.shape[0]
    span = torch.where(iv_valid, iv_c1 - iv_c0 + 1, 0)
    n_ch = (span + cmax - 1) // cmax
    ends = torch.cumsum(n_ch, dim=0)
    total = ends[-1]
    starts = ends - n_ch
    j = torch.arange(ch_max)
    scat0 = torch.where(n_ch > 0, starts.clamp(max=ch_max), ch_max)
    iv_of = torch.zeros(ch_max + 1, dtype=i64).scatter_reduce_(
        0, scat0, torch.arange(NI), "amax"
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
    lo = l2_sweep.bucketed_gpos_search(mini_gpos, key_lo, gpos_bucket, gpos_shift, gpos_steps)
    hi = l2_sweep.bucketed_gpos_search(mini_gpos, key_hi, gpos_bucket, gpos_shift, gpos_steps)
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


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _draft_operands(monkeypatch, **budgets):
    """The plan's operands recorded from the draft panel's block: L1's
    intervals over a store of nine contigs."""
    mapper, frags = draft_panel()
    sidx, _, calls, _ = run_block(monkeypatch, mapper, frags, **budgets)
    q_sorted, s_sizes, iv_g0, iv_g1, iv_valid, idx, ivmax, shift, steps, cmw, cmax, rmax, ch_max = (
        calls["_l2_interval_scan"])
    return (iv_g0, iv_g1, iv_valid, ivmax, idx["contig_offset"], idx["cof_idx"], idx["mini_gpos"],
            idx["gpos_bucket"], shift, steps, cmw, cmax, tidx._l2_kernel_rows(rmax) - 128, ch_max)


@pytest.mark.parametrize("name", SWEEP_CASES + ("draft", "draft_overflow"))
def test_plain_plan_equals_the_lookup_then_the_old_plan(monkeypatch, name):
    """`l2_plan_reference` on L1's intervals is bitwise the session's old
    contig lookup followed by the old plain plan: ``chip_smoke``'s cases
    (windows before their contig, junk bounds of invalid intervals, 12,000
    contigs, totals at and past the slots) and the draft panel's block."""
    if name.startswith("draft"):
        budgets = dict(cmax=32, t_chunks=1) if name == "draft_overflow" else {}
        args = _draft_operands(monkeypatch, **budgets)
    else:
        args = torch_args(sweep_case(name), "cpu")
    want = _old_composition(*args)
    got = l2_sweep.l2_plan_reference(*args)
    _assert_bitwise(got, want)
    if name == "draft_overflow":
        assert bool(got[7])


def test_lookup_clamps_early_windows_and_junk_bounds():
    """A window that starts before its contig's base is clamped to offset
    0, and an invalid interval's junk bounds (negative, past the last
    contig) still get a contig in ``[0, C - 1]`` and no chunk."""
    coff = torch.tensor([0, 1000, 5000, 9000], dtype=torch.int32)
    g0 = torch.tensor([[995, -70, 12_000, 4_000]], dtype=torch.int32)
    g1 = torch.tensor([[1_500, -3, 20_000, 4_999]], dtype=torch.int32)
    valid = torch.tensor([True, False, False, True])
    frag, seq, c0, c1 = l2_sweep.contig_lookup(g0, g1, 4, coff)
    assert seq.tolist() == [1, 0, 2, 1]
    assert c0.tolist()[0] == 0 and c1.tolist()[0] == 500
    assert (c0.tolist()[3], c1.tolist()[3]) == (3000, 3999)
    assert frag.tolist() == [0, 0, 0, 0]
    gpos = torch.arange(0, 9000, 7, dtype=torch.int32)
    bucket, shift, steps = _build_gpos_bucket(gpos.numpy()[None, :])
    cof = torch.from_numpy(np.searchsorted(gpos.numpy(), coff.numpy()).astype(np.int32))
    args = (g0, g1, valid, 4, coff, cof, gpos, torch.from_numpy(bucket[0]), shift, steps,
            40, 512, 4096, 8)
    plan = l2_sweep.l2_plan_reference(*args)
    assert plan[5].tolist() == [1, 1, 1, 3]  # 501 offsets, then 1000 in two chunks
    assert plan[3][:3].tolist() == [0, 3000, 3512] and plan[4][:3].tolist() == [501, 512, 488]
    assert _plan_err(l2_sweep.l2_plan_tiled(*args), plan) == 0


@pytest.mark.parametrize("name", SWEEP_CASES)
def test_tiled_twin_matches_plain_plan_on_smoke_cases(name):
    """The kernels' design in plain torch (`l2_plan_tiled`) equals the
    plain plan under the kernels' contract, with 0 in all five chunk
    operands past the live slots."""
    args = torch_args(sweep_case(name), "cpu")
    want = l2_sweep.l2_plan_reference(*args)
    got = l2_sweep.l2_plan_tiled(*args)
    assert _plan_err(got, want) == 0
    live = min(int(want[5][-1]), want[0].shape[0])
    assert all(not bool(t[live:].any()) for t in got[:5])


def _clumped_positions(rng, n_contigs: int, contig_len: int):
    """A store whose positions crowd some stretches and skip others, so
    that interpolated windows miss on both sides."""
    from pyfastani_tpu_torch._common import GBIG

    offs = np.arange(n_contigs + 1, dtype=np.int64) * (contig_len + 3008)
    gpos = []
    for c in range(n_contigs):
        steps = np.where(rng.random(contig_len // 4) < 0.9, 1, rng.integers(50, 400, contig_len // 4))
        row = np.cumsum(steps)
        gpos.append(row[row < contig_len] + offs[c])
    gpos = np.concatenate(gpos + [np.full(16, GBIG)]).astype(np.int32)
    bucket, shift, depth = _build_gpos_bucket(gpos[None, :])
    return offs.astype(np.int32), np.searchsorted(gpos, offs).astype(np.int32), gpos, bucket[0], shift, depth


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    F=st.integers(1, 48), ivmax=st.integers(1, 24), n_contigs=st.sampled_from([1, 5, 10_000]),
    clumped=st.booleans(), cut=st.sampled_from([0, 0, 1, 3]),
    slots=st.sampled_from(["free", "minus1", "exact", "plus1", "straddle"]),
    frac=st.floats(0.0, 1.0), seed=st.integers(0, 2**16),
)
def test_tiled_twin_matches_plain_plan_on_drawn_shapes(F, ivmax, n_contigs, clumped, cut, slots,
                                                       frac, seed):
    """The twin against the plain plan on drawn shapes: NI on and off the
    512-interval tile, 1 to 10,000 contigs, even and clumped stores, a
    search depth cut below the buckets (the plain version's halvings stop
    early), and chunk slots one short of, equal to and one past the total,
    or ending inside an interval's chunks."""
    rng = np.random.default_rng(seed)
    contig_len = 2_000 if n_contigs > 5 else 40_000
    if clumped:
        coff, cof, gpos, bucket, shift, depth = _clumped_positions(rng, n_contigs, contig_len)
    else:
        coff, cof, gpos, bucket, shift, depth = _positions(rng, n_contigs, contig_len)
    NI = F * ivmax
    cmax, cmw = 256, 300
    valid = rng.random(NI) < frac
    seq = rng.integers(0, n_contigs, NI)
    c0 = rng.integers(0, contig_len, NI)
    c1 = np.minimum(c0 + rng.integers(1, 4 * cmax, NI) - 1, contig_len - 1)
    g0 = coff[seq].astype(np.int64) + c0 - rng.integers(0, 2, NI) * rng.integers(0, 500, NI)
    g1 = coff[seq].astype(np.int64) + c1
    junk = ~valid
    g0[junk] = rng.integers(-3000, int(coff[-1]) + 3000, int(junk.sum()))
    g1[junk] = rng.integers(-3000, int(coff[-1]) + 3000, int(junk.sum()))
    case = [g0.astype(np.int32).reshape(F, ivmax), g1.astype(np.int32).reshape(F, ivmax), valid,
            ivmax, coff, cof, gpos, bucket, shift, max(1, depth - cut), cmw, cmax, 64, 4 * NI + 1]
    args = list(torch_args(case, "cpu"))
    ends = l2_sweep.l2_plan_reference(*args)[5]
    total = int(ends[-1])
    n_ch = torch.diff(ends, prepend=ends.new_zeros(1))
    wide = torch.nonzero(n_ch >= 2).flatten()
    if slots == "straddle" and wide.numel():
        i = int(wide[len(wide) // 2])
        args[13] = int(ends[i] - n_ch[i]) + 1
    elif slots in ("minus1", "exact", "plus1"):
        args[13] = max(1, total + {"minus1": -1, "exact": 0, "plus1": 1}[slots])
    want = l2_sweep.l2_plan_reference(*args)
    got = l2_sweep.l2_plan_tiled(*args)
    assert _plan_err(got, want) == 0
    live = min(int(want[5][-1]), want[0].shape[0])
    assert all(not bool(t[live:].any()) for t in got[:5])
