"""Port parity: the L2 sweep around its chunk evaluator (`ops.l2_sweep`).

A fragment block goes through the port's ``_query_block`` on the CPU,
whose call of ``_l2_interval_scan`` is recorded; the recorded operands (the
L1 stage's intervals after the contig lookup) then go through the port's
``_l2_interval_scan`` -- the chunk plan (`l2_plan`, the plain version on
the CPU), `l2_chunks` and the merge (`l2_merge`) -- and through the JAX
package's ``_l2_interval_scan`` with ``use_pallas=False``, whose outputs
its own tests pin as bit-identical to its Pallas branch.  Best, first,
last and both budget flags must be equal, with tolerance 0, on the tiny
panel of ``tests/test_torch_query.py`` and on a panel of multi-contig
genomes, also at a chunk budget that overflows.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
import pyfastani_tpu
from pyfastani_tpu import stats
from pyfastani_tpu.parallel import sharded as jsh
from pyfastani_tpu_torch import index as tidx
from pyfastani_tpu_torch import session as S

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
    """The JAX package's ``_l2_interval_scan`` (its XLA branch) on the
    port's recorded operands; ``rmax`` is the port's range capacity."""
    q_sorted, s_sizes, frag_of_iv, iv_seq, iv_c0, iv_c1, iv_valid, _, _, _, cmw, cmax, rmax, ch_max = args

    def j(t, dtype):
        return jnp.asarray(t.numpy().astype(dtype))

    planes = (jnp.asarray(getattr(sidx, f)[0]) for f in (
        "mini_hash", "mini_wpos", "mini_seqid", "mini_gpos", "mini_prev", "contig_offset"))
    return jsh._l2_interval_scan(
        j(q_sorted, np.uint32), j(s_sizes, np.int32), j(frag_of_iv, np.int32),
        j(iv_seq, np.int32), j(iv_c0, np.int32), j(iv_c1, np.int32), jnp.asarray(iv_valid.numpy()),
        *planes, cmw, cmax, tidx._l2_kernel_rows(rmax) - 128, ch_max, use_pallas=False,
    )


@pytest.mark.parametrize("panel,budgets,overflows", [
    ("tiny", {}, False),
    ("draft", dict(cmax=128, t_chunks=16), False),
    ("draft", dict(cmax=32, t_chunks=1), True),
])
def test_l2_interval_scan_matches_jax(monkeypatch, panel, budgets, overflows):
    mapper, frags = tiny_panel() if panel == "tiny" else draft_panel()
    sidx, _, calls, _ = run_block(monkeypatch, mapper, frags, **budgets)
    args = calls["_l2_interval_scan"]
    got = S._l2_interval_scan(*args)
    want = _jax_scan(sidx, args)
    names = ["best", "first", "last", "ovf_chunks", "ovf_r"]
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64), err_msg=name)
    assert bool(got[3]) == overflows and not bool(got[4]) and not bool(got[5])
    assert int((got[0] > 0).sum()) > 0


def test_plan_and_merge_route_through_their_wrappers(monkeypatch):
    """The sweep calls the plan and the merge once each, their plain
    versions on the CPU."""
    from pyfastani_tpu_torch.ops import l2_sweep

    mapper, frags = tiny_panel()
    _, _, calls, _ = run_block(monkeypatch, mapper, frags)
    def counts(kind):
        return {k: getattr(l2_sweep, f"{k}_{kind}") for k in ("l2_plan", "l2_merge")}

    before, launched = counts("reference_calls"), counts("launches")
    S._l2_interval_scan(*calls["_l2_interval_scan"])
    assert counts("launches") == launched
    after = counts("reference_calls")
    assert {k: after[k] - before[k] for k in before} == {"l2_plan": 1, "l2_merge": 1}
