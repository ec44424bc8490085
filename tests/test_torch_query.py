"""Port parity: the query block, the host index layer, the session and the
facade.

Inputs are made with numpy from a seed and handed to the JAX package and
to ``pyfastani_tpu_torch`` on the CPU.  Every device output is an integer
or an exact fixed-point sum, so every comparison is exact.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
import pyfastani_tpu
import pyfastani_tpu_torch
from pyfastani_tpu import stats
from pyfastani_tpu.parallel import sharded as jsh
from pyfastani_tpu_torch import index as tidx
from pyfastani_tpu_torch._common import resolve_device
from chip_smoke import densify
from pyfastani_tpu_torch.session import Session, _fold, _query_block

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ACGT = np.frombuffer(b"ACGT", np.uint8)
# the static budgets of __graft_entry__.entry()
_BUDGETS = dict(hmax=1024, ivmax=32, cmax=128, rmax=512, t_chunks=16, bin_max=256, smax=512)


def _jax_fold(best_bin, s2g, q_count, bin_max, g_max):
    """The identity fold of ``ShardedSession``'s ``block_fn`` on one shard."""
    C = s2g.shape[0]
    bb3 = best_bin.reshape(q_count, C, bin_max)
    occ = bb3 > 0.0
    q17 = jnp.round(bb3 * jnp.float32(131072.0)).astype(jnp.int32)
    q17 = jnp.where(occ, q17, 0)
    key = (jnp.arange(q_count, dtype=jnp.int32)[:, None] * g_max + s2g).reshape(-1)

    def fold(x_qc):
        return jax.ops.segment_sum(
            x_qc.reshape(-1), key, num_segments=q_count * g_max
        ).reshape(q_count, g_max)

    return (
        fold(occ.sum(axis=2).astype(jnp.int32)),
        fold((q17 >> 12).sum(axis=2).astype(jnp.int32)),
        fold((q17 & 0xFFF).sum(axis=2).astype(jnp.int32)),
    )


@pytest.fixture(scope="module")
def tiny():
    refs, query, frag_len = __graft_entry__._tiny_workload()
    sk = pyfastani_tpu.Sketch(fragment_length=frag_len, backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    l = mapper._param.min_read_length
    q = np.frombuffer(query, np.uint8)
    n_frag = q.shape[0] // l
    frags = np.zeros((n_frag, l + 4), np.uint8)
    frags[:, :l] = q[: n_frag * l].reshape(n_frag, l)
    return mapper, frags


@pytest.mark.parametrize("q_count", [1, 2])
def test_query_block_and_fold_match_jax(tiny, q_count):
    mapper, frags = tiny
    params = mapper._param
    l, k = params.min_read_length, params.kmer_size
    sidx = tidx.build_sharded_index(mapper, 1)
    b = _BUDGETS
    frag_qg = (np.arange(frags.shape[0]) % q_count).astype(np.int32)
    tab = np.asarray(stats.min_hits_relaxed_table(l, k, params.percentage_identity))
    gate = np.asarray(stats.l2_gate_table(l, k, params.percentage_identity))
    ident = np.asarray(stats.identity_table(b["smax"], k))
    m_values = tuple(sorted({int(max(int(v), 1)) for v in tab[: b["smax"] + 1]}))
    g_max = int(sidx.genome_lengths.shape[1])
    hb = sidx.hash_bucket[0]

    best_bin, ovf = jsh._query_block(
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
    want = _jax_fold(best_bin, jnp.asarray(sidx.seq_to_genome[0]), q_count, b["bin_max"], g_max)

    idx = tidx.index_to_device(sidx, "cpu")
    (slot_bin, slot_ident), t_ovf = _query_block(
        torch.from_numpy(frags), torch.from_numpy(frag_qg), idx, int(sidx.freq_threshold[0]),
        torch.from_numpy(tab), torch.from_numpy(gate), torch.from_numpy(ident),
        k, params.window_size, l, False,
        b["hmax"], b["ivmax"], b["cmax"], b["rmax"], b["t_chunks"], g_max, b["bin_max"],
        b["smax"], q_count, sidx.bucket_steps, m_values, sidx.gpos_shift, sidx.gpos_steps,
    )
    # the slots' max into -inf bins is JAX's dense best_bin
    t_bin = densify((slot_bin, slot_ident), best_bin.shape[0])
    scratch = torch.full_like(t_bin, -np.inf)
    got = _fold(slot_bin, slot_ident, scratch, idx["seq_to_genome"], q_count, b["bin_max"], g_max,
                torch.empty((3, q_count, g_max), dtype=torch.int64))
    for name, g, w in zip(["counts", "isum_hi", "isum_lo"], got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # the port's flags are JAX's five budget overflows, then the L2 range flag
    np.testing.assert_array_equal(t_ovf[:5].numpy(), np.asarray(ovf))
    np.testing.assert_array_equal(t_bin.numpy(), np.asarray(best_bin))
    assert got[0].numpy()[0, 0] > 0 and not t_ovf.any()
    assert bool(torch.isneginf(scratch).all())


def _genomes(seed=0, n=3, length=40_000, rate=0.02):
    rng = np.random.default_rng(seed)
    refs = [rng.choice(_ACGT, size=length).tobytes() for _ in range(n)]
    query = np.frombuffer(refs[1], np.uint8).copy()
    mut = rng.random(query.shape[0]) < rate
    query[mut] = rng.choice(_ACGT, size=int(mut.sum()))
    unrelated = rng.choice(_ACGT, size=length).tobytes()
    return refs, query.tobytes(), unrelated


def _sketch(cls, refs, **kw):
    sk = cls(**kw)
    for i, r in enumerate(refs):
        sk.add_genome(f"ref{i}", r)
    return sk.index()


def _key(hits):
    return [(h.name, h.identity, h.matches, h.fragments) for h in hits]


@pytest.fixture(scope="module")
def genomes():
    return _genomes()


def test_build_sharded_index_matches_jax(genomes):
    refs, _, _ = genomes
    mapper = _sketch(pyfastani_tpu.Sketch, refs, backend="numpy")
    want = jsh.build_sharded_index(mapper, 1)
    got = tidx.build_sharded_index(mapper, 1)
    for f in want.__dataclass_fields__:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    budgets = dict.fromkeys(["hmax", "ivmax", "cmax", "rmax", "t_chunks", "bin_max", "smax"])
    assert tidx._presize_budgets(got, mapper._param, budgets) == jsh._presize_budgets(
        want, mapper._param, budgets
    )
    for x, y in zip(tidx._build_gpos_bucket(got.mini_gpos), jsh._build_gpos_bucket(want.mini_gpos)):
        np.testing.assert_array_equal(x, y)
    for n in (0, 1, 896, 897, 8064):
        assert tidx._l2_kernel_rows(n) == jsh._l2_kernel_rows(n)
        assert tidx._round_up(n, 256) == jsh._round_up(n, 256)
    with pytest.raises(TypeError, match="4-byte"):
        tidx._native.take_4byte(np.zeros(4, np.int64), np.zeros(2, np.int32))


def test_npz_from_jax_package_loads_in_port(genomes, tmp_path):
    refs, query, _ = genomes
    mapper = _sketch(pyfastani_tpu.Sketch, refs, backend="numpy")
    path = str(tmp_path / "index.npz")
    jsh.build_sharded_index(mapper, 1).save(path)
    restored = tidx.ShardedIndex.load(path)
    restored.gpos_bucket = None  # an older checkpoint: rebuilt on load
    session = Session.from_index(restored, device="cpu")
    hits = session.query([query])
    assert hits and _key(hits) == _key(mapper.query_genome(query))
    with pytest.raises(ValueError, match="mismatch"):
        other = type(mapper._param)()  # defaults, not the float32-rounded fields
        Session.from_index(tidx.ShardedIndex.load(path), params=other, device="cpu")


def test_facade_matches_host_engine(genomes):
    refs, query, unrelated = genomes
    port = _sketch(pyfastani_tpu_torch.Sketch, refs, device="cpu")
    host = _sketch(pyfastani_tpu.Sketch, refs, backend="numpy")
    hits = port.query_genome(query)
    assert isinstance(port, pyfastani_tpu_torch.Mapper)
    assert hits and hits[0].name == "ref1"
    assert _key(hits) == _key(host.query_genome(query))
    draft = [query[:15_000], query[15_000:]]
    assert _key(port.query_draft(draft)) == _key(host.query_draft(draft))
    assert port.query_genome(unrelated) == []
    # one session serves a batch; results equal the per-genome facade
    many = Session(port, device="cpu").query_many([[query], [unrelated], draft])
    assert [_key(h) for h in many] == [_key(hits), [], _key(port.query_draft(draft))]


def test_mapper_pickle_round_trip(genomes):
    refs, query, _ = genomes
    mapper = _sketch(pyfastani_tpu_torch.Sketch, refs, device="cpu")
    hits = mapper.query_genome(query)
    clone = pickle.loads(pickle.dumps(mapper))
    assert type(clone) is pyfastani_tpu_torch.Mapper
    assert clone.names == mapper.names
    assert _key(clone.query_genome(query)) == _key(hits)


def test_default_device_is_cuda_and_raises_without_gpu(genomes):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    refs, query, _ = genomes
    mapper = _sketch(pyfastani_tpu_torch.Sketch, refs[:1])
    with pytest.raises(RuntimeError, match="cuda"):
        mapper.query_genome(query)
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_never_imports_jax():
    script = textwrap.dedent(
        f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import pyfastani_tpu_torch as pt
        rng = np.random.default_rng(0)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        ref = rng.choice(acgt, size=20_000).tobytes()
        import pickle
        sk = pt.Sketch(device="cpu")
        sk.add_genome("ref", ref)
        # unpickling names the backend instead of probing for JAX
        sk = pickle.loads(pickle.dumps(sk))
        mapper = pickle.loads(pickle.dumps(sk.index()))
        hits = mapper.query_genome(ref)
        assert hits and hits[0].matches == hits[0].fragments, hits
        # the mesh, the sharded session, the ingest winnow and profiling
        from pyfastani_tpu_torch.models._engine_torch import winnow_sequence_device
        from pyfastani_tpu_torch.parallel.mesh import make_mesh
        from pyfastani_tpu_torch.parallel.sharded import ShardedSession, sharded_query
        from pyfastani_tpu_torch.utils.profiling import timed, trace
        mesh = make_mesh(2, 2, devices=["cpu"] * 4)
        assert ShardedSession(mapper, mesh).query([ref]) == hits
        assert sharded_query(mapper, [ref], mesh) == hits
        h, p = winnow_sequence_device(np.frombuffer(ref, np.uint8), mapper._param, device="cpu")
        assert h.size == p.size > 0
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, env=env, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_protein_golden_through_the_port():
    """The MIBiG protein golden of ``tests/test_ani.py`` (130 of 176
    fragments against two identical references), through the port."""
    from pyfastani_tpu._fasta import Parser

    data = os.path.join(ROOT, "tests", "data")
    bgc1 = [r.seq for r in Parser(os.path.join(data, "BGC0001425.faa"))]
    bgc3 = [r.seq for r in Parser(os.path.join(data, "BGC0001428.faa"))]
    hits = {}
    engines = ((pyfastani_tpu_torch, dict(device="cpu")), (pyfastani_tpu, dict(backend="numpy")))
    for pkg, kw in engines:
        sk = pkg.Sketch(protein=True, fragment_length=100, **kw)
        sk.add_draft("BGC0001425", bgc1)
        sk.add_draft("BGC0001427", bgc1)
        hits[pkg] = sk.index().query_draft(bgc3)
    got = hits[pyfastani_tpu_torch]
    assert [(h.name, h.matches, h.fragments) for h in got] == [
        ("BGC0001425", 130, 176), ("BGC0001427", 130, 176)
    ]
    assert _key(got) == _key(hits[pyfastani_tpu])
