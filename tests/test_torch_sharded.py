"""Port parity: the mesh and ``ShardedSession`` against the JAX package.

The JAX ``ShardedSession`` runs in the same process on the 8 virtual CPU
devices of ``tests/conftest.py``; the port's runs on meshes of the same
shapes laid over ``["cpu"] * 8``.  Budgets are pinned as in
``tests/test_sharded.py``.  Hits, budgets and the session counters must
be equal, and hits must equal the host NumPy engine (identity ``==``).
"""

import concurrent.futures
import re
import warnings

import numpy as np
import pytest
import torch

import pyfastani_tpu
import pyfastani_tpu_torch
from pyfastani_tpu.parallel import sharded as jsh
from pyfastani_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pyfastani_tpu_torch import index as tidx
from pyfastani_tpu_torch.parallel.mesh import make_mesh
from pyfastani_tpu_torch.parallel.sharded import (
    ShardedIndex,
    ShardedSession,
    build_sharded_index,
    sharded_query,
)

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_BUDGETS = dict(hmax=512, ivmax=16, cmax=128, rmax=384, t_chunks=52, bin_max=64, smax=256)
_COUNTERS = ("dispatches", "fragments_padded", "budget_escalations")


def _rand_genome(rng, n):
    return rng.choice(_ACGT, size=n).tobytes()


def _mutate(rng, seq, rate):
    arr = np.frombuffer(seq, np.uint8).copy()
    idx = rng.random(arr.shape[0]) < rate
    arr[idx] = rng.choice(_ACGT, size=int(idx.sum()))
    return arr.tobytes()


def _key(hits):
    return [(h.name, h.identity, h.matches, h.fragments) for h in hits]


def _cpu_mesh(n_data, n_shard):
    return make_mesh(n_data, n_shard, devices=["cpu"] * (n_data * n_shard))


@pytest.fixture(scope="module")
def panel():
    """Five references, two mutated queries and the host engine's hits."""
    rng = np.random.default_rng(17)
    refs = [_rand_genome(rng, n) for n in (40_000, 25_000, 31_000, 18_000, 22_000)]
    queries = [_mutate(rng, refs[1], 0.04), _mutate(rng, refs[3], 0.03)]
    sk = pyfastani_tpu.Sketch(backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    host = [mapper.query_genome(q) for q in queries]
    assert all(host)
    return mapper, queries, host


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1)])
def test_sharded_session_matches_jax(panel, shape):
    mapper, queries, host = panel
    batch = [[q] for q in queries]
    want_session = jsh.ShardedSession(mapper, jax_make_mesh(*shape), **_BUDGETS)
    want = want_session.query_many(batch)
    session = ShardedSession(mapper, _cpu_mesh(*shape), **_BUDGETS)
    got = session.query_many(batch)
    assert [_key(h) for h in got] == [_key(h) for h in want] == [_key(h) for h in host]
    assert session.budgets == want_session.budgets
    assert {k: session.stats[k] for k in _COUNTERS} == {
        k: want_session.stats[k] for k in _COUNTERS
    }


def test_sharded_query_one_shot(panel):
    mapper, queries, host = panel
    assert _key(sharded_query(mapper, [queries[0]], _cpu_mesh(2, 2), **_BUDGETS)) == _key(host[0])


def test_mesh_layout_and_refusals():
    mesh = make_mesh(2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "shard": 4} and not mesh.distributed
    assert len(mesh.local_cells()) == 8
    assert mesh.local_cells()[5] == (1, 1, torch.device("cpu"))
    assert make_mesh(2, 3, devices=["cpu"] * 8).shape == {"data": 2, "shard": 3}
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh(4, 2, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()


def test_jax_checkpoint_restores_through_port(panel, tmp_path):
    """A 4-shard index saved by the JAX package restores through the
    port's ``from_index``; the port's own 4-shard build is the same
    index; a shard count unlike the mesh's raises."""
    mapper, queries, host = panel
    path = str(tmp_path / "index.npz")
    want = jsh.build_sharded_index(mapper, 4)
    want.save(path)
    built = build_sharded_index(mapper, 4)
    for f in want.__dataclass_fields__:
        a, b = getattr(built, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f
    restored = ShardedIndex.load(path)
    assert restored.n_shards == 4 and restored.genome_names == want.genome_names
    session = ShardedSession.from_index(restored, mapper._param, _cpu_mesh(2, 4), **_BUDGETS)
    assert [_key(h) for h in session.query_many([[q] for q in queries])] == [
        _key(h) for h in host
    ]
    with pytest.raises(ValueError, match="restored index has 4 shards, mesh has 2"):
        ShardedSession.from_index(tidx.ShardedIndex.load(path), mesh=_cpu_mesh(2, 2), **_BUDGETS)


def _escalations(run):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        hits = run()
    steps = [
        re.search(r"escalating (.*?)(?: \(recompile\))?$", str(w.message)).group(1)
        for w in caught
        if "escalating" in str(w.message)
    ]
    return hits, steps


def _folds(session, batch):
    """``query_many(batch)``'s hits and the counts and identity sums of its
    groups, as ``_run_groups`` returns them (the JAX session has the same
    method)."""
    seen = []
    run = session._run_groups

    def record(per_genome, groups):
        out = run(per_genome, groups)
        seen.extend(out)
        return out

    session._run_groups = record
    try:
        hits = session.query_many(batch)
    finally:
        del session._run_groups
    return hits, seen


def _same_folds(got, want):
    assert len(got) == len(want)
    for (g_group, g_counts, g_sum), (w_group, w_counts, w_sum) in zip(got, want):
        assert list(g_group) == list(w_group)
        np.testing.assert_array_equal(g_counts, np.asarray(w_counts))
        np.testing.assert_array_equal(g_sum, np.asarray(w_sum))


_TINY = dict(hmax=4, ivmax=16, cmax=128, rmax=384, t_chunks=4, bin_max=64, smax=128)


@pytest.fixture(scope="module")
def escalated(panel):
    """The JAX session on a (2, 2) mesh at budgets that blow: the session,
    its hits, its escalation steps and its groups' counts and sums."""
    mapper, queries, _ = panel
    session = jsh.ShardedSession(mapper, jax_make_mesh(2, 2), **_TINY)
    (hits, folds), steps = _escalations(lambda: _folds(session, [[q] for q in queries]))
    return session, hits, steps, folds


def test_escalation_follows_jax_budget_sequence(panel, escalated):
    """Tiny budgets blow on a (2, 2) mesh, where each cell sees half the
    fragment block: every attempt doubles the same budgets as JAX."""
    mapper, queries, host = panel
    want_session, want, want_steps, _ = escalated
    batch = [[q] for q in queries]
    session = ShardedSession(mapper, _cpu_mesh(2, 2), **_TINY)
    got, steps = _escalations(lambda: session.query_many(batch))
    assert steps == want_steps and len(steps) >= 2
    assert [_key(h) for h in got] == [_key(h) for h in want] == [_key(h) for h in host]
    assert session.budgets == want_session.budgets
    assert {k: session.stats[k] for k in _COUNTERS} == {
        k: want_session.stats[k] for k in _COUNTERS
    }


@pytest.mark.parametrize("where", ["after_cgi", "inside_fold"])
def test_scratch_stays_neg_inf_across_passes(panel, escalated, monkeypatch, where):
    """On a (2, 2) mesh (two data rows a shard): a batch whose budgets
    escalate, the same batch again, a pass of its second query alone (in
    the first query's slot) that raises after CGI (``after_cgi``: before
    the fold runs; ``inside_fold``: after the last shard's max went into
    its scratch, before its visit), then the batch once more, which
    touches none of the stale bins.  Every finished pass leaves each
    shard's scratch all ``-inf`` and gives the JAX session's counts and
    identity sums; the raised one leaves it marked dirty, and the next pass
    fills it again."""
    mapper, queries, host = panel
    from pyfastani_tpu_torch import session as S

    batch = [[q] for q in queries]
    _, want_hits, _, want = escalated
    session = ShardedSession(mapper, _cpu_mesh(2, 2), **_TINY)

    def all_neg_inf():
        # one scratch a shard, on the device of its home cell (0, sh)
        assert sorted(session._scratch) == list(range(session.n_shard))
        for sh, scratch in session._scratch.items():
            assert scratch.device == session.mesh.devices[0][sh]
        return all(bool(torch.isneginf(s).all()) for s in session._scratch.values())

    def clean():
        assert not session._scratch_dirty and all_neg_inf()

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for _ in range(2):
            hits, got = _folds(session, batch)
            assert [_key(h) for h in hits] == [_key(h) for h in want_hits]
            _same_folds(got, want)
            clean()
    assert session.stats["budget_escalations"] >= 1

    fold = S._fold
    calls = []

    def stopped(slot_bin, slot_ident, scratch, *rest):
        # inside_fold: the first shard folds, the last one stops after its max
        calls.append(scratch)
        if where == "inside_fold":
            if len(calls) < session.n_shard:
                return fold(slot_bin, slot_ident, scratch, *rest)
            kept = slot_bin >= 0
            assert bool(kept.any())
            scratch.scatter_reduce_(0, slot_bin[kept], slot_ident[kept], "amax")
        raise RuntimeError("stopped")

    monkeypatch.setattr(S, "_fold", stopped)
    with pytest.raises(RuntimeError, match="stopped"):
        session.query_many(batch[1:])
    assert session._scratch_dirty
    assert all_neg_inf() == (where == "after_cgi")
    monkeypatch.setattr(S, "_fold", fold)
    hits, got = _folds(session, batch)
    _same_folds(got, want)
    assert [_key(h) for h in hits] == [_key(h) for h in want_hits] == [_key(h) for h in host]
    clean()


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_each_shard_folds_once_a_pass_at_home(panel, monkeypatch, shape):
    """Every pass folds each shard once (one `fold_bins` call), on the
    device of its home cell ``(0, sh)``, and only there; the slots of a
    mesh on one device move nowhere, and one process gathers nothing."""
    mapper, queries, host = panel
    from pyfastani_tpu_torch import session as S
    from pyfastani_tpu_torch.ops import cgi

    session = ShardedSession(mapper, _cpu_mesh(*shape), q_capacity=1, frag_capacity=256,
                             **_BUDGETS)
    assert session._homes == list(range(shape[1]))
    folds, passes = [], []
    fold, run_pass = S._fold, session._pass

    def recording_fold(slot_bin, slot_ident, scratch, *rest):
        [sh] = [s for s, t in session._scratch.items() if t is scratch]
        folds.append((len(passes), sh, scratch.device, slot_bin.device))
        return fold(slot_bin, slot_ident, scratch, *rest)

    def recording_pass(*args, **kwargs):
        out = run_pass(*args, **kwargs)
        passes.append(dict(session.traffic))
        return out

    monkeypatch.setattr(S, "_fold", recording_fold)
    monkeypatch.setattr(session, "_pass", recording_pass)
    calls = cgi.fold_bins_reference_calls
    hits = session.query_many([[q] for q in queries])
    assert [_key(h) for h in hits] == [_key(h) for h in host]
    assert len(passes) == session.stats["dispatches"] == len(queries)
    assert cgi.fold_bins_reference_calls - calls == len(folds) == len(passes) * shape[1]
    assert [(p, sh) for p, sh, _, _ in folds] == [
        (p, sh) for p in range(len(passes)) for sh in range(shape[1])
    ]
    mesh = session.mesh
    assert all(a == b == mesh.devices[0][sh] for _, sh, a, b in folds)
    for t in passes:
        assert t["cell_slots"] > 0
        assert {k: v for k, v in t.items() if k != "cell_slots"} == dict.fromkeys(
            ("slots_across_cards", "slots_across_processes", "limbs_across_cards",
             "collectives"), 0)


def test_multi_group_batch_equals_one_group_per_query():
    """q_capacity=2 and 6 queries: three groups through the two recycled
    staging slots, equal to one pass per query and to the host engine."""
    rng = np.random.default_rng(23)
    refs = [_rand_genome(rng, n) for n in (30_000, 24_000, 27_000)]
    queries = [_mutate(rng, refs[i % 3], 0.02 + 0.01 * (i % 3)) for i in range(5)]
    queries.append(_rand_genome(rng, 20_000))  # unrelated: no hits
    sk = pyfastani_tpu.Sketch(backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    session = ShardedSession(
        mapper, _cpu_mesh(2, 2), q_capacity=2, frag_capacity=256, **_BUDGETS
    )
    batched = session.query_many([[q] for q in queries])
    assert session.stats["dispatches"] == 3
    assert len(session._slots) == 2
    for q, hits in zip(queries, batched):
        assert _key(hits) == _key(session.query([q])) == _key(mapper.query_genome(q))
    assert batched[-1] == [] and all(batched[:-1])


def test_concurrent_queries_match_serial():
    """Concurrent ``query_genome`` calls on one port Mapper serialize on
    the cached session's lock and equal serial calls."""
    rng = np.random.default_rng(29)
    refs = [_rand_genome(rng, n) for n in (40_000, 30_000, 25_000)]
    queries = [_mutate(rng, refs[i % 3], 0.03) for i in range(6)]
    sk = pyfastani_tpu_torch.Sketch(device="cpu")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    serial = [mapper.query_genome(q) for q in queries]
    assert all(serial)
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        threaded = list(pool.map(mapper.query_genome, queries))
    assert threaded == serial


def test_lookup_index_edit_invalidates_session():
    rng = np.random.default_rng(31)
    ref = _rand_genome(rng, 50_000)
    query = _mutate(rng, ref, 0.02)
    sk = pyfastani_tpu_torch.Sketch(device="cpu")
    sk.add_genome("g0", ref)
    mapper = sk.index()
    assert mapper.query_genome(query)
    idx = mapper.lookup_index
    for h in list(idx):
        del idx[h]
    assert len(mapper.lookup_index) == 0
    assert mapper.query_genome(query) == []


def test_warmup_accepts_q_counts(panel):
    mapper, queries, host = panel
    session = ShardedSession(mapper, _cpu_mesh(1, 2), **_BUDGETS)
    rep = session.warmup([10], q_counts=[1])
    assert list(rep) == [256] and rep[256] >= 0
    assert session.stats["dispatches"] == 0  # as in JAX, warmup is no dispatch
    assert _key(session.query([queries[0]])) == _key(host[0])
