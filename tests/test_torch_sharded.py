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


def test_escalation_follows_jax_budget_sequence(panel):
    """Tiny budgets blow on a (2, 2) mesh, where each cell sees half the
    fragment block: every attempt doubles the same budgets as JAX."""
    mapper, queries, host = panel
    tiny = dict(hmax=4, ivmax=16, cmax=128, rmax=384, t_chunks=4, bin_max=64, smax=128)
    batch = [[q] for q in queries]
    want_session = jsh.ShardedSession(mapper, jax_make_mesh(2, 2), **tiny)
    want, want_steps = _escalations(lambda: want_session.query_many(batch))
    session = ShardedSession(mapper, _cpu_mesh(2, 2), **tiny)
    got, steps = _escalations(lambda: session.query_many(batch))
    assert steps == want_steps and len(steps) >= 2
    assert [_key(h) for h in got] == [_key(h) for h in want] == [_key(h) for h in host]
    assert session.budgets == want_session.budgets
    assert {k: session.stats[k] for k in _COUNTERS} == {
        k: want_session.stats[k] for k in _COUNTERS
    }


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
