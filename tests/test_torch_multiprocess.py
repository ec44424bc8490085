"""Real multi-process meshes of the port (the counterpart of
``tests/test_multiprocess.py``).

Subprocesses join a ``torch.distributed`` group on gloo, one CPU cell or
more each, restore the same `ShardedIndex` checkpoint and run the query.
A shard is folded only by the process of its home cell ``(0, sh)``: a
data row that another process runs sends it its slots (point to point),
and every pass gathers only the folded limbs and the flags' max to every
process.  The children import neither JAX nor ``pyfastani_tpu``.

* ``test_two_process_mesh_matches_host``: two processes on a ``(2, 2)``
  mesh, one data row each, give the host engine's hits.
* ``test_multiprocess_mesh_matches_jax``: four processes on a ``(1, 4)``
  mesh and two on a ``(2, 2)`` one, at budgets that escalate: each rank's
  hits, budgets and counters equal the JAX ``ShardedSession`` on the same
  mesh shape over the conftest's CPU devices; each shard is folded once a
  pass, by its home process on its home device; the slots that cross
  processes are only those of data rows away from their home (none on
  ``(1, 4)``), and the collectives carry the limbs and flags alone.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from pyfastani_tpu import Sketch
from pyfastani_tpu.parallel import sharded as jsh
from pyfastani_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pyfastani_tpu_torch.index import build_sharded_index

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import json, os, sys
rank = int(sys.argv[1]); port = sys.argv[2]; work = sys.argv[3]
world, n_data, n_shard, cells = (int(a) for a in sys.argv[4:8])
budgets = json.loads(sys.argv[8])
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}", world_size=world,
                        rank=rank)

from pyfastani_tpu_torch import session as S
from pyfastani_tpu_torch.parallel.mesh import make_mesh
from pyfastani_tpu_torch.parallel.sharded import ShardedIndex, ShardedSession

mesh = make_mesh(n_data, n_shard, devices=["cpu"] * cells)  # spanning every process
idx = ShardedIndex.load(os.path.join(work, "index.npz"))
queries = [open(os.path.join(work, f"query{{i}}.bin"), "rb").read()
           for i in range(int(open(os.path.join(work, "n_queries")).read()))]
sess = ShardedSession.from_index(idx, mesh=mesh, **budgets)

# each fold's shard (by its scratch) and devices, and each pass's traffic
folds, traffic = [], []
fold, run_pass = S._fold, sess._pass
def recording_fold(slot_bin, slot_ident, scratch, *rest):
    sh = [s for s, t in sess._scratch.items() if t is scratch]
    folds.append([len(traffic), sh, str(scratch.device), str(slot_bin.device)])
    return fold(slot_bin, slot_ident, scratch, *rest)
def recording_pass(*args, **kwargs):
    out = run_pass(*args, **kwargs)
    traffic.append(dict(sess.traffic))
    return out
S._fold, sess._pass = recording_fold, recording_pass

hits = sess.query_many([[q] for q in queries])
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "pyfastani_tpu")]
with open(os.path.join(work, f"out{{rank}}.json"), "w") as f:
    json.dump({{
        "hits": [[[h.name, h.identity, h.matches, h.fragments] for h in g] for g in hits],
        "budgets": sess.budgets, "stats": sess.stats, "ranks": mesh.ranks,
        "limbs": [sess.q_capacity, sess._g_max],
        "folds": folds, "traffic": traffic, "loaded": loaded,
    }}, f)
dist.destroy_process_group()
"""

_BUDGETS = dict(hmax=512, ivmax=16, cmax=128, rmax=384, t_chunks=52, bin_max=64, smax=256)
# small enough that every mesh escalates: a flag one cell raises must reach
# every process, or their attempts part and the next collective hangs
_TINY = dict(hmax=4, ivmax=16, cmax=128, rmax=384, t_chunks=4, bin_max=64, smax=128)
_COUNTERS = ("dispatches", "fragments_padded", "budget_escalations")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rand_genome(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n).tobytes()


def _mutate(rng, seq, rate):
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    idx = rng.random(arr.shape[0]) < rate
    arr[idx] = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=int(idx.sum()))
    return arr.tobytes()


def _run_children(tmp_path, mapper, queries, world, shape, cells, budgets):
    """Each rank's output (`_CHILD`) of a ``shape`` mesh of ``cells`` CPU
    cells a process over ``world`` gloo processes."""
    build_sharded_index(mapper, shape[1]).save(str(tmp_path / "index.npz"))
    for i, q in enumerate(queries):
        (tmp_path / f"query{i}.bin").write_bytes(q)
    (tmp_path / "n_queries").write_text(str(len(queries)))
    child = str(tmp_path / "child.py")
    with open(child, "w") as f:
        f.write(_CHILD.format(repo=_REPO))

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"  # the processes share the host's cores
    args = [str(port), str(tmp_path), str(world), *map(str, shape), str(cells),
            json.dumps(budgets)]
    procs = [
        subprocess.Popen([sys.executable, child, str(rank), *args], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in reversed(range(world))
    ]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    outs = []
    for rank in range(world):
        with open(tmp_path / f"out{rank}.json") as f:
            outs.append(json.load(f))
        assert outs[-1]["loaded"] == [], outs[-1]["loaded"]
    return outs


def test_two_process_mesh_matches_host(tmp_path):
    rng = np.random.default_rng(47)
    refs = [_rand_genome(rng, n) for n in (30_000, 24_000, 27_000, 21_000)]
    query = _mutate(rng, refs[1], 0.04)

    sk = Sketch(backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    expected = mapper.query_genome(query)
    assert expected, "workload must produce hits"

    outs = _run_children(tmp_path, mapper, [query], 2, (2, 2), 2, _BUDGETS)
    want = [[h.name, h.identity, h.matches, h.fragments] for h in expected]
    for out in outs:
        assert out["ranks"] == [[0, 0], [1, 1]]
        assert out["hits"] == [want]


@pytest.fixture(scope="module")
def panel():
    """Five references, two mutated queries and the host engine's hits."""
    rng = np.random.default_rng(53)
    refs = [_rand_genome(rng, n) for n in (26_000, 21_000, 24_000, 18_000, 22_000)]
    queries = [_mutate(rng, refs[1], 0.04), _mutate(rng, refs[3], 0.03)]
    sk = Sketch(backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    host = [mapper.query_genome(q) for q in queries]
    assert all(host)
    return mapper, queries, host


@pytest.mark.parametrize("world, shape", [(4, (1, 4)), (2, (2, 2))], ids=["1x4_4procs", "2x2_2procs"])
def test_multiprocess_mesh_matches_jax(tmp_path, panel, world, shape):
    mapper, queries, host = panel
    want_session = jsh.ShardedSession(mapper, jax_make_mesh(*shape), **_TINY)
    want = want_session.query_many([[q] for q in queries])
    key = [[[h.name, h.identity, h.matches, h.fragments] for h in g] for g in want]
    assert key == [[[h.name, h.identity, h.matches, h.fragments] for h in g] for g in host]

    cells = shape[0] * shape[1] // world
    outs = _run_children(tmp_path, mapper, queries, world, shape, cells, _TINY)
    n_pass = want_session.stats["dispatches"]
    assert want_session.stats["budget_escalations"] >= 1 and n_pass >= 2
    ranks = outs[0]["ranks"]
    homes = ranks[0]  # shard sh's home process
    # the all_gather takes from every rank the limbs of as many shards as
    # the rank of most homes, (3, q_capacity, g_max) int64 each; the flags'
    # all_reduce six int32
    q, g = outs[0]["limbs"]
    collectives = world * max(homes.count(r) for r in range(world)) * 3 * q * g * 8 + 6 * 4
    for rank, out in enumerate(outs):
        assert out["ranks"] == ranks
        assert out["hits"] == key
        assert out["budgets"] == want_session.budgets
        assert {k: out["stats"][k] for k in _COUNTERS} == {
            k: want_session.stats[k] for k in _COUNTERS
        }
        # each pass folds every shard this rank is home of once, on the CPU
        mine = [sh for sh in range(shape[1]) if homes[sh] == rank]
        assert [f[0] for f in out["folds"]] == [p for p in range(n_pass) for _ in mine]
        assert [f[1] for f in out["folds"]] == [[sh] for _ in range(n_pass) for sh in mine]
        assert all(f[2] == f[3] == "cpu" for f in out["folds"])
        # slots cross processes only from a data row away from its home
        away = sum(1 for d in range(1, shape[0]) for sh in range(shape[1])
                   if ranks[d][sh] != homes[sh] and rank in (ranks[d][sh], homes[sh]))
        assert len(out["traffic"]) == n_pass
        for t in out["traffic"]:
            assert t["slots_across_processes"] == away * t["cell_slots"]
            assert t["slots_across_cards"] == t["limbs_across_cards"] == 0
            assert t["collectives"] == collectives
        if shape == (1, 4):
            assert all(t["slots_across_processes"] == 0 for t in out["traffic"])
    # together the ranks fold every shard once a pass
    folded = sorted(f[1][0] for out in outs for f in out["folds"])
    assert folded == sorted(list(range(shape[1])) * n_pass)
