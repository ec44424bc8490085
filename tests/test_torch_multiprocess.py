"""A real two-process mesh of the port (the counterpart of
``tests/test_multiprocess.py``).

Two subprocesses join a ``torch.distributed`` group on gloo and lay a
``(2, 2)`` mesh over two CPU cells each, so each process runs one data
row of both shards.  They restore the same `ShardedIndex` checkpoint and
run the query: every pass ``all_gather``s each cell's kept slots and the
flags, so each process folds every shard over both data rows, and both
processes must give the host engine's hits.  The children import no JAX.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

from pyfastani_tpu import Sketch
from pyfastani_tpu_torch.index import build_sharded_index

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import json, os, sys
rank = int(sys.argv[1]); port = sys.argv[2]; work = sys.argv[3]
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}", world_size=2, rank=rank)

from pyfastani_tpu_torch.parallel.mesh import make_mesh
from pyfastani_tpu_torch.parallel.sharded import ShardedIndex, ShardedSession

mesh = make_mesh(2, 2, devices=["cpu"] * 2)  # data x shard, spanning both processes
assert mesh.distributed and mesh.ranks == ((0, 0), (1, 1)), mesh
idx = ShardedIndex.load(os.path.join(work, "index.npz"))
query = open(os.path.join(work, "query.bin"), "rb").read()
sess = ShardedSession.from_index(
    idx, mesh=mesh,
    hmax=512, ivmax=16, cmax=128, rmax=384, t_chunks=52, bin_max=64, smax=256,
)
hits = sess.query([query])
with open(os.path.join(work, f"hits{{rank}}.json"), "w") as f:
    json.dump([[h.name, h.identity, h.matches, h.fragments] for h in hits], f)
assert "jax" not in sys.modules
dist.destroy_process_group()
"""


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

    build_sharded_index(mapper, 2).save(str(tmp_path / "index.npz"))
    (tmp_path / "query.bin").write_bytes(query)
    child = str(tmp_path / "child.py")
    with open(child, "w") as f:
        f.write(_CHILD.format(repo=_REPO))

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, child, str(rank), str(port), str(tmp_path)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for rank in (1, 0)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        logs.append(out.decode(errors="replace"))
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)

    want = [[h.name, h.identity, h.matches, h.fragments] for h in expected]
    for rank in (0, 1):
        with open(tmp_path / f"hits{rank}.json") as f:
            assert json.load(f) == want, "\n".join(logs)
