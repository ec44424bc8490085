"""Where the time of the port's query path goes, on one NVIDIA GPU.

    python3 tools/torch_query_profile.py [--refs 10] [--ref-len 2000000] [--queries 4]
    python3 tools/torch_query_profile.py --ava 512 [--groups 8]

Builds the ``bench.py`` small-batch workload (random references, queries
mutated at 3%), or with ``--ava N`` the N-genome all-vs-all of
``bench_torch.workloads.ava_genomes`` (the whole panel indexed; the batch
is the genomes of the first G groups of the all-vs-all's packing, which
``query_many`` runs as about G groups), warms one `Session`, then over
steady ``query_many`` passes reports:

* per-stage stream time, from CUDA events (``bench_torch.spans``) around
  each stage of ``session._query_block`` (fragment winnow, L1, L2 chunk
  sweep, gate and CGI) and around the identity fold, with the host wall
  time of the pass;
* host wall time of the session's host steps: cutting the queries into
  fragments (``_fragments``, which views their raw bytes; the card
  uppercases them after the staging copy), filling the staging slots
  (``_stage``) and the final read-back, which waits for the device
  (``_read_back``);
* the device's busy and idle share and the top kernels by device time,
  from ``torch.profiler`` through ``pyfastani_tpu_torch.utils.profiling``
  (the Chrome trace lands in ``build/torch_query_profile/``).

Every line names the card and its power limit.  Needs a GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import workloads  # noqa: E402
from bench_torch.spans import HOST_STEPS, QUERY_STAGES, HostTimer, StageTimer  # noqa: E402


def _gpu() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _first_groups(session, batch, n_groups: int):
    """The genomes of the first ``n_groups`` groups into which
    ``session.query_many(batch)`` packs ``batch``: the packing runs with
    the dispatch replaced by a recorder."""
    seen = []

    def record(per_genome, groups):
        seen.extend(groups[:n_groups])
        return []

    session._run_groups = record
    try:
        session.query_many(batch)
    finally:
        del session._run_groups
    return [batch[gi] for group in seen for gi in group]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refs", type=int, default=10)
    ap.add_argument("--ref-len", type=int, default=2_000_000)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--ava", type=int, default=0, metavar="N",
                    help="profile the N-genome all-vs-all instead of the small batch")
    ap.add_argument("--groups", type=int, default=8, metavar="G",
                    help="with --ava: the first G groups of the all-vs-all")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    gpu = _gpu()

    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch import session as S

    if args.ava:
        genomes = workloads.ava_genomes(n_genomes=args.ava)
        sk = pt.Sketch()
        for i, g in enumerate(genomes):
            sk.add_genome(f"g{i}", g)
        session = S.Session(sk.index())
        batch = _first_groups(session, [[g] for g in genomes], args.groups)
        workload = (f"all-vs-all of {args.ava} genomes ({sum(len(g) for g in genomes)} bp "
                    f"indexed), the {len(batch)} genomes of its first {args.groups} groups")
    else:
        rng = np.random.default_rng(0)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        refs = [rng.choice(acgt, size=args.ref_len) for _ in range(args.refs)]
        batch = []
        for i in range(args.queries):
            q = refs[i % args.refs].copy()
            mut = rng.random(q.shape[0]) < 0.03
            q[mut] = rng.choice(acgt, size=int(mut.sum()))
            batch.append([q.tobytes()])
        sk = pt.Sketch()
        for i, r in enumerate(refs):
            sk.add_genome(f"ref{i}", r.tobytes())
        session = S.Session(sk.index())
        workload = f"{args.refs} x {args.ref_len} bp refs, {args.queries} queries"
    session.warmup()
    session.query_many(batch)
    torch.cuda.synchronize()
    qbp = sum(len(q[0]) for q in batch)
    dispatches = session.stats["dispatches"]
    session.query_many(batch)
    groups = session.stats["dispatches"] - dispatches

    # stage times: the query block's own stages, then its remainder
    timer = StageTimer(S, QUERY_STAGES)
    host = HostTimer(S.ShardedSession, HOST_STEPS)
    walls = []
    for _ in range(args.passes):
        t0 = time.perf_counter()
        session.query_many(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    timer.restore()
    host.restore()
    tot = {k: v / args.passes for k, v in timer.totals_ms().items()}
    host_ms = {k: v / args.passes for k, v in host.totals_ms().items()}
    block = tot.pop("query_block")
    tot["gate_cgi"] = block - sum(tot[k] for k in ("winnow", "l1", "l2_sweep"))
    wall_ms = 1e3 * float(np.median(walls))
    print(f"card: {gpu}; workload {workload} ({qbp} bp of queries, {groups} groups a "
          f"pass), budgets {session.budgets}")
    print(f"steady query_many wall {wall_ms:.3f} ms (median of {args.passes}; "
          f"{qbp / 1e3 / wall_ms:.2f} Mbp/s); stream time per pass by stage "
          "(CUDA events, launch gaps included):")
    for k, v in tot.items():
        print(f"  {k:14s} {v:9.3f} ms  {100 * v / wall_ms:5.1f}% of wall")
    rest = wall_ms - block - tot["fold"]
    print(f"  {'host+transfer':14s} {rest:9.3f} ms  {100 * rest / wall_ms:5.1f}% of wall "
          "(wall less the block and the fold)")
    print("host wall time per pass (perf_counter around the session's host steps):")
    for k, v in host_ms.items():
        print(f"  {k:14s} {v:9.3f} ms  {100 * v / wall_ms:5.1f}% of wall")

    from torch.autograd import DeviceType

    from pyfastani_tpu_torch.utils.profiling import device_time_ms, trace

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with trace(os.path.join(root, "build", "torch_query_profile")) as prof:
        t0 = time.perf_counter()
        session.query_many(batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy_ms = device_time_ms(prof)
    busy = 100 * busy_ms / 1e3 / prof_wall
    print(f"profiled pass: wall {1e3 * prof_wall:.3f} ms, device busy {busy_ms:.3f} ms "
          f"= {busy:.1f}% (idle {100 - busy:.1f}%) ({gpu})")
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    if busy_ms == 0:
        print("  the profiler recorded no device time: read the event times above")
    return 0


if __name__ == "__main__":
    sys.exit(main())
