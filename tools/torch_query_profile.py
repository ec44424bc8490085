"""Where the time of the port's query path goes, on one NVIDIA GPU.

    python3 tools/torch_query_profile.py [--refs 10] [--ref-len 2000000] [--queries 4]

Builds the ``bench.py`` small-batch workload (random references, queries
mutated at 3%), warms one `Session`, then over steady ``query_many``
passes reports:

* per-stage stream time, from CUDA events around each stage of
  ``session._query_block`` (fragment winnow, L1, L2 chunk sweep, gate and
  CGI) and around the identity fold, with the host wall time of the pass;
* host wall time of the session's host steps: cutting the queries into
  fragments (``_fragments``, which runs ``codec.to_bytes``), filling the
  staging slots (``_stage``) and the final read-back, which waits for the
  device (``_read_back``);
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
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _gpu() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class _StageTimer:
    """Wraps the stage functions the query block calls; each call records
    a CUDA event pair on the current stream."""

    def __init__(self, module, names):
        self.events = defaultdict(list)
        self._orig = {}
        for attr, label in names.items():
            fn = getattr(module, attr)
            self._orig[attr] = fn
            setattr(module, attr, self._wrap(fn, label))
        self._module = module

    def _wrap(self, fn, label):
        import torch

        def timed(*args, **kwargs):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            self.events[label].append((a, b))
            return out

        return timed

    def totals_ms(self):
        return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in self.events.items()}

    def restore(self):
        for attr, fn in self._orig.items():
            setattr(self._module, attr, fn)


class _HostTimer(_StageTimer):
    """Wraps methods with a host wall clock instead of CUDA events."""

    def _wrap(self, fn, label):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.events[label].append(time.perf_counter() - t0)

        return timed

    def totals_ms(self):
        return {k: 1e3 * sum(v) for k, v in self.events.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refs", type=int, default=10)
    ap.add_argument("--ref-len", type=int, default=2_000_000)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--passes", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    gpu = _gpu()

    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch import session as S

    rng = np.random.default_rng(0)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    refs = [rng.choice(acgt, size=args.ref_len) for _ in range(args.refs)]
    queries = []
    for i in range(args.queries):
        q = refs[i % args.refs].copy()
        mut = rng.random(q.shape[0]) < 0.03
        q[mut] = rng.choice(acgt, size=int(mut.sum()))
        queries.append(q.tobytes())
    sk = pt.Sketch()
    for i, r in enumerate(refs):
        sk.add_genome(f"ref{i}", r.tobytes())
    session = S.Session(sk.index())
    batch = [[q] for q in queries]
    session.query_many(batch)
    torch.cuda.synchronize()
    qbp = sum(len(q) for q in queries)

    # stage times: the query block's own stages, then its remainder
    timer = _StageTimer(S, {
        "winnow_fragments": "winnow+sketch",
        "l1_candidates": "L1",
        "_l2_interval_scan": "L2 sweep",
        "_query_block": "query block",
        "_fold": "identity fold",
    })
    host = _HostTimer(S.ShardedSession, {
        "_fragments": "_fragments",
        "_stage": "_stage",
        "_read_back": "_read_back",
    })
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
    block = tot.pop("query block")
    tot["gate+CGI"] = block - sum(tot[k] for k in ("winnow+sketch", "L1", "L2 sweep"))
    wall_ms = 1e3 * float(np.median(walls))
    print(f"card: {gpu}; workload {args.refs} x {args.ref_len} bp refs, "
          f"{args.queries} queries ({qbp} bp), budgets {session.budgets}")
    print(f"steady query_many wall {wall_ms:.3f} ms (median of {args.passes}; "
          f"{qbp / 1e3 / wall_ms:.2f} Mbp/s); stream time per pass by stage "
          "(CUDA events, launch gaps included):")
    for k, v in tot.items():
        print(f"  {k:14s} {v:9.3f} ms  {100 * v / wall_ms:5.1f}% of wall")
    rest = wall_ms - block - tot["identity fold"]
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
