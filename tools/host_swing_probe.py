"""Why the host steps of a query pass swing between runs: one process, no card.

    python3 tools/host_swing_probe.py [--genomes 64] [--reps 5]

Times ``ShardedSession._fragments``, the host step that cuts every query
genome into fragments (views of its raw bytes, ``codec.raw_bytes``: the
card uppercases them after the staging copy), over the first
``--genomes`` genomes of ``bench_torch.workloads.ava_genomes`` (seed 7),
``--reps`` times in each of three settings:

* ``as_run``: as a query pass runs it;
* ``gc_off``: with Python's garbage collector off;
* ``pinned``: with the process pinned to one CPU;

and, in the same way, the host conversion ``_fragments`` ran before the
card took the uppercase, split into its parts:

* ``to_bytes``: ``codec.to_bytes`` of each genome, a copy and an
  upper-casing table lookup, each into a new array;
* ``copy``: the copy alone, ``bytes(memoryview(genome))``;
* ``touched``: the lookup alone, into one output buffer written before,
  so without the first-touch page faults of new arrays.

Also the NumPy copy rate into a buffer written before and into a new one,
the CPU model, the CPUs this process may run on and the load average.
Prints one JSON object.  Imports neither JAX nor anything of
``pyfastani_tpu``; needs no card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_torch import workloads  # noqa: E402
from bench_torch.run import host_info  # noqa: E402


def _rates(fn, mbp: float, reps: int) -> dict:
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        rates.append(mbp / (time.perf_counter() - t0))
    return {"median": float(np.median(rates)), "min": min(rates), "max": max(rates)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genomes", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch.ops import codec
    from pyfastani_tpu_torch.session import ShardedSession

    genomes = workloads.ava_genomes(7, n_genomes=args.genomes)
    mbp = sum(len(g) for g in genomes) / 1e6
    session = types.SimpleNamespace(params=pt.Sketch(device="cpu")._param)

    def fragments():
        for g in genomes:
            ShardedSession._fragments(session, [g])

    upper = np.frombuffer(bytes(range(256)).upper(), np.uint8)
    out = np.empty(max(len(g) for g in genomes), np.uint8)

    def touched():
        for g in genomes:
            raw = np.frombuffer(g, np.uint8)
            np.take(upper, raw, out=out[: raw.shape[0]])

    fragments()  # the first call pays imports and allocator growth
    result = {"host": host_info(), "genomes": args.genomes, "mbp": mbp}
    result["as_run"] = _rates(fragments, mbp, args.reps)
    gc.disable()
    try:
        result["gc_off"] = _rates(fragments, mbp, args.reps)
    finally:
        gc.enable()
    cpus = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {min(cpus)})
    try:
        result["pinned"] = _rates(fragments, mbp, args.reps)
    finally:
        os.sched_setaffinity(0, cpus)
    result["to_bytes"] = _rates(lambda: [codec.to_bytes(g) for g in genomes], mbp, args.reps)
    result["copy"] = _rates(lambda: [bytes(memoryview(g)) for g in genomes], mbp, args.reps)
    result["touched"] = _rates(touched, mbp, args.reps)

    src = np.ones(1 << 30, np.uint8)
    dst = np.empty_like(src)
    np.copyto(dst, src)
    result["copy_touched_gb_per_s"] = _rates(lambda: np.copyto(dst, src), 2 * 1.073741824, args.reps)
    result["copy_fresh_gb_per_s"] = _rates(
        lambda: np.copyto(np.empty_like(src), src), 2 * 1.073741824, args.reps)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
