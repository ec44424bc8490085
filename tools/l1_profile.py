"""Where the time of the L1 candidate stage goes, op by op, on one NVIDIA GPU.

    python3 tools/l1_profile.py [--ava 512] [--reps 3] [--route plain|kernel|both]

Builds the all-vs-all panel of ``bench_torch.workloads.ava_genomes`` (seed
7, ``--ava`` genomes), indexes it, and captures the operands of two
``l1_candidates`` calls from the user's entry points:

* ``ava``: the first group of ``Session(mapper).query_many`` of every
  genome (``chip_smoke.py`` phase 10's first group);
* ``draft``: the one group of ``mapper.query_draft`` of g0 (the
  ``ava512_query_draft`` cell's first query).

(``chip_smoke.capture_operands``: the index planes by reference, the rest
cloned.)

Each route of the stage then runs ``--reps`` times on those operands
under ``torch.profiler``: the plain version (``l1_candidates_reference``,
on CUDA tensors) and the wrapper's kernels (``l1_candidates``).  The
plain version's top-level ops are split in the order they run: the probe
(every op before the first ``cumsum``: the bucketed binary search), the
first ``cummax`` (the owning probe of each hit slot), the ``sort`` of
the hit keys, the second ``cummax`` (the last candidate), and the rest.
For each part: device time and top-level ops per call.  Per route: the
call's time between CUDA events, its device time and device kernels, and
its largest kernels.
Every line names the card and its power limit.  Needs a GPU; imports no
JAX.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import workloads  # noqa: E402
from chip_smoke import capture_operands, gpu_line, time_ms  # noqa: E402


def split_plain(prof) -> dict:
    """Device ms and top-level ops of each part of the profiled runs of
    the plain version (see the module docstring)."""
    from torch.autograd import DeviceType

    top = sorted(
        (e for e in prof.events() if e.cpu_parent is None and e.device_type == DeviceType.CPU),
        key=lambda e: e.time_range.start,
    )
    parts = defaultdict(lambda: [0.0, 0])
    state, cummax_seen = "probe", 0
    for e in top:
        name = e.name
        if state == "probe" and name == "aten::cumsum":
            state = "rest"
        if name == "aten::cummax":
            cummax_seen += 1
            part = "cummax 1 (slot owner)" if cummax_seen % 2 == 1 else "cummax 2 (last candidate)"
        elif name == "aten::sort":
            part = "sort (hit keys)"
        else:
            part = "probe (binary search)" if state == "probe" else "rest"
        parts[part][0] += e.device_time_total / 1e3
        parts[part][1] += 1
    return parts


def profile_route(fn, args, reps: int):
    """A ``torch.profiler`` trace of ``reps`` calls after a warm call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    return prof


def describe(args) -> str:
    q, s, uniq, _, _, post = args[:6]
    F, S = q.shape
    hmax, ivmax, l, steps, m_values = args[9:14]
    return (f"F={F}, S={S}, U={uniq.shape[0]}, M={post.shape[0]}, hmax={hmax} (T={F * hmax}), "
            f"ivmax={ivmax}, l={l}, bucket_steps={steps}, m_values={m_values}, sketch sizes "
            f"{int(s.min())}-{int(s.max())}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ava", type=int, default=workloads.AVA_GENOMES, metavar="N")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--route", choices=("plain", "kernel", "both"), default="both")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    gpu = gpu_line()

    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch.ops import l1
    from pyfastani_tpu_torch.session import Session
    from torch.autograd import DeviceType

    genomes = workloads.ava_genomes(7, args.ava)
    sk = pt.Sketch()
    for i, g in enumerate(genomes):
        sk.add_genome(f"g{i}", g)
    mapper = sk.index()
    session = Session(mapper)
    cases = {
        "ava": capture_operands(lambda: session.query_many([[g] for g in genomes]))[3],
        "draft": capture_operands(lambda: mapper.query_draft([genomes[0]]))[3],
    }
    del session
    routes = {"plain": l1.l1_candidates_reference, "kernel": l1.l1_candidates}
    if args.route != "both":
        routes = {args.route: routes[args.route]}
    for case, ops in cases.items():
        print(f"[{case}] {describe(ops)} ({gpu})")
        for route, fn in routes.items():
            prof = profile_route(fn, ops, args.reps)
            event_ms = time_ms(fn, ops, args.reps)
            device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in device) / 1e3 / args.reps
            launches = sum(e.count for e in device) / args.reps
            print(f"[{case}] {route}: {event_ms:.4f} ms a call between CUDA events, "
                  f"{busy:.4f} ms of device time, {launches:.0f} device kernels a call ({gpu})")
            if route == "plain":
                for part, (ms, n_ops) in split_plain(prof).items():
                    print(f"[{case}]   {part:26s} {ms / args.reps:9.4f} ms of device time, "
                          f"{n_ops / args.reps:5.0f} top-level ops a call")
            device.sort(key=lambda e: -e.self_device_time_total)
            for e in device[:8]:
                print(f"[{case}]     {e.self_device_time_total / 1e3 / args.reps:9.4f} ms "
                      f"x{e.count / args.reps:<5.0f} {e.key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
