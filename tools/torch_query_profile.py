"""Where the time of the port's query path goes, on one NVIDIA GPU.

    python3 tools/torch_query_profile.py [--refs 10] [--ref-len 2000000] [--queries 4]
    python3 tools/torch_query_profile.py --ava 512 [--groups 8] [--draft 4]
    python3 tools/torch_query_profile.py --panel bgc --protein --fragment-length 100
    python3 tools/torch_query_profile.py --panel phages --k 14 --fragment-length 1000
    python3 tools/torch_query_profile.py --fragment-length 5000

``--k``, ``--fragment-length`` and ``--protein`` set the ``Sketch``'s
parameters (default k 16, 3000, nucleotide); with ``--protein`` the small
batch draws its letters from the 20 amino acids.  ``--panel bgc`` and
``--panel phages`` take ``chip_smoke.py`` phase 15's protein and phage
panels (``chip_smoke.param_panel``: 2,048 drafts of 24 proteins, or 1,024
genomes of 30-80 kb) and their 32 queries.

Builds the ``bench.py`` small-batch workload (random references, queries
mutated at 3%), or with ``--ava N`` the N-genome all-vs-all of
``bench_torch.workloads.ava_genomes`` (the whole panel indexed; the batch
is the genomes of the first G groups of the all-vs-all's packing, which
``query_many`` runs as about G groups), warms one `Session`, then over
steady ``query_many`` passes reports:

* per-stage stream time a pass and a group, from CUDA events (``bench_torch.spans``) around
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
  (the Chrome trace lands in ``build/torch_query_profile/``);
* the split of one profiled pass by the steps of a group (`split_pass`):
  in ``_l2_interval_scan`` the chunk plan (every op before
  ``l2_chunks``: the plan's kernels, which also look up each interval's
  contig) and ``l2_chunks``, where the sweep ends; in ``_query_block`` the
  ops between ``l1_candidates`` and the sweep ("before sweep") and the
  merge, gate and CGI (after the sweep: ``cgi_bins``); ``_fold``; and
  ``_pass``'s glue (its own ops outside ``_query_block`` and ``_fold``).
  For each step: host ms (the span of its ops, under the profiler), the
  torch ops it enqueues, the device kernels they launch and their device
  ms, then the kernels by name; beside it the device ms of every 1-D
  ``cummax`` of the plan and the glue's largest ops by host ms.

With ``--ava N --draft D`` the split also runs over D ``Mapper.query_draft``
calls on the same index (g0, g4, ...: one genome of each of the first D
families, the ``ava512_query_draft`` cell's first queries), per call.

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


# the session functions whose calls `split_pass` marks, where the session
# module has them
SPLIT_FUNCS = (
    "winnow_fragments", "l1_candidates", "l2_plan", "l2_chunks", "_l2_interval_scan",
    "cgi_bins", "_query_block", "fold_bins", "_fold",
)
_MARK = "split:"


def _marked(fn, name):
    import torch

    def run(*args, **kwargs):
        with torch.profiler.record_function(_MARK + name):
            return fn(*args, **kwargs)

    return run


# the port's own kernels by the step that launches them: they launch
# through ctypes, not through a torch op, so they are counted by name
OWN_KERNELS = {
    "l2_plan": "l2 plan", "l2_chunks": "l2_chunks", "cgi_bins": "gate + CGI",
    "fold_scatter": "fold", "fold_visit": "fold",
}


def _own(name: str) -> bool:
    return any(k in name for k in OWN_KERNELS) or "winnow_fragments" in name or "l1_" in name


def _subtree(e, names):
    """``(top-level torch ops, device kernels, device ms)`` of event ``e``
    and everything under it, the port's own kernels left out, whose names
    add to ``names`` (name -> [kernels, ms]); an op counts once, a marked
    range by the ops under it."""
    ops, kernels, ms = 0, 0, 0.0
    for k in getattr(e, "kernels", ()):
        # a marked range's span on the device is no kernel
        if not _own(k.name) and not k.name.startswith(_MARK):
            kernels, ms = kernels + 1, ms + k.duration / 1e3
            row = names.setdefault(k.name, [0, 0.0])
            row[0], row[1] = row[0] + 1, row[1] + k.duration / 1e3
    for c in e.cpu_children:
        o, k, d = _subtree(c, names)
        ops, kernels, ms = ops + o, kernels + k, ms + d
    return (ops if e.name.startswith(_MARK) else 1), kernels, ms


def split_pass(run):
    """``run()`` once under ``torch.profiler`` with every call of
    `SPLIT_FUNCS` and of ``ShardedSession._pass`` marked; returns ``{step:
    [host ms, torch ops, device kernels, device ms]}`` summed over the
    run (see the module docstring), ``[device ms, calls]`` of the plan's
    1-D ``cummax``, the host ms of ``_pass``'s glue by op, and each step's
    device kernels by name (``[launches, device ms]``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pyfastani_tpu_torch import session as S

    orig = {n: getattr(S, n) for n in SPLIT_FUNCS if hasattr(S, n)}
    orig_pass = S.ShardedSession._pass
    for n, fn in orig.items():
        setattr(S, n, _marked(fn, n))
    S.ShardedSession._pass = _marked(orig_pass, "_pass")
    try:
        cuda = torch.cuda.is_available()
        with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda) as prof:
            run()
            if cuda:
                torch.cuda.synchronize()
    finally:
        for n, fn in orig.items():
            setattr(S, n, fn)
        S.ShardedSession._pass = orig_pass

    steps = {k: [0.0, 0, 0, 0.0] for k in (
        "l2 plan", "l2_chunks", "before sweep", "gate + CGI", "fold", "_pass glue",
    )}
    cummax = [0.0, 0]
    kernel_names = {k: {} for k in steps}

    def add(step, events, host_us):
        row = steps[step]
        row[0] += host_us / 1e3
        for e in events:
            o, k, d = _subtree(e, kernel_names[step])
            row[1] += o
            row[2] += k
            row[3] += d

    def name(e):
        return e.name[len(_MARK):] if e.name.startswith(_MARK) else None

    def walk_cummax(e):
        if e.name == "aten::cummax" and (e.cpu_parent is None or e.cpu_parent.name != "aten::cummax"):
            cummax[0] += e.device_time_total / 1e3
            cummax[1] += 1
            return
        for c in e.cpu_children:
            walk_cummax(c)

    from torch.autograd import DeviceType

    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not e.key.startswith(_MARK):
            for key, step in OWN_KERNELS.items():
                if key in e.key:
                    steps[step][2] += e.count
                    steps[step][3] += e.self_device_time_total / 1e3
                    kernel_names[step][e.key] = [e.count, e.self_device_time_total / 1e3]
    glue_ops = {}
    for p in (e for e in prof.events() if name(e) == "_pass"):
        inner = [c for c in p.cpu_children if name(c) in ("_query_block", "_fold")]
        glue = [c for c in p.cpu_children if c not in inner]
        add("_pass glue", glue, (p.time_range.end - p.time_range.start)
            - sum(c.time_range.end - c.time_range.start for c in inner))
        for c in glue:
            glue_ops[c.name] = glue_ops.get(c.name, 0.0) + (c.time_range.end - c.time_range.start) / 1e3
        for q in inner:
            if name(q) == "_fold":
                add("fold", [q], q.time_range.end - q.time_range.start)
                continue
            kids = sorted(q.cpu_children, key=lambda c: c.time_range.start)
            l1 = next(c for c in kids if name(c) == "l1_candidates")
            scan = next(c for c in kids if name(c) == "_l2_interval_scan")
            add("before sweep",
                [c for c in kids if l1.time_range.end <= c.time_range.start < scan.time_range.start],
                scan.time_range.start - l1.time_range.end)
            add("gate + CGI", [c for c in kids if c.time_range.start >= scan.time_range.end],
                q.time_range.end - scan.time_range.end)
            sk = sorted(scan.cpu_children, key=lambda c: c.time_range.start)
            ch = next(c for c in sk if name(c) == "l2_chunks")
            before = [c for c in sk if c.time_range.end <= ch.time_range.start]
            add("l2 plan", before, ch.time_range.start - scan.time_range.start)
            add("l2_chunks", [ch], ch.time_range.end - ch.time_range.start)
            for c in before:
                walk_cummax(c)
    return steps, cummax, glue_ops, kernel_names


def _short(kernel: str) -> str:
    """A kernel's name without its template and parameter lists."""
    kernel = kernel.replace("void ", "").replace("(anonymous namespace)::", "")
    name = kernel.split("(")[0].split("<")[0].split("::")[-1]
    if name.endswith("kernel") and "<" in kernel:  # torch's kernels: the functor says more
        functor = kernel.split("<", 1)[1]
        for word in ("Fill", "copy", "scan", "reduce", "index", "scatter", "compare", "where",
                     "Binary", "Unary", "CUDAFunctor", "sort", "cat", "stack"):
            if word in functor:
                return f"{name}[{word}]"
    return name


def print_split(what: str, units: int, per: str, run, gpu: str) -> None:
    steps, (cummax_ms, cummax_n), glue_ops, kernel_names = split_pass(run)
    print(f"split of {what}, per {per} ({units}); host ms under the profiler ({gpu}):")
    print(f"  {'step':14s} {'host ms':>9s} {'torch ops':>9s} {'kernels':>8s} {'device ms':>10s}")
    for k, (host, ops, kern, dev) in steps.items():
        print(f"  {k:14s} {host / units:9.3f} {ops / units:9.1f} {kern / units:8.1f} "
              f"{dev / units:10.4f}")
    tot = [sum(v[i] for v in steps.values()) / units for i in range(4)]
    print(f"  {'all steps':14s} {tot[0]:9.3f} {tot[1]:9.1f} {tot[2]:8.1f} {tot[3]:10.4f}")
    print(f"  the plan's 1-D cummax: {cummax_n / units:.1f} a {per}, "
          f"{cummax_ms / units:.4f} ms of device time")
    top = sorted(glue_ops.items(), key=lambda kv: -kv[1])[:4]
    print("  _pass glue's largest ops by host ms: "
          + ", ".join(f"{k} {v / units:.3f}" for k, v in top))
    print(f"  device kernels by step (launches a {per}, device ms a {per}):")
    for step, names in kernel_names.items():
        rows = sorted(names.items(), key=lambda kv: -kv[1][1])
        print(f"    {step}: " + "; ".join(
            f"{_short(n)} x{c / units:g} {ms / units:.4f}" for n, (c, ms) in rows))


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
    ap.add_argument("--draft", type=int, default=0, metavar="D",
                    help="with --ava: also split D query_draft calls by step")
    ap.add_argument("--k", type=int, default=16, help="the Sketch's k-mer size")
    ap.add_argument("--fragment-length", type=int, default=3000,
                    help="the Sketch's fragment length")
    ap.add_argument("--protein", action="store_true", help="a protein Sketch (w 1)")
    ap.add_argument("--panel", choices=("small", "bgc", "phages"), default="small",
                    help="chip_smoke.py phase 15's protein or phage panel and its queries")
    args = ap.parse_args()
    sketch_kw = dict(k=args.k, fragment_length=args.fragment_length, protein=args.protein)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    gpu = _gpu()

    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch import session as S

    if args.ava:
        genomes = workloads.ava_genomes(n_genomes=args.ava)
        sk = pt.Sketch(**sketch_kw)
        for i, g in enumerate(genomes):
            sk.add_genome(f"g{i}", g)
        mapper = sk.index()
        session = S.Session(mapper)
        batch = _first_groups(session, [[g] for g in genomes], args.groups)
        workload = (f"all-vs-all of {args.ava} genomes ({sum(len(g) for g in genomes)} bp "
                    f"indexed), the {len(batch)} genomes of its first {args.groups} groups")
    elif args.panel != "small":
        import chip_smoke

        name = {"bgc": "protein_bgc", "phages": "nucl_k14_f1000"}[args.panel]
        references, batch, _, _ = chip_smoke.param_panel(name)
        sk = pt.Sketch(**sketch_kw)
        for ref, contigs in references:
            sk.add_draft(ref, contigs)
        session = S.Session(sk.index())
        workload = (f"chip_smoke.py phase 15's {name} panel ({len(references)} references, "
                    f"{sum(len(c) for _, contigs in references for c in contigs)} letters), "
                    f"its {len(batch)} queries")
    else:
        rng = np.random.default_rng(0)
        letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY" if args.protein else b"ACGT", np.uint8)
        refs = [rng.choice(letters, size=args.ref_len) for _ in range(args.refs)]
        batch = []
        for i in range(args.queries):
            q = refs[i % args.refs].copy()
            mut = rng.random(q.shape[0]) < 0.03
            q[mut] = rng.choice(letters, size=int(mut.sum()))
            batch.append([q.tobytes()])
        sk = pt.Sketch(**sketch_kw)
        for i, r in enumerate(refs):
            sk.add_genome(f"ref{i}", r.tobytes())
        session = S.Session(sk.index())
        workload = f"{args.refs} x {args.ref_len} bp refs, {args.queries} queries"
    workload += f"; Sketch {sketch_kw} (w {session.params.window_size})"
    session.warmup()
    session.query_many(batch)
    torch.cuda.synchronize()
    qbp = sum(len(c) for q in batch for c in q)
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
          "(CUDA events, launch gaps included), and a group:")
    for k, v in tot.items():
        print(f"  {k:14s} {v:9.3f} ms  {100 * v / wall_ms:5.1f}% of wall  {v / groups:9.4f} ms "
              "a group")
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

    print_split(f"one query_many pass ({groups} groups)", groups, "group",
                lambda: session.query_many(batch), gpu)
    if args.ava and args.draft:
        drafts = [[genomes[i]] for i in range(0, workloads.AVA_FAMILY * args.draft,
                                               workloads.AVA_FAMILY)]
        for q in drafts:  # the cached one-genome session, warm
            mapper.query_draft(q)
        torch.cuda.synchronize()

        def sweep():
            for q in drafts:
                mapper.query_draft(q)

        print_split(f"{len(drafts)} query_draft calls (g0, g4, ... on the same index)",
                    len(drafts), "call", sweep, gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
