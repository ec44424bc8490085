"""Smoke test of the PyTorch/CUDA port (``pyfastani_tpu_torch``) on one GPU.

Run from the root of a checkout, with one NVIDIA Hopper card visible:

    python3 chip_smoke.py

It builds the port's host C extension (``pyfastani_tpu_torch/_native/``)
and CUDA kernel (``pyfastani_tpu_torch/csrc/``) and runs these phases in
order, one line each; any failure exits non-zero without printing a
result:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; exits 1 when ``torch.cuda.is_available()`` is false;
2. the two builds (host C compiler, nvcc), timed;
3. the L2 chunk kernel against its plain torch version, bitwise (the
   range flag included, also on chunks that leave the store), on CUDA
   tensors: a synthetic ``main`` case at the small batch's budgets, a
   ``wide`` one at the largest presized range, a ``huge`` one at
   ``rmax`` 16128, past shared memory (the kernel's scratch variant),
   and two captured from the path: after phase 4, ``real``, the operands
   of one L2 sweep of phase 4's small batch; after phase 10, ``ava``, the
   first L2 sweep of the all-vs-all.  Each with the kernel's and the
   plain version's times, the kernel alone in device time
   (``torch.profiler``), and its bound;
4. the query path at a real size (10 random 2 Mbp references, 4 queries
   mutated at 3%): ``Sketch`` -> ``index()`` -> ``Mapper.query_genome``
   and ``Session.query_many``, held against the port's host NumPy engine
   on a ``Sketch(device="cpu")`` ingested and indexed on its own
   (``Mapper._query_host``, L1 and L2 in NumPy; hits equal, identity
   ``==``), an unrelated query giving ``[]``, and the kernel launch
   count of that run;
5. phase 4's panel on a ``(2, 2)`` mesh (``ShardedSession``): four cards
   when there are four, else ``cuda:0`` in all four cells; hits equal
   phase 4's and the host engine's;
6. a steady ``query_many`` of 8 queries at ``q_capacity=2`` (4 groups
   through the two pinned staging slots) under
   ``torch.cuda.set_sync_debug_mode("error")``, so that no pass may wait
   for the device; hits equal each query run alone; then, outside that
   check, Mbp/s and the device idle share (as
   ``tools/torch_query_profile.py`` computes it);
7. the device ingest winnow (``winnow_sequence_device``) of one 2 Mbp
   reference, bitwise against the host C winnow, with Mbp/s;
8. the two-process NCCL mesh (``torch.distributed``, one card per
   process) when there are two cards; otherwise one line says it did not
   run;
9. budget escalation on the card: phase 4's panel through a ``Session``
   whose budgets are too small escalates at least twice and gives phase
   4's hits;
10. the all-vs-all of ``bench.py`` (`ava_genomes`: 512 genomes, 1408 Mbp)
    through ``Sketch`` -> ``add_genome`` -> ``index()`` ->
    ``Session(mapper)`` -> ``warmup()`` -> ``query_many`` of every genome,
    a first pass timed apart and a steady one: step times (the park's
    check that the store is in position order timed alone), Mbp/s, pairs/s,
    groups, fragments, budgets, escalations and the peak device memory of
    each pass; every genome hits exactly the 8
    genomes of its family and its sibling family, itself at identity 100
    (4096 hits, as the JAX package returned); g0 and g4 equal the host
    NumPy engine on the same index (g0 alone when the two would take
    over 90 s); with four cards, the same on a ``(1, 4)`` mesh, the index
    split by genome, equal to the one-card hits, else one line says it
    did not run;
11. (run after phase 9, while phase 4's index is still parked) phase 4's
    batch as uppercase ``bytes``, lowercase ``bytes``, a mixed-case
    ``bytearray`` and a mixed-case uint8 ``ndarray``: the session stages
    raw bytes and the card uppercases them, so each kind's hits equal
    phase 4's; each pass's ``_fragments`` and ``_stage`` milliseconds.

Phases 4 to 6, 9, 10 and 11 each reset the kernel's launch counters before
their run and fail unless the kernel ran and its plain version did not.
The last lines are the card, a JSON object with one entry per kernel
(launches summed over phases 4 to 6, 9, 10's steady pass and 11, times and
bound at the ``real`` case, which its ``case`` key names), and
``{"ok": true, "device": {...}}``.  Takes no arguments.  Imports neither
JAX nor anything of ``pyfastani_tpu``, and fails if either was loaded.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

# the benchmark's generator and roofline work, one copy: the smoke's bound
# reads the same work as the benchmark's l2_kernel_roofline_share
from bench_torch import workloads
from bench_torch.work import l2_chunks_work
from bench_torch.workloads import (  # noqa: F401 (CROSS_RATE: the tests read it here)
    AVA_FAMILY,
    AVA_GENOMES,
    AVA_LENGTHS,
    CROSS_RATE,
    MUT_RATE,
    ava_expected,
)

ROOT = os.path.dirname(os.path.abspath(__file__))

# phase 3: synthetic minimizer store and chunks at the query path's shapes
KERNEL_M = 1_600_000  # minimizers of 10 x 2 Mbp at w = 24
KERNEL_CONTIGS = 10
KERNEL_F, KERNEL_S = 3072, 384  # fragments per pass, sketch budget smax
KERNEL_N = 50_000  # chunks per pass
KERNEL_RMAX = 896  # range capacity R - 128 the presizer gives 10 x 2 Mbp
WIDE_N, WIDE_RMAX = 4096, 8064  # the largest presized range: > 48 KB smem
# past the card's shared memory (the rmax of a second escalation): the
# kernel's scratch variant
HUGE_N, HUGE_RMAX = 2048, 16128
CMW, CMAX = 2985, 3072  # k = 16, l = 3000
TIMING_REPS = 10

# phase 4: the small-batch workload of bench.py (mutated at MUT_RATE, 3%)
N_REFS, REF_LEN, N_QUERIES = 10, 2_000_000, 4
# phase 6: 8 queries in groups of 2
PIPE_QUERIES, PIPE_Q_CAPACITY, PIPE_FRAG_CAPACITY = 8, 2, 2048
# the all-vs-all of bench.py (`bench_torch.workloads`): 512 genomes in
# families of 4 mutants (3%) of an ancestor, every second family descending
# from the one before at 9%, family lengths cycling 1/2/3/5 Mbp (1408 Mbp)
AVA_SEED = 7
AVA_HITS_PER_GENOME = 2 * AVA_FAMILY  # its own family and its sibling family
NCCL_TIMEOUT = 300
# phase 9: budgets small enough that phase 4's panel escalates (the tiny
# budgets of tests/test_torch_sharded.py would still overflow hmax after
# the session's six attempts on 2 Mbp genomes)
ESCALATE_BUDGETS = dict(hmax=32, ivmax=1, t_chunks=4, smax=128)
# phase 10: the host engine's check of g0 and g4 keeps g0 alone when the
# two would take longer than this
ORACLE_SECONDS = 90.0


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def mini_store(rng, m: int, n_contigs: int, hash_bits: int = 18):
    """Position-ordered minimizer store with dense hash reuse (the recipe of
    the JAX package's L2 kernel tests)."""
    gpos = np.cumsum(rng.integers(5, 20, size=m))
    bounds = np.sort(rng.choice(gpos[m // 8 :], size=n_contigs - 1, replace=False))
    seqid = np.searchsorted(bounds, gpos, side="right").astype(np.int32)
    base = np.concatenate([[0], bounds])
    wpos = (gpos - base[seqid]).astype(np.int32)
    mh = rng.integers(0, 1 << hash_bits, size=m).astype(np.uint32)
    return mh, seqid, wpos


def kernel_case(rng, n_chunks: int, rmax: int, device):
    """CUDA operands of one `l2_chunks` call: ranges inside one contig,
    ``rlen`` up to ``rmax``, a few empty chunks."""
    import torch

    from pyfastani_tpu_torch._common import bits_to_i32
    from pyfastani_tpu_torch.ops.l2 import compute_mini_prev

    mh, seqid, wpos = mini_store(rng, KERNEL_M, KERNEL_CONTIGS)
    prev = compute_mini_prev(mh, seqid, wpos)
    contig_end = np.searchsorted(seqid, np.arange(KERNEL_CONTIGS), side="right")
    q = np.sort(rng.choice(mh, size=(KERNEL_F, KERNEL_S)), axis=1)
    s = rng.integers(KERNEL_S // 2, KERNEL_S + 1, size=KERNEL_F).astype(np.int32)
    lo = rng.integers(0, KERNEL_M - 1, size=n_chunks)
    rlen = np.minimum(rng.integers(0, rmax + 1, size=n_chunks), contig_end[seqid[lo]] - lo)
    clen = rng.integers(1, CMAX + 1, size=n_chunks)
    clen[rng.random(n_chunks) < 0.05] = 0
    c0 = wpos[lo]
    frag = rng.integers(0, KERNEL_F, size=n_chunks)

    def put(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return (
        put(q.astype(np.int64), torch.int64), put(s), put(bits_to_i32(mh)),
        put(wpos), put(prev), put(lo), put(rlen), put(frag), put(c0), put(clen),
        CMW, rmax,
    )


def time_ms(fn, args, reps: int = TIMING_REPS) -> float:
    import torch

    fn(*args)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn(*args)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


mutate = workloads._mutate


def kernel_device_ms(fn, args, reps: int = 20, tries: int = 3) -> float:
    """Device time of the L2 kernel (either variant) alone per call, from a
    ``torch.profiler`` trace of ``reps`` calls.  A trace that holds none of
    the kernel's device time (seen once among the smoke's runs on an H100,
    and not again in the same sequence of calls) is taken again, up to
    ``tries`` traces; then it raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in device if "l2_chunks" in e.key)
        if total > 0:
            return total / 1e3 / reps
        log(f"torch.profiler recorded no device time of the kernel ({len(device)} device "
            f"kernels in the trace); tracing again")
    raise RuntimeError(f"torch.profiler recorded no device time of the kernel in {tries} traces")


def check_kernel(name: str, args, gpu: str) -> dict:
    """The kernel against its plain version on ``args``, bitwise, with the
    range flag 0 there and 1 on a copy whose chunks leave the store or
    name no sketch row; then both times (plain, kernel, kernel, plain),
    the kernel alone in device time, and the bound."""
    import torch

    from pyfastani_tpu_torch.ops import l2

    got = l2.l2_chunks(*args)
    want = l2.l2_chunks_reference(*args)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    if err != 0 or int(got[3]) != 0:
        raise AssertionError(f"l2_chunks kernel differs from the plain version ({name}): {err}")
    n, M, F = args[5].shape[0], args[2].shape[0], args[0].shape[0]
    bad = list(args)
    sel = torch.arange(n, device=args[5].device) % 97 == 0
    bad[5] = torch.where(sel, M - 1, args[5])
    bad[6] = torch.where(sel, 2, args[6])
    bad[7] = torch.where(torch.arange(n, device=args[5].device) % 89 == 0, F, args[7])
    got_bad = l2.l2_chunks(*bad)
    want_bad = l2.l2_chunks_reference(*bad)
    torch.cuda.synchronize()
    err_bad = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got_bad, want_bad))
    if err_bad != 0 or int(got_bad[3]) != 1:
        raise AssertionError(f"l2_chunks range flag differs from the plain version ({name})")
    plain_a = time_ms(l2.l2_chunks_reference, args)
    kern_a = time_ms(l2.l2_chunks, args)
    kern_b = time_ms(l2.l2_chunks, args)
    plain_b = time_ms(l2.l2_chunks_reference, args)
    alone = kernel_device_ms(l2.l2_chunks, args)
    work = l2_chunks_work(args)
    kern_ms, plain_ms = min(kern_a, kern_b), min(plain_a, plain_b)
    log(
        f"[3] l2_chunks {name}: N={n} chunks ({work['live']} live, {work['entries']} range "
        f"entries), rmax={args[11]}, S={args[0].shape[1]}, cmw={args[10]}: bitwise equal, "
        f"range flag 0, and 1 on equal output with chunks off the store; kernel "
        f"{kern_a:.3f}/{kern_b:.3f} ms, plain {plain_a:.3f}/{plain_b:.3f} ms per call, "
        f"kernel alone {alone:.4f} ms of device time; bound {work['bound_ms']:.4f} ms by "
        f"{work['bound_by']} ({work['bytes']} B, {work['ops']} int32 ops), "
        f"{100 * work['bound_ms'] / alone:.1f}% of it reached ({gpu})"
    )
    return dict(
        max_abs_err=err, ms=kern_ms, plain_ms=plain_ms, device_ms=alone,
        bound_ms=work["bound_ms"], bound_by=work["bound_by"], library_ms=None,
    )


def phase_kernel(device, gpu: str) -> None:
    rng = np.random.default_rng(11)
    for name, n, rmax in (
        ("main", KERNEL_N, KERNEL_RMAX),
        ("wide", WIDE_N, WIDE_RMAX),
        ("huge (the scratch variant)", HUGE_N, HUGE_RMAX),
    ):
        check_kernel(name, kernel_case(rng, n, rmax, device), gpu)


# operands of `l2_chunks` that are the session's parked store planes
# (mini_hash, mini_wpos, mini_prev): no pass writes them
STORE_OPERANDS = (2, 3, 4)


def capture_l2_operands(session, batch):
    """``(hits, operands)``: one ``session.query_many(batch)`` and the
    operands of its first `l2_chunks` call, cloned but for the store
    planes, which are kept by reference."""
    import torch

    from pyfastani_tpu_torch import session as session_module

    captured = []
    original = session_module.l2_chunks

    def capture(*args):
        if not captured:
            captured.append(tuple(
                a.clone() if isinstance(a, torch.Tensor) and i not in STORE_OPERANDS else a
                for i, a in enumerate(args)
            ))
        return original(*args)

    session_module.l2_chunks = capture
    try:
        hits = session.query_many(batch)
    finally:
        session_module.l2_chunks = original
    return hits, captured[0]


def ava_genomes(n_genomes: int = AVA_GENOMES, lengths=AVA_LENGTHS):
    """`bench_torch.workloads.ava_genomes` at the smoke's seed, 7."""
    return workloads.ava_genomes(AVA_SEED, n_genomes, lengths)


def genomes():
    rng = np.random.default_rng(0)
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    refs = [rng.choice(alphabet, size=REF_LEN).tobytes() for _ in range(N_REFS)]
    queries = [
        mutate(rng, np.frombuffer(refs[i % N_REFS], dtype=np.uint8), MUT_RATE).tobytes()
        for i in range(N_QUERIES)
    ]
    unrelated = np.random.default_rng(1).choice(alphabet, size=REF_LEN).tobytes()
    more = np.random.default_rng(2)
    queries += [
        mutate(more, np.frombuffer(refs[i % N_REFS], dtype=np.uint8), MUT_RATE).tobytes()
        for i in range(N_QUERIES, PIPE_QUERIES)
    ]
    return refs, queries, unrelated


def hit_key(hits):
    return [(h.name, h.identity, h.matches, h.fragments) for h in hits]


def counted(run):
    """``run()`` with the kernel's counters set to 0 just before it and
    read just after: ``(result, launches)``; fails unless the kernel ran
    and its plain version did not."""
    from pyfastani_tpu_torch.ops import l2

    l2.launches = 0
    l2.reference_calls = 0
    out = run()
    launches, plain_calls = l2.launches, l2.reference_calls
    if launches <= 0 or plain_calls != 0:
        raise AssertionError(
            f"the path ran the kernel {launches} times and the plain version {plain_calls} times"
        )
    return out, launches


def phase_query(gpu: str, refs, all_queries, unrelated):
    import torch

    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch.ops import l2
    from pyfastani_tpu_torch.session import Session

    queries = all_queries[:N_QUERIES]
    t0 = time.perf_counter()
    sketch = pt.Sketch()
    for i, r in enumerate(refs):
        sketch.add_genome(f"ref{i}", r)
    mapper = sketch.index()
    t_index = time.perf_counter() - t0
    log(
        f"[4] index {N_REFS} x {REF_LEN} bp: {t_index:.3f} s "
        f"({mapper._index.n_minimizers} minimizers, on the host; {gpu})"
    )

    l2.launches = 0
    l2.reference_calls = 0
    t0 = time.perf_counter()
    first = mapper.query_genome(queries[0])
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0

    t0 = time.perf_counter()
    session = Session(mapper)
    torch.cuda.synchronize()
    t_park = time.perf_counter() - t0
    batch = [[q] for q in queries]
    many = session.query_many(batch)  # first pass: allocator growth
    torch.cuda.synchronize()
    steady = []
    for _ in range(3):
        t0 = time.perf_counter()
        again = session.query_many(batch)
        torch.cuda.synchronize()
        steady.append(time.perf_counter() - t0)
        if [hit_key(h) for h in again] != [hit_key(h) for h in many]:
            raise AssertionError("query_many differs between passes")
    none = mapper.query_genome(unrelated)
    launches, plain_calls = l2.launches, l2.reference_calls

    qbp = sum(len(q) for q in queries)
    rates = [qbp / 1e6 / t for t in steady]
    log(
        f"[4] first query_genome (session build + park + query) {t_first:.3f} s; "
        f"Session park {t_park:.3f} s; steady query_many of {N_QUERIES} x "
        f"{REF_LEN} bp: {', '.join(f'{t:.3f}' for t in steady)} s = "
        f"{', '.join(f'{r:.2f}' for r in rates)} Mbp/s ({gpu}); "
        f"escalations {session.stats['budget_escalations']}, budgets {session.budgets}"
    )
    log(f"[4] query 0 hits: {first}")

    if none != []:
        raise AssertionError(f"unrelated query gave hits: {none}")
    if hit_key(many[0]) != hit_key(first):
        raise AssertionError(f"query_many[0] {many[0]} != query_genome {first}")
    if launches <= 0 or plain_calls != 0:
        raise AssertionError(
            f"main path ran the kernel {launches} times and the plain version {plain_calls} times"
        )

    # the oracle ingests and indexes the panel again, on its own
    t0 = time.perf_counter()
    host_sketch = pt.Sketch(device="cpu")
    for i, r in enumerate(refs):
        host_sketch.add_genome(f"ref{i}", r)
    host_mapper = host_sketch.index()
    for qi, q in enumerate(queries):
        want = host_mapper._query_host([q])
        if not want or want[0].name != f"ref{qi % N_REFS}":
            raise AssertionError(f"host engine query {qi} gave {want}")
        if hit_key(many[qi]) != hit_key(want):
            raise AssertionError(f"query {qi}: port {many[qi]} != host engine {want}")
    t_host = time.perf_counter() - t0
    log(
        f"[4] hits of all {N_QUERIES} queries equal the host NumPy engine "
        f"of its own ingest and index (names, matches, fragments, identity ==; host "
        f"ingest, index and queries {t_host:.1f} s); "
        f"unrelated query -> []; kernel launches {launches}, plain-version runs {plain_calls}"
    )
    _, real = capture_l2_operands(session, batch)
    return mapper, many, launches, real


def phase_mesh(gpu: str, mapper, queries, want) -> int:
    """Phase 4's panel on a (2, 2) mesh; returns the kernel launches."""
    import torch

    from pyfastani_tpu_torch.parallel.mesh import make_mesh
    from pyfastani_tpu_torch.parallel.sharded import ShardedSession

    n_dev = torch.cuda.device_count()
    if n_dev >= 4:
        devices, where = [f"cuda:{i}" for i in range(4)], "four cards, one cell each"
    else:
        devices, where = ["cuda:0"] * 4, f"cuda:0 in all four cells ({n_dev} card(s) visible)"
    mesh = make_mesh(2, 2, devices=devices)
    batch = [[q] for q in queries[:N_QUERIES]]

    def run():
        session = ShardedSession(mapper, mesh)
        t0 = time.perf_counter()
        first = session.query_many(batch)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = session.query_many(batch)
        torch.cuda.synchronize()
        return session, first, again, t_first, time.perf_counter() - t0

    (session, first, again, t_first, t_steady), launches = counted(run)
    for qi, (a, b) in enumerate(zip(first, again)):
        if hit_key(a) != hit_key(want[qi]) or hit_key(b) != hit_key(want[qi]):
            raise AssertionError(f"(2, 2) mesh query {qi}: {a} != phase 4 / host engine {want[qi]}")
    log(
        f"[5] (2, 2) mesh on {where}: hits of {N_QUERIES} queries equal phase 4 and the "
        f"host engine; query_many {t_first:.3f} s first, {t_steady:.3f} s steady; "
        f"budgets {session.budgets}; kernel launches {launches}, plain-version runs 0 ({gpu})"
    )
    return launches


def phase_pipeline(gpu: str, mapper, queries) -> int:
    """8 queries in 4 groups under the sync check; returns the kernel
    launches of the checked run."""
    import torch

    from pyfastani_tpu_torch.session import Session
    from pyfastani_tpu_torch.utils.profiling import device_time_ms, trace

    session = Session(mapper, q_capacity=PIPE_Q_CAPACITY, frag_capacity=PIPE_FRAG_CAPACITY)
    batch = [[q] for q in queries]
    alone = [session.query([q]) for q in queries]
    warm = session.query_many(batch)  # grows the slots and the allocators
    torch.cuda.synchronize()
    dispatches = session.stats["dispatches"]

    def checked():
        torch.cuda.set_sync_debug_mode("error")
        try:
            return session.query_many(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    steady, launches = counted(checked)
    groups = session.stats["dispatches"] - dispatches
    for qi, (a, b, c) in enumerate(zip(steady, warm, alone)):
        if not (hit_key(a) == hit_key(b) == hit_key(c)) or not c:
            raise AssertionError(f"pipelined query {qi}: {a} / {b} != alone {c}")
    if groups != PIPE_QUERIES // PIPE_Q_CAPACITY:
        raise AssertionError(f"expected {PIPE_QUERIES // PIPE_Q_CAPACITY} groups, ran {groups}")
    log(
        f"[6] query_many of {PIPE_QUERIES} x {REF_LEN} bp at q_capacity={PIPE_Q_CAPACITY} "
        f"({groups} groups of {PIPE_FRAG_CAPACITY} fragments) completed under "
        f"set_sync_debug_mode('error'); hits equal each query alone; "
        f"kernel launches {launches}, plain-version runs 0"
    )

    qbp = sum(len(q) for q in queries)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        session.query_many(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with trace(os.path.join(ROOT, "build", "chip_smoke_trace")) as prof:
        t0 = time.perf_counter()
        session.query_many(batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy = device_time_ms(prof) / 1e3 / prof_wall
    log(
        f"[6] steady query_many {', '.join(f'{t:.3f}' for t in walls)} s = "
        f"{', '.join(f'{qbp / 1e6 / t:.2f}' for t in walls)} Mbp/s; profiled pass "
        f"{1e3 * prof_wall:.3f} ms, device busy {1e3 * busy * prof_wall:.3f} ms, "
        f"idle {100 * (1 - busy):.1f}% ({gpu})"
    )
    return launches


def phase_ingest(gpu: str, refs) -> None:
    import torch

    from pyfastani_tpu_torch import _native
    from pyfastani_tpu_torch.models._engine_torch import winnow_sequence_device
    from pyfastani_tpu_torch.models._params import Parameters

    params = Parameters()
    data = np.frombuffer(refs[0], dtype=np.uint8)
    t0 = time.perf_counter()
    h_raw, p_raw = _native.winnow(
        data.tobytes(), params.kmer_size, params.window_size, params.alphabet_size != 4
    )
    t_host = time.perf_counter() - t0
    want = (np.frombuffer(h_raw, np.uint32), np.frombuffer(p_raw, np.int32))
    got = winnow_sequence_device(data, params)  # first call: allocator growth
    for g, w in zip(got, want):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError("device ingest winnow differs from the host C winnow")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        winnow_sequence_device(data, params)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    mb = data.shape[0] / 1e6
    log(
        f"[7] winnow_sequence_device of {data.shape[0]} bp: {want[0].shape[0]} minimizers, "
        f"bitwise equal to the host C winnow; {', '.join(f'{mb / t:.2f}' for t in times)} "
        f"Mbp/s with the copy back (host C {mb / t_host:.2f} Mbp/s; {gpu})"
    )


def phase_escalation(gpu: str, mapper, queries, want) -> int:
    """Phase 4's panel through a `Session` whose budgets are too small:
    the session doubles the blown budgets and runs the batch again, at
    least twice, and gives phase 4's hits.  Returns the kernel launches."""
    import warnings

    import torch

    from pyfastani_tpu_torch.session import Session

    session = Session(mapper, **ESCALATE_BUDGETS)
    batch = [[q] for q in queries[:N_QUERIES]]

    def run():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            hits = session.query_many(batch)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
        steps = [
            str(w.message).split("escalating ", 1)[1]
            for w in caught if "escalating" in str(w.message)
        ]
        return hits, steps, took

    (hits, steps, took), launches = counted(run)
    n = session.stats["budget_escalations"]
    if n < 2 or len(steps) != n:
        raise AssertionError(f"expected at least two escalations, got {n}: {steps}")
    for qi, (a, b) in enumerate(zip(hits, want)):
        if hit_key(a) != hit_key(b):
            raise AssertionError(f"escalated query {qi}: {a} != phase 4 {b}")
    log(
        f"[9] escalation on the card: phase 4's panel from budgets {ESCALATE_BUDGETS} "
        f"escalated {n} times ({'; '.join(steps)}) to {session.budgets} in {took:.3f} s; "
        f"hits equal phase 4; kernel launches {launches}, plain-version runs 0 ({gpu})"
    )
    return launches


def phase_case(gpu: str, mapper, queries, want) -> int:
    """Phase 4's batch as uppercase ``bytes``, then as lowercase ``bytes``,
    a mixed-case ``bytearray`` and a mixed-case uint8 ``ndarray`` through
    one `Session`: the session stages the raw bytes and the card
    uppercases them, so every kind gives phase 4's hits.  Each pass's
    `_fragments` and `_stage` milliseconds are printed.  Returns the kernel
    launches."""
    import torch

    from bench_torch.spans import HOST_STEPS, HostTimer
    from pyfastani_tpu_torch.session import Session, ShardedSession

    rng = np.random.default_rng(3)

    def mixed(q: bytes) -> np.ndarray:
        arr = np.frombuffer(q, np.uint8).copy()
        arr[rng.random(arr.shape[0]) < 0.5] |= 0x20  # ACGT -> acgt
        return arr

    queries = queries[:N_QUERIES]
    kinds = {
        "uppercase bytes": [[q] for q in queries],
        "lowercase bytes": [[q.lower()] for q in queries],
        "mixed-case bytearray": [[bytearray(mixed(q).tobytes())] for q in queries],
        "mixed-case uint8 ndarray": [[mixed(q)] for q in queries],
    }
    session = Session(mapper)
    session.query_many(kinds["uppercase bytes"])  # allocator growth
    torch.cuda.synchronize()
    launches = 0
    for name, batch in kinds.items():
        host = HostTimer(ShardedSession, HOST_STEPS)
        try:
            t0 = time.perf_counter()
            hits, n = counted(lambda: session.query_many(batch))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            host.restore()
        for qi, (a, b) in enumerate(zip(hits, want)):
            if hit_key(a) != hit_key(b):
                raise AssertionError(f"{name} query {qi}: {a} != phase 4's uppercase run {b}")
        ms = host.totals_ms()
        log(
            f"[11] {name}, {N_QUERIES} x {REF_LEN} bp: hits equal phase 4's uppercase bytes run; "
            f"pass {1e3 * wall:.3f} ms, _fragments {ms['host_fragments']:.3f} ms, "
            f"_stage {ms['host_stage']:.3f} ms; kernel launches {n} ({gpu})"
        )
        launches += n
    return launches


def check_ava_hits(hits, n_genomes: int, where: str) -> None:
    """Every genome hits exactly its family and its sibling family, itself
    at identity 100: `AVA_HITS_PER_GENOME` hits each."""
    total = sum(len(h) for h in hits)
    if total != AVA_HITS_PER_GENOME * n_genomes:
        raise AssertionError(f"{where}: {total} hits, expected {AVA_HITS_PER_GENOME * n_genomes}")
    for i, h in enumerate(hits):
        names = [x.name for x in h]
        if sorted(names) != sorted(ava_expected(i)):
            raise AssertionError(f"{where}: g{i} hits {names}, expected {sorted(ava_expected(i))}")
        self_hit = [x.identity for x in h if x.name == f"g{i}"]
        if self_hit != [100.0]:
            raise AssertionError(f"{where}: g{i} self-hit identity {self_hit}, expected [100.0]")


def phase_ava(gpu: str):
    """The all-vs-all of ``bench.py`` through the user's entry points on
    one card: ``Sketch`` -> ``add_genome`` x N -> ``index()`` ->
    ``Session(mapper)`` -> ``warmup()`` -> ``query_many`` of every genome,
    twice (the first pass timed apart; it also captures the operands of
    its first L2 sweep).  Then the host NumPy engine on g0 and g4, and the
    four-card (1, 4) mesh when there are four cards.  Returns the kernel
    launches of the steady pass and the captured operands."""
    import torch

    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch import _native
    from pyfastani_tpu_torch.session import Session

    n_genomes = AVA_GENOMES
    t0 = time.perf_counter()
    genomes = ava_genomes(n_genomes)
    t_gen = time.perf_counter() - t0
    qbp = sum(len(g) for g in genomes)
    t0 = time.perf_counter()
    sketch = pt.Sketch()
    for i, g in enumerate(genomes):
        sketch.add_genome(f"g{i}", g)
    t_ingest = time.perf_counter() - t0
    t0 = time.perf_counter()
    mapper = sketch.index()
    t_index = time.perf_counter() - t0
    # the park's check that the store is in position order, which its
    # order-based shortcuts need, timed alone on the same store
    t0 = time.perf_counter()
    ordered = _native.position_ordered(mapper._index.mini_seqid, mapper._index.mini_wpos)
    t_order = time.perf_counter() - t0
    if not ordered:
        raise AssertionError("all-vs-all: the ingested store is not in position order")
    log(
        f"[10] all-vs-all panel: {n_genomes} genomes (families of {AVA_FAMILY}, "
        f"lengths {'/'.join(str(n // 10**6) for n in AVA_LENGTHS)} Mbp), {qbp} bp; generated in "
        f"{t_gen:.3f} s, ingested (host C winnow) in {t_ingest:.3f} s, indexed in "
        f"{t_index:.3f} s: {mapper._index.n_minimizers} minimizers, in position order "
        f"(checked in {1e3 * t_order:.1f} ms) ({gpu})"
    )

    t0 = time.perf_counter()
    session = Session(mapper)
    torch.cuda.synchronize()
    t_park = time.perf_counter() - t0
    parked = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    session.warmup()
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    batch = [[g] for g in genomes]
    before = dict(session.stats)

    def first_run():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hits, operands = capture_l2_operands(session, batch)
        torch.cuda.synchronize()
        return hits, operands, time.perf_counter() - t0

    (first, operands, t_first), launches_first = counted(first_run)
    ran = {k: session.stats[k] - before[k] for k in before}
    peak_first = torch.cuda.max_memory_allocated()
    # the clones of the capture, held on the card from the first pass on
    held = sum(
        a.numel() * a.element_size()
        for i, a in enumerate(operands)
        if isinstance(a, torch.Tensor) and i not in STORE_OPERANDS
    )

    def steady_run():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hits = session.query_many(batch)
        torch.cuda.synchronize()
        return hits, time.perf_counter() - t0

    (steady, t_steady), launches = counted(steady_run)
    peak = torch.cuda.max_memory_allocated()
    if [hit_key(h) for h in steady] != [hit_key(h) for h in first]:
        raise AssertionError("all-vs-all: the steady pass differs from the first")
    check_ava_hits(first, n_genomes, "all-vs-all")
    pairs = n_genomes * n_genomes
    log(
        f"[10] Session park {t_park:.3f} s ({parked / 2**30:.3f} GiB on the card), warmup "
        f"{t_warm:.3f} s; query_many first {t_first:.3f} s = {qbp / 1e6 / t_first:.2f} Mbp/s = "
        f"{pairs / t_first:.1f} pairs/s, steady {t_steady:.3f} s = {qbp / 1e6 / t_steady:.2f} "
        f"Mbp/s = {pairs / t_steady:.1f} pairs/s ({gpu}); per query_many: "
        f"{ran['dispatches']} groups dispatched, {ran['fragments_dispatched']} fragments "
        f"dispatched and {ran['fragments_padded']} padded, escalations "
        f"{ran['budget_escalations']}; budgets {session.budgets}; kernel launches "
        f"{launches_first} first, {launches} steady, plain-version runs 0; peak device memory "
        f"(allocated, the parked index included) {peak_first / 2**30:.3f} GiB in the first pass, "
        f"{peak / 2**30:.3f} GiB in the steady one, {held / 2**20:.1f} MiB of each the captured "
        f"L2 operands"
    )
    log(
        f"[10] {sum(len(h) for h in first)} hits, equal in both passes: every genome hits "
        f"exactly the {AVA_HITS_PER_GENOME} genomes of its family and its sibling family, "
        f"itself at identity 100.0"
    )

    t0 = time.perf_counter()
    checked, note = [], ""
    for gi in (0, AVA_FAMILY):
        spent = time.perf_counter() - t0
        if checked and 2 * spent > ORACLE_SECONDS:
            note = (f"; g{gi} not checked: g0 alone took {spent:.1f} s, so the two would "
                    f"pass {ORACLE_SECONDS:.0f} s")
            break
        want = mapper._query_host([genomes[gi]])
        if hit_key(first[gi]) != hit_key(want):
            raise AssertionError(f"all-vs-all g{gi}: port {first[gi]} != host engine {want}")
        checked.append(f"g{gi}")
    log(
        f"[10] {' and '.join(checked)} equal the host NumPy engine on the same index (names, "
        f"matches, fragments, identity ==) in {time.perf_counter() - t0:.1f} s{note}"
    )

    del session
    torch.cuda.empty_cache()
    phase_ava_four_cards(gpu, mapper, batch, first)
    return launches, operands


def phase_ava_four_cards(gpu: str, mapper, batch, want) -> None:
    """The all-vs-all on a (1, 4) mesh over four cards, the index split by
    genome (``build_sharded_index(mapper, 4)``): one pass, hits equal the
    one-card run."""
    import torch

    from pyfastani_tpu_torch.parallel.mesh import make_mesh
    from pyfastani_tpu_torch.parallel.sharded import ShardedSession

    n_dev = torch.cuda.device_count()
    if n_dev < 4:
        log(f"[10] four-card (1, 4) all-vs-all: not run, it needs four cards ({n_dev} visible)")
        return
    devices = [f"cuda:{i}" for i in range(4)]

    def sync():
        for dev in devices:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    session = ShardedSession(mapper, make_mesh(1, 4, devices=devices))
    sync()
    t_park = time.perf_counter() - t0

    def run():
        t0 = time.perf_counter()
        hits = session.query_many(batch)
        sync()
        return hits, time.perf_counter() - t0

    (hits, took), launches = counted(run)
    if [hit_key(h) for h in hits] != [hit_key(h) for h in want]:
        raise AssertionError("four-card (1, 4) all-vs-all differs from the one-card run")
    qbp = sum(len(g[0]) for g in batch)
    log(
        f"[10] four-card (1, 4) all-vs-all, index split by genome: hits equal the one-card "
        f"run; shard build and park {t_park:.3f} s, query_many {took:.3f} s = "
        f"{qbp / 1e6 / took:.2f} Mbp/s; budgets {session.budgets}; kernel launches {launches}, "
        f"plain-version runs 0 ({gpu})"
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_nccl(gpu: str, mapper, query, want) -> None:
    """Two processes, one card each, on a (2, 2) mesh over NCCL."""
    import torch

    from pyfastani_tpu_torch.index import build_sharded_index

    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        log(f"[8] two-process NCCL mesh: not run, it needs a second card ({n_dev} visible)")
        return
    work = os.path.join(ROOT, "build", "chip_smoke_nccl")
    os.makedirs(work, exist_ok=True)
    build_sharded_index(mapper, 2).save(os.path.join(work, "index.npz"))
    with open(os.path.join(work, "query.bin"), "wb") as fh:
        fh.write(query)
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--nccl-rank", str(rank), port, work],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in (1, 0)
    ]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=NCCL_TIMEOUT)
            logs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("NCCL child failed:\n" + "\n".join(logs)[-4000:])
    for rank in (0, 1):
        with open(os.path.join(work, f"hits{rank}.json")) as fh:
            got = [tuple(h) for h in json.load(fh)]
        if got != [tuple(k) for k in hit_key(want)]:
            raise AssertionError(f"NCCL rank {rank}: {got} != host engine {hit_key(want)}")
    log(f"[8] two-process NCCL (2, 2) mesh, one card per process: both ranks' hits equal "
        f"the host engine ({gpu})")


def nccl_child(rank: int, port: str, work: str) -> int:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank
    )
    try:
        from pyfastani_tpu_torch.parallel.mesh import make_mesh
        from pyfastani_tpu_torch.parallel.sharded import ShardedIndex, ShardedSession

        mesh = make_mesh(2, 2, devices=[f"cuda:{rank}"] * 2)
        session = ShardedSession.from_index(ShardedIndex.load(os.path.join(work, "index.npz")), mesh=mesh)
        with open(os.path.join(work, "query.bin"), "rb") as fh:
            hits = session.query([fh.read()])
        with open(os.path.join(work, f"hits{rank}.json"), "w") as fh:
            json.dump(hit_key(hits), fh)
    finally:
        dist.destroy_process_group()
    return 0


def main() -> int:
    import torch

    log(
        f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}"
    )
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no GPU to run on", file=sys.stderr)
        return 1
    gpu = gpu_line()
    log(f"[1] {gpu}; {torch.cuda.device_count()} device(s)")

    sys.path.insert(0, ROOT)
    import pyfastani_tpu_torch  # noqa: F401  (fails outside a checkout)
    from pyfastani_tpu_torch import _build, _native

    t0 = time.perf_counter()
    _native.load()
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.load_library()
    took = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log().splitlines() if "registers" in ln]
    log(f"[2] host C extension built and loaded in {t_native:.1f} s; kernel library built "
        f"and loaded in {took:.1f} s; ptxas: {' | '.join(ptxas)}")

    device = torch.device("cuda", 0)
    phase_kernel(device, gpu)
    refs, queries, unrelated = genomes()
    mapper, many, launches, real = phase_query(gpu, refs, queries, unrelated)
    kern = check_kernel("real (one L2 sweep of phase 4's small batch)", real, gpu)
    launches += phase_mesh(gpu, mapper, queries, many)
    launches += phase_pipeline(gpu, mapper, queries)
    phase_ingest(gpu, refs)
    phase_nccl(gpu, mapper, queries[0], many[0])
    launches += phase_escalation(gpu, mapper, queries, many)
    launches += phase_case(gpu, mapper, queries, many)
    del mapper, real
    ava_launches, ava_ops = phase_ava(gpu)
    check_kernel("ava (the first L2 sweep of the all-vs-all's first pass)", ava_ops, gpu)
    loaded = sorted(
        m for m in sys.modules
        if m == "jax" or m.startswith("jax.") or m == "pyfastani_tpu" or m.startswith("pyfastani_tpu.")
    )
    if loaded:
        raise AssertionError(f"modules of JAX or of the JAX package were imported: {loaded}")

    print(gpu)
    print(json.dumps({"kernels": [{
        "name": "l2_chunks",
        "route": "cuda",
        "source": "pyfastani_tpu_torch/csrc/l2_chunks.cu",
        "replaces": "pyfastani_tpu/ops/l2_pallas.py:119",
        "launches": launches + ava_launches,
        "case": "real",
        **{k: v for k, v in kern.items() if k != "device_ms"},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--nccl-rank"]:
        sys.exit(nccl_child(int(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if len(sys.argv) > 1:
        sys.exit(f"usage: python3 {os.path.basename(__file__)} (it takes no arguments)")
    sys.exit(main())
