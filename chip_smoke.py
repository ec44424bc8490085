"""Smoke test of the PyTorch/CUDA port (``pyfastani_tpu_torch``) on one GPU.

Run from the root of a checkout, with one NVIDIA Hopper card visible:

    python3 chip_smoke.py

It builds the port's CUDA kernel from ``pyfastani_tpu_torch/csrc/`` and
runs these phases in order, one line each; any failure exits non-zero
without printing a result:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; exits 1 when ``torch.cuda.is_available()`` is false;
2. the kernel build (nvcc), timed;
3. the L2 chunk kernel against its plain torch version, bitwise (the
   range flag included, also on chunks that leave the store), on CUDA
   tensors at the query path's shapes, with both times;
4. the query path at a real size (10 random 2 Mbp references, 4 queries
   mutated at 3%): ``Sketch`` -> ``index()`` -> ``Mapper.query_genome``
   and ``Session.query_many``, held against the host NumPy engine of
   ``pyfastani_tpu`` (hits equal, identity ``==``), an unrelated query
   giving ``[]``, and the kernel launch count of that run;
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
   run.

Phases 4 to 6 each reset the kernel's launch counters before their run
and fail unless the kernel ran and its plain version did not.  The last
lines are the card, a JSON object with one entry per kernel (launches
summed over phases 4 to 6), and ``{"ok": true, "device": {...}}``.
Imports no JAX.
"""

from __future__ import annotations

import glob
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# phase 3: synthetic minimizer store and chunks at the query path's shapes
KERNEL_M = 1_600_000  # minimizers of 10 x 2 Mbp at w = 24
KERNEL_CONTIGS = 10
KERNEL_F, KERNEL_S = 3072, 384  # fragments per pass, sketch budget smax
KERNEL_N = 50_000  # chunks per pass
KERNEL_RMAX = 896  # range capacity R - 128 the presizer gives 10 x 2 Mbp
WIDE_N, WIDE_RMAX = 4096, 8064  # the largest presized range: > 48 KB smem
CMW, CMAX = 2985, 3072  # k = 16, l = 3000
TIMING_REPS = 10

# phase 4: the small-batch workload of bench.py
N_REFS, REF_LEN, N_QUERIES, MUT_RATE = 10, 2_000_000, 4, 0.03
# phase 6: 8 queries in groups of 2
PIPE_QUERIES, PIPE_Q_CAPACITY, PIPE_FRAG_CAPACITY = 8, 2, 2048
NCCL_TIMEOUT = 300


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ensure_native() -> str:
    """Build the host C extension in place when absent (it is not committed).

    Runs before anything imports ``pyfastani_tpu``, so the process loads
    the built module once and never its NumPy fallback."""
    pattern = os.path.join(ROOT, "pyfastani_tpu", "_native", "_native*.so")
    if glob.glob(pattern):
        return "present"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "setup.py", "-q", "build_ext", "--inplace"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    took = time.perf_counter() - t0
    if not glob.glob(pattern):
        return f"unbuilt, NumPy fallback (rc={proc.returncode}, {took:.1f} s)"
    return f"built in {took:.1f} s"


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


def phase_kernel(device, gpu: str) -> dict:
    import torch

    from pyfastani_tpu_torch.ops import l2

    rng = np.random.default_rng(11)
    result = None
    for name, n, rmax in (("main", KERNEL_N, KERNEL_RMAX), ("wide", WIDE_N, WIDE_RMAX)):
        args = kernel_case(rng, n, rmax, device)
        got = l2.l2_chunks(*args)
        want = l2.l2_chunks_reference(*args)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        if err != 0 or int(got[3]) != 0:
            raise AssertionError(f"l2_chunks kernel differs from the plain version ({name}): {err}")
        # some chunks leave the store or name no fragment row: both versions
        # skip them and raise the range flag
        bad = list(args)
        sel = torch.arange(n, device=device) % 97 == 0
        bad[5] = torch.where(sel, KERNEL_M - 1, args[5])
        bad[6] = torch.where(sel, 2, args[6])
        bad[7] = torch.where(torch.arange(n, device=device) % 89 == 0, KERNEL_F, args[7])
        got_bad = l2.l2_chunks(*bad)
        want_bad = l2.l2_chunks_reference(*bad)
        torch.cuda.synchronize()
        err_bad = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got_bad, want_bad))
        if err_bad != 0 or int(got_bad[3]) != 1:
            raise AssertionError(f"l2_chunks range flag differs from the plain version ({name})")
        # plain, kernel, kernel, plain: both sides see the same card state
        plain_a = time_ms(l2.l2_chunks_reference, args)
        kern_a = time_ms(l2.l2_chunks, args)
        kern_b = time_ms(l2.l2_chunks, args)
        plain_b = time_ms(l2.l2_chunks_reference, args)
        live = int(((args[6] > 0) & (args[9] > 0)).sum())
        kern_ms, plain_ms = min(kern_a, kern_b), min(plain_a, plain_b)
        log(
            f"[3] l2_chunks {name}: N={n} chunks ({live} live), rmax={rmax}, "
            f"S={KERNEL_S}, cmw={CMW}: bitwise equal, range flag 0, and 1 on equal "
            f"output with chunks off the store; kernel {kern_a:.3f}/{kern_b:.3f} ms, "
            f"plain {plain_a:.3f}/{plain_b:.3f} ms per call ({gpu})"
        )
        if result is None:
            result = dict(max_abs_err=err, ms=kern_ms, plain_ms=plain_ms)
    return result


def mutate(rng, base: np.ndarray, rate: float) -> np.ndarray:
    arr = base.copy()
    idx = rng.random(arr.shape[0]) < rate
    arr[idx] = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=int(idx.sum()))
    return arr


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

    import pyfastani_tpu

    host = pyfastani_tpu.Sketch(backend="numpy")
    for i, r in enumerate(refs):
        host.add_genome(f"ref{i}", r)
    host_mapper = host.index()
    t0 = time.perf_counter()
    for qi, q in enumerate(queries):
        want = host_mapper.query_genome(q)
        if not want or want[0].name != f"ref{qi % N_REFS}":
            raise AssertionError(f"host engine query {qi} gave {want}")
        if hit_key(many[qi]) != hit_key(want):
            raise AssertionError(f"query {qi}: port {many[qi]} != host engine {want}")
    t_host = time.perf_counter() - t0
    log(
        f"[4] hits of all {N_QUERIES} queries equal the host NumPy engine "
        f"(names, matches, fragments, identity ==; host {t_host:.1f} s); "
        f"unrelated query -> []; kernel launches {launches}, plain-version runs {plain_calls}"
    )
    return mapper, many, launches


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

    from pyfastani_tpu import _native
    from pyfastani_tpu.models._params import Parameters
    from pyfastani_tpu_torch.models._engine_torch import winnow_sequence_device

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

    log(f"[2] host C extension: {ensure_native()}")
    sys.path.insert(0, ROOT)
    import pyfastani_tpu_torch  # noqa: F401  (fails outside a checkout)
    from pyfastani_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load_library()
    took = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log().splitlines() if "registers" in ln]
    log(f"[2] kernel library built and loaded in {took:.1f} s; ptxas: {' | '.join(ptxas)}")

    device = torch.device("cuda", 0)
    kern = phase_kernel(device, gpu)
    refs, queries, unrelated = genomes()
    mapper, many, launches = phase_query(gpu, refs, queries, unrelated)
    launches += phase_mesh(gpu, mapper, queries, many)
    launches += phase_pipeline(gpu, mapper, queries)
    phase_ingest(gpu, refs)
    phase_nccl(gpu, mapper, queries[0], many[0])
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    print(gpu)
    print(json.dumps({"kernels": [{
        "name": "l2_chunks",
        "route": "cuda",
        "source": "pyfastani_tpu_torch/csrc/l2_chunks.cu",
        "replaces": "pyfastani_tpu/ops/l2_pallas.py:119",
        "launches": launches,
        **kern,
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
    sys.exit(main())
