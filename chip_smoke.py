"""Smoke test of the PyTorch/CUDA port (``pyfastani_tpu_torch``) on one GPU.

Run from the root of a checkout, with one NVIDIA Hopper card visible:

    python3 chip_smoke.py

With four cards visible it also runs the multi-card phases on them (5's
one cell a card, 8 and 10's ``(1, 4)`` mesh); with fewer, those print
one line each that they did not run.

It builds the port's host C extension (``pyfastani_tpu_torch/_native/``)
and CUDA kernels (``pyfastani_tpu_torch/csrc/``) and runs these phases in
order, one line each; any failure exits non-zero without printing a
result:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; exits 1 when ``torch.cuda.is_available()`` is false;
2. the two builds (host C compiler, nvcc: one process per kernel source,
   side by side), timed;
3. the L2 chunk kernel against its plain torch version, bitwise (the
   range flag included, also on chunks that leave the store), on CUDA
   tensors: a synthetic ``main`` case at the small batch's budgets, a
   ``wide`` one at the largest presized range, a ``huge`` one at
   ``rmax`` 16128, past shared memory (the kernel's scratch variant),
   and two captured from the path: after phase 4, ``real``, the operands
   of one L2 sweep of phase 4's small batch; after phase 10, ``ava``, the
   first L2 sweep of the all-vs-all.  Each with the kernel's and the
   plain version's times, the kernel alone in device time
   (``torch.profiler``), and its bound; then phase 12;
4. the query path at a real size (10 random 2 Mbp references, 4 queries
   mutated at 3%): ``Sketch`` -> ``index()`` -> ``Mapper.query_genome``
   and ``Session.query_many``, held against the port's host NumPy engine
   on a ``Sketch(device="cpu")`` ingested and indexed on its own
   (``Mapper._query_host``, L1 and L2 in NumPy; hits equal, identity
   ``==``), an unrelated query giving ``[]``, and the kernel launch
   count of that run;
5. phase 4's panel on a ``(2, 2)`` mesh (``ShardedSession``): four cards
   when there are four, else ``cuda:0`` in all four cells; hits equal
   phase 4's and the host engine's; each shard folded on its home card
   (the card of its cell ``(0, sh)``) and nowhere else, every other
   kernel launched on every card (`counted_by_card`); the bytes of slots
   and of limbs one pass moved between cards, beside the parent commit's
   placement counted from the same shapes (`parent_traffic`), and each
   card's launches and peak memory;
6. a steady ``query_many`` of 8 queries at ``q_capacity=2`` (4 groups
   through the two pinned staging slots) under
   ``torch.cuda.set_sync_debug_mode("error")``, so that no pass may wait
   for the device; hits equal each query run alone; then, outside that
   check, Mbp/s and the device idle share (as
   ``tools/torch_query_profile.py`` computes it);
7. the device ingest winnow (``winnow_sequence_device``) of one 2 Mbp
   reference, bitwise against the host C winnow, with Mbp/s;
8. (run last, after phase 10's four-card run) with four cards, four
   NCCL processes (``torch.distributed``, one card each, `nccl_child`):
   phase 4's panel on a ``(2, 2)`` mesh from its two-shard ``.npz``
   checkpoint, then the all-vs-all on a ``(1, 4)`` mesh from phase 10's
   four-shard one, each
   rank's hits equal to phase 4's and to phase 10's one-card run (4096
   hits); for each rank the index load, park and ``query_many`` times,
   Mbp/s, peak memory, the bytes one pass sent and gathered beside the
   parent's placement, and its launches (the fold once a pass a shard the
   rank is home of); otherwise one line says it did not run;
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
    over 90 s); with four cards, after the kernel checks on this phase's
    operands (phases 3, 12 to 14; in runs where the four-card phases came
    first, ``torch.profiler`` then recorded no device time on ``cuda:0``),
    the same on a ``(1, 4)`` mesh, the index split by genome, equal to
    the one-card hits, every kernel on every card, with phase 5's lines of
    bytes, launches and memory by card (its index then saved as phase 8's
    checkpoint), else one line says it did not run;
11. (run after phase 9, while phase 4's index is still parked) phase 4's
    batch as uppercase ``bytes``, lowercase ``bytes``, a mixed-case
    ``bytearray`` and a mixed-case uint8 ``ndarray``: the session stages
    raw bytes and the card uppercases them, so each kind's hits equal
    phase 4's; each pass's ``_fragments`` and ``_stage`` milliseconds;
12. (run after phase 3) the fragment winnow kernel
    (``csrc/winnow_fragments.cu``) against its plain torch version,
    bitwise (sketch, sizes, overflow flag), on CUDA tensors: the edge
    cases of `WINNOW_CASES` (palindromes, runs of N and other bytes, the
    window-0 quirk, an overflow, k not a multiple of 4, protein at w 1,
    one fragment, no window, a length past shared memory: the long
    route's scratch variant; the tile route's last position and one past
    it: the long route in shared memory; record counts on both sides of
    the register sort's 512; a warp's positions and one more at w 33),
    each on the route it names, and ``main``, the all-vs-all's shape (4096 fragments of
    3000 bytes, k 16, w 24, pad 4); and, captured from the path, ``real``
    (phase 4's first group) and ``ava`` (the all-vs-all's first group).
    ``main``, ``real`` and ``ava`` with the kernel's and the plain
    version's times, the kernel alone in device time and its bound;
13. (run after phase 12) the L1 candidate kernels
    (``csrc/l1_candidates.cu``: probe, then one block a fragment) against
    their plain torch version under the stage's exactness contract
    (`_l1_err`: both overflow flags always, ``iv_valid`` while the
    interval flag is clear, the bounds where ``iv_valid`` holds), on CUDA
    tensors: the synthetic cases of `L1_CASES` (``main`` at the
    all-vs-all's shape, minimum hits past 4 with a frequency threshold,
    the hit axis cut at T, an interval overflow, fragments and a batch
    without hits, sketch sizes 0 and past S, one fragment, a fragment
    past shared memory: the scratch variant, and fragments on both sides
    of the register merge sort's 1024 and 2048 hits), an empty index
    (U = M = 0, where the plain version cannot run: nothing found); and,
    captured from the path, ``real`` (phase 4's first group) and ``ava``
    (the all-vs-all's first group).  ``main``, ``trunc``, ``scratch``,
    ``real`` and ``ava`` with the kernels' and the plain version's times,
    the kernels alone in device time and their bound (`l1_work`), the
    call's device time split by kernel (probe, ``cumsum``, intervals,
    fill) and the 32-byte sectors it touches (`l1_sectors`).

14. (run after phase 13) the L2 sweep's chunk plan (``csrc/l2_sweep.cu``:
    ``l2_plan``, the contig lookup and the plan from the L1 stage's
    intervals in two launches tiled by intervals) and the sweep's merge
    with the gate + CGI, then the identity fold (``csrc/cgi.cu``:
    ``cgi_bins``, one launch that merges each interval's chunks, gates
    and keeps its mapping and writes the pass's flags row;
    ``fold_bins``) against their plain torch versions under their
    contracts (`_plan_err`: both flags, ``ends`` and the contigs always,
    the chunk operands on the live slots, 0 past them; `_cgi_err`: the
    flags row always, the kept slots, and the bins they give (their max
    into ``-inf`` bins, `densify`) bitwise, ``-inf`` included, while no
    flag is raised; `_fold_err`: every output, the merged flags, and the
    scratch all ``-inf`` after the fold), on CUDA tensors: the synthetic
    cases of `SWEEP_CASES` (``main`` at the all-vs-all's shape, more
    chunks than slots, ranges past their capacity, no valid interval, one
    interval of ten chunks, chunks past their contig's end, intervals off
    the plan's tile, chunk totals at and one past the slots, an interval
    across the last slot, contigs past the shared-memory table), each
    plan's chunks then given results (`plan_cgi_args`) for ``cgi_bins``,
    and of `CGI_CASES` (``main`` at the all-vs-all's shape, tied
    intervals, more intervals than a warp, two query genomes with padded
    rows, genomes of several contigs, chunks tied at an interval's best,
    intervals without chunks and invalid ones with chunks, a chunk total
    cut inside an interval), the plan on an empty store (M = 0, where
    the plain version cannot run) and the fold of slots that keep
    nothing; and, captured from the path, ``real`` (phase 4's first
    group), ``ava`` (the all-vs-all's first group) and ``draft`` (one
    ``Mapper.query_draft`` call on phase 10's panel: ``q_capacity`` 1).
    ``main``, ``real``, ``ava`` and ``draft`` with the wrappers' and the
    plain versions' times, each wrapper's device time (its kernels and
    output fills) and its bound (`plan_work`, `cgi_work`, `fold_work`;
    for CGI also the bound of the parent's merge + CGI, which wrote and
    read three int64 an interval, and for the fold that of the dense
    contract, which wrote and read every bin).
    After every pass of phases 4 to 6, 9, 10, 11 and 15, and every fold
    here, the session's scratch bins read all ``-inf`` (`check_scratch`);
15. (run after phase 11, before phase 10) the port's other parameter
    paths, the configurations of `PARAM_PATHS`, each through ``Sketch``
    -> ``add_draft`` -> ``index()`` -> ``Mapper.query_draft`` of every
    query (the cached one-genome session) and ``Session.query_many`` at
    ``q_capacity`` 16 (`param_path`): ``protein_bgc`` (protein, 100-residue
    fragments, w 1: the MIBiG golden of ``tests/data``, 130 of 176
    fragments against two references, through ``query_draft``,
    ``query_many`` and mappers pickled before and after ``index()``; then
    `bgc_panel`, 2,048 drafts of 24 proteins in families of four at 5%,
    about 49k contigs, past the contig lookup's shared table, every
    eighth query again with `X`, stops and lowercase residues,
    `odd_residues`, in one ``query_many`` call), ``nucl_k14_f1000`` (k 14,
    1 kb fragments: `phage_panel`, 1,024 genomes of 30-80 kb in families
    of four at 3%), ``nucl_f5000`` (5 kb fragments on phase 4's panel: the
    winnow's long route), ``nucl_k15`` (k 15 on `phage_panel`: the tile
    route's any-k instance at a one-byte shift), ``nucl_k21_f5000`` (k 21,
    5 kb fragments on phase 4's panel: the long route past k 16, where
    ``Sketch`` warns) and ``nucl_species95`` (identity 95, minimum
    fraction 0.5: `species_panel`, 130 genomes of 1-5 Mbp; then the same
    panel at the defaults, `species_defaults`); 32 queries of each panel
    (4 of phase 4's, 26 of the species panel).  Hits equal through both
    entry points, each query hits its family (or reference; at k 21 also
    unrelated pairs under identity 80, as the host engine does), the
    first two equal the port's CPU route (a ``Sketch(device="cpu")``
    ingested and indexed on its own) and the host engine; the routes
    taken (`param_routes`: the winnow's and its instance, asserted, the
    L2 kernel's variant, the contig lookup's table, global for
    ``protein_bgc``), budgets and escalations printed; the wall time of
    the first three at most `PARAM_SECONDS`, of `PARAM_MORE` at most
    `PARAM_MORE_SECONDS`.  Then each kernel against its plain version on
    the operands of each configuration's first group (the L2 kernel
    timed, as in phase 3).

Phases 4 to 6, 8 to 11 and 15 each reset the kernels' launch counters
before their run and fail unless every kernel ran and no plain version
did.  The last lines are the card, a JSON object with one entry per
kernel (launches summed over phases 4 to 6, 9, 10's steady pass, 11 and
15, and with four cards phase 10's four-card pass and phase 8's ranks;
times and bound at the case its ``case`` key names: ``real`` for the L2
kernel, ``ava`` for the others), and ``{"ok": true, "device":
{...}}``.
Takes no arguments.  Imports neither JAX nor anything of
``pyfastani_tpu``, and fails if either was loaded.
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
from bench_torch.work import HBM_BYTES_PER_S, INT32_OPS_PER_S, l2_chunks_work
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
# phase 8: four processes, one card each
NCCL_WORLD, NCCL_TIMEOUT = 4, 600
# phase 9: budgets small enough that phase 4's panel escalates (the tiny
# budgets of tests/test_torch_sharded.py would still overflow hmax after
# the session's six attempts on 2 Mbp genomes)
ESCALATE_BUDGETS = dict(hmax=32, ivmax=1, t_chunks=4, smax=128)
# phase 10: the host engine's check of g0 and g4 keeps g0 alone when the
# two would take longer than this
ORACLE_SECONDS = 90.0
# phase 12: the long route's working store is about 11 bytes a position,
# so a fragment this long passes the card's 227 KB of opt-in shared memory
WINNOW_SCRATCH_LENGTH = 30_000
# the tile route serves fragments of at most 3072 k-mer positions (256
# threads x 12), 384 a warp, and sorts up to 512 records in registers
WINNOW_TILE_POSITIONS = 3072
WINNOW_CASES = (
    "nucl_edges", "all_bytes", "overflow", "k15", "k18", "k5", "protein_w1",
    "one_fragment", "wide_window", "no_window", "scratch", "tile_full", "tile_past",
    "sort_edge", "warp_edge",
)
# phase 13: the L1 kernels' synthetic cases (`l1_case`); a fragment with
# this many hits passes the card's opt-in shared memory (~57K int32 slots)
L1_SCRATCH_HITS = 75_000
# the intervals kernel sorts up to 1024 hits with 4 a thread, up to 2048
# with 8, more in a bitonic network: `sort_edges` has fragments of these
# hits, each of one or a few long rows
L1_SORT_EDGE_HITS = (1024, 1025, 2048, 2049, 1023, 1203)
L1_CASES = (
    "main", "m_high", "trunc", "ovf_iv", "empty", "all_empty", "s_zero", "one_fragment",
    "scratch", "sort_edges",
)
# phase 15: the port's other parameter paths, each a `Sketch` keyword set,
# its panel (`param_panel`) and the winnow route its fragments take
# (`param_routes`)
PARAM_PATHS = {
    "protein_bgc": dict(protein=True, fragment_length=100),
    "nucl_k14_f1000": dict(k=14, fragment_length=1000),
    "nucl_f5000": dict(fragment_length=5000),
    "nucl_k15": dict(k=15),
    "nucl_k21_f5000": dict(k=21, fragment_length=5000),
    "nucl_species95": dict(percentage_identity=95, minimum_fraction=0.5),
}
PARAM_PANELS = {
    "protein_bgc": "bgc", "nucl_k14_f1000": "phages", "nucl_f5000": "phase 4",
    "nucl_k15": "phages", "nucl_k21_f5000": "phase 4", "nucl_species95": "species",
}
PARAM_ROUTES = {
    "protein_bgc": "tile, k 16 instance",
    "nucl_k14_f1000": "tile, any-k instance (d 2), 2-byte tail",
    "nucl_f5000": "long, shared store",
    "nucl_k15": "tile, any-k instance (d 1), 3-byte tail",
    "nucl_k21_f5000": "long, shared store, 1-byte tail",
    "nucl_species95": "tile, k 16 instance",
}
# the configurations added last, held to a wall limit of their own
# (`PARAM_MORE_SECONDS`; the others to `PARAM_SECONDS`)
PARAM_MORE = ("nucl_k15", "nucl_k21_f5000", "nucl_species95")
PARAM_SEED = 15
# a BGC database: drafts of 24 proteins of 150-600 residues over the 20
# amino acids, in families of four mutants at 5% substitutions
BGC_DRAFTS, BGC_PROTEINS, BGC_RESIDUES, BGC_RATE = 2048, 24, (150, 600), 0.05
# phages and plasmids: 30-80 kb genomes in families of four at 3%
PHAGE_GENOMES, PHAGE_LENGTHS, PHAGE_RATE = 1024, (30_000, 80_000), 0.03
# queried: one panel member in 64 (protein) or 32 (phages) through
# `query_draft` and `query_many` at this capacity; the first few against the
# CPU route and the host engine; the phase's wall time at most this
PARAM_QUERIES, PARAM_Q_CAPACITY, PARAM_CHECKED, PARAM_SECONDS = 32, 16, 2, 120.0
PARAM_MORE_SECONDS = 180.0
# species at FastANI's 95% ANI (Jain et al. 2018): genomes in bench.py's
# 1/2/3/5 Mbp mix (`AVA_LENGTHS`), in families of `SPECIES_FAMILY`: three
# members at `SPECIES_RATES[0]` substitutions from an ancestor, a fourth at
# `SPECIES_RATES[1]` (another species, which the 95% gate drops), and a
# chimera of the first member's length, its first `SPECIES_SHARE` a mutant
# of that member at the first rate and the rest random (same species, but
# under the fraction 0.5); the first member of each family is queried
SPECIES_FAMILIES, SPECIES_FAMILY, SPECIES_RATES, SPECIES_SHARE = 26, 5, (0.03, 0.2), 0.35
# the MIBiG golden of tests/test_ani.py: BGC0001428 against two copies of
# BGC0001425
MIBIG_GOLDEN = [("BGC0001425", 130, 176), ("BGC0001427", 130, 176)]
_ACGT = np.frombuffer(b"ACGT", np.uint8)
_AMINO = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
_NUCL = np.frombuffer(b"ACGTN", np.uint8)
_PROT = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX", np.uint8)


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


def kernel_device_ms(fn, args, key: str = "l2_chunks", reps: int = 20, tries: int = 3) -> float:
    """Device time of a kernel alone per call (the device kernels whose
    names hold ``key``: either variant), from a ``torch.profiler`` trace
    of ``reps`` calls.  A trace that holds none of the kernel's device
    time (seen once among the smoke's runs on an H100, and not again in
    the same sequence of calls) is taken again, up to ``tries`` traces;
    then it raises."""
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
        total = sum(e.self_device_time_total for e in device if key in e.key)
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


def _frag_rows(rng, alphabet, n_frag: int, length: int, pad: int = 4):
    frags = np.zeros((n_frag, length + pad), np.uint8)
    frags[:, :length] = rng.choice(alphabet, size=(n_frag, length))
    return frags


def _edge_rows(rng, length: int):
    """Random ACGT fragments with the edge cases written into the first
    ones."""
    frags = _frag_rows(rng, _ACGT, 8, length)
    frags[0, :length] = ord("A")  # poly-A: one hash everywhere
    frags[1, : length // 3] = ord("A")  # starts on a repeated hash
    frags[2, :length] = np.resize(_ACGT, length)  # palindromes
    frags[3, :length] = np.resize(np.frombuffer(b"AAAAAT", np.uint8), length)  # equal-hash ties
    frags[4, 100:400] = ord("N")  # a run of N
    frags[5, rng.random(length + 4) < 0.05] = ord("N")  # scattered N, also in the pad
    frags[6, :60] = np.resize(_ACGT, 60)  # starts on palindromes
    return frags


def winnow_case(name: str):
    """``(frags, k, w, length, protein, kc)`` of one case of
    `WINNOW_CASES` (``frags`` a numpy array), made from a seed: the inputs
    the winnow kernel has to get right."""
    rng = np.random.default_rng(sum(name.encode()))
    if name == "nucl_edges":
        return _edge_rows(rng, 3000), 16, 24, 3000, False, 512
    if name == "all_bytes":  # every byte value, the pad full of junk
        return rng.integers(0, 256, size=(4, 1004), dtype=np.uint8), 16, 24, 1000, False, 1024
    if name == "overflow":  # ~240 unique hashes against kc 64
        return _frag_rows(rng, _NUCL, 3, 3000), 16, 24, 3000, False, 64
    if name == "k15":
        return _edge_rows(rng, 800), 15, 10, 800, False, 256
    if name == "k18":
        return _frag_rows(rng, _NUCL, 5, 777), 18, 7, 777, False, 300
    if name == "k5":
        return _edge_rows(rng, 500), 5, 4, 500, False, 500
    if name == "protein_w1":
        frags = _frag_rows(rng, _PROT, 3, 900)
        frags[0, :900] = ord("W")
        return frags, 8, 1, 900, True, 1024
    if name == "one_fragment":
        return _frag_rows(rng, _NUCL, 1, 3000), 16, 24, 3000, False, 512
    if name == "wide_window":
        return _edge_rows(rng, 3000), 16, 700, 3000, False, 512
    if name == "no_window":  # w > positions: no window, empty sketches
        return _frag_rows(rng, _ACGT, 2, 40), 16, 30, 40, False, 64
    if name == "scratch":
        frags = _frag_rows(rng, _NUCL, 2, WINNOW_SCRATCH_LENGTH)
        frags[0, :5000] = ord("A")
        return frags, 16, 24, WINNOW_SCRATCH_LENGTH, False, 4096
    if name in ("tile_full", "tile_past"):  # the tile's last position, and one past it
        length = WINNOW_TILE_POSITIONS + 15 + (name == "tile_past")
        return _edge_rows(rng, length), 16, 24, length, False, 512
    if name == "sort_edge":  # 439-565 records: both sides of the register sort's 512
        frags = _frag_rows(rng, _ACGT, 8, 3000)
        for j in range(4):
            frags[4 + j, 100 : 100 + 150 * (j + 1)] = ord("N")
        return frags, 16, 10, 3000, False, 1024
    if name == "warp_edge":  # 385 positions: a warp's 384 and one; w past a warp
        return _edge_rows(rng, 399), 15, 33, 399, False, 128
    raise KeyError(name)


def winnow_work(args, s_sizes) -> dict:
    """The least work of one ``winnow_fragments(*args)`` call whose sketch
    sizes are ``s_sizes``, for its roofline bound.  Bytes: each fragment's
    ``length`` bytes and the complement table read once, the sketch, sizes
    and flag written once.  int32 operations a position: per strand,
    Murmur3's 7 a 4-byte block, 5 for a tail and 9 to finish; 2 to choose
    the canonical strand; 3 for the window minimum (prefix and suffix
    minima over blocks of w, then their minimum); 4 for the record test
    and its compaction.  Then ``s log2 s`` to sort each sketch of ``s``
    hashes."""
    import torch

    frags, k, w, length, protein, kc = args
    F = frags.shape[0]
    n_pos = max(0, length - k + 1)
    wout = max(0, min(kc, length - k - w + 2))
    strands = 1 if protein else 2
    per_pos = strands * (7 * (k // 4) + 5 * (k % 4 > 0) + 9) + 2 * (strands - 1) + 3 + 4
    s = s_sizes.double().cpu()
    sort = int((s * torch.ceil(torch.log2(s + 1))).sum())
    nbytes = F * length + 256 + F * wout * 8 + F * 4 + 4
    ops = F * n_pos * per_pos + sort
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / INT32_OPS_PER_S
    return dict(
        bytes=nbytes, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


def _ceil_log2(x):
    import torch

    return torch.ceil(torch.log2(x.clamp(min=1)))


def l1_hits(args):
    """``(n, probe_depth)``: each fragment's hits on the flat axis of
    ``l1_candidates(*args)`` (cut at T), and the binary-search steps each
    live probe's bucket needs, by torch ops on the operands' device."""
    import torch

    from pyfastani_tpu_torch._common import i32_to_hash

    q, s, uniq, _, row_len, _, thr, _, bucket, hmax, _, _, steps, _ = args
    F, S = q.shape
    live = torch.arange(S, device=q.device)[None, :] < s[:, None]
    U = uniq.shape[0]
    counts = torch.zeros(F, dtype=torch.int64, device=q.device)
    if U:
        h = i32_to_hash(uniq)
        r = torch.searchsorted(h, q)
        rc = r.clamp(max=U - 1)
        found = live & (r < U) & (h[rc] == q)
        lens = row_len[rc].long()
        counts = torch.where(found & (lens < thr), lens, 0).sum(dim=1)
    start = torch.cumsum(counts, 0) - counts
    n = (F * hmax - start).clamp(min=0).minimum(counts)
    bits = int(bucket.shape[0] - 1).bit_length() - 1
    b = (q[live] >> (32 - bits)).long()
    size = (bucket[b + 1] - bucket[b]).double()
    depth = torch.ceil(torch.log2(size + 1)).clamp(max=steps)
    return n, depth


def l1_work(args) -> dict:
    """The least work of one ``l1_candidates(*args)`` call, for its
    roofline bound, from this call's data.  Bytes: each live probe's
    hash (8), its bucket's two bounds (8), the 4-byte row hashes its
    binary search reads, and its row's length and start (8); each hit's
    posting (4); the sketch sizes; the outputs written once (two int32
    and one bool a column, two flags).  int32 operations: 4 a search
    step and 6 more a probe (the row test, the scan of lengths); a
    comparison sort of each fragment's n hits (``n ceil(log2 n)``) and 6
    a hit (its slot's probe, the candidate test, the merge scan)."""
    n, depth = l1_hits(args)
    F = args[0].shape[0]
    ivmax = args[10]
    live = int(depth.numel())
    nd = n.double()
    sort = int((nd * _ceil_log2(nd)).sum())
    nbytes = live * 24 + 4 * int(depth.sum()) + 4 * int(n.sum()) + 4 * F + F * ivmax * 9 + 2
    ops = 4 * int(depth.sum()) + 6 * live + sort + 6 * int(n.sum())
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / INT32_OPS_PER_S
    return dict(
        bytes=nbytes, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


def device_split(fn, args, reps: int) -> dict:
    """Device ms per call of each device kernel ``fn(*args)`` launches,
    by name, from a ``torch.profiler`` trace of ``reps`` calls."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        split = Counter()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                split[e.key[:96]] += e.self_device_time_total / 1e3 / reps
        if sum(split.values()) > 0:
            return split
    raise RuntimeError("torch.profiler recorded no device time in 3 traces")


def kernel_name(key: str) -> str:
    """A device kernel's function name from its profiler key:
    ``void (anonymous namespace)::l1_probe_kernel(long long const*, ...``
    gives ``l1_probe_kernel``, ``void at_cuda_detail::cub::DeviceScanKernel<...``
    ``DeviceScanKernel``."""
    name = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    for stop in "<(":
        name = name.split(stop)[0]
    return name.split("::")[-1]


def l1_sectors(args) -> dict:
    """The 32-byte sectors one ``l1_candidates(*args)`` call touches, a
    diagnostic beside `l1_work`'s byte bound: every read of the index is
    scattered over far more than the L2 holds, so each costs a sector.
    Both patterns count each live probe's bucket bounds, row length and
    row start (3), each found row's postings (the sectors they span), the
    sketch read and the outputs written.  ``search``: a binary search of
    one sector a step (the first design's probe); ``window``: the 16-entry window
    around the interpolated place (the sectors it spans; when it does not
    bracket the hash, a search of the rest of the bucket), or the
    search where the bucket is deeper than ``steps`` halvings reach."""
    import torch

    from pyfastani_tpu_torch._common import i32_to_hash

    q, s, uniq, row_start, row_len, _, thr, _, bucket, _, ivmax, _, steps, _ = args
    F, S = q.shape
    n, depth = l1_hits(args)
    live = torch.arange(S, device=q.device)[None, :] < s[:, None]
    base = 3 * int(depth.numel()) + (F * S * 8 + 31) // 32 + (F * ivmax * 9 + 31) // 32
    U = uniq.shape[0]
    window = int(depth.sum())
    if U:
        h = i32_to_hash(uniq)
        r = torch.searchsorted(h, q).clamp(max=U - 1)
        found = live & (h[r] == q) & (row_len[r].long() < thr)
        a = row_start[r][found].long() * 4
        b = a + row_len[r][found].long() * 4
        base += int(((b + 31) // 32 - a // 32).sum())
        bits = int(bucket.shape[0] - 1).bit_length() - 1
        ql = q[live]
        lo, hi = bucket[ql >> (32 - bits)].long(), bucket[(ql >> (32 - bits)) + 1].long()
        g = lo + (((ql & ((1 << (32 - bits)) - 1)) * (hi - lo)) >> (32 - bits))
        wa = torch.maximum(lo, torch.minimum(g - 6, hi - 16)).clamp(min=0) & ~3
        wa_lo, w_hi = torch.maximum(wa, lo), torch.minimum(wa + 16, hi)
        span = ((4 * w_hi + 31) // 32 - (4 * wa_lo) // 32).clamp(min=0)
        lb = torch.searchsorted(h, ql)
        outside = (lb < wa_lo) | (lb > w_hi)
        deep = (hi - lo) >> steps != 0
        window = int(torch.where(deep, depth, span + torch.where(outside, depth, 0)).sum())
    return dict(search=base + int(depth.sum()), window=base + window)


def _winnow_err(got, want) -> int:
    """The largest absolute difference of sketch and sizes (0 when equal);
    raises when the flags, shapes or types differ."""
    if got[0].dim() != 0 or bool(got[0]) != bool(want[0]):
        raise AssertionError(f"winnow_fragments overflow flag {got[0]} != plain {want[0]}")
    for g, w in zip(got[1:], want[1:]):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"winnow_fragments output {g.shape} {g.dtype} != {w.shape} {w.dtype}")
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got[1:], want[1:]))


def check_winnow(name: str, args, gpu: str, timed: bool = True) -> dict:
    """The winnow kernel against its plain version on ``args`` (CUDA
    tensors), bitwise; with ``timed``, both times (plain, kernel, kernel,
    plain), the kernel alone in device time and the bound."""
    import torch

    from pyfastani_tpu_torch.ops import fragments

    got = fragments.winnow_fragments(*args)
    want = fragments.winnow_fragments_reference(*args)
    torch.cuda.synchronize()
    err = _winnow_err(got, want)
    if err != 0:
        raise AssertionError(f"winnow_fragments kernel differs from the plain version ({name}): {err}")
    frags, k, w, length, protein, kc = args
    s = want[2]
    head = (f"[12] winnow_fragments {name}: F={frags.shape[0]} x {length} bytes (rows of "
            f"{frags.shape[1]}), k={k}, w={w}, protein={protein}, kc={kc}: bitwise equal "
            f"(sketch sizes {int(s.min()) if s.numel() else 0}-{int(s.max()) if s.numel() else 0}, "
            f"overflow {bool(want[0])})")
    if not timed:
        log(f"{head} ({gpu})")
        return dict(max_abs_err=err)
    plain_a = time_ms(fragments.winnow_fragments_reference, args)
    kern_a = time_ms(fragments.winnow_fragments, args)
    kern_b = time_ms(fragments.winnow_fragments, args)
    plain_b = time_ms(fragments.winnow_fragments_reference, args)
    alone = kernel_device_ms(fragments.winnow_fragments, args, "winnow_fragments")
    work = winnow_work(args, s)
    log(
        f"{head}; kernel {kern_a:.3f}/{kern_b:.3f} ms, plain {plain_a:.3f}/{plain_b:.3f} ms per "
        f"call, kernel alone {alone:.4f} ms of device time; bound {work['bound_ms']:.4f} ms by "
        f"{work['bound_by']} ({work['bytes']} B = {work['bytes_ms']:.4f} ms, {work['ops']} int32 "
        f"ops = {work['ops_ms']:.4f} ms), {100 * work['bound_ms'] / alone:.1f}% of it reached ({gpu})"
    )
    return dict(
        max_abs_err=err, ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
        device_ms=alone, bound_ms=work["bound_ms"], bound_by=work["bound_by"], library_ms=None,
    )


def winnow_route(lib, device, length: int, k: int, w: int) -> str:
    """The winnow kernel's route for fragments of ``length`` bytes at
    ``(k, w)``: ``tile``, ``long`` (its store in shared memory) or
    ``long, scratch``."""
    from pyfastani_tpu_torch.ops import fragments

    if lib.winnow_fragments_tile_route(length, k, w):
        return "tile"
    return "long, scratch" if fragments._store_bytes(device.index, length, k, w) else "long"


def phase_winnow(device, gpu: str) -> None:
    """Phase 12's synthetic cases: every edge case, then ``main``."""
    import torch

    from pyfastani_tpu_torch._build import load_library

    lib = load_library()
    for name in WINNOW_CASES:
        frags, k, w, length, protein, kc = winnow_case(name)
        route = winnow_route(lib, device, length, k, w)
        if (route == "long, scratch") != (name == "scratch") or (
                route == "long") != (name == "tile_past"):
            raise AssertionError(f"winnow case {name}: the {route} route")
        args = (torch.from_numpy(frags).to(device), k, w, length, protein, kc)
        check_winnow(f"{name} (the {route} route)", args, gpu, timed=False)
    main = _frag_rows(np.random.default_rng(12), _ACGT, 4096, 3000)
    check_winnow("main (the all-vs-all's shape)",
                 (torch.from_numpy(main).to(device), 16, 24, 3000, False, 512), gpu)


def _l1_table(S: int, ms=(1, 2, 3, 4), steps=(50, 150, 250)) -> np.ndarray:
    """A minimum-hits table by sketch size: ``ms[i]`` from size
    ``steps[i - 1]`` on (the shape of ``stats.min_hits_relaxed_table``)."""
    return np.asarray(ms, np.int32)[np.searchsorted(np.asarray(steps), np.arange(S + 1), "right")]


def l1_case(name: str):
    """The operands of one synthetic `l1_candidates` call of `L1_CASES`,
    as numpy arrays in the wrapper's order (``uniq_hash`` as uint32), made
    from a seed: a position-ordered minimizer store over contigs laid out
    ``l + 8`` apart, hashes drawn from a pool twice its size (most rows
    of 1 posting), its posting index and hash-prefix table, and fragments
    whose sketches are 90% of the hashes of an ``l``-long window of the
    store plus 5% hashes the index lacks.  ``main`` is the all-vs-all's
    shape (4096 fragments, S 384, hmax 1152); the others are small and
    each drives one edge of the kernels: minimum hits past 4 and a
    frequency threshold (``m_high``), the hit axis cut at T (``trunc``),
    more intervals than ``ivmax`` (``ovf_iv``), fragments without hits
    (``empty``) or a batch without any (``all_empty``), sketches of size
    0 and past S (``s_zero``), ``F = 1`` (``one_fragment``), and a
    fragment of `L1_SCRATCH_HITS` hits (``scratch``), and fragments of
    `L1_SORT_EDGE_HITS` hits on both sides of each of the intervals
    kernel's sort capacities (``sort_edges``)."""
    rng = np.random.default_rng(sum(name.encode()) + 13)
    l, S, F, hmax, ivmax, thr = 3000, 384, 48, 1024, 32, 2**31 - 1
    n_contigs, contig_len = 8, 500_000
    table = _l1_table(S)
    if name == "main":
        F, hmax, n_contigs, contig_len = 4096, 1152, 8, 2_000_000
    elif name == "m_high":
        table, thr = _l1_table(S, (1, 5, 6, 8)), 4
    elif name == "ovf_iv":
        table, ivmax = _l1_table(S, (1,), ()), 1
    elif name == "one_fragment":
        F = 1
    elif name == "scratch":
        F, hmax = 4, 24_000
    elif name == "sort_edges":
        F, hmax = len(L1_SORT_EDGE_HITS), 3000
    # the store: a minimizer every 1-23 bases, contigs l + 8 apart
    gap = l + 8
    per = contig_len // 12
    wpos = np.cumsum(rng.integers(1, 24, size=(n_contigs, per)), axis=1)
    wpos = np.minimum(wpos, contig_len - 1)
    gpos = (wpos + np.arange(n_contigs)[:, None] * (contig_len + gap)).reshape(-1)
    n_pool = 2 * gpos.shape[0]
    pool = np.unique(rng.integers(0, 2**32 - 1, size=n_pool, dtype=np.uint64)).astype(np.uint32)
    hid = rng.integers(0, pool.shape[0], size=gpos.shape[0])
    hashes = pool[hid]
    repeats = np.zeros(0, np.uint32)
    if name == "scratch":  # three hashes of long rows, tandem repeats
        repeats = pool[:3]
        per_row = L1_SCRATCH_HITS // 3 + 1
        rep_pos = np.arange(per_row) * 37 + 1000
        gpos = np.concatenate([gpos] + [rep_pos + j for j in range(3)])
        hashes = np.concatenate([hashes] + [np.full(per_row, h, np.uint32) for h in repeats])
    # sort_edges: rows of these lengths, tandem repeats; fragment f's
    # sketch is the rows rows_of[f] and a few absent hashes
    rows_of = ((0,), (0, 1), (2,), (2, 1), (3,), (4, 5, 6, 1))
    if name == "sort_edges":
        lengths = (1024, 1, 2048, 1023, 500, 700, 2)
        repeats = pool[~np.isin(pool, hashes)][: len(lengths)]
        runs = []
        for j, n in enumerate(lengths):  # every ~300th gap opens a new interval
            gaps = np.where(rng.random(n) < 1 / 300, 5000, rng.integers(1, 40, size=n))
            runs.append(1000 + j + np.cumsum(gaps))
        gpos = np.concatenate([gpos] + runs)
        hashes = np.concatenate(
            [hashes] + [np.full(n, h, np.uint32) for n, h in zip(lengths, repeats)])
    order = np.lexsort((gpos, hashes))
    post_gpos = gpos[order].astype(np.int32)
    uniq, row_start, row_len = np.unique(hashes[order], return_index=True, return_counts=True)
    bits = 10
    edges = np.arange((1 << bits) + 1, dtype=np.uint64) << np.uint64(32 - bits)
    bucket = np.searchsorted(uniq.astype(np.uint64), edges).astype(np.int32)
    deepest = int(np.diff(bucket).max(initial=0))
    steps = max(1, int(np.ceil(np.log2(deepest + 1))))

    # the fragments: a window of one contig, 90% of its hashes, 5% absent
    absent = rng.integers(0, 2**32 - 1, size=4 * S * F, dtype=np.uint64).astype(np.uint32)
    absent = absent[~np.isin(absent, uniq)]
    q = np.full((F, S), 0xFFFFFFFF, np.int64)
    s = np.zeros(F, np.int32)
    for f in range(F):
        if name == "all_empty" or (name == "empty" and f % 3 == 1):
            sk = absent[f * 200 : f * 200 + 200]
        elif name == "sort_edges":
            sk = np.concatenate([repeats[list(rows_of[f])], absent[f * 200 : f * 200 + 9]])
        elif name == "s_zero" and f % 4 == 0:
            sk = absent[:0]
        else:
            c = rng.integers(0, n_contigs)
            p = rng.integers(0, contig_len - l)
            row = wpos[c]
            win = hashes[c * per + np.nonzero((row >= p) & (row < p + l))[0]]
            win = win[rng.random(win.shape[0]) < 0.9]
            extra = absent[f * 200 : f * 200 + max(1, win.shape[0] // 20)]
            sk = np.concatenate([win, extra])
            if name == "s_zero" and f % 4 == 1:  # past S: the sketch is cut, s is not
                sk = np.concatenate([sk, absent[-2 * S :]])
            if name == "scratch" and f == 0:
                sk = np.concatenate([sk, repeats])
        sk = np.unique(sk.astype(np.int64))
        s[f] = sk.shape[0]
        q[f, : min(S, s[f])] = sk[:S]
    m_values = tuple(sorted({int(max(v, 1)) for v in table[: min(S, table.shape[0] - 1) + 1]}))
    case = (q, s, uniq, row_start.astype(np.int32), row_len.astype(np.int32), post_gpos,
            thr, table, bucket, hmax, ivmax, l, steps, m_values)
    if name == "trunc":  # about half the hits fit, and every interval
        total = int(l1_hits(l1_torch_args(case, "cpu"))[0].sum())
        case = case[:9] + (max(1, total // (2 * F)), 256) + case[11:]
    return case


def l1_torch_args(case, device):
    """`l1_case` operands as the wrapper takes them, on ``device``."""
    import torch

    from pyfastani_tpu_torch._common import bits_to_i32

    def put(a):
        return torch.from_numpy(np.array(a)).to(device)

    q, s, uniq, rs, rl, post, thr, table, bucket, *static = case
    return (put(q), put(s), put(bits_to_i32(uniq)), put(rs), put(rl), put(post), thr,
            put(table), put(bucket), *static)


def _l1_err(got, want) -> int:
    """The exactness contract of the L1 kernels against the plain version:
    raises unless shapes, types and both flags agree and, with the
    interval flag clear, ``iv_valid`` too; returns the largest absolute
    difference of the bounds where ``iv_valid`` holds (0 when the
    interval flag is set: the caller reruns that pass, the bounds are
    unconstrained)."""
    for name, g, w in zip(("iv_g0", "iv_g1", "iv_valid", "ovf_hits", "ovf_iv"), got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"l1_candidates {name}: {g.shape} {g.dtype} != {w.shape} {w.dtype}")
    for name, g, w in zip(("ovf_hits", "ovf_iv"), got[3:], want[3:]):
        if bool(g) != bool(w):
            raise AssertionError(f"l1_candidates {name} {bool(g)} != plain {bool(w)}")
    if bool(want[4]):
        return 0
    if not bool((got[2] == want[2]).all()):
        raise AssertionError("l1_candidates iv_valid differs from the plain version")
    valid = want[2]
    if not bool(valid.any()):
        return 0
    return max(int((g[valid].long() - w[valid].long()).abs().max()) for g, w in zip(got[:2], want[:2]))


def check_l1(name: str, args, gpu: str, timed: bool = True) -> dict:
    """The L1 kernels against their plain version on ``args`` (CUDA
    tensors) under `_l1_err`'s contract; with ``timed``, both times
    (plain, kernels, kernels, plain), the kernels alone in device time
    and the bound."""
    import torch

    from pyfastani_tpu_torch.ops import l1

    got = l1.l1_candidates(*args)
    want = l1.l1_candidates_reference(*args)
    torch.cuda.synchronize()
    err = _l1_err(got, want)
    if err != 0:
        raise AssertionError(f"l1_candidates kernels differ from the plain version ({name}): {err}")
    q, hmax, ivmax = args[0], args[9], args[10]
    n, _ = l1_hits(args)
    cap = l1._shared_slots(q.device.index, hmax, q.shape[1])
    head = (f"[13] l1_candidates {name}: F={q.shape[0]}, S={q.shape[1]}, hmax={hmax}, "
            f"ivmax={ivmax}, m_values={args[13]}: {int(n.sum())} hits (at most "
            f"{int(n.max()) if n.numel() else 0} a fragment, {int((n > cap).sum())} fragment(s) "
            f"past the {cap} shared slots), {int(want[2].sum())} intervals, overflow "
            f"hits/intervals {bool(want[3])}/{bool(want[4])}: equal under the contract")
    if not timed:
        log(f"{head} ({gpu})")
        return dict(max_abs_err=err, scratch_fragments=int((n > cap).sum()))
    plain_a = time_ms(l1.l1_candidates_reference, args)
    kern_a = time_ms(l1.l1_candidates, args)
    kern_b = time_ms(l1.l1_candidates, args)
    plain_b = time_ms(l1.l1_candidates_reference, args)
    alone = kernel_device_ms(l1.l1_candidates, args, "l1_")
    work = l1_work(args)
    split = device_split(l1.l1_candidates, args, 20)
    sectors = l1_sectors(args)
    log(
        f"{head}; kernels {kern_a:.3f}/{kern_b:.3f} ms, plain {plain_a:.3f}/{plain_b:.3f} ms per "
        f"call, kernels alone {alone:.4f} ms of device time; bound {work['bound_ms']:.4f} ms by "
        f"{work['bound_by']} ({work['bytes']} B = {work['bytes_ms']:.4f} ms, {work['ops']} int32 "
        f"ops = {work['ops_ms']:.4f} ms), {100 * work['bound_ms'] / alone:.1f}% of it reached; "
        f"device ms a call by kernel: "
        f"{', '.join(f'{kernel_name(name)} {ms:.4f}' for name, ms in split.most_common())}"
        f"; 32-byte sectors {sectors['window']} = {1e3 * 32 * sectors['window'] / HBM_BYTES_PER_S:.4f}"
        f" ms at the bytes rate ({sectors['search']} with a binary-search probe) ({gpu})"
    )
    return dict(
        max_abs_err=err, ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
        device_ms=alone, bound_ms=work["bound_ms"], bound_by=work["bound_by"], library_ms=None,
        scratch_fragments=int((n > cap).sum()),
    )


def l1_no_index(device):
    """`l1_case` ``one_fragment`` against an empty index (U = M = 0), where
    the plain version cannot run: the kernels find nothing."""
    case = list(l1_case("one_fragment"))
    for i in (2, 3, 4, 5):
        case[i] = case[i][:0]
    case[8] = np.zeros_like(case[8])
    return l1_torch_args(case, device)


def phase_l1(device, gpu: str) -> None:
    """Phase 13's synthetic cases: every case of `L1_CASES` (``main``,
    ``trunc`` and ``scratch`` timed), then an empty index."""
    import torch

    from pyfastani_tpu_torch.ops import l1

    for name in L1_CASES:
        res = check_l1(name, l1_torch_args(l1_case(name), device), gpu,
                       timed=name in ("main", "trunc", "scratch"))
        if (res["scratch_fragments"] > 0) != (name == "scratch"):
            raise AssertionError(f"l1 case {name}: {res['scratch_fragments']} scratch fragments")
    iv_g0, iv_g1, iv_valid, ovf_hits, ovf_iv = l1.l1_candidates(*l1_no_index(device))
    torch.cuda.synchronize()
    if bool(iv_valid.any()) or bool(ovf_hits) or bool(ovf_iv) or bool(iv_g0.any()) or bool(iv_g1.any()):
        raise AssertionError("l1_candidates found intervals in an empty index")
    log(f"[13] l1_candidates on an empty index (U = M = 0): no interval, no flag ({gpu})")


# phase 14: the L2 sweep's chunk plan (`csrc/l2_sweep.cu`) and its merge
# with the gate + CGI, and the identity fold (`csrc/cgi.cu`); synthetic
# cases of `sweep_case` and `cgi_case`
SWEEP_CASES = ("main", "overflow", "range", "empty", "one_interval", "contig_edges",
               "tile_edge", "at_slots", "one_past", "straddle", "many_contigs")
# the cases whose chunk total passes their slots
SWEEP_OVERFLOW = ("overflow", "one_past", "straddle")
CGI_CASES = ("main", "ties", "wide_iv", "q2_padded", "draft", "chunk_ties", "no_chunks",
             "chunk_overflow")
SWEEP_CMW, SWEEP_CMAX = 2985, 3072  # k = 16, l = 3000, as the presizer gives


def _positions(rng, n_contigs: int, contig_len: int, gap: int = 3008, pads: int = 16):
    """A position-ordered store's global positions (a minimizer every 1-23
    bases of each contig, contigs ``gap`` apart, ``GBIG`` pads at the end),
    with ``contig_offset``, ``cof_idx`` and the prefix-bucket table, its
    shift and depth: the planes `l2_plan` reads."""
    from pyfastani_tpu_torch._common import GBIG
    from pyfastani_tpu_torch.index import _build_gpos_bucket

    offs = np.arange(n_contigs + 1, dtype=np.int64) * (contig_len + gap)
    per = contig_len // 13
    rows = np.minimum(np.cumsum(rng.integers(1, 24, size=(n_contigs, per)), axis=1),
                      contig_len - 1)
    # each row ascends strictly but for the clamp at its end: keep the first of a run
    new = np.ones(rows.shape, bool)
    new[:, 1:] = rows[:, 1:] != rows[:, :-1]
    gpos = (rows + offs[:n_contigs, None])[new]
    gpos = np.concatenate([gpos, np.full(pads, GBIG)]).astype(np.int32)
    bucket, shift, depth = _build_gpos_bucket(gpos[None, :])
    return offs.astype(np.int32), np.searchsorted(gpos, offs).astype(np.int32), gpos, bucket[0], shift, depth


def sweep_case(name: str):
    """The operands of one synthetic `l2_plan` call of `SWEEP_CASES`, as
    numpy arrays and ints in the wrapper's order, made from a seed: the
    candidate intervals of F fragments as global positions (``ivmax``
    columns each, a share valid, a few starting before their contig, the
    columns past them junk that nothing but the contig lookup may read)
    over a store of contigs.  ``main`` is the all-vs-all's shape (F 4096,
    ivmax 32, t_chunks 37: 151,552 chunk slots); the others are small and
    each drives one edge: more chunks than slots (``overflow``), ranges
    past ``rcap`` (``range``), no valid interval (``empty``), one interval
    of ten chunks (``one_interval``), short contigs whose chunks' windows
    end past the contig (``contig_edges``), 1,037 intervals, two past a
    tile of the kernels (``tile_edge``), a chunk total of exactly the
    slots (``at_slots``) and of one more (``one_past``), an interval of
    several chunks across the last slot (``straddle``), and 12,000
    contigs, past the kernels' shared-memory table (``many_contigs``)."""
    rng = np.random.default_rng(sum(name.encode()) + 14)
    F, ivmax, t_chunks, frac, span_hi, rcap = 64, 8, 37, 0.6, SWEEP_CMAX, 896
    n_contigs, contig_len = 8, 200_000
    if name == "main":
        F, ivmax, frac, span_hi, n_contigs, contig_len = 4096, 32, 0.5, 2 * SWEEP_CMAX, 64, 2_000_000
    elif name == "overflow":
        t_chunks, frac, span_hi = 2, 0.9, 4 * SWEEP_CMAX
    elif name == "range":
        rcap = 64
    elif name == "empty":
        frac = 0.0
    elif name == "one_interval":
        F, ivmax, t_chunks = 1, 1, 16
    elif name == "contig_edges":
        F, n_contigs, contig_len = 128, 200, 6_000
    elif name == "tile_edge":
        F, ivmax = 1037, 1
    elif name in ("at_slots", "one_past", "straddle"):
        span_hi = 3 * SWEEP_CMAX
    elif name == "many_contigs":
        F, n_contigs, contig_len = 256, 12_000, 3_000
    coff, cof, gpos, bucket, shift, depth = _positions(rng, n_contigs, contig_len)
    NI = F * ivmax
    n_f = rng.binomial(ivmax, frac, size=F)
    valid = (np.arange(ivmax)[None, :] < n_f[:, None]).reshape(-1)
    seq = rng.integers(0, n_contigs, NI)
    c0 = rng.integers(0, contig_len, NI)
    if name == "contig_edges":
        c0 = contig_len - rng.integers(1, 2 * SWEEP_CMAX, NI).clip(max=contig_len)
    c1 = np.minimum(c0 + rng.integers(1, span_hi + 1, NI) - 1, contig_len - 1)
    if name == "one_interval":
        valid[:], seq[:], c0[:], c1[:] = True, 3, 1000, 1000 + 10 * SWEEP_CMAX - 1
    # a window that starts before its contig: the lookup clamps it to 0
    early = rng.random(NI) < 0.05
    c0[early] = 0
    c1[early] = np.minimum(rng.integers(0, span_hi, int(early.sum())), contig_len - 1)
    base = coff[seq].astype(np.int64)
    g0, g1 = base + c0, base + c1
    g0[early] -= rng.integers(1, 3000, int(early.sum()))
    junk = ~valid
    g0[junk] = rng.integers(-5000, int(coff[-1]) + 5000, int(junk.sum()))
    g1[junk] = rng.integers(-5000, int(coff[-1]) + 5000, int(junk.sum()))
    ch_max = -(-F * t_chunks // 256) * 256
    n_ch = np.where(valid, -(-(c1 - c0 + 1) // SWEEP_CMAX), 0)
    total = int(n_ch.sum())
    if name == "at_slots":
        ch_max = total
    elif name == "one_past":
        ch_max = total - 1
    elif name == "straddle":  # the last slot is the second chunk of an interval
        wide = np.flatnonzero(n_ch >= 3)
        i = int(wide[len(wide) // 2])
        ch_max = int(n_ch[:i].sum()) + 2
    return (g0.astype(np.int32).reshape(F, ivmax), g1.astype(np.int32).reshape(F, ivmax), valid,
            ivmax, coff, cof, gpos, bucket, shift, depth, SWEEP_CMW, SWEEP_CMAX, rcap, ch_max)


def torch_args(case, device):
    """A case's numpy operands as tensors on ``device`` (a tuple of them, as
    `cgi_bins`' flags, a tuple of tensors), ints as they are."""
    import torch

    def put(a):
        if isinstance(a, tuple):
            return tuple(put(x) for x in a)
        return torch.from_numpy(np.array(a)).to(device) if isinstance(a, np.ndarray) else a

    return tuple(put(a) for a in case)


def _flags(raised=()):
    """The six 0-d flags as the session passes them to `cgi_bins` (the five
    budget overflows, bool, then the L2 range flag, int32), those named by
    index in ``raised`` set."""
    from pyfastani_tpu_torch.session import _N_FLAGS

    return tuple(np.array(i in raised, np.int32 if i == _N_FLAGS - 1 else np.bool_)
                 for i in range(_N_FLAGS))


def _cgi_tables(rng, F: int, q: int, C: int, per_genome: int, smax: int = 384, k: int = 16):
    """A `cgi_bins` call's per-fragment operands and tables, from a seed:
    sketch sizes, query genomes, the gate and identity tables, each contig's
    genome and the genome count."""
    from pyfastani_tpu_torch import stats

    s = rng.integers(150, smax + 1, F).astype(np.int32)
    qg = rng.integers(0, q, F).astype(np.int32)
    gate = np.asarray(stats.l2_gate_table(smax, k, 80.0))
    ident = np.asarray(stats.identity_table(smax, k))
    s2g = (np.arange(C) // per_genome).astype(np.int32)
    return s, qg, gate, ident, s2g, -(-C // per_genome)


def _chunks(rng, tgt, n_ch, bin_max: int, l: int, spread: int = 3):
    """Chunk results of intervals with ``n_ch`` chunks each, back to back:
    each chunk's best ``tgt`` of its interval less ``[0, spread)``, one
    chunk of each interval at ``tgt`` itself, so that chunks of one
    interval tie; anchors drawn in ``bin_max`` bins of ``l``.  Returns
    ``(cbest, cfirst, clast, ends)``."""
    ends = np.cumsum(n_ch).astype(np.int64)
    owner = np.repeat(np.arange(tgt.shape[0]), n_ch)
    cbest = tgt[owner] - rng.integers(0, spread, owner.shape[0])
    top = (ends - n_ch + rng.integers(0, 1 << 30, tgt.shape[0]) % np.maximum(n_ch, 1))[n_ch > 0]
    cbest[top] = tgt[n_ch > 0]
    cfirst = rng.integers(0, bin_max * l, owner.shape[0])
    clast = cfirst + rng.integers(0, 2 * l, owner.shape[0])
    return cbest, cfirst, clast, ends


def cgi_case(name: str):
    """The operands of one synthetic `cgi_bins` call of `CGI_CASES`, as
    numpy arrays and ints in the wrapper's order, made from a seed: the
    chunk results of F fragments' intervals, each interval's best shared
    count around the gate so that some map and some do not, and the
    slots past the chunks junk that nothing may read.  ``main`` is the
    all-vs-all's shape (F 4096, ivmax 32, q 16, 512 one-contig genomes,
    bin_max 1728); ``ties`` puts two intervals of one fragment on one
    genome at one identity (and more ties across a genome's contigs);
    ``wide_iv`` has ivmax 80, past a warp; ``q2_padded`` two query genomes
    and padded rows; ``draft`` one query genome against genomes of several
    contigs; ``chunk_ties`` three to five chunks an interval, most of them
    tied at the interval's best (the first anchor the smallest of theirs,
    the last the largest); ``no_chunks`` valid intervals without a chunk
    slot and invalid ones with chunks; ``chunk_overflow`` a chunk total
    past the slots, cut inside an interval's chunks, with its flag
    raised."""
    rng = np.random.default_rng(sum(name.encode()) + 15)
    F, ivmax, q, C, per_genome, bin_max, smax, l = 64, 8, 2, 24, 3, 64, 384, 3000
    if name == "main":
        F, ivmax, q, C, per_genome, bin_max = 4096, 32, 16, 512, 1, 1728
    elif name == "ties":
        F, ivmax, q, C, per_genome = 8, 4, 1, 6, 2
    elif name == "wide_iv":
        ivmax = 80
    elif name == "draft":
        F, q, C, per_genome, bin_max = 512, 1, 64, 8, 400
    s, qg, gate, ident, s2g, g_max = _cgi_tables(rng, F, q, C, per_genome, smax)
    NI = F * ivmax
    valid = rng.random(NI) < 0.6
    seq = rng.integers(0, C, NI)
    g_iv = gate[np.minimum(np.repeat(s, ivmax), gate.shape[0] - 1)]
    tgt = np.clip(g_iv + rng.integers(-3, 6, NI), -1, smax)
    n_ch = np.where(valid, rng.integers(1, 4, NI), 0)
    spread = 3
    if name == "ties":  # fragment 0: intervals 1 and 3 tie on genome 0, 0 below them
        valid[:4], seq[:4], n_ch[:4] = True, [0, 1, 4, 0], [1, 2, 1, 3]
        tgt[1] = tgt[3] = g_iv[0] + 2
        tgt[0], tgt[2] = tgt[1] - 1, g_iv[0] + 4
    if name == "q2_padded":  # the last quarter of the rows is padding
        pad = np.arange(F) >= 3 * F // 4
        s[pad], qg[pad] = 0, 0
        valid[np.repeat(pad, ivmax)] = False
        n_ch[np.repeat(pad, ivmax)] = 0
    if name == "chunk_ties":
        n_ch, spread = np.where(valid, rng.integers(3, 6, NI), 0), 2
    if name == "no_chunks":  # a third of the valid intervals lose their chunks,
        # half the invalid ones get chunks over the gate
        n_ch[valid & (rng.random(NI) < 0.35)] = 0
        junk = ~valid & (rng.random(NI) < 0.5)
        n_ch[junk] = rng.integers(1, 4, int(junk.sum()))
        tgt[junk] = np.minimum(g_iv[junk] + 5, smax)
    cbest, cfirst, clast, ends = _chunks(rng, tgt, n_ch, bin_max, l, spread)
    total = int(ends[-1])
    ch_max = -(-total // 256) * 256 + 256
    raised = (0, 5) if name == "wide_iv" else ()  # a bool flag and the int32 one
    if name == "chunk_overflow":  # the last slot is an inner chunk of an interval
        i = int(np.flatnonzero(n_ch >= 2)[len(np.flatnonzero(n_ch >= 2)) // 2])
        ch_max, raised = int(ends[i]) - 1, (3,)
    # past the chunks: junk that nothing reads
    pad = ch_max - total
    if pad > 0:
        cbest = np.concatenate([cbest, rng.integers(0, smax, pad)])
        cfirst = np.concatenate([cfirst, rng.integers(-(2**31), 2**31 - 1, pad)])
        clast = np.concatenate([clast, rng.integers(-(2**31), 2**31 - 1, pad)])
    cbest, cfirst, clast = (a[:ch_max].astype(np.int32) for a in (cbest, cfirst, clast))
    return (cbest, cfirst, clast, ends, valid, seq, s, qg, gate, ident, s2g,
            SWEEP_CMW, l, ivmax, bin_max, g_max, q, _flags(raised))


def plan_cgi_args(plan, case, seed: int = 5):
    """`cgi_bins` operands for a plan's outputs (``plan``, of `sweep_case`
    operands ``case``, tensors): chunk results drawn from a seed around the
    gate of each chunk's fragment, the plan's ``ends`` and contigs, two
    query genomes, two contigs a genome, and the flags with the plan's two."""
    import torch

    rng = np.random.default_rng(seed)
    valid, ivmax = case[2], case[3]
    F, C, ch_max, l, bin_max = valid.shape[0] // ivmax, case[4].shape[0] - 1, plan[0].shape[0], \
        3000, 64
    s, qg, gate, ident, s2g, g_max = _cgi_tables(rng, F, 2, C, 2)
    frag = plan[2].cpu().numpy()
    cbest = gate[np.minimum(s[frag], gate.shape[0] - 1)] + rng.integers(-3, 6, ch_max)
    cfirst = rng.integers(0, bin_max * l, ch_max)
    clast = cfirst + rng.integers(0, 2 * l, ch_max)
    dev = plan[0].device
    put = torch_args((cbest.astype(np.int32), cfirst.astype(np.int32), clast.astype(np.int32),
                      s, qg, gate, ident, s2g, _flags()), dev)
    flags = put[8][:3] + (plan[7], plan[8]) + put[8][5:]
    return (*put[:3], plan[5], valid, plan[6], *put[3:8], SWEEP_CMW, l, ivmax, bin_max, g_max,
            2, flags)


def fold_args(slots, case, flags=None):
    """`fold_bins` operands for `cgi_bins` operands ``case`` (tensors) and
    their slots (`cgi_bins`' output; its flags row is not read): a fresh
    ``-inf`` scratch and ``(3, q, g_max)`` output on the slots' device, and
    with ``flags`` (int32 rows of 6) their merge into a fresh
    ``out_flags``."""
    import torch

    s2g, bin_max, g_max, q = case[10], case[14], case[15], case[16]
    slots = slots[:2]
    dev = slots[0].device
    scratch = torch.full((q * s2g.shape[0] * bin_max,), -np.inf, device=dev)
    out = torch.empty((3, q, g_max), dtype=torch.int64, device=dev)
    out_flags = None if flags is None else torch.zeros(flags.shape[-1], dtype=torch.int64,
                                                        device=dev)
    return (*slots, scratch, s2g, q, bin_max, g_max, out, flags, out_flags)


def fold_fresh(args):
    """``fold_bins`` operands with their outputs fresh: a new ``out``, and
    a new ``out_flags`` when the flags merge."""
    import torch

    out_flags = args[9]
    return (*args[:7], torch.empty_like(args[7]), args[8],
            None if out_flags is None else torch.zeros_like(out_flags))


def second_row(slots, shift: int):
    """A second data row of one shard for `cgi_bins`' slots: the same kept
    bins, the first, third, ... kept slot's identity 0.01 above the first
    row's and the others' 0.01 below, so the bins' maxima come from both
    rows; rolled by ``shift`` slots."""
    import torch

    slot_bin, slot_ident = slots[:2]
    kept = slot_bin >= 0
    step = torch.where(torch.cumsum(kept, 0) % 2 == 1, 0.01, -0.01).to(slot_ident.dtype)
    ident = torch.where(kept, slot_ident + step, slot_ident)
    return slot_bin.roll(shift), ident.roll(shift)


def densify(slots, n_bins: int):
    """The dense per-(query genome, contig, bin) best identity of `cgi_bins`'
    slots: their max into ``n_bins`` bins of ``-inf`` (the JAX package's
    ``best_bin``)."""
    import torch

    slot_bin, slot_ident = slots[:2]
    kept = slot_bin >= 0
    bins = torch.full((n_bins,), -np.inf, device=slot_bin.device)
    return bins.scatter_reduce_(0, slot_bin[kept], slot_ident[kept], "amax")


def cgi_bins_count(args) -> int:
    """``q_count * C * bin_max`` of a `cgi_bins` call."""
    return args[16] * args[10].shape[0] * args[14]


def scratch_clean(scratch, where: str) -> None:
    """Raises unless every scratch bin reads ``-inf``."""
    import torch

    if not bool(torch.isneginf(scratch).all()):
        raise AssertionError(f"{where}: the fold left scratch bins other than -inf")


def check_scratch(session, where: str) -> None:
    """After a session's passes: the scratch bins of every shard it is
    home of all ``-inf``, on the device of the shard's home cell ``(0,
    sh)``, none dirty."""
    import torch

    for dev in session._devices:
        torch.cuda.synchronize(dev)
    if session._scratch_dirty:
        raise AssertionError(f"{where}: the session's scratch is marked dirty")
    if sorted(session._scratch) != session._homes:
        raise AssertionError(f"{where}: scratch of shards {sorted(session._scratch)}, "
                             f"home of {session._homes}")
    for sh, scratch in session._scratch.items():
        if scratch.device != session.mesh.devices[0][sh]:
            raise AssertionError(f"{where}: shard {sh}'s scratch on {scratch.device}, its home "
                                 f"is {session.mesh.devices[0][sh]}")
        scratch_clean(scratch, f"{where}, shard {sh}")


def _same_shape(what: str, got, want) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{what} output {i}: {g.shape} {g.dtype} != {w.shape} {w.dtype}")


def _plan_err(got, want) -> int:
    """The contract of `l2_plan`'s kernels against the plain version:
    raises unless shapes, types, both flags, ``ends`` and the contigs
    ``iv_seq`` agree, and both hold ``rlen = ch_len = ch_c0 = 0`` on the
    slots at and past ``min(total, ch_max)``; returns the largest absolute
    difference of the five chunk operands on the slots below it."""
    _same_shape("l2_plan", got, want)
    for name, g, w in zip(("overflow", "rovf"), got[7:], want[7:]):
        if bool(g) != bool(w):
            raise AssertionError(f"l2_plan {name} {bool(g)} != plain {bool(w)}")
    if not bool((got[5] == want[5]).all()):
        raise AssertionError("l2_plan ends differ from the plain version")
    if not bool((got[6] == want[6]).all()):
        raise AssertionError("l2_plan contigs (iv_seq) differ from the plain version")
    live = min(int(want[5][-1]), want[0].shape[0])
    for out in (got, want):
        for i in (1, 3, 4):
            if bool(out[i][live:].any()):
                raise AssertionError(f"l2_plan output {i} is not 0 past the live slots")
    if live == 0:
        return 0
    return max(int((g[:live].long() - w[:live].long()).abs().max())
               for g, w in zip(got[:5], want[:5]))


def _cgi_err(got, want, flagged: bool = False, n_bins: int | None = None) -> float:
    """The contract of `cgi_bins`' kernel: the flags row equal always; with
    the pass's flags clear, the slots ``(slot_bin, slot_ident)`` equal, and
    the bins they give (`densify` into ``n_bins``, by default one past the
    largest kept bin) bitwise equal; raises when the flags row, a slot's
    bin, an empty (``-inf``) bin or a bit pattern differs, returns the
    largest absolute difference of the occupied bins (0.0 when a flag is
    raised)."""
    import torch

    _same_shape("cgi_bins", got, want)
    if len(got) != 3 or not bool((got[2] == want[2]).all()):
        raise AssertionError("cgi_bins flags row differs from the plain version")
    if flagged:
        return 0.0
    if not bool((got[0] == want[0]).all()):
        raise AssertionError("cgi_bins kept slots differ from the plain version")
    if n_bins is None:
        n_bins = int(want[0].max()) + 1 if want[0].numel() else 0
    got, want = densify(got, n_bins), densify(want, n_bins)
    if not bool((torch.isinf(got) == torch.isinf(want)).all()):
        raise AssertionError("cgi_bins empty bins differ from the plain version")
    fin = ~torch.isinf(want)
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    if err == 0.0 and not bool((got.view(torch.int32) == want.view(torch.int32)).all()):
        raise AssertionError("cgi_bins bins differ from the plain version in their bits")
    return err


def _fold_err(got, want) -> int:
    """The contract of `fold_bins`' kernel: every output equal; returns the
    largest absolute difference."""
    _same_shape("fold_bins", got, want)
    return max(int((g - w).abs().max()) if g.numel() else 0 for g, w in zip(got, want))


def _bound(nbytes: int, ops: int) -> dict:
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / INT32_OPS_PER_S
    return dict(
        bytes=nbytes, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


def plan_work(args, out) -> dict:
    """The least work of ``l2_plan(*args)``, whose plain outputs are
    ``out``, from this call's data.  Bytes: each interval's flag and last
    position read (for its contig), a valid one's first position, its
    contig and running chunk count written (int64 each); the contig
    tables; each live slot's (below ``min(total, ch_max)``) two searches'
    bucket bounds (8 bytes each) and the store positions they read (one a
    step: each search's bucket needs ``ceil(log2(size + 1))`` steps, at
    most ``steps``); each slot's five int32 operands written.  int32
    operations: 3 a step of each interval's contig search
    (``ceil(log2(C + 2))`` steps) and 6 more an interval; 30 a live slot
    and 4 a store search step.  A slot past the live ones has no range,
    so it reads and searches nothing."""
    import torch

    from pyfastani_tpu_torch._common import BIG

    _, _, valid, _, coff, _, _, bucket, shift, steps, cmw, _, _, ch_max = args
    ch_c0, ch_len, ends, seq = out[3].long(), out[4].long(), out[5], out[6]
    NI, C1 = valid.shape[0], coff.shape[0]
    live = min(int(ends[-1]), ch_max)
    owner = torch.searchsorted(ends, torch.arange(live, device=ends.device), right=True)
    base = coff[seq[owner]].long()
    c0, ln = ch_c0[:live], ch_len[:live]
    keys = torch.cat([base + c0, base + (c0 + ln - 1 + cmw).clamp(max=BIG)])
    b = (keys >> shift).clamp(0, bucket.shape[0] - 2)
    size = (bucket[b + 1] - bucket[b]).double()
    depth = int(torch.ceil(torch.log2(size + 1)).clamp(max=steps).sum())
    nbytes = (NI * (1 + 4 + 8 + 8) + int(valid.sum()) * 4 + C1 * 8 + keys.numel() * 8
              + 4 * depth + ch_max * 20 + 2)
    ops = NI * (3 * C1.bit_length() + 6) + live * 30 + 4 * depth
    return _bound(nbytes, ops)


def cgi_work(args, old: bool = False) -> dict:
    """The least work of ``cgi_bins(*args)``, from this call's data.
    Bytes: each interval's ``ends`` word (int64) and flag read; the chunk
    slots of each valid interval, their best read (4 bytes each); a mapped
    interval's chunks at its best, their first and last anchors (4 bytes
    each); each fragment's size, query genome and gate (4 bytes each); a
    mapped interval's contig (int64), its identity and genome looked up (4
    bytes each); each interval's slot written (12 bytes); the flags read
    and their row written.  int32 operations: 6 an interval (its slots'
    bounds, the gate), 3 a chunk read and 25 a mapped interval (the bin,
    the identity, its comparisons).  With ``old``, the parent's two
    launches: the merge (each live slot's three results read, each
    interval's ``ends`` and flag read and three int64 written; 4
    operations a slot and 6 an interval), then CGI (each interval's best
    and flag, a mapped one's first, last and contig read, the rest as
    above)."""
    import torch

    from pyfastani_tpu_torch.ops.l2_sweep import l2_merge_reference

    cbest, _, _, ends, valid, _, s_sizes, _, gate = args[:9]
    ivmax, flags = args[13], args[17]
    NI, F = ends.shape[0], s_sizes.shape[0]
    best = l2_merge_reference(*args[:5])[0]
    s_iv = s_sizes.long().repeat_interleave(ivmax)
    gate_iv = gate.long()[s_iv.clamp(0, gate.shape[0] - 1)]
    mapped = valid & (best > 0) & (best >= gate_iv)
    n_mapped = int(mapped.sum())
    ch_max = cbest.shape[0]
    j = torch.arange(ch_max, device=ends.device)
    owner = torch.searchsorted(ends, j, right=True).clamp(max=NI - 1)
    live = j < ends[-1]
    read = live & valid[owner]
    at_best = int((read & mapped[owner] & (cbest.long() == best[owner])).sum())
    flag_bytes = sum(f.element_size() + 4 for f in flags)
    fixed = F * 12 + n_mapped * (8 + 2 * 4) + NI * 12
    if old:
        n_live = int(live.sum())
        return _bound(n_live * 12 + NI * (8 + 1 + 24) + NI * (8 + 1) + fixed + n_mapped * 16,
                      n_live * 4 + NI * 6 + NI * 4 + n_mapped * 25)
    n_read = int(read.sum())
    return _bound(NI * (8 + 1) + n_read * 4 + at_best * 8 + fixed + flag_bytes,
                  NI * 6 + n_read * 3 + n_mapped * 25)


def fold_work(args, dense: bool = False) -> dict:
    """The least work of ``fold_bins(*args)``, from this call's data: each
    slot's bin read once (8 bytes) and a kept slot's identity (4 bytes;
    an unkept slot's is not needed), each bin they touch read and left
    ``-inf`` (4 bytes each way), the contigs' genomes, three ``(q, g_max)``
    int64 written, and the flags' rows read and their merge written; 6
    int32 operations a slot and 20 a touched bin.  With ``dense``, the dense
    contract: every bin read once and 6 operations a bin."""
    import torch

    slot_bin, _, scratch, s2g, q, _, g_max, _, flags, _ = args
    fixed = s2g.shape[0] * 4 + 3 * q * g_max * 8
    fixed += 0 if flags is None else flags.numel() * 4 + flags.shape[-1] * 8
    if dense:
        return _bound(scratch.shape[0] * 4 + fixed, scratch.shape[0] * 6)
    kept = slot_bin[slot_bin >= 0]
    touched = int(torch.unique(kept).numel())
    return _bound(slot_bin.shape[0] * 8 + kept.numel() * 4 + touched * 8 + fixed,
                  slot_bin.shape[0] * 6 + touched * 20)


# phase 14's three kernels: wrapper, plain version, contract, work, and the
# device kernels' name
SWEEP_KERNELS = {
    "l2_plan": ("l2_sweep", "l2_plan", _plan_err, plan_work),
    "cgi_bins": ("cgi", "cgi_bins", _cgi_err, cgi_work),
    "fold_bins": ("cgi", "fold_bins", _fold_err, fold_work),
}


def check_sweep(kernel: str, name: str, args, gpu: str, timed: bool = False,
                flagged: bool = False) -> dict:
    """Kernel ``kernel`` of phase 14 against its plain version on ``args``
    (CUDA tensors) under its contract (``flagged``: the pass's flags are
    raised, which waives CGI's slots); with ``timed``, both times
    (plain, kernel, kernel, plain), the wrapper's device time and the
    bound.  Returns the line's numbers and the plain outputs."""
    import importlib

    import torch

    mod_name, fn, err_fn, work_fn = SWEEP_KERNELS[kernel]
    mod = importlib.import_module(f"pyfastani_tpu_torch.ops.{mod_name}")
    wrapper, plain = getattr(mod, fn), getattr(mod, f"{fn}_reference")
    if kernel == "fold_bins":  # each call its own outputs; the scratch is shared
        scratch_clean(args[2], f"fold_bins {name}: the scratch on entry")
        got_args, want_args = fold_fresh(args), fold_fresh(args)
        got = wrapper(*got_args)
        torch.cuda.synchronize()
        scratch_clean(args[2], f"fold_bins {name} (kernel)")
        want = plain(*want_args)
        scratch_clean(args[2], f"fold_bins {name} (plain version)")
        if args[8] is not None and not bool((got_args[9] == want_args[9]).all()):
            raise AssertionError(f"fold_bins {name}: merged flags differ from the plain version")
    else:
        got = wrapper(*args)
        want = plain(*args)
    torch.cuda.synchronize()
    if kernel == "cgi_bins":
        err = err_fn(got, want, flagged, cgi_bins_count(args))
    else:
        err = err_fn(got, want)
    if err != 0:
        raise AssertionError(f"{kernel} kernel differs from the plain version ({name}): {err}")
    work = work_fn(args, want) if kernel == "l2_plan" else work_fn(args)
    head = f"[14] {kernel} {name}: equal under the contract"
    if kernel == "fold_bins":
        head += f", the scratch all -inf after each fold ({int((args[0] >= 0).sum())} kept slots)"
    if kernel == "l2_plan":
        head += (f" ({int(want[5][-1])} chunks of {args[13]} slots from {args[2].shape[0]} "
                 f"intervals on {args[4].shape[0] - 1} contigs; overflow/range flags "
                 f"{bool(want[7])}/{bool(want[8])})")
    if not timed:
        log(f"{head} ({gpu})")
        return dict(max_abs_err=err, want=want)
    plain_a = time_ms(plain, args)
    kern_a = time_ms(wrapper, args)
    kern_b = time_ms(wrapper, args)
    plain_b = time_ms(plain, args)
    # the bound counts the function's outputs written once: the wrapper's
    # device time is every kernel of its calls
    alone = kernel_device_ms(wrapper, args, "")
    if kernel == "fold_bins":
        scratch_clean(args[2], f"fold_bins {name} after the timed calls")
    old = ""
    if kernel in ("cgi_bins", "fold_bins"):
        what, other = ("the merge + CGI contract's", work_fn(args, old=True)) \
            if kernel == "cgi_bins" else ("the dense contract's", work_fn(args, dense=True))
        old = (f"; {what} bound {other['bound_ms']:.4f} ms by {other['bound_by']} "
               f"({other['bytes']} B), {100 * other['bound_ms'] / alone:.1f}% of it")
    log(
        f"{head}; kernel {kern_a:.3f}/{kern_b:.3f} ms, plain {plain_a:.3f}/{plain_b:.3f} ms per "
        f"call, the wrapper's device time {alone:.4f} ms (every kernel of a call); "
        f"bound {work['bound_ms']:.4f} ms by "
        f"{work['bound_by']} ({work['bytes']} B = {work['bytes_ms']:.4f} ms, {work['ops']} int32 "
        f"ops = {work['ops_ms']:.4f} ms), {100 * work['bound_ms'] / alone:.1f}% of it reached"
        f"{old} ({gpu})"
    )
    return dict(
        max_abs_err=err, ms=min(kern_a, kern_b), plain_ms=min(plain_a, plain_b),
        device_ms=alone, bound_ms=work["bound_ms"], bound_by=work["bound_by"], library_ms=None,
        want=want,
    )


def plan_no_store(device):
    """`sweep_case` ``contig_edges`` against an empty store (M = 0), where
    the plain version cannot run: every range is empty."""
    case = list(sweep_case("contig_edges"))
    case[5] = np.zeros_like(case[5])  # cof_idx
    case[6] = case[6][:0]  # mini_gpos
    case[7] = np.zeros_like(case[7])  # gpos_bucket
    return torch_args(case, device)


def phase_sweep(device, gpu: str) -> None:
    """Phase 14's synthetic cases: `l2_plan` and `cgi_bins` (on chunk
    results drawn for the plan, `plan_cgi_args`) on every case of
    `SWEEP_CASES`, then the plan on an empty store; `cgi_bins` and
    `fold_bins` on every case of `CGI_CASES`, then the fold of all-empty
    bins.  ``main`` timed."""
    import torch

    from pyfastani_tpu_torch.ops import cgi, l2_sweep

    for name in SWEEP_CASES:
        args = torch_args(sweep_case(name), device)
        plan = check_sweep("l2_plan", name, args, gpu, timed=name == "main")["want"]
        if bool(plan[7]) != (name in SWEEP_OVERFLOW) or bool(plan[8]) != (name == "range"):
            raise AssertionError(f"sweep case {name}: flags {bool(plan[7])}/{bool(plan[8])}")
        check_sweep("cgi_bins", f"{name} (the plan's chunks)", plan_cgi_args(plan, args), gpu,
                    timed=name == "main")
    plan = l2_sweep.l2_plan(*plan_no_store(device))
    torch.cuda.synchronize()
    if bool(plan[1].any()) or bool(plan[8]):
        raise AssertionError("l2_plan found ranges in an empty store")
    log(f"[14] l2_plan on an empty store (M = 0): every range empty, no range flag ({gpu})")
    for name in CGI_CASES:
        args = torch_args(cgi_case(name), device)
        slots = check_sweep("cgi_bins", name, args, gpu, timed=name == "main")["want"]
        if int((slots[0] >= 0).sum()) == 0:
            raise AssertionError(f"cgi case {name}: no slot kept")
        # two data rows' slots of one shard, the second's identities 0.01 off the
        # first's in the same bins, and their flags, the second row flagged
        flags = torch.tensor([[0, 0, 0, 0, 0, 0], [0, 1, 0, 0, 0, 1]], dtype=torch.int32,
                             device=device)
        two = [torch.cat(pair) for pair in zip(slots, second_row(slots, 7))]
        for rows, fargs in (("", fold_args(slots, args)),
                            (" (two data rows)", fold_args(two, args, flags))):
            check_sweep("fold_bins", name + rows, fargs, gpu, timed=name == "main" and not rows)
    none = (torch.full_like(slots[0], -1), torch.full_like(slots[1], -np.inf))
    fargs = fold_args(none, args)
    counts = cgi.fold_bins(*fargs)[0]
    torch.cuda.synchronize()
    if bool(counts.any()):
        raise AssertionError("fold_bins counted bins of slots that keep nothing")
    scratch_clean(fargs[2], "fold_bins of slots that keep nothing")
    log(f"[14] fold_bins of slots that keep nothing: no count, the scratch all -inf ({gpu})")


def check_sweep_path(name: str, captured: dict, gpu: str, timed: bool) -> dict:
    """The three kernels of phase 14 against their plain versions on the
    operands captured from one group of the path (`capture_operands`);
    returns each kernel's numbers."""
    plan = check_sweep("l2_plan", name, captured["l2_plan"], gpu, timed)
    flagged = bool(plan["want"][7]) or bool(plan["want"][8])
    out = {"l2_plan": plan}
    out["cgi_bins"] = check_sweep("cgi_bins", name, captured["cgi_bins"], gpu, timed, flagged)
    out["fold_bins"] = check_sweep("fold_bins", name, captured["fold_bins"], gpu, timed)
    return out


# operands of `l2_chunks` and of `l1_candidates` that are the session's
# parked index planes (mini_hash, mini_wpos, mini_prev; uniq_hash,
# row_start, row_len, post_gpos, hash_bucket): no pass writes them
STORE_OPERANDS = (2, 3, 4)
L1_STORE_OPERANDS = (2, 3, 4, 5, 8)
# the same of phase 14's kernels: the contig tables, mini_gpos and the
# gpos bucket; the gate and identity tables and seq_to_genome
SWEEP_STORE_OPERANDS = {
    "l2_plan": (4, 5, 6, 7), "cgi_bins": (8, 9, 10), "fold_bins": (2, 3),
}


def capture_operands(run):
    """``(result, l2_operands, winnow_operands, l1_operands,
    sweep_operands)``: ``run()`` (a query through the session) and the
    operands of its first `l2_chunks`, `winnow_fragments` and
    `l1_candidates` call, and (a dict by name) of its first call of each
    kernel of `SWEEP_KERNELS`, cloned but for the index planes and
    tables, which are kept by reference."""
    import torch

    from pyfastani_tpu_torch import session as session_module

    captured = {}
    keep = {"l2_chunks": STORE_OPERANDS, "winnow_fragments": (), "l1_candidates": L1_STORE_OPERANDS,
            **SWEEP_STORE_OPERANDS}
    originals = {name: getattr(session_module, name) for name in keep}

    def clone(a):  # a tensor, or a tuple of them (`cgi_bins`' flags)
        if isinstance(a, tuple):
            return tuple(clone(x) for x in a)
        return a.clone() if isinstance(a, torch.Tensor) else a

    def capturing(name):
        def capture(*args):
            if name not in captured:
                captured[name] = tuple(
                    a if i in keep[name] else clone(a) for i, a in enumerate(args)
                )
            return originals[name](*args)
        return capture

    for name in keep:
        setattr(session_module, name, capturing(name))
    try:
        result = run()
    finally:
        for name, fn in originals.items():
            setattr(session_module, name, fn)
    return (result, captured["l2_chunks"], captured["winnow_fragments"],
            captured["l1_candidates"], {name: captured[name] for name in SWEEP_STORE_OPERANDS})


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


def substitute(rng, base: np.ndarray, rate: float, alphabet: np.ndarray) -> np.ndarray:
    """A copy of ``base`` with each letter redrawn from ``alphabet`` at
    ``rate`` (`mutate` over any alphabet)."""
    arr = base.copy()
    idx = rng.random(arr.shape[0]) < rate
    arr[idx] = rng.choice(alphabet, size=int(idx.sum()))
    return arr


def bgc_panel(n_drafts: int = BGC_DRAFTS, seed: int = PARAM_SEED):
    """``n_drafts`` protein drafts (lists of ``bytes``) of `BGC_PROTEINS`
    proteins each, in families of `AVA_FAMILY` mutants of an ancestor at
    `BGC_RATE` substitutions; each ancestor's protein lengths uniform in
    `BGC_RESIDUES`."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n_drafts:
        lengths = rng.integers(BGC_RESIDUES[0], BGC_RESIDUES[1] + 1, size=BGC_PROTEINS)
        base = rng.choice(_AMINO, size=int(lengths.sum()))
        cuts = np.cumsum(lengths)[:-1]
        for _ in range(min(AVA_FAMILY, n_drafts - len(out))):
            mutant = substitute(rng, base, BGC_RATE, _AMINO)
            out.append([p.tobytes() for p in np.split(mutant, cuts)])
    return out


def phage_panel(n_genomes: int = PHAGE_GENOMES, seed: int = PARAM_SEED):
    """``n_genomes`` one-contig genomes (lists of ``bytes``) in families
    of `AVA_FAMILY` mutants of an ancestor at `PHAGE_RATE`; each ancestor's
    length uniform in `PHAGE_LENGTHS`."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n_genomes:
        base = rng.choice(_ACGT, size=int(rng.integers(PHAGE_LENGTHS[0], PHAGE_LENGTHS[1] + 1)))
        for _ in range(min(AVA_FAMILY, n_genomes - len(out))):
            out.append([substitute(rng, base, PHAGE_RATE, _ACGT).tobytes()])
    return out


def species_panel(n_families: int = SPECIES_FAMILIES, lengths=AVA_LENGTHS,
                  seed: int = PARAM_SEED):
    """``n_families`` families of `SPECIES_FAMILY` one-contig genomes
    (lists of ``bytes``): three members of an ancestor at
    ``SPECIES_RATES[0]``, one at ``SPECIES_RATES[1]``, then a chimera of
    the first member's length whose first `SPECIES_SHARE` is a mutant of
    that member at ``SPECIES_RATES[0]`` and the rest random; family ``f``'s
    ancestor ``lengths[f % len(lengths)]`` long."""
    rng = np.random.default_rng(seed)
    out = []
    for f in range(n_families):
        base = rng.choice(_ACGT, size=lengths[f % len(lengths)])
        members = [substitute(rng, base, rate, _ACGT)
                   for rate in (SPECIES_RATES[0],) * 3 + (SPECIES_RATES[1],)]
        cut = int(SPECIES_SHARE * base.shape[0])
        chimera = np.concatenate([substitute(rng, members[0][:cut], SPECIES_RATES[0], _ACGT),
                                  rng.choice(_ACGT, size=base.shape[0] - cut)])
        out += [[g.tobytes()] for g in members + [chimera]]
    return out


def species_expected(i: int, defaults: bool = False) -> set:
    """The names the first member ``i`` of a `species_panel` family hits:
    the three members at (95, 0.5); at the defaults (80, 0.2) also the
    other species and the chimera."""
    return {f"g{j}" for j in range(i, i + (SPECIES_FAMILY if defaults else 3))}


def species_drops(strict, defaults, lengths: dict, query_lengths, l: int):
    """The pairs ``(query, reference name)`` that the defaults (80, 0.2)
    keep and (95, 0.5) drops, by the knob that drops them: ``(gate,
    fraction)``.  ``strict`` and ``defaults`` are each query's hits at the
    two settings, ``lengths`` each reference's length, ``query_lengths``
    each query's.  A pair is the gate's when its identity at the defaults
    is under 95 and its fraction (``matches * l`` over the shorter genome)
    at least 0.5, the fraction's when the other way round; fails unless
    every pair kept at (95, 0.5) is kept at the defaults."""
    gate, fraction = [], []
    for qi, (kept, wide) in enumerate(zip(strict, defaults)):
        names = {h.name for h in wide}
        if not {h.name for h in kept} < names:
            raise AssertionError(f"query {qi}: hits at (95, 0.5) {hit_key(kept)} are not a "
                                 f"strict subset of those at the defaults {hit_key(wide)}")
        for h in wide:
            if h.name in {x.name for x in kept}:
                continue
            share = h.matches * l / min(lengths[h.name], query_lengths[qi])
            if h.identity < 95.0 and share >= 0.5:
                gate.append((qi, h.name))
            elif h.identity >= 95.0 and share < 0.5:
                fraction.append((qi, h.name))
    return gate, fraction


def odd_residues(contigs, seed: int = PARAM_SEED):
    """Protein ``contigs`` as a real FASTA file may hold them: 1% of the
    residues ``X``, a third of the letters lowercase, and each protein
    ending in a stop, ``*``."""
    rng = np.random.default_rng(seed)
    out = []
    for contig in contigs:
        arr = np.frombuffer(contig, np.uint8).copy()
        arr[rng.random(arr.shape[0]) < 0.01] = ord("X")
        arr[rng.random(arr.shape[0]) < 1 / 3] |= 0x20
        out.append(arr.tobytes() + b"*")
    return out


def family_of(i: int, n: int) -> set:
    """The names panel member ``i`` of `bgc_panel` or `phage_panel` hits:
    the `AVA_FAMILY` members of its own family."""
    lo = i - i % AVA_FAMILY
    return {f"g{j}" for j in range(lo, min(lo + AVA_FAMILY, n))}


def param_panel(name: str, refs=None, queries=None, scale: int = 1):
    """Phase 15's panel of configuration ``name``: ``(references,
    queries, expected, self_hit)``, the references ``(name, contigs)``,
    the queries lists of contigs, ``expected`` each query's hit names, and
    ``self_hit`` whether a query is itself a reference (then it hits
    itself at identity 100).  The configurations on phase 4's panel
    (`PARAM_PANELS`) take its ``refs`` and ``queries``; ``scale`` divides
    the panels' sizes, the species panel's lengths too (the CPU tests run
    them small)."""
    panel_name = PARAM_PANELS[name]
    if panel_name == "phase 4":
        queries = queries[:N_QUERIES]
        return ([(f"ref{i}", [r]) for i, r in enumerate(refs)], [[q] for q in queries],
                [{f"ref{i % len(refs)}"} for i in range(len(queries))], False)
    if panel_name == "species":
        panel = species_panel(max(1, SPECIES_FAMILIES // scale),
                              [n // scale for n in AVA_LENGTHS])
        picked = range(0, len(panel), SPECIES_FAMILY)
        return ([(f"g{i}", contigs) for i, contigs in enumerate(panel)],
                [panel[i] for i in picked], [species_expected(i) for i in picked], True)
    if panel_name == "bgc":
        panel = bgc_panel(BGC_DRAFTS // scale)
    else:
        panel = phage_panel(PHAGE_GENOMES // scale)
    n = len(panel)
    step = max(1, n // PARAM_QUERIES)
    picked = range(0, n, step)
    return ([(f"g{i}", contigs) for i, contigs in enumerate(panel)],
            [panel[i] for i in picked], [family_of(i, n) for i in picked], True)


def hit_key(hits):
    return [(h.name, h.identity, h.matches, h.fragments) for h in hits]


def kernel_counters() -> dict:
    """Each wrapper's counters by kernel name: ``(module, prefix)``, the
    module's ints ``<prefix>launches`` and ``<prefix>reference_calls``
    (the prefix is empty in a module of one wrapper)."""
    from pyfastani_tpu_torch.ops import cgi, fragments, l1, l2, l2_sweep

    return {
        "l2_chunks": (l2, ""), "winnow_fragments": (fragments, ""), "l1_candidates": (l1, ""),
        "l2_plan": (l2_sweep, "l2_plan_"),
        **{name: (cgi, f"{name}_") for name in ("cgi_bins", "fold_bins")},
    }


def read_counts(kind: str) -> dict:
    """``launches`` or ``reference_calls`` of every wrapper, by name."""
    return {name: getattr(mod, prefix + kind)
            for name, (mod, prefix) in kernel_counters().items()}


def reset_counts() -> None:
    """Every kernel's counters set to 0."""
    for mod, prefix in kernel_counters().values():
        for kind in ("launches", "reference_calls"):
            setattr(mod, prefix + kind, 0)


def counted(run):
    """``run()`` with every kernel's counters set to 0 just before it and
    read just after: ``(result, launches)``, ``launches`` a `Counter` by
    kernel name; fails unless every kernel ran and no plain version did."""
    from collections import Counter

    reset_counts()
    out = run()
    launches = Counter(read_counts("launches"))
    plain = read_counts("reference_calls")
    if min(launches.values()) <= 0 or any(plain.values()):
        raise AssertionError(
            f"the path ran the kernels {dict(launches)} times and their plain versions "
            f"{plain} times"
        )
    return out, launches


def counted_by_card(run, mesh):
    """`counted` of ``run()``, and each card's launches: ``(result,
    launches, by_card)``, ``by_card`` a `Counter` by kernel name for each
    card (``"cuda:i"``), read as the growth of the wrapper's counter in
    each of its calls from the session, by the card of the call's first
    tensor; fails unless every kernel launched on every card of ``mesh``
    and the fold on the home cards of its shards (cells ``(0, sh)``)
    alone."""
    from collections import Counter, defaultdict

    from pyfastani_tpu_torch import session as session_module

    by_card = defaultdict(Counter)
    originals = {name: getattr(session_module, name) for name in kernel_counters()}

    def per_card(name, fn, mod, attr):
        def call(*args, **kwargs):
            before = getattr(mod, attr)
            out = fn(*args, **kwargs)
            by_card[str(args[0].device)][name] += getattr(mod, attr) - before
            return out
        return call

    for name, (mod, prefix) in kernel_counters().items():
        setattr(session_module, name, per_card(name, originals[name], mod, prefix + "launches"))
    try:
        out, launches = counted(run)
    finally:
        for name, fn in originals.items():
            setattr(session_module, name, fn)
    homes = {str(dev) for dev in mesh.devices[0]}
    for card in {str(dev) for row in mesh.devices for dev in row}:
        missing = [name for name in kernel_counters()
                   if by_card[card][name] <= 0 and (name != "fold_bins" or card in homes)]
        if missing or (card not in homes and by_card[card]["fold_bins"]):
            raise AssertionError(f"{card} launched no {missing} or folded away from a home: "
                                 f"{dict(by_card[card])}")
    if sum(by_card.values(), Counter()) != launches:
        raise AssertionError(f"launches by card {dict(by_card)} do not sum to {dict(launches)}")
    return out, launches, by_card


def parent_traffic(session) -> dict:
    """The bytes that the parent commit's placement moved in a pass of the
    shape of ``session``'s last pass, counted from the shapes: every
    cell's slots to the merge device (the home of shard 0), where every
    shard was folded; across processes an ``all_gather`` of every cell's
    slots and of each process's flags to every process."""
    import torch

    t, mesh = session.traffic, session.mesh
    if not mesh.distributed:
        merge = mesh.devices[0][0]
        away = sum(dev != merge for row in mesh.devices for dev in row)
        return {"slots_across_cards": away * t["cell_slots"], "limbs_across_cards": 0}
    cells = session.n_data * session.n_shard
    return {"collectives": torch.distributed.get_world_size() * (cells * t["cell_slots"] + 6 * 4)}


def traffic_line(session) -> str:
    """The bytes ``session``'s last pass moved, beside the parent's."""
    moved = {k: v for k, v in session.traffic.items() if k != "cell_slots"}
    return (f"bytes moved in one pass {moved} (one cell's slots {session.traffic['cell_slots']}); "
            f"the parent's placement, counted from the same shapes: {parent_traffic(session)}")


def card_lines(tag: str, by_card, held, peaks) -> None:
    """One line a card: its launches by kernel, the memory it held before
    the run and its peak memory in the run."""
    for card in sorted(by_card):
        log(f"{tag} {card}: kernel launches {dict(by_card[card])}; device memory (allocated) "
            f"{held[card] / 2**30:.3f} GiB held before the run, {peaks[card] / 2**30:.3f} GiB "
            f"at its peak")


def reset_peaks(cards) -> dict:
    """Each card's peak memory statistic reset; returns the memory each
    holds."""
    import torch

    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    return {card: torch.cuda.memory_allocated(card) for card in cards}


def read_peaks(cards) -> dict:
    import torch

    return {card: torch.cuda.max_memory_allocated(card) for card in cards}


def phase_query(gpu: str, refs, all_queries, unrelated):
    import torch

    import pyfastani_tpu_torch as pt
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

    batch = [[q] for q in queries]

    def run():
        t0 = time.perf_counter()
        first = mapper.query_genome(queries[0])
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0

        t0 = time.perf_counter()
        session = Session(mapper)
        torch.cuda.synchronize()
        t_park = time.perf_counter() - t0
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
        return first, t_first, session, t_park, many, steady, none

    (first, t_first, session, t_park, many, steady, none), launches = counted(run)
    check_scratch(session, "[4] query_many")
    check_scratch(mapper._device_session(), "[4] query_genome")

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
        f"unrelated query -> []; kernel launches {dict(launches)}, plain-version runs 0"
    )
    _, real, real_winnow, real_l1, real_sweep = capture_operands(lambda: session.query_many(batch))
    return mapper, many, launches, real, real_winnow, real_l1, real_sweep


def phase_mesh(gpu: str, mapper, queries, want):
    """Phase 4's panel on a (2, 2) mesh; returns the kernel launches."""
    import torch

    from pyfastani_tpu_torch.parallel.mesh import make_mesh
    from pyfastani_tpu_torch.parallel.sharded import ShardedSession

    n_dev = torch.cuda.device_count()
    if n_dev >= 4:
        devices, where = [f"cuda:{i}" for i in range(4)], "four cards, one cell each"
    else:
        devices, where = ["cuda:0"] * 4, f"cuda:0 in all four cells ({n_dev} card(s) visible)"
    cards = sorted(set(devices))
    mesh = make_mesh(2, 2, devices=devices)
    batch = [[q] for q in queries[:N_QUERIES]]

    def run():
        session = ShardedSession(mapper, mesh)
        held = reset_peaks(cards)
        t0 = time.perf_counter()
        first = session.query_many(batch)
        for card in cards:
            torch.cuda.synchronize(card)
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = session.query_many(batch)
        for card in cards:
            torch.cuda.synchronize(card)
        return session, held, first, again, t_first, time.perf_counter() - t0

    (session, held, first, again, t_first, t_steady), launches, by_card = counted_by_card(run, mesh)
    peaks = read_peaks(cards)
    check_scratch(session, "[5] (2, 2) mesh")
    for qi, (a, b) in enumerate(zip(first, again)):
        if hit_key(a) != hit_key(want[qi]) or hit_key(b) != hit_key(want[qi]):
            raise AssertionError(f"(2, 2) mesh query {qi}: {a} != phase 4 / host engine {want[qi]}")
    homes = {sh: str(mesh.devices[0][sh]) for sh in range(2)}
    log(
        f"[5] (2, 2) mesh on {where}: hits of {N_QUERIES} queries equal phase 4 and the "
        f"host engine; query_many {t_first:.3f} s first, {t_steady:.3f} s steady; "
        f"budgets {session.budgets}; kernel launches {dict(launches)}, plain-version runs 0 "
        f"({gpu})"
    )
    log(f"[5] each shard folded on its home card {homes}; {traffic_line(session)}")
    card_lines("[5]", by_card, held, peaks)
    return launches


def phase_pipeline(gpu: str, mapper, queries):
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
    check_scratch(session, "[6] pipelined groups")
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
        f"kernel launches {dict(launches)}, plain-version runs 0"
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


def phase_escalation(gpu: str, mapper, queries, want):
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
    check_scratch(session, "[9] escalation (flagged passes included)")
    n = session.stats["budget_escalations"]
    if n < 2 or len(steps) != n:
        raise AssertionError(f"expected at least two escalations, got {n}: {steps}")
    for qi, (a, b) in enumerate(zip(hits, want)):
        if hit_key(a) != hit_key(b):
            raise AssertionError(f"escalated query {qi}: {a} != phase 4 {b}")
    log(
        f"[9] escalation on the card: phase 4's panel from budgets {ESCALATE_BUDGETS} "
        f"escalated {n} times ({'; '.join(steps)}) to {session.budgets} in {took:.3f} s; "
        f"hits equal phase 4; kernel launches {dict(launches)}, plain-version runs 0 ({gpu})"
    )
    return launches


def phase_case(gpu: str, mapper, queries, want):
    """Phase 4's batch as uppercase ``bytes``, then as lowercase ``bytes``,
    a mixed-case ``bytearray`` and a mixed-case uint8 ``ndarray`` through
    one `Session`: the session stages the raw bytes and the card
    uppercases them, so every kind gives phase 4's hits.  Each pass's
    `_fragments` and `_stage` milliseconds are printed.  Returns the kernel
    launches."""
    from collections import Counter

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
    launches = Counter()
    for name, batch in kinds.items():
        host = HostTimer(ShardedSession, HOST_STEPS)
        try:
            t0 = time.perf_counter()
            hits, n = counted(lambda: session.query_many(batch))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            host.restore()
        check_scratch(session, f"[11] {name}")
        for qi, (a, b) in enumerate(zip(hits, want)):
            if hit_key(a) != hit_key(b):
                raise AssertionError(f"{name} query {qi}: {a} != phase 4's uppercase run {b}")
        ms = host.totals_ms()
        log(
            f"[11] {name}, {N_QUERIES} x {REF_LEN} bp: hits equal phase 4's uppercase bytes run; "
            f"pass {1e3 * wall:.3f} ms, _fragments {ms['host_fragments']:.3f} ms, "
            f"_stage {ms['host_stage']:.3f} ms; kernel launches {dict(n)} ({gpu})"
        )
        launches += n
    return launches


def mibig_golden():
    """``(BGC0001425's proteins, BGC0001428's)``, read from ``tests/data``
    by the port's FASTA reader."""
    from pyfastani_tpu_torch._fasta import Parser

    data = os.path.join(ROOT, "tests", "data")
    return tuple([r.seq for r in Parser(os.path.join(data, f"{name}.faa"))]
                 for name in ("BGC0001425", "BGC0001428"))


def golden_runs(device=None) -> dict:
    """The MIBiG golden through the user's entry points on ``device``
    (``None``: the card): two copies of BGC0001425 indexed, BGC0001428
    queried through ``query_draft``, through ``Session.query_many``,
    through mappers pickled before and after ``index()``, and through the
    host engine (``Mapper._query_host``).  Hits by route."""
    import pickle

    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch.session import Session

    bgc1, bgc3 = mibig_golden()
    sketch = pt.Sketch(**PARAM_PATHS["protein_bgc"], device=device)
    sketch.add_draft("BGC0001425", bgc1)
    sketch.add_draft("BGC0001427", bgc1)
    before = pickle.loads(pickle.dumps(sketch))
    mapper = sketch.index()
    return {
        "query_draft": mapper.query_draft(bgc3),
        "query_many": Session(mapper, device=device, q_capacity=PARAM_Q_CAPACITY).query_many(
            [bgc3])[0],
        "pickled sketch": before.index().query_draft(bgc3),
        "pickled mapper": pickle.loads(pickle.dumps(mapper)).query_draft(bgc3),
        "host engine": mapper._query_host(bgc3),
    }


def param_routes(lib, device, params, ops) -> dict:
    """The routes phase 15's configuration took, from the operands of its
    first group (`capture_operands`): the winnow's (`winnow_route`; on the
    tile route its instance, and the any-k instance's shift ``d`` of the
    complemented words; the k-mer's tail past its 4-byte blocks), the L2
    kernel's variant and the contig lookup's table."""
    l2_args, sweep = ops[0], ops[3]
    S, rmax = l2_args[0].shape[1], l2_args[11]
    n_coff = sweep["l2_plan"][4].shape[0]
    k = params.kmer_size
    winnow = winnow_route(lib, device, params.min_read_length, k, params.window_size)
    if winnow == "tile":
        winnow += ", k 16 instance" if k == 16 else f", any-k instance (d {(4 - k % 4) % 4})"
    elif winnow == "long":
        winnow += ", shared store"
    if k % 4:
        winnow += f", {k % 4}-byte tail"
    return {
        "winnow": winnow,
        "l2_chunks": "shared" if lib.l2_chunks_fits_shared(device.index, S, rmax) else "scratch",
        "contig lookup": ("shared" if lib.l2_plan_coff_staged(n_coff) else "global")
                         + f" ({n_coff - 1} contigs)",
    }


def param_path(gpu: str, name: str, references, queries, expected, self_hit):
    """One configuration of phase 15 through the user's entry points on
    the card: ``Sketch(**PARAM_PATHS[name])`` -> ``add_draft`` ->
    ``index()`` -> ``query_draft`` of every query (the cached one-genome
    session) and ``Session.query_many`` at ``q_capacity`` 16 (and, for
    protein, the second query with `odd_residues` and the MIBiG golden,
    `golden_runs`), the kernels' launch counters around it; then the same
    data through the port's CPU route and the host engine.  Returns the launches and the operands of the batch's
    first group (`capture_operands`)."""
    import warnings

    import torch

    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch._build import load_library
    from pyfastani_tpu_torch.session import Session

    tag = f"[15] {name}"
    device = torch.device("cuda", 0)
    kw = PARAM_PATHS[name]
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sketch = pt.Sketch(**kw)
    made = [str(w.message) for w in caught]
    k = kw.get("k", 16)
    if made != ([f"Using k-mer size greater than 16 ({k}), accuracy will be degraded."]
                if k > 16 else []):
        raise AssertionError(f"{tag}: Sketch({kw}) warned {made}")
    for ref, contigs in references:
        sketch.add_draft(ref, contigs)
    mapper = sketch.index()
    params = mapper._param
    residues = sum(len(c) for _, contigs in references for c in contigs)
    log(
        f"{tag}: {kw} (k {params.kmer_size}, w {params.window_size}, l "
        f"{params.min_read_length}): {len(references)} references, "
        f"{sum(len(c) for _, c in references)} contigs, {residues} letters, "
        f"{mapper._index.n_minimizers} minimizers; generated, ingested and indexed in "
        f"{time.perf_counter() - t0:.3f} s; Sketch warned {made or 'nothing'} ({gpu})"
    )

    def run():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            draft = [mapper.query_draft(q) for q in queries]
            torch.cuda.synchronize()
            t_draft = time.perf_counter() - t0
            t0 = time.perf_counter()
            session = Session(mapper, q_capacity=PARAM_Q_CAPACITY)
            many, *ops = capture_operands(lambda: session.query_many(queries))
            torch.cuda.synchronize()
            t_many = time.perf_counter() - t0
            groups = session.stats["dispatches"]
            odd = golden = None
            if params.protein:
                odd = ([mapper.query_draft(q) for q in odd_queries],
                       session.query_many(odd_queries))
                golden = golden_runs()
        steps = [str(w.message).split("escalating ", 1)[1]
                 for w in caught if "escalating" in str(w.message)]
        return draft, t_draft, session, many, t_many, groups, ops, odd, golden, steps

    # every eighth query again with X, stops and lowercase residues
    odd_queries = [odd_residues(q) for q in queries[::8]] if params.protein else []
    (draft, t_draft, session, many, t_many, groups, ops, odd, golden, steps), launches = counted(
        run)
    one = mapper._device_session()
    check_scratch(one, f"{tag} query_draft")
    check_scratch(session, f"{tag} query_many")
    for qi, (a, b) in enumerate(zip(draft, many)):
        if hit_key(a) != hit_key(b):
            raise AssertionError(f"{tag} query {qi}: query_draft {a} != query_many {b}")
    # above k 16 (where `Parameters` warns that accuracy degrades) a
    # fragment of a random pair maps on one shared minimizer hash, at an
    # identity under the gate's: such pairs pass when a fifth of the
    # fragments do; the host engine reports them too (the checks below)
    degraded = []
    for qi, (hits, want) in enumerate(zip(draft, expected)):
        names = sorted(h.name for h in hits)
        extra = [h for h in hits if h.name not in want]
        degraded += extra
        if not set(want) <= set(names) or (extra and (
                k <= 16 or max(h.identity for h in extra) >= params.percentage_identity)):
            raise AssertionError(f"{tag} query {qi}: hits {names}, expected {sorted(want)}")
        if self_hit and 100.0 not in [h.identity for h in hits]:
            raise AssertionError(f"{tag} query {qi}: no self-hit at identity 100: {hits}")
    routes = param_routes(load_library(), device, params, ops)
    if routes["winnow"] != PARAM_ROUTES[name]:
        raise AssertionError(f"{tag}: the winnow took the {routes['winnow']} route, "
                             f"expected {PARAM_ROUTES[name]}")
    if params.protein and not routes["contig lookup"].startswith("global"):
        raise AssertionError(f"{tag}: the contig lookup stayed in shared memory")
    qbp = sum(len(c) for q in queries for c in q)
    more = (f", and {len(degraded)} of unrelated pairs at identity "
            f"{min(h.identity for h in degraded)}-{max(h.identity for h in degraded)} on "
            f"{min(h.matches for h in degraded)}-{max(h.matches for h in degraded)} of "
            f"{degraded[0].fragments} fragments" if degraded else "")
    log(
        f"{tag}: {len(queries)} queries ({qbp} letters): query_draft {t_draft:.3f} s, "
        f"Session park + query_many at q_capacity {PARAM_Q_CAPACITY} {t_many:.3f} s "
        f"({groups} groups); hits equal through both, each query hits "
        f"its {'family' if self_hit else 'reference'} "
        f"({sum(len(h) for h in draft)} hits{', itself at identity 100' if self_hit else ''}"
        f"{more}); routes: {'; '.join(f'{k} {v}' for k, v in routes.items())}; budgets "
        f"{session.budgets} (query_draft's {one.budgets}); escalations "
        f"{session.stats['budget_escalations']} in query_many, "
        f"{one.stats['budget_escalations']} in query_draft ({'; '.join(steps) or 'none'}); "
        f"scratch all -inf; kernel launches {dict(launches)}, plain-version runs 0 ({gpu})"
    )
    if golden is not None:
        for route, hits in golden.items():
            got = [(h.name, h.matches, h.fragments) for h in hits]
            if got != MIBIG_GOLDEN or hit_key(hits) != hit_key(golden["query_draft"]):
                raise AssertionError(f"{tag} MIBiG golden through {route}: {hits}")
        log(f"{tag}: MIBiG golden on the card {MIBIG_GOLDEN} (identity "
            f"{golden['query_draft'][0].identity}) through {', '.join(golden)}: all equal ({gpu})")

    # the CPU route ingests and indexes the same data on its own
    t0 = time.perf_counter()
    host_sketch = pt.Sketch(**kw, device="cpu")
    for ref, contigs in references:
        host_sketch.add_draft(ref, contigs)
    host_mapper = host_sketch.index()
    for qi in range(PARAM_CHECKED):
        cpu = host_mapper.query_draft(queries[qi])
        engine = host_mapper._query_host(queries[qi])
        if not (hit_key(draft[qi]) == hit_key(cpu) == hit_key(engine)):
            raise AssertionError(
                f"{tag} query {qi}: card {draft[qi]} / CPU route {cpu} / host engine {engine}")
    check = ""
    for j, (query, want) in enumerate(zip(odd_queries, expected[::8])):
        cpu, engine = host_mapper.query_draft(query), host_mapper._query_host(query)
        card = (odd[0][j], odd[1][j])
        if not (hit_key(card[0]) == hit_key(card[1]) == hit_key(cpu) == hit_key(engine)) or sorted(
                h.name for h in card[0]) != sorted(want):
            raise AssertionError(f"{tag} query {8 * j} with X, * and lowercase: card {card} / "
                                 f"CPU route {cpu} / host engine {engine}")
    if params.protein:
        check += (f", queries 0, 8, ... with X, * and lowercase residues ({len(odd_queries)} "
                  f"queries, {sum(len(h) for h in odd[0])} hits, through query_draft and one "
                  f"query_many call)")
        cpu_golden = golden_runs("cpu")
        if any(hit_key(h) != hit_key(golden["query_draft"]) for h in cpu_golden.values()):
            raise AssertionError(f"{tag} MIBiG golden on the CPU route: {cpu_golden}")
        check += " and the MIBiG golden's five routes"
    log(
        f"{tag}: queries 0-{PARAM_CHECKED - 1}{check} equal the port's CPU route and the "
        f"host NumPy engine of their own ingest and index (names, matches, fragments, "
        f"identity ==) in {time.perf_counter() - t0:.1f} s"
    )
    if PARAM_PANELS[name] == "species":
        species_defaults(tag, gpu, references, queries, draft, params.min_read_length)
    return launches, ops


def species_defaults(tag: str, gpu: str, references, queries, strict, l: int,
                     device=None) -> None:
    """The species panel again at the defaults (80, 0.2) on ``device``
    (``None``: the card), ``Sketch()`` -> ``add_draft`` -> ``index()`` ->
    ``Session.query_many``: each query keeps its whole family, the first
    `PARAM_CHECKED` equal the host engine's, and against ``strict``, the
    hits at (95, 0.5), each query loses the other species to the 95% gate
    and the chimera to the fraction 0.5 (`species_drops`)."""
    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch.session import Session

    t0 = time.perf_counter()
    sketch = pt.Sketch(device=device)
    for ref, contigs in references:
        sketch.add_draft(ref, contigs)
    mapper = sketch.index()
    wide = Session(mapper, device=device, q_capacity=PARAM_Q_CAPACITY).query_many(queries)
    firsts = [SPECIES_FAMILY * qi for qi in range(len(queries))]
    for qi, hits in enumerate(wide):
        names = {h.name for h in hits}
        if names != species_expected(firsts[qi], defaults=True):
            raise AssertionError(f"{tag} at the defaults, query {qi}: hits {sorted(names)}")
    for qi in range(PARAM_CHECKED):
        engine = mapper._query_host(queries[qi])
        if hit_key(wide[qi]) != hit_key(engine):
            raise AssertionError(f"{tag} at the defaults, query {qi}: card {wide[qi]} / host "
                                 f"engine {engine}")
    lengths = {ref: sum(len(c) for c in contigs) for ref, contigs in references}
    gate, fraction = species_drops(strict, wide, lengths,
                                   [sum(len(c) for c in q) for q in queries], l)
    if (gate, fraction) != ([(qi, f"g{i + 3}") for qi, i in enumerate(firsts)],
                            [(qi, f"g{i + 4}") for qi, i in enumerate(firsts)]):
        raise AssertionError(f"{tag}: pairs dropped by the 95% gate {gate}, by the fraction 0.5 "
                             f"{fraction}")
    other = [h for h in wide[0] if h.name == "g3"][0]
    chimera = [h for h in wide[0] if h.name == "g4"][0]
    log(
        f"{tag}: the same panel at the defaults (80, 0.2) keeps each query's "
        f"{SPECIES_FAMILY} family members ({sum(len(h) for h in wide)} hits; queries "
        f"0-{PARAM_CHECKED - 1} equal the host engine); (95, 0.5) drops {len(gate)} pairs by "
        f"the 95% gate (query 0's other species: identity {other.identity}, "
        f"{other.matches}/{other.fragments} at the defaults) and {len(fraction)} by the "
        f"fraction 0.5 (query 0's chimera: identity {chimera.identity}, "
        f"{chimera.matches}/{chimera.fragments}), none kept at (95, 0.5) missing at the "
        f"defaults; in {time.perf_counter() - t0:.1f} s ({gpu})"
    )


def phase_params(gpu: str, refs, queries):
    """Phase 15: the configurations of `PARAM_PATHS` through the user's
    entry points (`param_path`), then each kernel against its plain
    version on the operands of each configuration's first group (outside
    the phase's wall time).  Returns the kernel launches."""
    from collections import Counter

    launches, walls = Counter(), {}
    for name in PARAM_PATHS:
        t0 = time.perf_counter()
        n, ops = param_path(gpu, name, *param_panel(name, refs, queries))
        walls[name] = time.perf_counter() - t0
        launches += n
        where = f"{name} (phase 15's first group)"
        check_kernel(where, ops[0], gpu)
        check_winnow(where, ops[1], gpu, timed=False)
        check_l1(where, ops[2], gpu, timed=False)
        check_sweep_path(where, ops[3], gpu, timed=False)
        del ops  # it holds the parked index planes by reference
    for group, limit in ((set(PARAM_PATHS) - set(PARAM_MORE), PARAM_SECONDS),
                         (set(PARAM_MORE), PARAM_MORE_SECONDS)):
        took = sum(v for k, v in walls.items() if k in group)
        log(f"[15] wall {took:.1f} s ("
            f"{', '.join(f'{k} {v:.1f} s' for k, v in walls.items() if k in group)}; "
            f"at most {limit:.0f} s) ({gpu})")
        if took > limit:
            raise AssertionError(f"phase 15's {sorted(group)} took {took:.1f} s, past "
                                 f"{limit:.0f} s")
    log(f"[15] kernel launches {dict(launches)} ({gpu})")
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
    its first L2 sweep).  Then the host NumPy engine on g0 and g4.
    Returns the kernel launches of the steady pass, the captured operands
    of the path's kernels, and the mapper, the batch and the hits for the
    four-card phases (`phase_ava_four_cards`, phase 8)."""
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
        hits, operands, winnow_ops, l1_ops, sweep_ops = capture_operands(
            lambda: session.query_many(batch))
        torch.cuda.synchronize()
        return hits, operands, winnow_ops, l1_ops, sweep_ops, time.perf_counter() - t0

    (first, operands, winnow_ops, l1_ops, sweep_ops, t_first), launches_first = counted(first_run)
    ran = {k: session.stats[k] - before[k] for k in before}
    peak_first = torch.cuda.max_memory_allocated()
    # the clones of the capture, held on the card from the first pass on
    held = sum(
        a.numel() * a.element_size()
        for i, a in enumerate(operands)
        if isinstance(a, torch.Tensor) and i not in STORE_OPERANDS
    ) + winnow_ops[0].numel() + sum(
        a.numel() * a.element_size()
        for i, a in enumerate(l1_ops)
        if isinstance(a, torch.Tensor) and i not in L1_STORE_OPERANDS
    ) + sum(
        a.numel() * a.element_size()
        for name, ops in sweep_ops.items()
        for i, a in enumerate(ops)
        if isinstance(a, torch.Tensor) and i not in SWEEP_STORE_OPERANDS[name]
    )

    def steady_run():
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hits = session.query_many(batch)
        torch.cuda.synchronize()
        return hits, time.perf_counter() - t0

    (steady, t_steady), launches = counted(steady_run)
    peak = torch.cuda.max_memory_allocated()
    check_scratch(session, "[10] all-vs-all")
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
        f"{dict(launches_first)} first, {dict(launches)} steady, plain-version runs 0; peak "
        f"device memory "
        f"(allocated, the parked index included) {peak_first / 2**30:.3f} GiB in the first pass, "
        f"{peak / 2**30:.3f} GiB in the steady one, {held / 2**20:.1f} MiB of each the captured "
        f"operands of the path's kernels"
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
    # one query_draft call (the Mapper's one-genome session, q_capacity 1):
    # the operands of phase 14's `draft` case
    draft, _, _, _, draft_ops = capture_operands(lambda: mapper.query_draft([genomes[0]]))
    if hit_key(draft) != hit_key(first[0]):
        raise AssertionError(f"query_draft g0: {draft} != the all-vs-all's {first[0]}")
    check_scratch(mapper._device_session(), "[10] query_draft")
    log(f"[10] query_draft of g0 on the same index: hits equal the all-vs-all's ({gpu})")
    mapper._session = None
    torch.cuda.empty_cache()
    return launches, operands, winnow_ops, l1_ops, sweep_ops, draft_ops, mapper, batch, first


def phase_ava_four_cards(gpu: str, mapper, batch, want, work):
    """The all-vs-all on a (1, 4) mesh over four cards, the index split by
    genome (``build_sharded_index(mapper, 4)``): one pass, hits equal the
    one-card run, every kernel launched on every card, each card's
    launches and peak memory and the bytes one pass moved.  With ``work``
    (phase 8 runs) the split index is saved there as phase 8's `.npz`
    checkpoint, and the genomes beside it.  Returns the kernel
    launches."""
    from collections import Counter

    import torch

    from pyfastani_tpu_torch.parallel.mesh import make_mesh
    from pyfastani_tpu_torch.parallel.sharded import ShardedSession

    n_dev = torch.cuda.device_count()
    if n_dev < 4:
        log(f"[10] four-card (1, 4) all-vs-all: not run, it needs four cards ({n_dev} visible)")
        return Counter()
    devices = [f"cuda:{i}" for i in range(4)]

    def sync():
        for dev in devices:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    mesh = make_mesh(1, 4, devices=devices)
    session = ShardedSession(mapper, mesh)
    sync()
    t_park = time.perf_counter() - t0
    t0 = time.perf_counter()
    session.warmup()
    sync()
    t_warm = time.perf_counter() - t0

    def run():
        held = reset_peaks(devices)
        t0 = time.perf_counter()
        hits = session.query_many(batch)
        sync()
        return hits, held, time.perf_counter() - t0

    (hits, held, took), launches, by_card = counted_by_card(run, mesh)
    peaks = read_peaks(devices)
    check_scratch(session, "[10] four-card (1, 4) all-vs-all")
    if [hit_key(h) for h in hits] != [hit_key(h) for h in want]:
        raise AssertionError("four-card (1, 4) all-vs-all differs from the one-card run")
    qbp = sum(len(g[0]) for g in batch)
    log(
        f"[10] four-card (1, 4) all-vs-all, index split by genome: hits equal the one-card "
        f"run; shard build and park {t_park:.3f} s, warmup {t_warm:.3f} s, query_many {took:.3f} s = "
        f"{qbp / 1e6 / took:.2f} Mbp/s; budgets {session.budgets}; kernel launches {dict(launches)}, "
        f"plain-version runs 0 ({gpu})"
    )
    log(f"[10] four-card (1, 4): each shard folded on its own card; {traffic_line(session)}")
    card_lines("[10] four-card (1, 4)", by_card, held, peaks)
    if work is not None:
        t0 = time.perf_counter()
        session.sidx.save(os.path.join(work, "ava.npz"))
        np.save(os.path.join(work, "ava_lengths.npy"), np.array([len(g[0]) for g in batch]))
        with open(os.path.join(work, "ava.bin"), "wb") as fh:
            for g in batch:
                fh.write(g[0])
        log(f"[10] the 4-shard index saved as phase 8's .npz checkpoint "
            f"({os.path.getsize(os.path.join(work, 'ava.npz')) / 2**30:.3f} GiB) and the "
            f"genomes beside it in {time.perf_counter() - t0:.1f} s")
    return launches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def prepare_nccl(mapper, queries):
    """With four cards, phase 8's directory, holding phase 4's index split
    in two shards as an ``.npz`` checkpoint and its queries; else
    ``None``."""
    import torch

    from pyfastani_tpu_torch.index import build_sharded_index

    if torch.cuda.device_count() < NCCL_WORLD:
        return None
    work = os.path.join(ROOT, "build", "chip_smoke_nccl")
    os.makedirs(work, exist_ok=True)
    build_sharded_index(mapper, 2).save(os.path.join(work, "small.npz"))
    for i, q in enumerate(queries):
        with open(os.path.join(work, f"query{i}.bin"), "wb") as fh:
            fh.write(q)
    return work


def phase_nccl(gpu: str, work, small_want, ava_want):
    """Four processes, one card each, over NCCL (`nccl_child`): phase 4's
    panel on a (2, 2) mesh, then the all-vs-all on a (1, 4) mesh from
    phase 10's checkpoint.  Every rank's hits equal phase 4's and phase
    10's one-card run.  Returns the kernel launches of every rank."""
    from collections import Counter

    import torch

    if work is None:
        log(f"[8] four-process NCCL meshes: not run, they need {NCCL_WORLD} cards "
            f"({torch.cuda.device_count()} visible)")
        return Counter()
    port = str(_free_port())
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--nccl-rank", str(rank), port, work],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in reversed(range(NCCL_WORLD))
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
        raise AssertionError("NCCL child failed:\n" + "\n".join(logs)[-6000:])
    took = time.perf_counter() - t0
    wants = {"small": [[list(k) for k in hit_key(h)] for h in small_want],
             "ava": [[list(k) for k in hit_key(h)] for h in ava_want]}
    launches = Counter()
    for rank in range(NCCL_WORLD):
        with open(os.path.join(work, f"out{rank}.json")) as fh:
            out = json.load(fh)
        for part, shape in (("small", "(2, 2)"), ("ava", "(1, 4)")):
            run = out[part]
            if run["hits"] != wants[part]:
                raise AssertionError(f"NCCL rank {rank} {shape}: hits differ from the one-card run")
            folds = run["passes"] * len(run["homes"])
            if (any(run["plain"].values()) or run["launches"]["fold_bins"] != folds
                    or min(v for k, v in run["launches"].items() if k != "fold_bins") <= 0):
                raise AssertionError(f"NCCL rank {rank} {shape}: launches {run['launches']}, plain "
                                     f"versions {run['plain']}, {folds} folds expected")
            launches += Counter(run["launches"])
            n_hits = sum(len(h) for h in run["hits"])
            log(
                f"[8] rank {rank} (cuda:{rank}) {shape} mesh, home of shards {run['homes']}: "
                f"{n_hits} hits, equal to the one-card run; index load {run['load_s']:.3f} s, "
                f"park {run['park_s']:.3f} s, warmup {run['warmup_s']:.3f} s, query_many "
                f"{run['query_s']:.3f} s = {run['mbp_s']:.2f} Mbp/s over {run['passes']} passes; "
                f"device memory (allocated) {run['held'] / 2**30:.3f} GiB held before, "
                f"{run['peak'] / 2**30:.3f} GiB at its peak; bytes of one "
                f"pass {run['traffic']}, the parent's placement counted from the same shapes "
                f"{run['parent']}; kernel launches {run['launches']}, plain-version runs 0"
            )
    log(f"[8] four NCCL processes, one card each: phase 4's panel on a (2, 2) mesh and the "
        f"{AVA_GENOMES}-genome all-vs-all on a (1, 4) mesh from its .npz checkpoint, every "
        f"rank's hits equal the one-card runs; {took:.1f} s of wall ({gpu})")
    return launches


def mesh_child(rank: int, shape, path: str, batch) -> dict:
    """One of phase 8's runs in rank ``rank``: the checkpoint at ``path``
    restored onto a ``shape`` mesh of one card a process, ``warmup()``,
    then one ``query_many`` of ``batch``, counted and timed."""
    import torch

    from pyfastani_tpu_torch.parallel.mesh import make_mesh
    from pyfastani_tpu_torch.parallel.sharded import ShardedIndex, ShardedSession

    dev = torch.device("cuda", rank)
    t0 = time.perf_counter()
    index = ShardedIndex.load(path)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    session = ShardedSession.from_index(index, mesh=make_mesh(*shape, devices=[dev]))
    torch.cuda.synchronize(dev)
    t_park = time.perf_counter() - t0
    t0 = time.perf_counter()
    session.warmup()
    torch.cuda.synchronize(dev)
    t_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    before = session.stats["dispatches"]
    reset_counts()
    torch.distributed.barrier()  # the ranks' clocks start together
    t0 = time.perf_counter()
    hits = session.query_many(batch)
    torch.cuda.synchronize(dev)
    took = time.perf_counter() - t0
    launches, plain = read_counts("launches"), read_counts("reference_calls")
    check_scratch(session, f"[8] rank {rank} {shape}")
    return {
        "hits": [hit_key(h) for h in hits], "homes": session._homes,
        "load_s": t_load, "park_s": t_park, "warmup_s": t_warm, "query_s": took,
        "mbp_s": sum(len(c) for g in batch for c in g) / 1e6 / took,
        "passes": session.stats["dispatches"] - before,
        "held": held, "peak": torch.cuda.max_memory_allocated(dev), "traffic": session.traffic,
        "parent": parent_traffic(session), "launches": launches, "plain": plain,
    }


def nccl_child(rank: int, port: str, work: str) -> int:
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.cuda.set_device(rank)
    # the processes share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or NCCL_WORLD) // NCCL_WORLD))
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", world_size=NCCL_WORLD, rank=rank,
        timeout=datetime.timedelta(seconds=NCCL_TIMEOUT),
    )
    try:
        small = []
        for i in range(N_QUERIES):
            with open(os.path.join(work, f"query{i}.bin"), "rb") as fh:
                small.append([fh.read()])
        with open(os.path.join(work, "ava.bin"), "rb") as fh:
            seq = fh.read()
        ends = np.cumsum(np.load(os.path.join(work, "ava_lengths.npy")))
        ava = [[seq[a:b]] for a, b in zip([0, *ends[:-1]], ends)]
        out = {
            "small": mesh_child(rank, (2, 2), os.path.join(work, "small.npz"), small),
            "ava": mesh_child(rank, (1, 4), os.path.join(work, "ava.npz"), ava),
        }
        loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "pyfastani_tpu")]
        if loaded:
            raise AssertionError(f"modules of JAX or of the JAX package were imported: {loaded}")
        with open(os.path.join(work, f"out{rank}.json"), "w") as fh:
            json.dump(out, fh)
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
    phase_winnow(device, gpu)
    phase_l1(device, gpu)
    phase_sweep(device, gpu)
    refs, queries, unrelated = genomes()
    mapper, many, launches, real, real_winnow, real_l1, real_sweep = phase_query(
        gpu, refs, queries, unrelated)
    kern = check_kernel("real (one L2 sweep of phase 4's small batch)", real, gpu)
    check_winnow("real (phase 4's first group)", real_winnow, gpu)
    check_l1("real (phase 4's first group)", real_l1, gpu)
    check_sweep_path("real (phase 4's first group)", real_sweep, gpu, timed=True)
    launches += phase_mesh(gpu, mapper, queries, many)
    launches += phase_pipeline(gpu, mapper, queries)
    phase_ingest(gpu, refs)
    nccl_work = prepare_nccl(mapper, queries[:N_QUERIES])
    launches += phase_escalation(gpu, mapper, queries, many)
    launches += phase_case(gpu, mapper, queries, many)
    del mapper, real, real_winnow, real_l1, real_sweep
    torch.cuda.empty_cache()
    launches += phase_params(gpu, refs, queries)
    torch.cuda.empty_cache()
    (ava_launches, ava_ops, ava_winnow, ava_l1, ava_sweep, draft_sweep, ava_mapper, ava_batch,
     ava_hits) = phase_ava(gpu)
    launches += ava_launches
    check_kernel("ava (the first L2 sweep of the all-vs-all's first pass)", ava_ops, gpu)
    winnow = check_winnow("ava (the all-vs-all's first group)", ava_winnow, gpu)
    cand = check_l1("ava (the all-vs-all's first group)", ava_l1, gpu)
    sweep = check_sweep_path("ava (the all-vs-all's first group)", ava_sweep, gpu, timed=True)
    check_sweep_path("draft (one query_draft call on the all-vs-all's panel)", draft_sweep, gpu,
                     timed=True)
    # the four-card phases come last: after them, torch.profiler's traces
    # on cuda:0 came back empty (the kernels' device times above)
    del ava_ops, ava_winnow, ava_l1, ava_sweep, draft_sweep
    torch.cuda.empty_cache()
    launches += phase_ava_four_cards(gpu, ava_mapper, ava_batch, ava_hits, nccl_work)
    del ava_mapper, ava_batch
    torch.cuda.empty_cache()
    launches += phase_nccl(gpu, nccl_work, many, ava_hits)
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
        "launches": launches["l2_chunks"],
        "case": "real",
        **{k: v for k, v in kern.items() if k != "device_ms"},
    }, {
        # a hand kernel of the port: the JAX package's stage is an XLA program
        "name": "winnow_fragments",
        "route": "cuda",
        "source": "pyfastani_tpu_torch/csrc/winnow_fragments.cu",
        "replaces": "pyfastani_tpu/ops/fragments.py:33",
        "launches": launches["winnow_fragments"],
        "case": "ava",
        **{k: v for k, v in winnow.items() if k != "device_ms"},
    }, {
        # a hand kernel of the port (two kernels, one wrapper): the JAX
        # package's stage is an XLA program
        "name": "l1_candidates",
        "route": "cuda",
        "source": "pyfastani_tpu_torch/csrc/l1_candidates.cu",
        "replaces": "pyfastani_tpu/ops/l1.py:110",
        "launches": launches["l1_candidates"],
        "case": "ava",
        **{k: v for k, v in cand.items() if k not in ("device_ms", "scratch_fragments")},
    }] + [{
        # hand kernels of the port: the JAX package's steps are XLA programs
        "name": name,
        "route": "cuda",
        "source": f"pyfastani_tpu_torch/csrc/{'l2_sweep' if name.startswith('l2_') else 'cgi'}.cu",
        "replaces": f"pyfastani_tpu/parallel/sharded.py:{line}",
        "launches": launches[name],
        "case": "ava",
        **{k: v for k, v in sweep[name].items() if k not in ("device_ms", "want")},
    } for name, line in (("l2_plan", "403 and :576"), ("cgi_bins", "519 and :611"),
                         ("fold_bins", 1219))]}))
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
