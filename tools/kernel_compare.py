"""The L2 merge + gate + CGI of a group against earlier sources of it, on one GPU.

    python3 tools/kernel_compare.py --kernel merge_cgi OLD_L2_SWEEP.cu OLD_CGI.cu \
        [--reps N] [--no-ava]

``--kernel merge_cgi OLD_L2_SWEEP.cu OLD_CGI.cu`` names an earlier
``pyfastani_tpu_torch/csrc/l2_sweep.cu`` and ``csrc/cgi.cu`` with the C
interface of commit ``93c9f97`` (``l2_merge_launch``, three int64 an
interval; ``cgi_bins_launch`` from them into the slots), for example
``git show 93c9f97:pyfastani_tpu_torch/csrc/l2_sweep.cu > build/old/l2_sweep.cu``
and the same of ``cgi.cu``.  The tool builds both sources into one
library with the port's nvcc flags and prints what ``-Xptxas -v`` says of
their merge and CGI kernels and of the current CGI kernel (registers,
spills, shared memory).  Both sides take the chunk results, the plan's
``ends`` and the pass's six flags to the slots and the flags row: old,
that commit's merge wrapper (a ``(3, NI)`` int64 output and its kernel),
the flags' six casts and their ``stack``, and its CGI wrapper (two slot
outputs and its kernel), through an adapter of that interface; new,
``ops/cgi.py::cgi_bins``, one launch.  A later redesign of another kernel
adds its own ``--kernel NAME`` and adapter here and takes out the one
before it once its numbers are recorded (the CGI + fold comparison is in
this file at commit ``93c9f97``; the winnow, L1 and L2 plan comparisons at
``4645a89``).

Cases: every case of ``chip_smoke.CGI_CASES`` (checked, not timed;
``main``, the all-vs-all's shape, timed), and the operands captured from
the path (``chip_smoke.capture_operands``): ``real``, the first group of
the 10 x 2 Mbp small batch (4 queries), ``ava``, the first group of the
512-genome all-vs-all (~100 s to index), and ``draft``, one
``Mapper.query_draft`` call on the all-vs-all's panel (``q_capacity`` 1).
On each case both sides' slots and flags row must equal the plain
version's bitwise.  On the timed cases: each call between CUDA events in
turns (old, new, new, old), each call's device work alone
(``torch.profiler``: every device kernel the call launches, its casts and
copies included) split by kernel name, the bounds (``chip_smoke.cgi_work``
of the fused contract and of the parent's) and the share of each that
each side reached.  Every line names the card and its power limit.  Needs
a GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

KERNELS = {"merge_cgi": 2}  # name: the old sources it takes


def build_old(kernel: str, sources):
    """``(library, ptxas lines)`` of ``sources`` built into one library
    with the port's nvcc flags."""
    from pyfastani_tpu_torch import _build

    digest = hashlib.sha256()
    for source in sources:
        with open(source, "rb") as fh:
            digest.update(fh.read())
    os.makedirs(_build._BUILD_DIR, exist_ok=True)
    path = os.path.join(_build._BUILD_DIR, f"old_{kernel}_{digest.hexdigest()[:16]}.so")
    proc = subprocess.run(
        [_build._nvcc(), *_build._NVCC_FLAGS, "-shared", "-o", path, *sources],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.l2_merge_launch.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, ptr, ptr, ptr, ptr]
    lib.l2_merge_launch.restype = i32
    lib.cgi_bins_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr, i64, i64, ptr, i64, i64, i64, i64,
        i64, i64, ptr, ptr, ptr,
    ]
    lib.cgi_bins_launch.restype = i32
    return lib, ptxas_lines(proc.stdout + proc.stderr, ("l2_merge", "cgi_bins"))


def ptxas_lines(log: str, keys) -> list:
    """The ``-Xptxas -v`` lines of the entry functions in ``log`` whose
    names hold one of ``keys``: one line each, name, registers, spills,
    shared memory."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln:
            if any(k in name for k in keys):
                out.append(f"{name[:60]}: {ln.split(':', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return out


def _check(lib_err: int, what: str) -> None:
    if lib_err != 0:
        raise RuntimeError(f"{what} launch failed: {lib_err}")


def old_path(lib):
    """The merge, the flags' row and CGI as commit 93c9f97 ran them, around
    ``lib``'s merge and CGI kernels: `cgi_bins` operands to ``(slot_bin,
    slot_ident, flag_row)``."""
    import torch

    def run(cbest, cfirst, clast, ends, valid, seq, s_sizes, frag_qg, gate, ident, s2g, cmw, l,
            ivmax, bin_max, g_max, q_count, flags):
        dev = ends.device
        NI, C, F = ends.shape[0], s2g.shape[0], s_sizes.shape[0]
        p = ctypes.c_void_p
        stream = p(torch.cuda.current_stream(dev).cuda_stream)
        # the merge's wrapper
        merged = torch.empty((3, NI), dtype=torch.int64, device=dev)
        _check(lib.l2_merge_launch(
            *(p(t.data_ptr()) for t in (cbest, cfirst, clast, ends, valid)), NI, cbest.shape[0],
            *(p(row.data_ptr()) for row in merged), stream), "old l2_merge")
        # _query_block's flags
        row = torch.stack([f.to(torch.int32) for f in flags])
        # the CGI wrapper
        slot_bin = torch.empty(F * ivmax, dtype=torch.int64, device=dev)
        slot_ident = torch.empty(F * ivmax, dtype=torch.float32, device=dev)
        _check(lib.cgi_bins_launch(
            *(p(t.data_ptr()) for t in (*merged, valid, seq, s_sizes, frag_qg, gate)),
            gate.shape[0], p(ident.data_ptr()), ident.shape[0] - 1, ident.shape[1],
            p(s2g.data_ptr()), C, F, ivmax, cmw, l, bin_max, p(slot_bin.data_ptr()),
            p(slot_ident.data_ptr()), stream), "old cgi_bins")
        return slot_bin, slot_ident, row

    return run


def compare(case: str, args, old, gpu: str, reps: int, timed: bool) -> None:
    """Old and new against the plain version on one case."""
    import torch

    from pyfastani_tpu_torch.ops import cgi

    want = cgi.cgi_bins_reference(*args)
    for label, fn in (("old", old), ("new", cgi.cgi_bins)):
        got = fn(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"merge_cgi {label} differs from the plain version ({case})")
    kept = int((want[0] >= 0).sum())
    shape = (f"F={args[6].shape[0]}, ivmax={args[13]}, ch_max={args[0].shape[0]}, "
             f"{int(args[3][-1])} chunks, {kept} kept slots, flags {want[2].tolist()}")
    if not timed:
        print(f"merge_cgi {case}: {shape}; old and new equal to the plain version ({gpu})",
              flush=True)
        return
    t_a1 = cs.time_ms(old, args, reps)
    t_b1 = cs.time_ms(cgi.cgi_bins, args, reps)
    t_b2 = cs.time_ms(cgi.cgi_bins, args, reps)
    t_a2 = cs.time_ms(old, args, reps)
    split_a = cs.device_split(old, args, reps)
    split_b = cs.device_split(cgi.cgi_bins, args, reps)
    d_a, d_b = sum(split_a.values()), sum(split_b.values())
    work, prior = cs.cgi_work(args), cs.cgi_work(args, old=True)
    print(
        f"merge_cgi {case}: {shape}; both equal to the plain version. Timed call old "
        f"{t_a1:.4f}/{t_a2:.4f} ms, new {t_b1:.4f}/{t_b2:.4f} ms; device work alone old "
        f"{d_a:.4f} ms in {len(split_a)} kernels, new {d_b:.4f} ms in {len(split_b)} (old/new "
        f"{d_a / d_b:.2f}x); fused bound {work['bound_ms']:.4f} ms by {work['bound_by']} "
        f"({work['bytes']} B, {work['ops']} int32 ops): new {100 * work['bound_ms'] / d_b:.1f}% "
        f"of it; the parent's merge + CGI bound {prior['bound_ms']:.4f} ms ({prior['bytes']} B):"
        f" old {100 * prior['bound_ms'] / d_a:.1f}% of it ({gpu})", flush=True)
    for label, split in (("old", split_a), ("new", split_b)):
        parts = ", ".join(f"{cs.kernel_name(name)} {ms:.4f}" for name, ms in split.most_common())
        print(f"merge_cgi {case}:   {label} split (ms a call): {parts}", flush=True)


def captured(gpu: str, with_ava: bool) -> dict:
    """``{case: {kernel: operands}}`` of the L2 sweep and the tail of the
    first group of the small batch (``real``), of the all-vs-all
    (``ava``) and of one ``query_draft`` call on its panel (``draft``)."""
    import torch

    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch.session import Session

    out = {}
    refs, queries, _ = cs.genomes()
    sketch = pt.Sketch()
    for i, r in enumerate(refs):
        sketch.add_genome(f"ref{i}", r)
    session = Session(sketch.index())
    got = cs.capture_operands(lambda: session.query_many([[q] for q in queries[: cs.N_QUERIES]]))
    out["real"] = got[4]
    del session, sketch
    torch.cuda.empty_cache()
    if with_ava:
        genomes = cs.ava_genomes(cs.AVA_GENOMES)
        sketch = pt.Sketch()
        for i, g in enumerate(genomes):
            sketch.add_genome(f"g{i}", g)
        mapper = sketch.index()
        session = Session(mapper)
        got = cs.capture_operands(lambda: session.query_many([[g] for g in genomes]))
        out["ava"] = got[4]
        del session
        torch.cuda.empty_cache()
        got = cs.capture_operands(lambda: mapper.query_draft([genomes[0]]))
        out["draft"] = got[4]
    print(f"captured the first group of: {', '.join(out)} ({gpu})", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", nargs="+", required=True,
                    metavar="merge_cgi OLD_L2_SWEEP.cu OLD_CGI.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-ava", action="store_true", help="skip the all-vs-all's capture")
    opts = ap.parse_args()
    name, *sources = opts.kernel
    if KERNELS.get(name) != len(sources):
        ap.error("--kernel takes merge_cgi OLD_L2_SWEEP.cu OLD_CGI.cu")

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    gpu = cs.gpu_line()
    from pyfastani_tpu_torch import _build

    _build.load_library()
    device = torch.device("cuda", 0)
    lib, lines = build_old(name, sources)
    old = old_path(lib)
    for ln in lines:
        print(f"ptxas old {name}: {ln}", flush=True)
    for ln in ptxas_lines(_build.build_log(), ("cgi_bins",)):
        print(f"ptxas new {name}: {ln}", flush=True)
    paths = captured(gpu, not opts.no_ava)
    for c in cs.CGI_CASES:
        compare(c, cs.torch_args(cs.cgi_case(c), device), old, gpu, opts.reps, c == "main")
    for c, ops in paths.items():
        compare(c, ops["cgi_bins"], old, gpu, opts.reps, True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
