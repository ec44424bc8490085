"""A group's CGI + fold tail against an earlier source of it, on one GPU.

    python3 tools/kernel_compare.py --kernel cgi_fold OLD.cu [--reps N] [--no-ava]

``--kernel cgi_fold OLD.cu`` names an earlier
``pyfastani_tpu_torch/csrc/cgi.cu`` with the C interface of commit
``4645a89`` (``cgi_bins_launch`` into a dense ``best_bin``,
``fold_bins_launch`` from it), for example
``git show 4645a89:pyfastani_tpu_torch/csrc/cgi.cu > build/old/cgi.cu``.
The tool builds that source with the port's nvcc flags and prints what
``-Xptxas -v`` says of its kernels and of the current ones (registers,
spills, shared memory).  Both sides are a group's whole tail on a
one-cell mesh, from CGI's operands and the cell's flags to the pass's
packed int64 outputs: old, that commit's ``-inf`` fill of ``best_bin``,
its CGI kernel, ``_pass``'s merge buffer (a ``-inf`` fill, the flags'
slice, two ``maximum``, the flags' float cast), the fold's ``zeros`` and
kernel, then the ``stack``s and ``cat``, through an adapter of that
interface; new, ``ops/cgi.py::cgi_bins`` and ``fold_bins`` into the
packed output through a persistent ``-inf`` scratch, which must read all
``-inf`` after every call.  A later redesign of another kernel adds its
own ``--kernel NAME`` and adapter here and takes out the one before it
once its numbers are recorded (the winnow, L1 and L2 plan comparisons of
PRs 11-12 are in this file at commit ``4645a89``).

Cases: every case of ``chip_smoke.CGI_CASES`` (checked, not timed;
``main``, the all-vs-all's shape, timed), and the operands captured from
the path (``chip_smoke.capture_operands``): ``real``, the first group of
the 10 x 2 Mbp small batch (4 queries), ``ava``, the first group of the
512-genome all-vs-all (~100 s to index), and ``draft``, one
``Mapper.query_draft`` call on the all-vs-all's panel (``q_capacity`` 1).
On each case both tails' packed outputs must equal the plain versions'
bitwise.  On the timed cases: each call between CUDA events in turns
(old, new, new, old), each call's device work alone (``torch.profiler``:
every device kernel the call launches, its fills and copies included)
split by kernel name, the bound (``chip_smoke.cgi_work`` +
``fold_work``, beside their dense contract's) and the share of it each
reached.  Every line names the card and its power limit.  Needs a GPU;
imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

KERNELS = ("cgi_fold",)


def build_old(kernel: str, source: str):
    """``(library, ptxas lines)`` of ``source`` built alone with the
    port's nvcc flags."""
    from pyfastani_tpu_torch import _build

    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    os.makedirs(_build._BUILD_DIR, exist_ok=True)
    path = os.path.join(_build._BUILD_DIR, f"old_{kernel}_{digest}.so")
    proc = subprocess.run(
        [_build._nvcc(), *_build._NVCC_FLAGS, "-shared", "-o", path, source],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cgi_bins_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr, i64, i64, ptr, i64, i64, i64, i64,
        i64, i64, ptr, ptr,
    ]
    lib.cgi_bins_launch.restype = i32
    lib.fold_bins_launch.argtypes = [ptr, ptr, i64, i64, i64, i64, ptr, ptr]
    lib.fold_bins_launch.restype = i32
    return lib, ptxas_lines(proc.stdout + proc.stderr, kernel)


def ptxas_lines(log: str, kernel: str) -> list:
    """The ``-Xptxas -v`` lines of ``kernel``'s entry functions in
    ``log``: one line each, name, registers, spills, shared memory."""
    key = {"cgi_fold": ("cgi_bins", "fold_")}[kernel]
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln:
            if any(k in name for k in key):
                out.append(f"{name[:60]}: {ln.split(':', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return out


def _check(lib_err: int, what: str) -> None:
    if lib_err != 0:
        raise RuntimeError(f"{what} launch failed: {lib_err}")


def old_tail(lib):
    """A group's tail on a one-cell mesh as commit 4645a89 ran it, around
    ``lib``'s CGI and fold kernels: ``(cgi_bins operands, the cell's
    flags)`` to the pass's packed int64 outputs."""
    import torch

    def run(args, flags):
        best, first, last, valid, seq, s_sizes, frag_qg, gate, ident, s2g, cmw, l, ivmax, \
            bin_max, g_max, q = args
        dev = best.device
        C, F = s2g.shape[0], s_sizes.shape[0]
        p = ctypes.c_void_p
        stream = p(torch.cuda.current_stream(dev).cuda_stream)
        # the wrapper
        best_bin = torch.full((q * C * bin_max,), -np.inf, dtype=torch.float32, device=dev)
        _check(lib.cgi_bins_launch(
            *(p(t.data_ptr()) for t in (best, first, last, valid, seq, s_sizes, frag_qg, gate)),
            gate.shape[0], p(ident.data_ptr()), ident.shape[0] - 1, ident.shape[1],
            p(s2g.data_ptr()), C, F, ivmax, cmw, l, bin_max, p(best_bin.data_ptr()), stream),
            "old cgi_bins")
        # _pass's merge on one cell
        n_bins = q * C * bin_max
        merged = torch.full((n_bins + 6,), -np.inf, dtype=torch.float32, device=dev)
        merged[-6:] = 0
        merged_flags = merged[-6:]
        out = merged[:n_bins]
        torch.maximum(out, best_bin.to(dev, non_blocking=True), out=out)
        torch.maximum(merged_flags, flags.to(dev, non_blocking=True).to(torch.float32),
                      out=merged_flags)
        # the fold's wrapper, then the packing
        sums = torch.zeros((3, q, g_max), dtype=torch.int64, device=dev)
        _check(lib.fold_bins_launch(p(out.data_ptr()), p(s2g.data_ptr()), q, C, bin_max, g_max,
                                    p(sums.data_ptr()), stream), "old fold_bins")
        folds = [sums.unbind(0)]
        return torch.cat([torch.stack(part).reshape(-1) for part in zip(*folds)]
                         + [merged_flags.to(torch.int64)])

    return run


def new_tail(scratch, plain: bool = False):
    """The same tail through this commit's wrappers (or, with ``plain``,
    their plain versions) and ``scratch``."""
    import torch

    from pyfastani_tpu_torch.ops import cgi

    cgi_fn = cgi.cgi_bins_reference if plain else cgi.cgi_bins
    fold_fn = cgi.fold_bins_reference if plain else cgi.fold_bins

    def run(args, flags):
        s2g, bin_max, g_max, q = args[9], args[13], args[14], args[15]
        slots = cgi_fn(*args)
        packed = torch.empty((3 * q * g_max + 6,), dtype=torch.int64, device=s2g.device)
        limbs = packed[:-6].view(3, q, g_max)
        fold_fn(*slots, scratch, s2g, q, bin_max, g_max, limbs, flags, packed[-6:])
        return packed

    return run


def tail_work(args, flags, dense: bool) -> dict:
    """The tail's bound: ``chip_smoke.cgi_work`` + ``fold_work`` on this
    call's slots (with ``dense``, both under the dense contract, which
    writes and reads every bin)."""
    from pyfastani_tpu_torch.ops import cgi

    fargs = cs.fold_args(cgi.cgi_bins_reference(*args), args, flags)
    a, b = cs.cgi_work(args, dense=dense), cs.fold_work(fargs, dense=dense)
    return cs._bound(a["bytes"] + b["bytes"], a["ops"] + b["ops"])


def compare_tail(case: str, args, flags, old, gpu: str, reps: int, timed: bool) -> None:
    """The tail, old and new, against the plain versions' on one case."""
    import torch

    from pyfastani_tpu_torch.ops import cgi

    scratch = torch.full((cs.cgi_bins_count(args),), -np.inf, device=args[0].device)
    new = new_tail(scratch)
    want = new_tail(scratch, plain=True)(args, flags)
    for label, fn in (("old", old), ("new", new)):
        got = fn(args, flags)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"cgi_fold {label} differs from the plain version ({case})")
        cs.scratch_clean(scratch, f"cgi_fold {case} ({label})")
    kept = int((cgi.cgi_bins_reference(*args)[0] >= 0).sum())
    shape = (f"F={args[5].shape[0]}, ivmax={args[12]}, q={args[15]}, C={args[9].shape[0]}, "
             f"bin_max={args[13]}, {kept} kept slots")
    if not timed:
        print(f"cgi_fold {case}: {shape}; old and new equal to the plain version ({gpu})",
              flush=True)
        return
    t_a1 = cs.time_ms(old, (args, flags), reps)
    t_b1 = cs.time_ms(new, (args, flags), reps)
    t_b2 = cs.time_ms(new, (args, flags), reps)
    t_a2 = cs.time_ms(old, (args, flags), reps)
    split_a = cs.device_split(old, (args, flags), reps)
    split_b = cs.device_split(new, (args, flags), reps)
    cs.scratch_clean(scratch, f"cgi_fold {case} after the timed calls")
    d_a, d_b = sum(split_a.values()), sum(split_b.values())
    work, dense = tail_work(args, flags, False), tail_work(args, flags, True)
    print(
        f"cgi_fold {case}: {shape}; both equal to the plain version, the scratch all -inf "
        f"after every call. Timed call old {t_a1:.4f}/{t_a2:.4f} ms, new {t_b1:.4f}/{t_b2:.4f} "
        f"ms; device work alone old {d_a:.4f} ms in {len(split_a)} kernels, new {d_b:.4f} ms in "
        f"{len(split_b)} (old/new {d_a / d_b:.2f}x); bound {work['bound_ms']:.4f} ms by "
        f"{work['bound_by']} ({work['bytes']} B, {work['ops']} int32 ops): old "
        f"{100 * work['bound_ms'] / d_a:.1f}%, new {100 * work['bound_ms'] / d_b:.1f}% of it; "
        f"the dense contract's bound {dense['bound_ms']:.4f} ms ({dense['bytes']} B): old "
        f"{100 * dense['bound_ms'] / d_a:.1f}%, new {100 * dense['bound_ms'] / d_b:.1f}% of it "
        f"({gpu})", flush=True)
    for label, split in (("old", split_a), ("new", split_b)):
        parts = ", ".join(f"{cs.kernel_name(name)} {ms:.4f}" for name, ms in split.most_common())
        print(f"cgi_fold {case}:   {label} split (ms a call): {parts}", flush=True)


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
    ap.add_argument("--kernel", nargs=2, required=True, metavar=("{cgi_fold}", "OLD.cu"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-ava", action="store_true", help="skip the all-vs-all's capture")
    opts = ap.parse_args()
    name, source = opts.kernel
    if name not in KERNELS:
        ap.error(f"--kernel takes cgi_fold, not {name}")

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    gpu = cs.gpu_line()
    from pyfastani_tpu_torch import _build

    _build.load_library()
    device = torch.device("cuda", 0)
    lib, lines = build_old(name, source)
    old = old_tail(lib)
    for ln in lines:
        print(f"ptxas old {name}: {ln}", flush=True)
    for ln in ptxas_lines(_build.build_log(), name):
        print(f"ptxas new {name}: {ln}", flush=True)
    paths = captured(gpu, not opts.no_ava)
    flags = torch.zeros(6, dtype=torch.int32, device=device)
    for c in cs.CGI_CASES:
        compare_tail(c, cs.torch_args(cs.cgi_case(c), device), flags, old, gpu, opts.reps,
                     c == "main")
    for c, ops in paths.items():
        compare_tail(c, ops["cgi_bins"], ops["fold_bins"][8], old, gpu, opts.reps, True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
