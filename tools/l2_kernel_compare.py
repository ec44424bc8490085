"""The L2 chunk kernel against another version of it, on one GPU.

    python3 tools/l2_kernel_compare.py OLD.cu
    python3 tools/l2_kernel_compare.py --scratch

With ``OLD.cu`` (an earlier ``pyfastani_tpu_torch/csrc/l2_chunks.cu``
with the same ``l2_chunks_launch`` C interface, for example
``git show <commit>:pyfastani_tpu_torch/csrc/l2_chunks.cu``) it builds that
source with the port's nvcc flags and holds its kernel ("old") against the
current one ("new").  With ``--scratch`` it holds the current scratch
variant (``l2_chunks_launch_scratch``, the kernel past shared memory)
against the current shared-memory kernel on ranges both serve.  The cases
are those of ``chip_smoke.py`` phase 3: ``main``, ``wide``, ``real`` (the
operands of one L2 sweep of the 10 x 2 Mbp small batch, 4 queries) and
``ava`` (the first L2 sweep of the 512-genome all-vs-all).  On each case
both must equal the plain version bitwise; then it prints both kernels'
times between CUDA events (in turns: a, b, b, a), each kernel alone in
device time (``torch.profiler``), the bound, the share of it reached, and
the kernel launches of one small-batch ``query_many``.  Last, the current
kernel's timed call on variants of ``main`` that isolate its costs:
fragments in runs (one sketch-set build per run), no sketch (nothing to
insert or match), no anchors, ranges cut to 64 entries.  Every line names
the card and its power limit.  Needs a GPU; imports no JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def build_old(source: str) -> ctypes.CDLL:
    from pyfastani_tpu_torch import _build

    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    os.makedirs(_build._BUILD_DIR, exist_ok=True)
    path = os.path.join(_build._BUILD_DIR, f"old_l2_chunks_{digest}.so")
    if not os.path.exists(path):
        proc = subprocess.run(
            [_build._nvcc(), *_build._NVCC_FLAGS, "-o", path, source],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.l2_chunks_launch.argtypes = [
        ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
        i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr,
    ]
    lib.l2_chunks_launch.restype = i32
    return lib


def kernel_of(lib, scratch: bool = False):
    """`ops.l2.l2_chunks` through ``lib``'s shared-memory kernel, or with
    ``scratch`` through its scratch variant whatever the range capacity."""
    import torch

    from pyfastani_tpu_torch._common import hash_to_i32

    def run(q, s, mh, wp, prev, lo, rlen, frag, c0, clen, cmw, rmax):
        N, S = lo.shape[0], q.shape[1]
        best = torch.empty(N, dtype=torch.int32, device=q.device)
        first, last = torch.empty_like(best), torch.empty_like(best)
        flag = torch.zeros(1, dtype=torch.int32, device=q.device)
        ops = [hash_to_i32(q), s, mh, wp, prev, lo, rlen, frag, c0, clen]
        p = [ctypes.c_void_p(t.contiguous().data_ptr()) for t in ops]
        out = [ctypes.c_void_p(t.data_ptr()) for t in (best, first, last, flag)]
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        tail = (N, cmw, rmax, mh.shape[0], q.shape[0], *out)
        if scratch:
            words = lib.l2_chunks_scratch_words(q.device.index, S, rmax, N)
            buf = torch.empty(max(words, 1), dtype=torch.int32, device=q.device)
            err = lib.l2_chunks_launch_scratch(
                *p[:2], S, *p[2:], *tail, ctypes.c_void_p(buf.data_ptr()), words, stream
            )
        else:
            err = lib.l2_chunks_launch(*p[:2], S, *p[2:], *tail, stream)
        if err:
            raise RuntimeError(f"kernel launch failed: {err}")
        return best, first, last, flag[0]

    return run


def real_case(gpu: str):
    """The operands of one L2 sweep of the small batch, and the kernel
    launches of one ``query_many`` of it."""
    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch.ops import l2
    from pyfastani_tpu_torch.session import Session

    refs, queries, _ = cs.genomes()
    sketch = pt.Sketch()
    for i, r in enumerate(refs):
        sketch.add_genome(f"ref{i}", r)
    session = Session(sketch.index())
    batch = [[q] for q in queries[: cs.N_QUERIES]]
    session.query_many(batch)
    l2.launches = 0
    passes = session.stats["dispatches"]
    session.query_many(batch)
    passes = session.stats["dispatches"] - passes
    print(f"small batch: {l2.launches} kernel launches in {passes} pass(es) of "
          f"query_many; budgets {session.budgets} ({gpu})", flush=True)
    return cs.capture_l2_operands(session, batch)[1]


def ava_case():
    """The operands of the first L2 sweep of the all-vs-all's first pass,
    as ``chip_smoke.py`` phase 10 captures them."""
    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch.session import Session

    genomes = cs.ava_genomes(cs.AVA_GENOMES)
    sketch = pt.Sketch()
    for i, g in enumerate(genomes):
        sketch.add_genome(f"g{i}", g)
    session = Session(sketch.index())
    return cs.capture_l2_operands(session, [[g] for g in genomes])[1]


def main() -> int:
    import torch

    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    gpu = cs.gpu_line()
    from pyfastani_tpu_torch import _build
    from pyfastani_tpu_torch.ops import l2

    if sys.argv[1] == "--scratch":
        pair = (("scratch", kernel_of(_build.load_library(), scratch=True)),
                ("shared", kernel_of(_build.load_library())))
    else:
        pair = (("old", kernel_of(build_old(sys.argv[1]))), ("new", l2.l2_chunks))
    (a_name, a_fn), (b_name, b_fn) = pair
    rng = np.random.default_rng(11)
    device = torch.device("cuda", 0)
    cases = [
        ("main", cs.kernel_case(rng, cs.KERNEL_N, cs.KERNEL_RMAX, device)),
        ("wide", cs.kernel_case(rng, cs.WIDE_N, cs.WIDE_RMAX, device)),
        ("real", real_case(gpu)),
        ("ava", ava_case()),
    ]
    for name, args in cases:
        want = l2.l2_chunks_reference(*args)
        for label, fn in pair:
            got = fn(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{label} kernel differs from the plain version ({name})")
        t_a1 = cs.time_ms(a_fn, args)
        t_b1 = cs.time_ms(b_fn, args)
        t_b2 = cs.time_ms(b_fn, args)
        t_a2 = cs.time_ms(a_fn, args)
        d_a = cs.kernel_device_ms(a_fn, args)
        d_b = cs.kernel_device_ms(b_fn, args)
        work = cs.kernel_work(args)
        print(
            f"{name}: {args[5].shape[0]} chunks ({work['live']} live, {work['entries']} range "
            f"entries), rmax {args[11]}, S {args[0].shape[1]}; both bitwise equal to the plain "
            f"version. Timed call {a_name} {t_a1:.4f}/{t_a2:.4f} ms, {b_name} {t_b1:.4f}/"
            f"{t_b2:.4f} ms; kernel alone {a_name} {d_a:.4f} ms, {b_name} {d_b:.4f} ms of "
            f"device time ({a_name}/{b_name} {d_a / d_b:.2f}x); bound {work['bound_ms']:.4f} ms "
            f"by {work['bound_by']} ({work['bytes']} B, {work['ops']} int32 ops): {a_name} "
            f"{100 * work['bound_ms'] / d_a:.2f}%, {b_name} {100 * work['bound_ms'] / d_b:.2f}% "
            f"of it ({gpu})",
            flush=True,
        )

    main_args = cases[0][1]
    probes = {
        "main as is": main_args,
        "fragments in runs": main_args[:7] + (torch.sort(main_args[7]).values,) + main_args[8:],
        "no sketch (s = 0)": main_args[:1] + (torch.zeros_like(main_args[1]),) + main_args[2:],
        "no anchors (clen = 1)": main_args[:9] + (torch.ones_like(main_args[9]),) + main_args[10:],
        "ranges cut to 64": main_args[:6] + (main_args[6].clamp(max=64),) + main_args[7:],
    }
    for label, args in probes.items():
        print(f"main probe, {label}: new kernel {cs.time_ms(l2.l2_chunks, args, reps=20):.4f} ms "
              f"per timed call ({gpu})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
