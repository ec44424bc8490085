"""The fragment winnow, L1 candidate and L2 plan kernels against earlier
sources of them, on one GPU.

    python3 tools/kernel_compare.py --kernel winnow OLD.cu [--kernel l1 OLD.cu]
                                    [--kernel l2_plan OLD.cu] [--reps N]

Each ``--kernel NAME OLD.cu`` names an earlier
``pyfastani_tpu_torch/csrc/winnow_fragments.cu`` (``winnow``) or
``csrc/l1_candidates.cu`` (``l1``) with the C interface of commit
``1c41f14`` (``winnow_fragments_scratch_bytes``/``winnow_fragments_launch``;
``l1_probe_launch``, a ``torch.cumsum``, ``l1_intervals_capacity``/
``l1_intervals_launch``), for example
``git show 1c41f14:pyfastani_tpu_torch/csrc/l1_candidates.cu > build/old_l1.cu``,
or an earlier ``csrc/l2_sweep.cu`` (``l2_plan``) with the interface of
commit ``0c54c8c`` (``l2_plan_count_launch``, a ``torch.cumsum``,
``l2_plan_launch`` on the looked-up intervals).
The tool builds that source with the port's nvcc flags and prints what
``-Xptxas -v`` says of its kernels and of the current ones (registers,
spills, shared memory).  It calls the old kernels through an adapter of
that interface ("old"; for the plan, behind the session's contig lookup
of that commit, 16 torch ops) and the current ones through the port's
wrapper (``ops/fragments.py::winnow_fragments``, ``ops/l1.py::l1_candidates``,
``ops/l2_sweep.py::l2_plan``, "new").

Cases: every case of ``chip_smoke.WINNOW_CASES`` / ``L1_CASES`` /
``SWEEP_CASES`` (checked, not timed; ``main`` of the L1 and plan cases
timed), the winnow's ``main`` (4096 x 3000 bytes, k 16, w 24), and the
operands captured from the path (``chip_smoke.capture_operands``):
``real``, the first group of the 10 x 2 Mbp small batch (4 queries), and
``ava``, the first group of the 512-genome all-vs-all (~100 s to index).
On each case both kernels must equal the plain version (the winnow
bitwise, L1 under ``chip_smoke._l1_err``, the plan under
``chip_smoke._plan_err``).  On the timed cases: each call between CUDA
events in turns (old, new, new, old), each call's device work alone
(``torch.profiler``: every device kernel the call launches, its fills,
``cumsum`` and lookup ops included) split by kernel name, the bound
(``chip_smoke.winnow_work`` / ``l1_work`` / ``plan_work``; for the plan
also the old contract's bound, `plan_work_pr10`) and the share of it
each reached.  For L1 also, as a diagnostic beside the bound, the 32-byte
sectors the call touches with the old probe's binary search and with the
new probe's window (``chip_smoke.l1_sectors``) and, on ``ava``, the live
probes' bucket depths.  Every line names the card and its power limit.  Needs a GPU;
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

KERNELS = ("winnow", "l1", "l2_plan")


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
    if kernel == "l2_plan":
        lib.l2_plan_count_launch.argtypes = [ptr, ptr, ptr, i64, i64, ptr, ptr]
        lib.l2_plan_count_launch.restype = i32
        lib.l2_plan_launch.argtypes = [
            ptr, i64, i64, ptr, ptr, ptr, ptr, ptr, i64, ptr, ptr, i64, ptr, i64, i32, i32, i64,
            i64, i64, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ]
        lib.l2_plan_launch.restype = i32
    elif kernel == "winnow":
        lib.winnow_fragments_scratch_bytes.argtypes = [i32, i64, i32, i32, i32]
        lib.winnow_fragments_scratch_bytes.restype = i64
        lib.winnow_fragments_launch.argtypes = [
            ptr, i64, i32, i64, i32, i32, i32, i32, i64, ptr, ptr, ptr, ptr, ptr, i64, ptr,
        ]
        lib.winnow_fragments_launch.restype = i32
    else:
        lib.l1_probe_launch.argtypes = [
            ptr, i64, ptr, i32, i32, ptr, ptr, ptr, i64, ptr, i32, i32, i64, ptr, ptr, ptr, ptr,
        ]
        lib.l1_probe_launch.restype = i32
        lib.l1_intervals_capacity.argtypes = [i32, i64]
        lib.l1_intervals_capacity.restype = i64
        lib.l1_intervals_launch.argtypes = [
            ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, i32, ptr, i64, i64, i32, i32, i64,
            ptr, ptr, ptr, ptr, ptr, ptr,
        ]
        lib.l1_intervals_launch.restype = i32
    return lib, ptxas_lines(proc.stdout + proc.stderr, kernel)


def ptxas_lines(log: str, kernel: str) -> list:
    """The ``-Xptxas -v`` lines of ``kernel``'s entry functions in
    ``log``: one line each, name, registers, spills, shared memory."""
    key = {"winnow": "winnow", "l1": "l1_", "l2_plan": "l2_plan"}[kernel]
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln:
            if key in name:
                out.append(f"{name[:60]}: {ln.split(':', 1)[1].strip()}; {spill}")
            name, spill = None, ""
    return out


def _check(lib_err: int, what: str) -> None:
    if lib_err != 0:
        raise RuntimeError(f"{what} launch failed: {lib_err}")


def old_winnow(lib):
    """The wrapper of commit 1c41f14 around ``lib``'s winnow kernel."""
    import torch

    from pyfastani_tpu_torch.ops.winnow import _complement_lut

    def run(frags, k, w, length, protein, kc):
        dev = frags.device
        F = frags.shape[0]
        wout = max(0, min(kc, length - k - w + 2))
        q = torch.empty((F, wout), dtype=torch.int64, device=dev)
        s = torch.empty(F, dtype=torch.int32, device=dev)
        ovf = torch.zeros(1, dtype=torch.int32, device=dev)
        comp = _complement_lut(dev)
        need = lib.winnow_fragments_scratch_bytes(dev.index or 0, length, k, w, F)
        scratch = torch.empty(need, dtype=torch.uint8, device=dev) if need else None
        p = ctypes.c_void_p
        _check(lib.winnow_fragments_launch(
            p(frags.data_ptr()), frags.stride(0), F, length, k, w, int(protein), kc, wout,
            p(comp.data_ptr()), p(q.data_ptr()), p(s.data_ptr()), p(ovf.data_ptr()),
            p(scratch.data_ptr()) if need else None, need,
            p(torch.cuda.current_stream().cuda_stream)), "old winnow")
        return ovf[0] != 0, q, s

    return run


def old_l1(lib):
    """The wrapper of commit 1c41f14 around ``lib``'s two L1 kernels."""
    import torch

    def run(q, s, uniq, rs, rl, post, thr, table, bucket, hmax, ivmax, l, steps, m_values):
        dev = q.device
        F, S = q.shape
        T = F * hmax
        g0 = torch.empty((F, ivmax), dtype=torch.int32, device=dev)
        g1 = torch.empty_like(g0)
        valid = torch.empty((F, ivmax), dtype=torch.bool, device=dev)
        flags = torch.zeros(2, dtype=torch.int32, device=dev)
        plen = torch.empty((F, S), dtype=torch.int32, device=dev)
        pstart = torch.empty_like(plen)
        counts = torch.empty(F, dtype=torch.int64, device=dev)
        bits = int(bucket.shape[0] - 1).bit_length() - 1
        p = ctypes.c_void_p
        stream = p(torch.cuda.current_stream().cuda_stream)
        _check(lib.l1_probe_launch(
            p(q.data_ptr()), q.stride(0), p(s.data_ptr()), F, S, p(uniq.data_ptr()),
            p(rs.data_ptr()), p(rl.data_ptr()), uniq.shape[0], p(bucket.data_ptr()), bits, steps,
            min(int(thr), 2**62), p(plen.data_ptr()), p(pstart.data_ptr()), p(counts.data_ptr()),
            stream), "old l1 probe")
        ends = torch.cumsum(counts, dim=0)
        cap = lib.l1_intervals_capacity(dev.index or 0, hmax)
        scratch = torch.empty(max(T, 1), dtype=torch.int32, device=dev)
        _check(lib.l1_intervals_launch(
            p(plen.data_ptr()), p(pstart.data_ptr()), p(counts.data_ptr()), p(ends.data_ptr()),
            F, S, p(s.data_ptr()), p(table.data_ptr()), table.shape[0], p(post.data_ptr()),
            post.shape[0], T, ivmax, l, cap, p(g0.data_ptr()), p(g1.data_ptr()),
            p(valid.data_ptr()), p(flags.data_ptr()), p(scratch.data_ptr()), stream),
            "old l1 intervals")
        ovf = flags != 0
        return g0, g1, valid, ovf[0], ovf[1]

    return run


def old_plan(lib):
    """The session's contig lookup and the plan wrapper of commit 0c54c8c
    around ``lib``'s two plan kernels, on this commit's operands and with
    its result (the contigs beside ``ends``)."""
    import torch

    from pyfastani_tpu_torch.ops._cuda import check

    def run(iv_g0, iv_g1, iv_valid, ivmax, contig_offset, cof_idx, mini_gpos, gpos_bucket,
            gpos_shift, gpos_steps, cmw, cmax, rcap, ch_max):
        dev = iv_g1.device
        i64 = torch.int64
        # the lookup, as the session ran it
        coff = contig_offset
        g0f = iv_g0.reshape(-1).to(i64)
        g1f = iv_g1.reshape(-1).to(i64)
        iv_seq = (torch.searchsorted(coff.to(i64), g1f, right=True) - 1).clamp(
            0, coff.shape[0] - 2
        )
        iv_base = coff[iv_seq].to(i64)
        iv_c0 = torch.maximum(g0f, iv_base) - iv_base
        iv_c1 = g1f - iv_base
        frag_of_iv = torch.arange(iv_g0.shape[0] * ivmax, device=dev) // ivmax
        # the wrapper
        NI = iv_seq.shape[0]
        for name, t in (("frag_of_iv", frag_of_iv), ("iv_seq", iv_seq), ("iv_c0", iv_c0),
                        ("iv_c1", iv_c1)):
            check(name, dev, i64, t, NI)
        check("iv_valid", dev, torch.bool, iv_valid, NI)
        for name, t in (("contig_offset", contig_offset), ("cof_idx", cof_idx),
                        ("mini_gpos", mini_gpos), ("gpos_bucket", gpos_bucket)):
            check(name, dev, torch.int32, t)
        frag_of_iv, iv_seq_c, iv_c0, iv_c1, iv_valid, contig_offset, cof_idx, mini_gpos, \
            gpos_bucket = (t.contiguous() for t in (frag_of_iv, iv_seq, iv_c0, iv_c1, iv_valid,
                                                    contig_offset, cof_idx, mini_gpos,
                                                    gpos_bucket))
        n_ch = torch.empty(NI, dtype=i64, device=dev)
        out = torch.empty((5, ch_max), dtype=torch.int32, device=dev)
        flags = torch.zeros(2, dtype=torch.bool, device=dev)
        p = ctypes.c_void_p
        stream = p(torch.cuda.current_stream(dev).cuda_stream)
        _check(lib.l2_plan_count_launch(
            p(iv_c0.data_ptr()), p(iv_c1.data_ptr()), p(iv_valid.data_ptr()), NI, cmax,
            p(n_ch.data_ptr()), stream), "old plan count")
        ends = torch.cumsum(n_ch, dim=0)
        _check(lib.l2_plan_launch(
            p(ends.data_ptr()), NI, ch_max, p(iv_seq_c.data_ptr()), p(iv_c0.data_ptr()),
            p(iv_c1.data_ptr()), p(frag_of_iv.data_ptr()), p(contig_offset.data_ptr()),
            contig_offset.shape[0], p(cof_idx.data_ptr()), p(mini_gpos.data_ptr()),
            mini_gpos.shape[0], p(gpos_bucket.data_ptr()), gpos_bucket.shape[0], gpos_shift,
            gpos_steps, cmw, cmax, rcap, *(p(row.data_ptr()) for row in out),
            p(flags.data_ptr()), stream), "old plan")
        return (*out.unbind(0), ends, iv_seq, flags[0], flags[1])

    return run


def plan_work_pr10(args, out) -> dict:
    """The least work of the plan under the contract of commit 0c54c8c,
    whose inputs were the looked-up intervals (int64 contig, window
    offsets and fragment row each): ``chip_smoke.plan_work`` of that
    commit on this call's data."""
    import torch

    from pyfastani_tpu_torch._common import BIG

    _, _, valid, _, coff, _, _, bucket, shift, steps, cmw, _, _, ch_max = args
    ch_c0, ch_len, ends, seq = out[3].long(), out[4].long(), out[5], out[6]
    NI, C1 = valid.shape[0], coff.shape[0]
    live = min(int(ends[-1]), ch_max)
    n_ch = torch.diff(ends, prepend=ends.new_zeros(1))
    owning = int(((n_ch > 0) & (ends - n_ch < ch_max)).sum())
    owner = torch.searchsorted(ends, torch.arange(live, device=ends.device), right=True)
    base = coff[seq[owner]].long()
    c0, ln = ch_c0[:live], ch_len[:live]
    keys = torch.cat([base + c0, base + (c0 + ln - 1 + cmw).clamp(max=BIG)])
    b = (keys >> shift).clamp(0, bucket.shape[0] - 2)
    size = (bucket[b + 1] - bucket[b]).double()
    depth = int(torch.ceil(torch.log2(size + 1)).clamp(max=steps).sum())
    nbytes = (NI * (1 + 8) + int(valid.sum()) * 16 + owning * 16 + C1 * 8 + keys.numel() * 8
              + 4 * depth + ch_max * 20 + 2)
    ops = NI * 6 + live * (3 * max(1, (NI - 1).bit_length()) + 30) + 4 * depth
    return cs._bound(nbytes, ops)


def depth_histogram(args) -> str:
    """The live probes' bucket sizes on ``args``, by range."""
    import torch

    q, s, _, _, _, _, _, _, bucket = args[:9]
    S = q.shape[1]
    live = torch.arange(S, device=q.device)[None, :] < s[:, None]
    bits = int(bucket.shape[0] - 1).bit_length() - 1
    b = (q[live] >> (32 - bits)).long()
    size = (bucket[b + 1] - bucket[b]).long().cpu().numpy()
    edges = [0, 1, 8, 16, 32, 64, 128, 256, 1 << 62]
    counts = np.histogram(size, bins=edges)[0]
    parts = [f"{lo}-{hi - 1}: {c}" for lo, hi, c in zip(edges[:-1], edges[1:], counts)]
    return (f"{size.shape[0]} live probes, bucket sizes (entries) {', '.join(parts[:-1])}, "
            f"256+: {counts[-1]}; median {np.median(size):.0f}, max {size.max(initial=0)}, "
            f"{bits} bucket bits")


def captured(gpu: str, with_ava: bool) -> dict:
    """``{case: (winnow operands, l1 operands, plan operands)}`` of the
    first group of the small batch (``real``) and of the all-vs-all
    (``ava``)."""
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
    out["real"] = (got[2], got[3], got[4]["l2_plan"])
    del session, sketch
    torch.cuda.empty_cache()
    if with_ava:
        genomes = cs.ava_genomes(cs.AVA_GENOMES)
        sketch = pt.Sketch()
        for i, g in enumerate(genomes):
            sketch.add_genome(f"g{i}", g)
        session = Session(sketch.index())
        got = cs.capture_operands(lambda: session.query_many([[g] for g in genomes]))
        out["ava"] = (got[2], got[3], got[4]["l2_plan"])
    print(f"captured the first group of: {', '.join(out)} ({gpu})", flush=True)
    return out


def compare(kernel: str, case: str, args, old, new, reference, gpu: str, reps: int,
            timed: bool) -> None:
    import torch

    for label, fn in (("old", old), ("new", new)):
        got = fn(*args)
        want = reference(*args)
        torch.cuda.synchronize()
        err = {"winnow": cs._winnow_err, "l1": cs._l1_err, "l2_plan": cs._plan_err}[kernel](
            got, want)
        if err != 0:
            raise AssertionError(f"{kernel} {label} differs from the plain version ({case}): {err}")
    if not timed:
        print(f"{kernel} {case}: old and new equal to the plain version ({gpu})", flush=True)
        return
    t_a1 = cs.time_ms(old, args, reps)
    t_b1 = cs.time_ms(new, args, reps)
    t_b2 = cs.time_ms(new, args, reps)
    t_a2 = cs.time_ms(old, args, reps)
    split_a = cs.device_split(old, args, reps)
    split_b = cs.device_split(new, args, reps)
    d_a, d_b = sum(split_a.values()), sum(split_b.values())
    if kernel == "winnow":
        work = cs.winnow_work(args, reference(*args)[2])
        shape = f"F={args[0].shape[0]} x {args[3]} bytes, k={args[1]}, w={args[2]}"
        extra = ""
    elif kernel == "l2_plan":
        want = reference(*args)
        work = cs.plan_work(args, want)
        old_work = plan_work_pr10(args, want)
        shape = (f"NI={args[2].shape[0]}, {int(want[5][-1])} chunks of {args[13]} slots, "
                 f"{args[4].shape[0] - 1} contigs, M={args[6].shape[0]}, steps {args[9]}")
        extra = (f"; the old contract's bound {old_work['bound_ms']:.4f} ms by "
                 f"{old_work['bound_by']} ({old_work['bytes']} B, {old_work['ops']} int32 ops): "
                 f"old {100 * old_work['bound_ms'] / d_a:.1f}%, new "
                 f"{100 * old_work['bound_ms'] / d_b:.1f}% of it")
    else:
        work = cs.l1_work(args)
        n, _ = cs.l1_hits(args)
        shape = (f"F={args[0].shape[0]}, S={args[0].shape[1]}, U={args[2].shape[0]}, "
                 f"hmax={args[9]}, {int(n.sum())} hits (at most {int(n.max())} a fragment)")
        sec = cs.l1_sectors(args)
        extra = "".join(
            f"; 32-byte sectors with the {kind} probe {n_sec} = "
            f"{1e3 * n_sec * 32 / cs.HBM_BYTES_PER_S:.4f} ms at the bytes rate"
            for kind, n_sec in sec.items())
    print(
        f"{kernel} {case}: {shape}; both equal to the plain version. Timed call old "
        f"{t_a1:.4f}/{t_a2:.4f} ms, new {t_b1:.4f}/{t_b2:.4f} ms; device work alone old "
        f"{d_a:.4f} ms, new {d_b:.4f} ms (old/new {d_a / d_b:.2f}x); bound "
        f"{work['bound_ms']:.4f} ms by {work['bound_by']} ({work['bytes']} B, {work['ops']} "
        f"int32 ops): old {100 * work['bound_ms'] / d_a:.1f}%, new "
        f"{100 * work['bound_ms'] / d_b:.1f}% of it{extra} ({gpu})", flush=True)
    for label, split in (("old", split_a), ("new", split_b)):
        parts = ", ".join(f"{cs.kernel_name(name)} {ms:.4f}" for name, ms in split.most_common())
        print(f"{kernel} {case}:   {label} split (ms a call): {parts}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", nargs=2, action="append", required=True,
                    metavar=("{winnow,l1,l2_plan}", "OLD.cu"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-ava", action="store_true", help="skip the all-vs-all's capture")
    opts = ap.parse_args()
    for name, _ in opts.kernel:
        if name not in KERNELS:
            ap.error(f"--kernel takes winnow, l1 or l2_plan, not {name}")

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    gpu = cs.gpu_line()
    from pyfastani_tpu_torch import _build
    from pyfastani_tpu_torch.ops import fragments, l1, l2_sweep

    _build.load_library()
    device = torch.device("cuda", 0)
    olds = {}
    for name, source in opts.kernel:
        lib, lines = build_old(name, source)
        olds[name] = {"winnow": old_winnow, "l1": old_l1, "l2_plan": old_plan}[name](lib)
        for ln in lines:
            print(f"ptxas old {name}: {ln}", flush=True)
        for ln in ptxas_lines(_build.build_log(), name):
            print(f"ptxas new {name}: {ln}", flush=True)
    paths = captured(gpu, not opts.no_ava)
    for name in olds:
        if name == "winnow":
            new, ref = fragments.winnow_fragments, fragments.winnow_fragments_reference
            cases = [(c, (torch.from_numpy(cs.winnow_case(c)[0]).to(device),
                          *cs.winnow_case(c)[1:]), False) for c in cs.WINNOW_CASES]
            main_frags = cs._frag_rows(np.random.default_rng(12), cs._ACGT, 4096, 3000)
            cases.append(("main", (torch.from_numpy(main_frags).to(device), 16, 24, 3000, False,
                                   512), True))
            cases += [(c, ops[0], True) for c, ops in paths.items()]
        elif name == "l1":
            new, ref = l1.l1_candidates, l1.l1_candidates_reference
            cases = [(c, cs.l1_torch_args(cs.l1_case(c), device), c == "main")
                     for c in cs.L1_CASES]
            cases += [(c, ops[1], True) for c, ops in paths.items()]
        else:
            new, ref = l2_sweep.l2_plan, l2_sweep.l2_plan_reference
            cases = [(c, cs.torch_args(cs.sweep_case(c), device), c == "main")
                     for c in cs.SWEEP_CASES]
            cases += [(c, ops[2], True) for c, ops in paths.items()]
        for case, args, timed in cases:
            compare(name, case, args, olds[name], new, ref, gpu, opts.reps, timed)
            if name == "l1" and case == "ava":
                print(f"l1 ava: {depth_histogram(args)} ({gpu})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
