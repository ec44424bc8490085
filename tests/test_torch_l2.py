"""Port parity: the L2 chunk evaluator and its index precomputations.

``l2_chunks_reference`` (the plain torch version of the CUDA kernel) must
equal the JAX package's Pallas kernel (interpret mode) and its XLA event
scan on the fixtures of ``tests/test_l2_pallas.py``.  The CUDA kernel
itself is compared with the plain version in a test that needs a card
(marker ``cuda``); it imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_l2.py -m cuda
"""

import numpy as np
import pytest
import torch

from pyfastani_tpu_torch._common import bits_to_i32
from pyfastani_tpu_torch.ops import l2 as tl2

CMW = 2985


def _mini_store(rng, m, n_contigs=2, hash_bits=18):
    """Synthetic position-ordered minimizer store with dense hash reuse."""
    gpos = np.cumsum(rng.integers(5, 20, size=m))
    bounds = np.sort(rng.choice(gpos[m // 8 :], size=n_contigs - 1, replace=False))
    seqid = np.searchsorted(bounds, gpos, side="right").astype(np.int32)
    base = np.concatenate([[0], bounds])
    wpos = (gpos - base[seqid]).astype(np.int32)
    mh = rng.integers(0, 1 << hash_bits, size=m).astype(np.uint32)
    return mh, seqid, wpos


def _contig_clamp(seqid, lo, rlen):
    """Cut each range at its first entry from another contig."""
    rlen = rlen.copy()
    hi = np.minimum(lo + rlen, seqid.shape[0])
    for i in range(lo.shape[0]):
        run = np.flatnonzero(seqid[lo[i] : hi[i]] != seqid[lo[i]])
        if run.size:
            rlen[i] = run[0]
    return rlen


def _random_case(seed, M=20000, F=16, S=256, N=64, rmax=700):
    rng = np.random.default_rng(seed)
    mh, seqid, wpos = _mini_store(rng, M)
    q = np.sort(rng.choice(mh, size=(F, S)), axis=1).astype(np.uint32)
    s_sizes = np.full(F, S, np.int32)
    lo = rng.integers(0, M - 900, size=N).astype(np.int32)
    rlen = rng.integers(0, rmax, size=N).astype(np.int32)
    frag = rng.integers(0, F, size=N).astype(np.int32)
    c0 = wpos[lo]
    clen = rng.integers(1, 3072, size=N).astype(np.int32)
    rlen = _contig_clamp(seqid, lo, rlen)
    return (mh, seqid, wpos), (q, s_sizes), (frag, c0, clen, lo, rlen)


def _edge_case():
    rng = np.random.default_rng(3)
    M = 4096
    mh, seqid, wpos = _mini_store(rng, M, n_contigs=1)
    F, S = 8, 128
    q = np.sort(rng.choice(mh, size=(F, S)), axis=1).astype(np.uint32)
    s_sizes = np.full(F, S, np.int32)
    # zero-length ranges, zero-length chunks, range at the very end
    frag = np.array([0, 1, 2, 3], np.int32)
    lo = np.array([0, M - 10, 100, 0], np.int32)
    rlen = np.array([0, 10, 0, 5], np.int32)
    c0 = np.array([0, int(wpos[M - 10]), 50, 0], np.int32)
    clen = np.array([100, 3072, 0, 1], np.int32)
    return (mh, seqid, wpos), (q, s_sizes), (frag, c0, clen, lo, rlen)


def _port(store, sketch, chunks, rmax, device="cpu"):
    mh, seqid, wpos = store
    q, s_sizes = sketch
    frag, c0, clen, lo, rlen = chunks
    prev = tl2.compute_mini_prev(mh, seqid, wpos)

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    return (
        t(q, torch.int64), t(s_sizes), t(bits_to_i32(mh)), t(wpos), t(prev),
        t(lo), t(rlen), t(frag), t(c0), t(clen), CMW, rmax,
    )


_CASES = {"seed1": lambda: _random_case(1), "seed2": lambda: _random_case(2), "edge": _edge_case}


@pytest.mark.parametrize("case", list(_CASES))
def test_reference_matches_pallas_and_xla(case):
    import jax.numpy as jnp

    from pyfastani_tpu.ops.l2 import l2_chunk_scan
    from pyfastani_tpu.ops.l2_pallas import compute_mini_prev, l2_chunks_pallas

    store, sketch, chunks = _CASES[case]()
    mh, seqid, wpos = store
    q, s_sizes = sketch
    frag, c0, clen, lo, rlen = chunks
    got = tl2.l2_chunks_reference(*_port(store, sketch, chunks, rmax=896))

    table = np.stack([frag, c0, clen, lo, rlen], axis=1)
    xla = l2_chunk_scan(q, s_sizes, mh, wpos, table, CMW, 3072)
    pallas = l2_chunks_pallas(
        jnp.asarray(q), mh, wpos, compute_mini_prev(mh, seqid, wpos),
        jnp.asarray(frag), jnp.asarray(c0), jnp.asarray(clen), jnp.asarray(lo),
        jnp.asarray(rlen), jnp.asarray(seqid[lo]), CMW, 1024, interpret=True,
    )
    for name, g, x, p in zip(["best", "first", "last"], got, xla, pallas):
        np.testing.assert_array_equal(g.numpy(), x, err_msg=name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(p), err_msg=name)
    assert (got[0].numpy() > 0).any()


def test_reference_bounds_search_by_sketch_size():
    """Membership looks only at the first ``min(s, S)`` sketch entries:
    a sketch cut to half its size equals a sketch whose tail is padding."""
    store, (q, s_sizes), chunks = _random_case(4)
    half = np.full_like(s_sizes, q.shape[1] // 2)
    q_pad = q.copy()
    q_pad[:, q.shape[1] // 2 :] = 0xFFFFFFFF
    a = tl2.l2_chunks_reference(*_port(store, (q, half), chunks, rmax=896))
    b = tl2.l2_chunks_reference(*_port(store, (q_pad, s_sizes), chunks, rmax=896))
    c = tl2.l2_chunks_reference(*_port(store, (q, s_sizes), chunks, rmax=896))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_mini_prev_copies_match_originals():
    from pyfastani_tpu.models import _engine_np
    from pyfastani_tpu.ops import l2_pallas as jl2

    rng = np.random.default_rng(0)
    mh, seqid, wpos = _mini_store(rng, 5000, n_contigs=3, hash_bits=10)
    np.testing.assert_array_equal(
        tl2.compute_mini_prev(mh, seqid, wpos), jl2.compute_mini_prev(mh, seqid, wpos)
    )
    sub = _engine_np.build_index(mh, seqid, wpos)
    want = jl2.mini_prev_from_index(sub)
    np.testing.assert_array_equal(tl2.mini_prev_from_index(sub), want)
    np.testing.assert_array_equal(want, jl2.compute_mini_prev(mh, seqid, wpos))
    sub.order = None  # the fallback when the CSR permutation is gone
    np.testing.assert_array_equal(tl2.mini_prev_from_index(sub), jl2.mini_prev_from_index(sub))


def test_l2_chunks_takes_plain_version_on_cpu_only():
    args = _port(*_edge_case(), rmax=896)
    before = (tl2.launches, tl2.reference_calls)
    out = tl2.l2_chunks(*args)
    assert (tl2.launches, tl2.reference_calls) == (before[0], before[1] + 1)
    ref = tl2.l2_chunks_reference(*args)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tl2.l2_chunks(*meta)
    with pytest.raises(TypeError):
        tl2.l2_chunks(args[0].to(torch.int32), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("case,rmax", [("seed1", 896), ("edge", 896), ("seed2", 8064)])
def test_cuda_kernel_matches_reference(case, rmax):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the L2 kernel is CUDA C++ with no CPU mode)")
    args = _port(*_CASES[case](), rmax=rmax, device="cuda")
    before = tl2.launches
    got = tl2.l2_chunks(*args)
    want = tl2.l2_chunks_reference(*args)
    torch.cuda.synchronize()
    assert tl2.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[3]) == 0
    with pytest.raises(ValueError, match="rmax"):
        tl2.l2_chunks(*args[:-1], 1 << 20)
    for name, bad_args in _out_of_range_cases("cuda").items():
        got = tl2.l2_chunks(*bad_args)
        want = tl2.l2_chunks_reference(*bad_args)
        torch.cuda.synchronize()
        assert int(got[3]) == int(want[3]) == 1, name
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


def _out_of_range_cases(device="cpu"):
    """The edge case with every range run off the store's end, and with
    every fragment row missing."""
    args = list(_port(*_edge_case(), rmax=896, device=device))
    M = args[2].shape[0]
    off_end = list(args)
    off_end[5] = torch.full_like(args[5], M - 3)  # lo: 5- and 10-long ranges leave the store
    no_row = list(args)
    no_row[7] = torch.full_like(args[7], 99)  # frag: no such sketch row
    return {"off_end": off_end, "no_row": no_row}


def test_l2_chunks_refuses_ranges_outside_the_store():
    """A chunk whose range leaves the store, or whose fragment row is
    missing, is not read: it comes back empty and raises the range flag,
    and a session that reads the flag after its pass raises."""
    for name, args in _out_of_range_cases().items():
        best, first, last, bad = tl2.l2_chunks(*args)
        assert bad.dtype == torch.int32 and bad.dim() == 0 and int(bad) == 1, name
        hit = (args[5].long() + args[6].long().clamp(0, 896) > args[2].shape[0]) | (
            args[7] >= args[0].shape[0]
        )
        assert torch.equal(best[hit], torch.full_like(best[hit], -1)), name
        assert torch.equal(first[hit], args[8][hit]) and torch.equal(last[hit], args[8][hit])
    ok = tl2.l2_chunks(*_port(*_edge_case(), rmax=896))
    assert int(ok[3]) == 0

    import pyfastani_tpu_torch as pt
    from pyfastani_tpu_torch.session import Session

    rng = np.random.default_rng(5)
    ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=20_000).tobytes()
    sk = pt.Sketch(device="cpu")
    sk.add_genome("ref", ref)
    session = Session(sk.index(), device="cpu")
    assert session.query([ref])
    # a corrupt index: every contig's first minimizer lies past the store
    idx = session._idx[torch.device("cpu"), 0]
    idx["cof_idx"] = idx["cof_idx"] + idx["mini_hash"].shape[0] + 5
    with pytest.raises(ValueError, match="range leaves the minimizer store or its fragment"):
        session.query([ref])
