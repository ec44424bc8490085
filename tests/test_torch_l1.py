"""Port parity: the device L1 candidate intervals.

A small index from ``__graft_entry__._tiny_workload`` and the sketches of
its query fragments go through the JAX ``l1_candidates_device`` and the
port's ``l1_candidates`` (CPU); outputs must be equal, overflow flags
included.  The same holds for the plain version,
``l1_candidates_reference``, on the synthetic inputs that drive each path
of the L1 kernels (``chip_smoke.l1_case``).
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

import __graft_entry__
from chip_smoke import (
    L1_CASES,
    L1_SCRATCH_HITS,
    L1_SORT_EDGE_HITS,
    l1_case,
    l1_hits,
    l1_torch_args,
)
from pyfastani_tpu import Sketch, stats
from pyfastani_tpu.ops.fragments import _winnow_fragments_impl
from pyfastani_tpu.ops.l1 import l1_candidates_device
from pyfastani_tpu_torch._common import bits_to_i32
from pyfastani_tpu_torch.index import build_sharded_index
from pyfastani_tpu_torch.ops import l1 as tl1
from pyfastani_tpu_torch.ops.l1 import (
    l1_candidates,
    l1_candidates_reference,
    l1_candidates_windowed,
)

SMAX = 256


@pytest.fixture(scope="module")
def workload():
    refs, query, frag_len = __graft_entry__._tiny_workload()
    sk = Sketch(fragment_length=frag_len, backend="numpy")
    for i, r in enumerate(refs):
        sk.add_genome(f"g{i}", r)
    mapper = sk.index()
    params = mapper._param
    l = params.min_read_length
    q = np.frombuffer(query, np.uint8)
    n_frag = q.shape[0] // l
    frags = np.zeros((n_frag, l + 4), np.uint8)
    frags[:, :l] = q[: n_frag * l].reshape(n_frag, l)
    # one unrelated fragment: no candidates
    frags[-1, :l] = np.random.default_rng(9).choice(np.frombuffer(b"ACGT", np.uint8), l)
    _, _, q_sorted, s_sizes = _winnow_fragments_impl(
        jnp.asarray(frags), params.kmer_size, params.window_size, l, False, SMAX + 128
    )
    q_sorted = np.asarray(q_sorted)[:, :SMAX]
    return mapper, build_sharded_index(mapper, 1), q_sorted, np.array(s_sizes)


@pytest.mark.parametrize("hmax,ivmax", [(1024, 32), (24, 2)])
def test_l1_candidates_match_jax(workload, hmax, ivmax):
    mapper, sidx, q_sorted, s_sizes = workload
    params = mapper._param
    l = params.min_read_length
    tab = np.asarray(stats.min_hits_relaxed_table(l, params.kmer_size, params.percentage_identity))
    m_values = tuple(sorted({int(max(int(v), 1)) for v in tab[: SMAX + 1]}))
    hb = sidx.hash_bucket[0]
    thr = int(sidx.freq_threshold[0])

    want = l1_candidates_device(
        jnp.asarray(q_sorted), jnp.asarray(s_sizes), jnp.asarray(sidx.uniq_hash[0]),
        jnp.asarray(sidx.row_start[0]), jnp.asarray(sidx.row_len[0]),
        jnp.asarray(sidx.post_gpos[0]), jnp.int32(thr), jnp.asarray(tab),
        jnp.asarray(np.stack([hb[:-1], hb[1:]], axis=-1)),
        hmax, ivmax, l, sidx.bucket_steps, m_values,
    )

    def t(a):
        return torch.from_numpy(np.array(a))  # a writable copy

    got = l1_candidates(
        t(q_sorted.astype(np.int64)), t(s_sizes), t(bits_to_i32(sidx.uniq_hash[0])),
        t(sidx.row_start[0]), t(sidx.row_len[0]), t(sidx.post_gpos[0]), thr, t(tab),
        t(hb), hmax, ivmax, l, sidx.bucket_steps, m_values,
    )
    names = ["iv_g0", "iv_g1", "iv_valid", "ovf_hits", "ovf_iv"]
    for name, w, g in zip(names, want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if hmax == 1024:
        assert got[2].any() and not got[3] and not got[4]
    else:
        assert got[3] or got[4]


# the synthetic cases of the L1 kernels' paths (chip_smoke.L1_CASES but
# ``main``, the all-vs-all's 4096 fragments, which the card runs)
KERNEL_CASES = [name for name in L1_CASES if name != "main"]


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_l1_reference_matches_jax_on_kernel_cases(name):
    """`l1_candidates_reference` against the JAX package, bitwise, on the
    inputs that drive each path of the kernels (``chip_smoke.l1_case``):
    every output, flags included; each case is checked to reach its edge."""
    case = l1_case(name)
    q, s, uniq, rs, rl, post, thr, table, hb, hmax, ivmax, l, steps, m_values = case
    want = l1_candidates_device(
        jnp.asarray(q.astype(np.uint32)), jnp.asarray(s), jnp.asarray(uniq), jnp.asarray(rs),
        jnp.asarray(rl), jnp.asarray(post), jnp.int32(thr), jnp.asarray(table),
        jnp.asarray(np.stack([hb[:-1], hb[1:]], axis=-1)), hmax, ivmax, l, steps, m_values,
    )
    got = l1_candidates_reference(*l1_torch_args(case, "cpu"))
    for label, w, g in zip(["iv_g0", "iv_g1", "iv_valid", "ovf_hits", "ovf_iv"], want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{name} {label}")

    n, _ = l1_hits(l1_torch_args(case, "cpu"))
    ovf_hits, ovf_iv = bool(got[3]), bool(got[4])
    assert ovf_hits == (name == "trunc"), name
    assert ovf_iv == (name == "ovf_iv"), name
    per_fragment = got[2].sum(dim=1)
    if name == "m_high":
        assert min(m_values) == 1 and max(m_values) > 4 and int(rl.max()) >= thr
    elif name == "empty":
        assert bool((n == 0).any()) and bool((per_fragment > 0).any())
    elif name == "all_empty":
        assert int(n.sum()) == 0 and not bool(got[2].any())
    elif name == "s_zero":
        assert int(s.min()) == 0 and int(s.max()) > q.shape[1] and bool(got[2].any())
    elif name == "one_fragment":
        assert q.shape[0] == 1 and bool(got[2].any())
    elif name == "scratch":
        assert int(n.max()) >= L1_SCRATCH_HITS and bool(per_fragment[int(n.argmax())] > 0)
    elif name == "trunc":
        assert int(n.sum()) == q.shape[0] * hmax and bool(got[2].any())
    elif name == "sort_edges":
        assert tuple(n.tolist()) == L1_SORT_EDGE_HITS and bool((per_fragment > 1).all())


def _jax_l1(case):
    q, s, uniq, rs, rl, post, thr, table, hb, hmax, ivmax, l, steps, m_values = case
    return l1_candidates_device(
        jnp.asarray(q.astype(np.uint32)), jnp.asarray(s), jnp.asarray(uniq), jnp.asarray(rs),
        jnp.asarray(rl), jnp.asarray(post), jnp.int32(thr), jnp.asarray(table),
        jnp.asarray(np.stack([hb[:-1], hb[1:]], axis=-1)), hmax, ivmax, l, steps, m_values,
    )


def _same_l1(got, want, what):
    for label, w, g in zip(["iv_g0", "iv_g1", "iv_valid", "ovf_hits", "ovf_iv"], want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{what} {label}")


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_windowed_twin_matches_reference_and_jax_on_kernel_cases(name):
    """The kernels' probe in plain torch (`l1_candidates_windowed`: an
    interpolated window of the bucket in place of the binary search)
    against the plain version and the JAX package, bitwise, on the
    kernels' cases; its rows equal the binary search's on every live
    probe."""
    case = l1_case(name)
    args = l1_torch_args(case, "cpu")
    got = l1_candidates_windowed(*args)
    _same_l1(got, l1_candidates_reference(*args), name)
    _same_l1(got, _jax_l1(case), name)
    q, s, uniq, hb, steps = args[0], args[1], args[2], args[8], args[12]
    live = torch.arange(q.shape[1])[None, :] < s[:, None]
    rows = tl1._probe_rows_window(q, uniq, hb, steps)
    assert torch.equal(rows[live], tl1._probe_rows(q, uniq, hb, steps)[live]), name


def _bucket_table(uniq: np.ndarray, bits: int):
    edges = np.arange((1 << bits) + 1, dtype=np.uint64) << np.uint64(32 - bits)
    bucket = np.searchsorted(uniq.astype(np.uint64), edges).astype(np.int32)
    deepest = int(np.diff(bucket).max(initial=0))
    return bucket, max(1, int(np.ceil(np.log2(deepest + 1))))


@st.composite
def _index(draw):
    """Sorted unique row hashes crowded toward 0 (as minimizers' are),
    a bucket table of 2-14 bits, a search depth that suffices or falls 1
    or 2 short (the plain version's steps then decide), and probes:
    present hashes, absent ones, 0 and 2^32 - 1."""
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    n = draw(st.integers(1, 3000))
    skew = draw(st.sampled_from([1.0, 3.0, 8.0]))
    uniq = np.unique((rng.random(n) ** skew * (2**32 - 1)).astype(np.uint32))
    bits = draw(st.integers(2, 14))
    bucket, steps = _bucket_table(uniq, bits)
    steps = max(1, steps - draw(st.sampled_from([0, 0, 1, 2])))
    present = rng.choice(uniq, size=96)
    absent = rng.integers(0, 2**32 - 1, size=96, dtype=np.uint64)
    q = np.concatenate([present.astype(np.int64), absent.astype(np.int64), [0, 2**32 - 1]])
    return torch.from_numpy(q[None, :]), uniq, torch.from_numpy(bucket), steps


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_index())
def test_window_probe_finds_the_binary_search_rows_on_drawn_indexes(index):
    """`_probe_rows_window` (the kernels' probe) finds the rows of the
    plain version's `steps`-step binary search on drawn indexes: buckets
    shallower and deeper than the 16-hash window, and depths that do not
    exhaust a bucket."""
    q, uniq, bucket, steps = index
    u32 = torch.from_numpy(bits_to_i32(uniq))
    want = tl1._probe_rows(q, u32, bucket, steps)
    assert torch.equal(tl1._probe_rows_window(q, u32, bucket, steps), want)


@settings(max_examples=4, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(3, 14), st.integers(0, 2))
def test_windowed_twin_matches_jax_on_drawn_buckets(bits, short):
    """The twin against the plain version and the JAX package on the
    ``empty`` case's index re-bucketed at a drawn number of bits, with a
    search depth that suffices or falls short."""
    case = list(l1_case("empty"))
    case[8], steps = _bucket_table(case[2], bits)
    case[12] = max(1, steps - short)
    args = l1_torch_args(case, "cpu")
    got = l1_candidates_windowed(*args)
    _same_l1(got, l1_candidates_reference(*args), (bits, short))
    _same_l1(got, _jax_l1(case), (bits, short))
