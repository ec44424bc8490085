"""Port parity: the device L1 candidate intervals.

A small index from ``__graft_entry__._tiny_workload`` and the sketches of
its query fragments go through the JAX ``l1_candidates_device`` and the
port's ``l1_candidates`` (CPU); outputs must be equal, overflow flags
included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from pyfastani_tpu import Sketch, stats
from pyfastani_tpu.ops.fragments import _winnow_fragments_impl
from pyfastani_tpu.ops.l1 import l1_candidates_device
from pyfastani_tpu_torch._common import bits_to_i32
from pyfastani_tpu_torch.index import build_sharded_index
from pyfastani_tpu_torch.ops.l1 import l1_candidates

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
