"""Port parity: k-mer hashing, winnowing and the fragment sketch.

The same numpy inputs go through the JAX package and through
``pyfastani_tpu_torch`` on the CPU; every output is an integer, so the
comparisons are exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyfastani_tpu.ops import murmur3 as jmurmur
from pyfastani_tpu.ops.fragments import _winnow_fragments_impl
from pyfastani_tpu_torch._common import hashes_to_numpy
from pyfastani_tpu_torch.ops.fragments import winnow_fragments, winnow_fragments_reference
from pyfastani_tpu_torch.ops.murmur3 import kmer_hashes
from pyfastani_tpu_torch.ops.winnow import nucl_canonical, prot_hashes, winnow

from .oracle import add_minimizers_oracle
from chip_smoke import WINNOW_CASES, winnow_case

_NUCL = np.frombuffer(b"ACGTN", dtype=np.uint8)
_PROT = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWYX", dtype=np.uint8)


@pytest.mark.parametrize("k", [4, 15, 16, 17, 18, 19])
def test_kmer_hashes_match_numpy(k):
    rng = np.random.default_rng(k)
    data = rng.integers(0, 256, size=(3, 400), dtype=np.uint8)
    want = np.stack([jmurmur.kmer_hashes(np, row, k, out_len=390 - k) for row in data])
    got = kmer_hashes(torch.from_numpy(data), k, out_len=390 - k)
    np.testing.assert_array_equal(hashes_to_numpy(got), want)


def _fragments(rng, alphabet, n_frag, length):
    frags = np.zeros((n_frag, length + 4), np.uint8)
    frags[:, :length] = rng.choice(alphabet, size=(n_frag, length))
    # a low-complexity fragment exercises palindromes and equal-hash ties
    frags[-1, :length] = np.resize(np.frombuffer(b"AAAAAT", np.uint8), length)
    return frags


@pytest.mark.parametrize(
    "protein,k,w,kc",
    [(False, 16, 24, 512), (False, 16, 24, 200), (True, 8, 1, 3000), (True, 8, 1, 1024)],
)
def test_winnow_fragments_match_jax(protein, k, w, kc):
    length = 3000
    rng = np.random.default_rng(5 + int(protein) + kc)
    frags = _fragments(rng, _PROT if protein else _NUCL, 4, length)
    j_ovf, _, j_q, j_s = _winnow_fragments_impl(jnp.asarray(frags), k, w, length, protein, kc)
    t_ovf, t_q, t_s = winnow_fragments(torch.from_numpy(frags), k, w, length, protein, kc)
    assert bool(t_ovf) == bool(j_ovf)
    np.testing.assert_array_equal(hashes_to_numpy(t_q), np.asarray(j_q))
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))


@pytest.mark.parametrize("name", WINNOW_CASES)
def test_winnow_fragments_reference_matches_jax_on_kernel_cases(name):
    """The plain version of the CUDA kernel on the kernel's edge cases
    (``chip_smoke.WINNOW_CASES``), bitwise."""
    frags, k, w, length, protein, kc = winnow_case(name)
    j_ovf, _, j_q, j_s = _winnow_fragments_impl(jnp.asarray(frags), k, w, length, protein, kc)
    t_ovf, t_q, t_s = winnow_fragments_reference(
        torch.from_numpy(frags), k, w, length, protein, kc
    )
    assert bool(t_ovf) == bool(j_ovf) == (name == "overflow")
    assert t_q.shape == j_q.shape and t_s.shape == j_s.shape
    np.testing.assert_array_equal(hashes_to_numpy(t_q), np.asarray(j_q))
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))


@pytest.mark.parametrize(
    "protein,k,w", [(False, 16, 24), (False, 5, 4), (True, 3, 1), (True, 7, 7)]
)
def test_winnow_records_match_oracle(protein, k, w):
    rng = np.random.default_rng(17 + k + w)
    length = 300
    seqs = rng.choice(_PROT if protein else _NUCL, size=(6, length))
    seqs[0] = np.resize(np.frombuffer(b"ACG", np.uint8), length)
    data = torch.from_numpy(np.concatenate([seqs, np.zeros((6, 4), np.uint8)], axis=1))
    hashes = prot_hashes if protein else nucl_canonical
    canon, valid = hashes(data, length, k, length - k + 1)
    record, win_hash = winnow(canon, valid, w)
    for row in range(seqs.shape[0]):
        want = [(m[0], m[2]) for m in add_minimizers_oracle(seqs[row].tobytes(), k, w, 0, protein)]
        pos = np.flatnonzero(record[row].numpy())
        got = list(zip(hashes_to_numpy(win_hash[row])[pos].tolist(), pos.tolist()))
        assert got == want, (row, protein, k, w)
