"""Port parity: k-mer hashing, winnowing and the fragment sketch.

The same numpy inputs go through the JAX package and through
``pyfastani_tpu_torch`` on the CPU; every output is an integer, so the
comparisons are exact (tolerance 0).
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from pyfastani_tpu.ops import murmur3 as jmurmur
from pyfastani_tpu.ops.fragments import _winnow_fragments_impl
from pyfastani_tpu_torch._common import hashes_to_numpy
from pyfastani_tpu_torch.ops.fragments import (
    winnow_fragments,
    winnow_fragments_blocked,
    winnow_fragments_reference,
)
from pyfastani_tpu_torch.ops.murmur3 import kmer_hashes
from pyfastani_tpu_torch.ops.winnow import nucl_canonical, prot_hashes, winnow

from .oracle import add_minimizers_oracle
from chip_smoke import WINNOW_CASES, WINNOW_TILE_POSITIONS, winnow_case

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


def _same_sketch(got, want, what):
    assert bool(got[0]) == bool(want[0]), what
    assert got[1].shape == want[1].shape and got[2].shape == want[2].shape, what
    np.testing.assert_array_equal(hashes_to_numpy(got[1]), hashes_to_numpy(want[1]), err_msg=str(what))
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]), err_msg=str(what))


def _jax_sketch(frags, k, w, length, protein, kc):
    ovf, _, q, s = _winnow_fragments_impl(jnp.asarray(frags), k, w, length, protein, kc)
    return ovf, torch.from_numpy(np.asarray(q).astype(np.int64)), np.asarray(s)


@pytest.mark.parametrize("name", WINNOW_CASES)
def test_blocked_twin_matches_reference_and_jax_on_kernel_cases(name):
    """The kernel's tile route in plain torch (`winnow_fragments_blocked`:
    prefix and suffix minima over blocks of w) against the plain version
    and the JAX package, bitwise, on the kernel's cases."""
    frags, k, w, length, protein, kc = winnow_case(name)
    t = torch.from_numpy(frags)
    got = winnow_fragments_blocked(t, k, w, length, protein, kc)
    _same_sketch(got, winnow_fragments_reference(t, k, w, length, protein, kc), name)
    _same_sketch(got, _jax_sketch(frags, k, w, length, protein, kc), name)


# the tile route's edges: a warp's positions (384) and the tile's (3072)
# give lengths at their multiples +-1; w over 1..64 and 700
_EDGE_POSITIONS = [1, 31, 32, 33, 383, 384, 385, 767, 768, 769, WINNOW_TILE_POSITIONS - 1,
                   WINNOW_TILE_POSITIONS, WINNOW_TILE_POSITIONS + 1]
_WINDOWS = st.one_of(st.integers(1, 64), st.just(700))


@st.composite
def _shapes(draw, max_positions: int):
    k = draw(st.integers(3, 21))
    w = draw(_WINDOWS)
    n_pos = draw(st.sampled_from([p for p in _EDGE_POSITIONS if p <= max_positions]))
    n_pos = max(n_pos, w + draw(st.integers(-2, 3)))  # a window or two, or none
    protein = draw(st.booleans())
    seed = draw(st.integers(0, 2**31 - 1))
    return k, w, n_pos + k - 1, protein, seed


def _drawn_rows(k, length, protein, seed, n_frag=3):
    rng = np.random.default_rng(seed)
    frags = np.zeros((n_frag, length + 4), np.uint8)
    frags[:, :length] = rng.choice(_PROT if protein else _NUCL, size=(n_frag, length))
    frags[-1, :length] = np.resize(np.frombuffer(b"AAAAAT", np.uint8), length)  # ties, quirk
    return frags


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_shapes(WINNOW_TILE_POSITIONS + 1))
def test_blocked_twin_matches_reference_on_drawn_shapes(shape):
    """The twin against the plain version on drawn shapes at the tile
    route's edges: w in 1..64 and 700, k not a multiple of 4, positions at
    multiples of a warp's and the tile's widths +-1, fewer than w."""
    k, w, length, protein, seed = shape
    t = torch.from_numpy(_drawn_rows(k, length, protein, seed))
    kc = 64 + seed % 512
    _same_sketch(winnow_fragments_blocked(t, k, w, length, protein, kc),
                 winnow_fragments_reference(t, k, w, length, protein, kc), shape)


@settings(max_examples=6, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(_shapes(800))
def test_blocked_twin_matches_jax_on_drawn_shapes(shape):
    """The twin against the JAX package on drawn shapes of up to 800
    positions (each shape compiles once for JAX)."""
    k, w, length, protein, seed = shape
    frags = _drawn_rows(k, length, protein, seed)
    kc = 64 + seed % 512
    _same_sketch(winnow_fragments_blocked(torch.from_numpy(frags), k, w, length, protein, kc),
                 _jax_sketch(frags, k, w, length, protein, kc), shape)
