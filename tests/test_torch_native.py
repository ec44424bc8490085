"""The bounds and order checks of the port's host C extension.

* ``sort_u32_perm``, ``take32`` and ``csr_bounds`` keep element counts and
  positions in int32: past 2^31 - 1 elements they raise ``OverflowError``
  before they read a byte, shown on a sparse 8 GiB ``np.memmap`` whose
  pages are never touched;
* ``take_4byte`` refuses elements that are not 4 bytes wide and indices
  outside int32 instead of reinterpreting or wrapping them;
* the index build's order-based shortcuts (``ops/l2.py::mini_prev_from_index``
  and the ``post_gpos`` gather of ``index.py::build_sharded_index``) hold
  only for a minimizer store in ``(seqid, wpos)`` order: a shuffled store
  takes the general path and gives what it gives, and what the JAX
  package's ``compute_mini_prev`` gives on the same store.
"""

import pickle

import numpy as np
import pytest

import pyfastani_tpu_torch
from pyfastani_tpu.ops import l2_pallas as jl2
from pyfastani_tpu_torch import _native
from pyfastani_tpu_torch import index as tidx
from pyfastani_tpu_torch.ops import l2 as tl2

_ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def past_int32(tmp_path_factory):
    """2^31 + 1 uint32 in a sparse file: mapped, never read."""
    path = tmp_path_factory.mktemp("sparse") / "past_int32.u32"
    big = np.memmap(path, dtype=np.uint32, mode="w+", shape=(2**31 + 1,))
    yield big
    del big


@pytest.mark.parametrize(
    "call",
    [
        lambda big: _native.argsort_u32_stable(big),
        lambda big: _native.csr_groups(big),
        lambda big: _native.take_4byte(np.zeros(4, np.int32), big.view(np.int32)),
        lambda big: _native.sort_u32_perm(big.data),
        lambda big: _native.csr_bounds(big.data),
        lambda big: _native.take32(np.zeros(4, np.int32).data, big.data),
    ],
    ids=["argsort_u32_stable", "csr_groups", "take_4byte", "sort_u32_perm", "csr_bounds", "take32"],
)
def test_more_than_int32_elements_raise_overflow(past_int32, call):
    with pytest.raises(OverflowError, match="2\\^31 - 1"):
        call(past_int32)


@pytest.mark.parametrize("dtype", [np.int64, np.uint64, np.float64, np.int16, np.uint8])
def test_take_4byte_refuses_elements_that_are_not_4_bytes(dtype):
    with pytest.raises(TypeError, match="4-byte"):
        _native.take_4byte(np.arange(8).astype(dtype), np.zeros(2, np.int32))


@pytest.mark.parametrize("bad", [2**31, -(2**31) - 1, 2**40])
def test_take_4byte_refuses_indices_outside_int32(bad):
    idx = np.array([0, bad, 1], np.int64)
    with pytest.raises(ValueError, match="outside int32"):
        _native.take_4byte(np.arange(8, dtype=np.int32), idx)
    with pytest.raises(TypeError, match="integer"):
        _native.take_4byte(np.arange(8, dtype=np.int32), idx.astype(np.float64))


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.float32])
def test_take_4byte_equals_numpy(dtype):
    rng = np.random.default_rng(5)
    values = rng.integers(0, 2**31, size=70_000).astype(dtype)
    idx = rng.integers(0, values.shape[0], size=90_000)
    for ix in (idx.astype(np.int32), idx.astype(np.int64), idx.astype(np.uint16)):
        got = _native.take_4byte(values, ix)
        assert got.dtype == values.dtype
        np.testing.assert_array_equal(got, values[ix])
    with pytest.raises(IndexError):
        _native.take_4byte(values, np.array([values.shape[0]], np.int32))


@pytest.mark.parametrize(
    "seqid,wpos,ordered",
    [
        ([], [], True),
        ([3], [7], True),
        ([0, 0, 0, 1, 1, 2], [1, 1, 5, 0, 9, 0], True),
        ([0, 0, 1, 1], [5, 4, 0, 1], False),
        ([0, 1, 0], [0, 0, 9], False),
        ([0, 0], [-(2**31), 2**31 - 1], True),
    ],
    ids=["empty", "one", "ties", "wpos-down", "seqid-down", "int32-extremes"],
)
def test_position_ordered(seqid, wpos, ordered):
    got = _native.position_ordered(np.asarray(seqid, np.int32), np.asarray(wpos, np.int32))
    assert got is ordered


@pytest.mark.parametrize("at", [1, 4095, 4096, 4097, 49_999])
def test_position_ordered_finds_one_step_down_in_any_block(at):
    seqid = np.repeat(np.arange(5, dtype=np.int32), 10_000)
    wpos = np.tile(np.arange(10_000, dtype=np.int32), 5)
    assert _native.position_ordered(seqid, wpos)
    w = wpos.copy()
    w[at] = -1
    assert not _native.position_ordered(seqid, w)
    s = seqid.copy()
    s[at] = -1
    assert not _native.position_ordered(s, wpos)


@pytest.fixture(scope="module")
def mappers():
    """A mapper on a position-ordered store and one on the same store
    shuffled, with the permutation between them."""
    rng = np.random.default_rng(13)
    sketch = pyfastani_tpu_torch.Sketch(device="cpu")
    for g in range(3):
        contigs = [rng.choice(_ACGT, size=n).tobytes() for n in (9_000, 6_000)]
        # repeats inside a contig give same-hash neighbours to find
        contigs[0] += contigs[0][:4_000]
        sketch.add_draft(f"g{g}", contigs)
    ordered = sketch.index()
    shuffled = pickle.loads(pickle.dumps(ordered))
    hashes, seqid, wpos = (a.copy() for a in ordered._minimizer_arrays())
    perm = rng.permutation(hashes.shape[0])
    shuffled._set_minimizer_arrays(hashes[perm], seqid[perm], wpos[perm])
    return ordered, shuffled, perm


def test_a_shuffled_store_takes_the_general_mini_prev(mappers):
    ordered, shuffled, perm = mappers
    sub = shuffled._index
    assert _native.position_ordered(ordered._index.mini_seqid, ordered._index.mini_wpos)
    assert not _native.position_ordered(sub.mini_seqid, sub.mini_wpos)
    store = (sub.mini_hash, sub.mini_seqid, sub.mini_wpos)
    general = tl2.compute_mini_prev(*store)
    np.testing.assert_array_equal(tl2.mini_prev_from_index(sub), general)
    np.testing.assert_array_equal(general, jl2.compute_mini_prev(*store))
    # the same previous occurrences as the ordered store, permuted with it
    np.testing.assert_array_equal(general, tl2.mini_prev_from_index(ordered._index)[perm])
    assert (general > 0).sum() > 100
    # the shortcut the check guards would be wrong here
    assert not np.array_equal(tl2.mini_prev_from_index(sub, ordered=True), general)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_a_shuffled_store_takes_the_general_post_gpos(mappers, n_shards):
    ordered, shuffled, _ = mappers
    got = tidx.build_sharded_index(shuffled, n_shards)
    want = tidx.build_sharded_index(ordered, n_shards)
    for sh in range(n_shards):
        m = int((got.post_seqid[sh] != tidx.BIG).sum())
        seqid, wpos = got.post_seqid[sh, :m], got.post_wpos[sh, :m]
        off = got.contig_offset[sh].astype(np.int64)
        # the offset arithmetic of the general path
        np.testing.assert_array_equal(got.post_gpos[sh, :m], (off[seqid] + wpos).astype(np.int32))
        # the store's own mini_prev, through the general path
        k = int((got.mini_seqid[sh] != tidx.BIG).sum())
        np.testing.assert_array_equal(
            got.mini_prev[sh, :k],
            tl2.compute_mini_prev(got.mini_hash[sh, :k], got.mini_seqid[sh, :k], got.mini_wpos[sh, :k]),
        )
        # as multisets the shuffled index equals the ordered one
        for name in ("post_gpos", "mini_gpos"):
            np.testing.assert_array_equal(
                np.sort(getattr(got, name)[sh]), np.sort(getattr(want, name)[sh])
            )


def test_an_ordered_store_keeps_the_shortcuts(mappers, monkeypatch):
    ordered, _, _ = mappers
    calls = []
    original = tl2.compute_mini_prev
    monkeypatch.setattr(tl2, "compute_mini_prev", lambda *a: calls.append(1) or original(*a))
    sidx = tidx.build_sharded_index(ordered, 1)
    assert calls == []
    sub = ordered._index
    np.testing.assert_array_equal(
        sidx.mini_prev[0, : sub.mini_hash.shape[0]],
        original(sub.mini_hash, sub.mini_seqid, sub.mini_wpos),
    )
