"""The L2 merge + gate + CGI and the identity fold: CUDA kernels against
plain versions.

``chip_smoke.CGI_CASES`` are the inputs the kernels (``csrc/cgi.cu``)
have to get right: the all-vs-all's shape, two intervals of one fragment
on one genome at one identity, more intervals a fragment than a warp,
two query genomes with padded rows, genomes of several contigs, chunks
tied at an interval's best, intervals without chunks and invalid ones
with chunks, and a chunk total past the slots.
``tests/test_torch_cgi.py`` holds the plain versions against the JAX
package and a NumPy transcription of the rules; here the wrappers'
dispatch and the contracts' checks run on the CPU, and the kernels against
the plain versions in tests that need a card (marker ``cuda``), bitwise
(``chip_smoke._cgi_err`` on the flags row, the slots and the bins they give,
``chip_smoke._fold_err``), the fold's scratch all ``-inf`` after each
fold.  The file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cgi_kernel.py -m cuda
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    CGI_CASES, _cgi_err, _fold_err, cgi_bins_count, cgi_case, fold_args, fold_fresh, second_row,
    torch_args,
)
from pyfastani_tpu_torch.ops import cgi


def _counts(kind: str) -> dict:
    """``launches`` or ``reference_calls`` of both wrappers, by name."""
    return {k: getattr(cgi, f"{k}_{kind}") for k in ("cgi_bins", "fold_bins")}


@pytest.mark.parametrize("name", ["ties", "wide_iv", "q2_padded"])
def test_cgi_and_fold_take_plain_versions_on_cpu_only(name):
    case = cgi_case(name)
    args = torch_args(case, "cpu")
    launched = _counts("launches")
    before = _counts("reference_calls")
    slots = cgi.cgi_bins(*args)
    for g, w in zip(slots, cgi.cgi_bins_reference(*args)):
        assert torch.equal(g, w)
    fargs = fold_args(slots, args, torch.tensor([[0, 1, 0, 0, 0, 0]], dtype=torch.int32))
    got_args, want_args = fold_fresh(fargs), fold_fresh(fargs)
    for g, w in zip(cgi.fold_bins(*got_args), cgi.fold_bins_reference(*want_args)):
        assert g.dtype == w.dtype == torch.int64 and torch.equal(g, w)
    assert got_args[9].tolist() == want_args[9].tolist() == [0, 1, 0, 0, 0, 0]
    assert bool(torch.isneginf(fargs[2]).all())
    assert _counts("launches") == launched
    after = _counts("reference_calls")
    assert {k: after[k] - before[k] for k in before} == {"cgi_bins": 2, "fold_bins": 2}
    n_slots = case[6].shape[0] * case[13]
    assert [(t.dtype, t.shape) for t in slots] == [(torch.int64, (n_slots,)),
                                                    (torch.float32, (n_slots,)),
                                                    (torch.int32, (6,))]
    assert slots[2].tolist() == [int(f) for f in case[17]]
    assert int(slots[0].max()) < cgi_bins_count(args)


def test_cgi_and_fold_refuse_other_devices():
    args = torch_args(cgi_case("ties"), "cpu")
    slots = cgi.cgi_bins_reference(*args)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    fmeta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in fold_args(slots, args)]
    before = (_counts("launches"), _counts("reference_calls"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        cgi.cgi_bins(*meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cgi.fold_bins(*fmeta)
    assert (_counts("launches"), _counts("reference_calls")) == before


def test_contracts_of_the_checks():
    """`_cgi_err` fails on a flags row, a kept slot's bin, an empty bin or a
    bit pattern that differs and measures the occupied bins unless the pass
    is flagged (the flags row always); `_fold_err` measures every
    output."""
    args = torch_args(cgi_case("draft"), "cpu")
    want = cgi.cgi_bins_reference(*args)
    n_bins = cgi_bins_count(args)
    assert _cgi_err(tuple(t.clone() for t in want), want, n_bins=n_bins) == 0.0
    bins, counts = torch.unique(want[0], return_counts=True)
    kept = torch.nonzero(want[0] == bins[(bins >= 0) & (counts == 1)][0])[0, 0]  # alone in its bin
    bad = (want[0], want[1].clone(), want[2])
    bad[1][kept] += 0.5
    assert _cgi_err(bad, want, n_bins=n_bins) == 0.5
    assert _cgi_err(bad, want, flagged=True) == 0.0
    bad = (want[0].clone(), want[1], want[2])
    bad[0][kept] = -1
    with pytest.raises(AssertionError, match="slots"):
        _cgi_err(bad, want, n_bins=n_bins)
    empty = (want[0], want[1].clone(), want[2])
    empty[1][kept] = -np.inf
    with pytest.raises(AssertionError, match="empty"):
        _cgi_err(empty, want, n_bins=n_bins)
    row = torch.zeros(6, dtype=torch.int32)
    zero = (torch.arange(4), torch.zeros(4), row)
    with pytest.raises(AssertionError, match="bits"):
        _cgi_err((zero[0], -zero[1], row), zero)
    flagged = (*want[:2], want[2] + 1)
    for f in (False, True):
        with pytest.raises(AssertionError, match="flags row"):
            _cgi_err(flagged, want, flagged=f)
    fold = cgi.fold_bins_reference(*fold_args(want, args))
    bad = [t.clone() for t in fold]
    bad[2][0, 0] += 9
    assert _fold_err(fold, fold) == 0 and _fold_err(bad, fold) == 9


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CGI and fold kernels are CUDA C++ with no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CGI_CASES)
def test_cuda_kernels_match_reference(name):
    _cuda()
    case = cgi_case(name)
    args = torch_args(case, "cuda")
    launched = _counts("launches")
    slots = cgi.cgi_bins(*args)
    want = cgi.cgi_bins_reference(*args)
    flags = torch.tensor([[0, 0, 1, 0, 0, 0], [1, 0, 0, 0, 0, 0]], dtype=torch.int32,
                         device="cuda")
    fargs = fold_args(want, args, flags)
    got_args, want_args = fold_fresh(fargs), fold_fresh(fargs)
    fold = cgi.fold_bins(*got_args)
    torch.cuda.synchronize()
    after = _counts("launches")
    assert {k: after[k] - launched[k] for k in launched} == {"cgi_bins": 1, "fold_bins": 1}
    assert bool(torch.isneginf(fargs[2]).all())
    assert _cgi_err(slots, want, n_bins=cgi_bins_count(args)) == 0.0
    assert slots[2].tolist() == [int(f) for f in case[17]]
    assert _fold_err(fold, cgi.fold_bins_reference(*want_args)) == 0
    assert got_args[9].tolist() == want_args[9].tolist() == [1, 0, 1, 0, 0, 0]
    # two data rows of one shard, the second's identities 0.01 off the first's
    # in the same bins: each bin's max comes from one row or the other
    two = [torch.cat(pair) for pair in zip(want, second_row(want, 5))]
    fargs = fold_args(two, args)
    fold = cgi.fold_bins(*fold_fresh(fargs))
    torch.cuda.synchronize()
    assert bool(torch.isneginf(fargs[2]).all())
    assert _fold_err(fold, cgi.fold_bins_reference(*fold_fresh(fargs))) == 0
    assert _fold_err(fold, cgi.fold_bins_reference(*fold_args(want, args))) > 0
    none = (torch.full_like(want[0], -1), torch.full_like(want[1], -np.inf))
    assert not bool(cgi.fold_bins(*fold_args(none, args))[0].any())


@pytest.mark.cuda
def test_cuda_kernels_refuse_wrong_types():
    _cuda()
    args = list(torch_args(cgi_case("ties"), "cuda"))
    bad = list(args)
    bad[0] = args[0].to(torch.int64)
    with pytest.raises(TypeError, match="cbest"):
        cgi.cgi_bins(*bad)
    bad = list(args)
    bad[3] = args[3].to(torch.int32)
    with pytest.raises(TypeError, match="ends"):
        cgi.cgi_bins(*bad)
    bad = list(args)
    bad[9] = args[9].to(torch.float64)
    with pytest.raises(TypeError, match="ident_table"):
        cgi.cgi_bins(*bad)
    bad = list(args)
    bad[17] = (*args[17][:5], args[17][5].to(torch.float32))
    with pytest.raises(TypeError, match="flags"):
        cgi.cgi_bins(*bad)
    slots = cgi.cgi_bins(*args)
    fargs = list(fold_args(slots, args))
    fargs[1] = slots[1][:-1]
    with pytest.raises(ValueError, match="slot_ident"):
        cgi.fold_bins(*fargs)
    fargs = list(fold_args(slots, args))
    fargs[2] = fargs[2][:-1]
    with pytest.raises(ValueError, match="scratch"):
        cgi.fold_bins(*fargs)
