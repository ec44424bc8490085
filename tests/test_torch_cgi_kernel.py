"""The gate + CGI and the identity fold: CUDA kernels against plain versions.

``chip_smoke.CGI_CASES`` are the inputs the kernels (``csrc/cgi.cu``)
have to get right: the all-vs-all's shape, two intervals of one fragment
on one genome at one identity, more intervals a fragment than a warp,
two query genomes with padded rows, and genomes of several contigs.
``tests/test_torch_cgi.py`` holds the plain versions against the JAX
package and a NumPy transcription of the rules; here the wrappers'
dispatch and the contracts' checks run on the CPU, and the kernels against
the plain versions in tests that need a card (marker ``cuda``), bitwise
(``chip_smoke._cgi_err``, ``chip_smoke._fold_err``).  The file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cgi_kernel.py -m cuda
"""

import numpy as np
import pytest
import torch

from chip_smoke import CGI_CASES, _cgi_err, _fold_err, cgi_case, fold_args, torch_args
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
    bins = cgi.cgi_bins(*args)
    assert torch.equal(bins, cgi.cgi_bins_reference(*args))
    fargs = fold_args(bins, args)
    for g, w in zip(cgi.fold_bins(*fargs), cgi.fold_bins_reference(*fargs)):
        assert g.dtype == w.dtype == torch.int64 and torch.equal(g, w)
    assert _counts("launches") == launched
    after = _counts("reference_calls")
    assert {k: after[k] - before[k] for k in before} == {"cgi_bins": 2, "fold_bins": 2}
    assert bins.dtype == torch.float32 and bins.shape == (case[15] * case[9].shape[0] * case[13],)


def test_cgi_and_fold_refuse_other_devices():
    args = torch_args(cgi_case("ties"), "cpu")
    bins = cgi.cgi_bins_reference(*args)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    fmeta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in fold_args(bins, args)]
    before = (_counts("launches"), _counts("reference_calls"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        cgi.cgi_bins(*meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cgi.fold_bins(*fmeta)
    assert (_counts("launches"), _counts("reference_calls")) == before


def test_contracts_of_the_checks():
    """`_cgi_err` fails on an empty bin or a bit pattern that differs and
    measures the occupied bins unless the pass is flagged; `_fold_err`
    measures every output."""
    args = torch_args(cgi_case("draft"), "cpu")
    want = cgi.cgi_bins_reference(*args)
    assert _cgi_err(want.clone(), want) == 0.0
    occupied = torch.nonzero(torch.isfinite(want))[0, 0]
    bad = want.clone()
    bad[occupied] += 0.5
    assert _cgi_err(bad, want) == 0.5
    assert _cgi_err(bad, want, flagged=True) == 0.0
    bad = want.clone()
    bad[occupied] = -np.inf
    with pytest.raises(AssertionError, match="empty"):
        _cgi_err(bad, want)
    zero = torch.zeros(4)
    with pytest.raises(AssertionError, match="bits"):
        _cgi_err(-zero, zero)
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
    bins = cgi.cgi_bins(*args)
    want = cgi.cgi_bins_reference(*args)
    fargs = fold_args(want, args)
    fold = cgi.fold_bins(*fargs)
    torch.cuda.synchronize()
    after = _counts("launches")
    assert {k: after[k] - launched[k] for k in launched} == {"cgi_bins": 1, "fold_bins": 1}
    assert _cgi_err(bins, want) == 0.0
    assert _fold_err(fold, cgi.fold_bins_reference(*fargs)) == 0
    empty = torch.full_like(want, -np.inf)
    assert not bool(cgi.fold_bins(*fold_args(empty, args))[0].any())


@pytest.mark.cuda
def test_cuda_kernels_refuse_wrong_types():
    _cuda()
    args = list(torch_args(cgi_case("ties"), "cuda"))
    bad = list(args)
    bad[0] = args[0].to(torch.int32)
    with pytest.raises(TypeError, match="best"):
        cgi.cgi_bins(*bad)
    bad = list(args)
    bad[8] = args[8].to(torch.float64)
    with pytest.raises(TypeError, match="ident_table"):
        cgi.cgi_bins(*bad)
    bins = cgi.cgi_bins(*args)
    fargs = list(fold_args(bins, args))
    fargs[0] = bins[:-1]
    with pytest.raises(ValueError, match="best_bin"):
        cgi.fold_bins(*fargs)
