"""The L1 candidate stage's CUDA kernels against their plain version.

``chip_smoke.L1_CASES`` are the inputs the kernels
(``csrc/l1_candidates.cu``) have to get right: the all-vs-all's shape,
minimum hits past 4 with a frequency threshold, the hit axis cut at T,
more intervals than ``ivmax``, fragments without hits and a batch without
any, sketches of size 0 and past S, one fragment, and a fragment past the
card's shared memory (the scratch variant).  ``tests/test_torch_l1.py``
holds the plain version, `l1_candidates_reference`, against the JAX
package on them; here the wrapper's dispatch is checked on the CPU, and
the kernels against the plain version in tests that need a card (marker
``cuda``), under the stage's exactness contract (``chip_smoke._l1_err``):
both flags always equal, ``iv_valid`` equal while the interval flag is
clear, the bounds equal where ``iv_valid`` holds.  The file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_l1_kernel.py -m cuda
"""

import pytest
import torch

from chip_smoke import L1_CASES, _l1_err, l1_case, l1_hits, l1_no_index, l1_torch_args
from pyfastani_tpu_torch.ops import l1


def _same(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("name", ["m_high", "trunc", "s_zero", "one_fragment"])
def test_l1_candidates_takes_plain_version_on_cpu_only(name):
    args = l1_torch_args(l1_case(name), "cpu")
    before = (l1.launches, l1.reference_calls)
    got = l1.l1_candidates(*args)
    assert (l1.launches, l1.reference_calls) == (before[0], before[1] + 1)
    _same(got, l1.l1_candidates_reference(*args))
    assert got[0].dtype == got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    assert got[3].dim() == got[4].dim() == 0 and got[3].dtype == got[4].dtype == torch.bool


def test_l1_candidates_refuses_other_devices():
    args = list(l1_torch_args(l1_case("one_fragment"), "cpu"))
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    before = (l1.launches, l1.reference_calls)
    with pytest.raises(ValueError, match="cuda or cpu"):
        l1.l1_candidates(*meta)
    assert (l1.launches, l1.reference_calls) == before


def test_exactness_contract_of_the_check():
    """`_l1_err` fails on a flag or a validity that differs, and ignores
    the bounds past ``iv_valid`` and, with the interval flag set, all."""
    want = l1.l1_candidates_reference(*l1_torch_args(l1_case("one_fragment"), "cpu"))
    got = [t.clone() for t in want]
    got[0][~want[2]] = 0  # the kernels' fill
    got[1][~want[2]] = 0
    assert _l1_err(got, want) == 0
    bad = [t.clone() for t in got]
    bad[0][want[2]] += 1
    assert _l1_err(bad, want) == 1
    bad = [t.clone() for t in got]
    bad[2][0, -1] = ~bad[2][0, -1]
    with pytest.raises(AssertionError, match="iv_valid"):
        _l1_err(bad, want)
    for i in (3, 4):
        bad = [t.clone() for t in got]
        bad[i] = ~bad[i]
        with pytest.raises(AssertionError, match="ovf"):
            _l1_err(bad, want)
    over = list(want)
    over[4] = torch.tensor(True)
    bad = [t.clone() for t in over]
    bad[0] += 7
    assert _l1_err(bad, over) == 0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the L1 kernels are CUDA C++ with no CPU mode)")
    from pyfastani_tpu_torch._build import load_library

    return load_library()


@pytest.mark.cuda
@pytest.mark.parametrize("name", L1_CASES)
def test_cuda_kernels_match_reference(name):
    lib = _cuda()
    args = l1_torch_args(l1_case(name), "cuda")
    n, _ = l1_hits(args)
    cap = lib.l1_intervals_capacity(torch.cuda.current_device(), args[9])
    assert bool((n > cap).any()) == (name == "scratch")
    before = (l1.launches, l1.reference_calls)
    got = l1.l1_candidates(*args)
    assert (l1.launches, l1.reference_calls) == (before[0] + 1, before[1])
    want = l1.l1_candidates_reference(*args)
    torch.cuda.synchronize()
    assert _l1_err(got, want) == 0
    # the session passes a column slice of a wider sketch (unit column stride)
    q = args[0]
    wide = torch.full((q.shape[0], q.shape[1] + 64), 0xFFFFFFFF, dtype=torch.int64, device="cuda")
    wide[:, : q.shape[1]] = q
    sliced = (wide[:, : q.shape[1]], *args[1:])
    got = l1.l1_candidates(*sliced)
    torch.cuda.synchronize()
    assert _l1_err(got, want) == 0


@pytest.mark.cuda
def test_cuda_kernels_on_an_empty_index_and_batch():
    _cuda()
    got = l1.l1_candidates(*l1_no_index("cuda"))
    torch.cuda.synchronize()
    assert not bool(got[2].any()) and not bool(got[3]) and not bool(got[4])
    assert not bool(got[0].any()) and not bool(got[1].any())
    args = l1_torch_args(l1_case("one_fragment"), "cuda")
    empty = (args[0][:0], args[1][:0], *args[2:])
    got = l1.l1_candidates(*empty)
    torch.cuda.synchronize()
    assert got[0].shape == (0, args[10]) and not bool(got[3]) and not bool(got[4])


@pytest.mark.cuda
def test_cuda_kernels_refuse_wrong_types():
    _cuda()
    args = list(l1_torch_args(l1_case("one_fragment"), "cuda"))
    bad = list(args)
    bad[0] = args[0].to(torch.int32)
    with pytest.raises(TypeError, match="q_sorted"):
        l1.l1_candidates(*bad)
    bad = list(args)
    bad[5] = args[5].to(torch.int64)
    with pytest.raises(TypeError, match="post_gpos"):
        l1.l1_candidates(*bad)
    bad = list(args)
    bad[1] = args[1][:0]
    with pytest.raises(ValueError, match="s_sizes"):
        l1.l1_candidates(*bad)
