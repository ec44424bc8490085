"""The L2 sweep's chunk plan and merge: CUDA kernels against plain versions.

``chip_smoke.SWEEP_CASES`` are the inputs the kernels
(``csrc/l2_sweep.cu``) have to get right: the all-vs-all's shape, more
chunks than slots, ranges past their capacity, no valid interval, one
interval of many chunks, and chunks whose windows end past their contig.
``tests/test_torch_l2_sweep.py`` holds the plain versions, through the
session's ``_l2_interval_scan``, against the JAX package; here the
wrappers' dispatch and the contracts' checks run on the CPU, and the
kernels against the plain versions in tests that need a card (marker
``cuda``), under the contracts (``chip_smoke._plan_err``: both flags and
``ends`` always equal, the chunk operands on the live slots,
``rlen = ch_len = ch_c0 = 0`` past them; ``chip_smoke._merge_err``: every
interval while no flag is raised).  The file imports no JAX, so it also
runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_l2_sweep_kernel.py -m cuda
"""

import pytest
import torch

from chip_smoke import (
    SWEEP_CASES,
    _merge_err,
    _plan_err,
    merge_args,
    plan_no_store,
    sweep_case,
    torch_args,
)
from pyfastani_tpu_torch.ops import l2_sweep


def _counts(kind: str) -> dict:
    """``launches`` or ``reference_calls`` of both wrappers, by name."""
    return {k: getattr(l2_sweep, f"{k}_{kind}") for k in ("l2_plan", "l2_merge")}


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("name", ["overflow", "range", "empty", "one_interval"])
def test_plan_and_merge_take_plain_versions_on_cpu_only(name):
    args = torch_args(sweep_case(name), "cpu")
    launched = _counts("launches")
    before = _counts("reference_calls")
    plan = l2_sweep.l2_plan(*args)
    _same(plan, l2_sweep.l2_plan_reference(*args))
    margs = merge_args(plan, args[4])
    _same(l2_sweep.l2_merge(*margs), l2_sweep.l2_merge_reference(*margs))
    assert _counts("launches") == launched
    after = _counts("reference_calls")
    assert {k: after[k] - before[k] for k in before} == {"l2_plan": 2, "l2_merge": 2}
    assert [t.dtype for t in plan[:6]] == [torch.int32] * 5 + [torch.int64]
    assert plan[6].dim() == plan[7].dim() == 0 and plan[6].dtype == plan[7].dtype == torch.bool
    assert (bool(plan[6]), bool(plan[7])) == (name == "overflow", name == "range")


def test_plan_and_merge_refuse_other_devices():
    args = torch_args(sweep_case("one_interval"), "cpu")
    plan = l2_sweep.l2_plan_reference(*args)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    margs = [a.to("meta") for a in merge_args(plan, args[4])]
    before = (_counts("launches"), _counts("reference_calls"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        l2_sweep.l2_plan(*meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        l2_sweep.l2_merge(*margs)
    assert (_counts("launches"), _counts("reference_calls")) == before


def test_contracts_of_the_checks():
    """`_plan_err` fails on a flag, ``ends`` or a non-zero operand past the
    live slots and measures the live slots only; `_merge_err` measures
    every interval unless the pass is flagged."""
    args = torch_args(sweep_case("range"), "cpu")
    want = l2_sweep.l2_plan_reference(*args)
    live = int(want[5][-1])
    got = [t.clone() for t in want]
    got[0][live:] = 7  # lo and frag are free past the live slots
    got[2][live:] = 7
    assert _plan_err(got, want) == 0
    bad = [t.clone() for t in got]
    bad[0][live - 1] += 3
    assert _plan_err(bad, want) == 3
    for i, match in ((1, "not 0"), (3, "not 0"), (4, "not 0")):
        bad = [t.clone() for t in got]
        bad[i][live] = 1
        with pytest.raises(AssertionError, match=match):
            _plan_err(bad, want)
    bad = [t.clone() for t in got]
    bad[5][0] += 1
    with pytest.raises(AssertionError, match="ends"):
        _plan_err(bad, want)
    for i in (6, 7):
        bad = [t.clone() for t in got]
        bad[i] = ~bad[i]
        with pytest.raises(AssertionError, match="overflow|rovf"):
            _plan_err(bad, want)
    m = l2_sweep.l2_merge_reference(*merge_args(want, args[4]))
    bad = [t.clone() for t in m]
    bad[1][0] += 2
    assert _merge_err(bad, m) == 2
    assert _merge_err(bad, m, flagged=True) == 0


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the L2 sweep kernels are CUDA C++ with no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SWEEP_CASES)
def test_cuda_kernels_match_reference(name):
    _cuda()
    args = torch_args(sweep_case(name), "cuda")
    launched = _counts("launches")
    before = _counts("reference_calls")
    plan = l2_sweep.l2_plan(*args)
    want = l2_sweep.l2_plan_reference(*args)
    margs = merge_args(want, args[4])
    merged = l2_sweep.l2_merge(*margs)
    torch.cuda.synchronize()
    after = _counts("launches")
    assert {k: after[k] - launched[k] for k in launched} == {"l2_plan": 1, "l2_merge": 1}
    assert _plan_err(plan, want) == 0
    live = min(int(want[5][-1]), want[0].shape[0])
    assert all(not bool(t[live:].any()) for t in plan[:5])  # an empty slot is all 0
    assert _merge_err(merged, l2_sweep.l2_merge_reference(*margs), bool(want[6])) == 0
    assert l2_sweep.l2_plan_reference_calls == before["l2_plan"] + 1


@pytest.mark.cuda
def test_cuda_plan_on_an_empty_store():
    _cuda()
    plan = l2_sweep.l2_plan(*plan_no_store("cuda"))
    torch.cuda.synchronize()
    assert not bool(plan[1].any()) and not bool(plan[7])


@pytest.mark.cuda
def test_cuda_kernels_refuse_wrong_types():
    _cuda()
    args = list(torch_args(sweep_case("one_interval"), "cuda"))
    bad = list(args)
    bad[1] = args[1].to(torch.int32)
    with pytest.raises(TypeError, match="iv_seq"):
        l2_sweep.l2_plan(*bad)
    bad = list(args)
    bad[7] = args[7].to(torch.int64)
    with pytest.raises(TypeError, match="mini_gpos"):
        l2_sweep.l2_plan(*bad)
    plan = l2_sweep.l2_plan(*args)
    margs = list(merge_args(plan, args[4]))
    margs[1] = margs[1][:-1]
    with pytest.raises(ValueError, match="cfirst"):
        l2_sweep.l2_merge(*margs)
