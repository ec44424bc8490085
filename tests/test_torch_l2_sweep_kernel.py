"""The L2 sweep's chunk plan and merge: CUDA kernels against plain versions.

``chip_smoke.SWEEP_CASES`` are the inputs the kernels
(``csrc/l2_sweep.cu``) have to get right: the all-vs-all's shape, more
chunks than slots, ranges past their capacity, no valid interval, one
interval of many chunks, chunks whose windows end past their contig,
intervals off the plan's tile, chunk totals at and one past the slots, an
interval across the last slot, and contigs past the kernels'
shared-memory table.  The merge runs inside the gate + CGI kernel
(``csrc/cgi.cu``, ``ops.cgi.cgi_bins``), here on chunk results drawn for
each case's plan (``chip_smoke.plan_cgi_args``).
``tests/test_torch_l2_sweep.py`` holds the plain versions, through the
session's ``_l2_interval_scan``, against the JAX package; here the
wrappers' dispatch and the contracts' checks run on the CPU, and the
kernels against the plain versions in tests that need a card (marker
``cuda``), under the contracts (``chip_smoke._plan_err``: both flags,
``ends`` and ``iv_seq`` always equal, the chunk operands on the live slots,
``rlen = ch_len = ch_c0 = 0`` past them; ``chip_smoke._cgi_err``: the
flags row always, the slots and the bins they give bitwise, here also
where the plan overflows).  The file imports no JAX, so it also runs
where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_l2_sweep_kernel.py -m cuda
"""

import pytest
import torch

from chip_smoke import (
    SWEEP_CASES,
    SWEEP_OVERFLOW,
    _cgi_err,
    _plan_err,
    cgi_bins_count,
    plan_cgi_args,
    plan_no_store,
    sweep_case,
    torch_args,
)
from pyfastani_tpu_torch.ops import cgi, l2_sweep


def _counts(kind: str) -> dict:
    """``launches`` or ``reference_calls`` of the plan's wrapper and of
    ``cgi_bins``, which merges the chunk results, by name."""
    return {"l2_plan": getattr(l2_sweep, f"l2_plan_{kind}"),
            "cgi_bins": getattr(cgi, f"cgi_bins_{kind}")}


def _meta(a):
    if isinstance(a, tuple):
        return tuple(_meta(x) for x in a)
    return a.to("meta") if isinstance(a, torch.Tensor) else a


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("name", ["overflow", "range", "empty", "one_interval", "tile_edge",
                                  "straddle"])
def test_plan_and_merge_take_plain_versions_on_cpu_only(name):
    args = torch_args(sweep_case(name), "cpu")
    launched = _counts("launches")
    before = _counts("reference_calls")
    plan = l2_sweep.l2_plan(*args)
    _same(plan, l2_sweep.l2_plan_reference(*args))
    cargs = plan_cgi_args(plan, args)
    _same(cgi.cgi_bins(*cargs), cgi.cgi_bins_reference(*cargs))
    assert _counts("launches") == launched
    after = _counts("reference_calls")
    assert {k: after[k] - before[k] for k in before} == {"l2_plan": 2, "cgi_bins": 2}
    assert [t.dtype for t in plan[:7]] == [torch.int32] * 5 + [torch.int64] * 2
    assert plan[5].shape == plan[6].shape == args[2].shape
    assert plan[7].dim() == plan[8].dim() == 0 and plan[7].dtype == plan[8].dtype == torch.bool
    assert (bool(plan[7]), bool(plan[8])) == (name in SWEEP_OVERFLOW, name == "range")


def test_plan_and_merge_refuse_other_devices():
    args = torch_args(sweep_case("one_interval"), "cpu")
    plan = l2_sweep.l2_plan_reference(*args)
    meta = [_meta(a) for a in args]
    cargs = [_meta(a) for a in plan_cgi_args(plan, args)]
    before = (_counts("launches"), _counts("reference_calls"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        l2_sweep.l2_plan(*meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cgi.cgi_bins(*cargs)
    assert (_counts("launches"), _counts("reference_calls")) == before


def test_contracts_of_the_checks():
    """`_plan_err` fails on a flag, ``ends``, a contig or a non-zero
    operand past the live slots and measures the live slots only;
    `_cgi_err` fails on a flags row that differs, also when the pass is
    flagged, and on a slot only when it is not."""
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
    bad = [t.clone() for t in got]
    bad[6][-1] += 1  # an invalid interval's contig counts too
    with pytest.raises(AssertionError, match="contigs"):
        _plan_err(bad, want)
    for i in (7, 8):
        bad = [t.clone() for t in got]
        bad[i] = ~bad[i]
        with pytest.raises(AssertionError, match="overflow|rovf"):
            _plan_err(bad, want)
    cargs = plan_cgi_args(want, args)
    m = cgi.cgi_bins_reference(*cargs)
    assert m[2].tolist() == [0, 0, 0, 0, 1, 0]  # the plan's range flag in the row
    kept = int(torch.nonzero(m[0] >= 0)[0, 0])
    bad = [t.clone() for t in m]
    bad[0][kept] = -1
    with pytest.raises(AssertionError, match="slots"):
        _cgi_err(bad, m, n_bins=cgi_bins_count(cargs))
    assert _cgi_err(bad, m, flagged=True) == 0.0
    bad = [t.clone() for t in m]
    bad[2][4] = 0
    for flagged in (False, True):
        with pytest.raises(AssertionError, match="flags row"):
            _cgi_err(bad, m, flagged=flagged)


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
    cargs = plan_cgi_args(want, args)
    merged = cgi.cgi_bins(*cargs)
    torch.cuda.synchronize()
    after = _counts("launches")
    assert {k: after[k] - launched[k] for k in launched} == {"l2_plan": 1, "cgi_bins": 1}
    assert _plan_err(plan, want) == 0
    live = min(int(want[5][-1]), want[0].shape[0])
    assert all(not bool(t[live:].any()) for t in plan[:5])  # an empty slot is all 0
    # the kernels' design, which their plain twin spells out, bitwise
    _same(plan, l2_sweep.l2_plan_tiled(*torch_args(sweep_case(name), "cpu")))
    # the slots bitwise even where the plan overflows: both routes read the
    # slots below ch_max alone
    assert _cgi_err(merged, cgi.cgi_bins_reference(*cargs), n_bins=cgi_bins_count(cargs)) == 0.0
    assert l2_sweep.l2_plan_reference_calls == before["l2_plan"] + 1


@pytest.mark.cuda
def test_cuda_plan_on_an_empty_store():
    _cuda()
    plan = l2_sweep.l2_plan(*plan_no_store("cuda"))
    torch.cuda.synchronize()
    assert not bool(plan[1].any()) and not bool(plan[8])


@pytest.mark.cuda
def test_cuda_kernels_refuse_wrong_types():
    _cuda()
    args = list(torch_args(sweep_case("one_interval"), "cuda"))
    bad = list(args)
    bad[1] = args[1].to(torch.int64)
    with pytest.raises(TypeError, match="iv_g1"):
        l2_sweep.l2_plan(*bad)
    bad = list(args)
    bad[0] = args[0].reshape(-1)
    with pytest.raises(TypeError, match="iv_g0"):
        l2_sweep.l2_plan(*bad)
    bad = list(args)
    bad[6] = args[6].to(torch.int64)
    with pytest.raises(TypeError, match="mini_gpos"):
        l2_sweep.l2_plan(*bad)
    plan = l2_sweep.l2_plan(*args)
    cargs = list(plan_cgi_args(plan, args))
    cargs[1] = cargs[1][:-1]
    with pytest.raises(ValueError, match="cfirst"):
        cgi.cgi_bins(*cargs)
