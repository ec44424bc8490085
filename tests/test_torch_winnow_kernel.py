"""The fragment winnow's CUDA kernel against its plain version.

``chip_smoke.WINNOW_CASES`` are the inputs the kernel
(``csrc/winnow_fragments.cu``) has to get right: palindromic k-mers, runs
of ``N`` and bytes outside ACGT, a poly-A fragment and fragments that
start on a repeated hash (the window-0 quirk), more unique hashes than
``kc`` (the overflow flag), ``k`` not a multiple of 4, protein at ``w`` 1,
one fragment, a window wider than the fragment, and a length past the
card's shared memory (the scratch variant).  ``tests/test_torch_winnow.py`` holds the plain version,
`winnow_fragments_reference`, against the JAX package on them; here the
wrapper's dispatch is checked on the CPU, and the kernel against the plain
version in a test that needs a card (marker ``cuda``).  Every output is an
integer: the comparisons are exact.  The file imports no JAX, so it also
runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_winnow_kernel.py -m cuda
"""

import numpy as np
import pytest
import torch

from chip_smoke import WINNOW_CASES as CASE_NAMES
from chip_smoke import winnow_case as case
from pyfastani_tpu_torch.ops import fragments


def _same(got, want):
    assert bool(got[0]) == bool(want[0])
    assert got[1].dtype == want[1].dtype == torch.int64
    assert got[2].dtype == want[2].dtype == torch.int32
    assert got[0].dim() == 0 and got[0].dtype == torch.bool
    assert torch.equal(got[1].cpu(), want[1].cpu())
    assert torch.equal(got[2].cpu(), want[2].cpu())


@pytest.mark.parametrize("name", ["nucl_edges", "k15", "protein_w1", "no_window"])
def test_winnow_fragments_takes_plain_version_on_cpu_only(name):
    frags, k, w, length, protein, kc = case(name)
    t = torch.from_numpy(frags)
    before = (fragments.launches, fragments.reference_calls)
    got = fragments.winnow_fragments(t, k, w, length, protein, kc)
    assert (fragments.launches, fragments.reference_calls) == (before[0], before[1] + 1)
    _same(got, fragments.winnow_fragments_reference(t, k, w, length, protein, kc))


def test_winnow_fragments_refuses_other_devices_and_types():
    frags, k, w, length, protein, kc = case("k5")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fragments.winnow_fragments(torch.from_numpy(frags).to("meta"), k, w, length, protein, kc)
    with pytest.raises(TypeError):
        fragments.winnow_fragments(torch.from_numpy(frags).to(torch.int32), k, w, length, protein, kc)
    with pytest.raises(ValueError, match="fewer than length"):
        fragments.winnow_fragments(torch.from_numpy(frags), k, w, length + 5, protein, kc)


def test_sketch_sizes_and_overflow_flag_of_the_plain_version():
    """The overflow case overflows and the others do not; the sketch is
    sorted, unique, without UMAX, padded with UMAX past its size."""
    for name in CASE_NAMES:
        frags, k, w, length, protein, kc = case(name)
        ovf, q, s = fragments.winnow_fragments_reference(
            torch.from_numpy(frags), k, w, length, protein, kc
        )
        assert bool(ovf) == (name == "overflow"), name
        for row, n in zip(q.numpy(), s.numpy()):
            m = min(int(n), row.shape[0])
            assert (np.diff(row[:m]) > 0).all() and (row[:m] < 0xFFFFFFFF).all(), name
            assert (row[m:] == 0xFFFFFFFF).all(), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASE_NAMES) + ["ava_shape"])
def test_cuda_kernel_matches_reference(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the winnow kernel is CUDA C++ with no CPU mode)")
    from pyfastani_tpu_torch._build import load_library

    if name == "ava_shape":  # the all-vs-all's groups: 4096 fragments of 3000 bytes
        frags = np.random.default_rng(4096).choice(np.frombuffer(b"ACGT", np.uint8), (4096, 3004))
        frags[:, 3000:] = 0
        k, w, length, protein, kc = 16, 24, 3000, False, 512
    else:
        frags, k, w, length, protein, kc = case(name)
    t = torch.from_numpy(frags).cuda()
    need = load_library().winnow_fragments_scratch_bytes(0, length, k, w, frags.shape[0])
    assert (need > 0) == (name == "scratch")
    before = (fragments.launches, fragments.reference_calls)
    got = fragments.winnow_fragments(t, k, w, length, protein, kc)
    assert (fragments.launches, fragments.reference_calls) == (before[0] + 1, before[1])
    want = fragments.winnow_fragments_reference(t, k, w, length, protein, kc)
    torch.cuda.synchronize()
    _same(got, want)
    # a row stride that is not a multiple of 4 (unaligned rows)
    wide = torch.zeros((frags.shape[0], frags.shape[1] + 3), dtype=torch.uint8, device="cuda")
    wide[:, 3:] = t
    got = fragments.winnow_fragments(wide[:, 3:], k, w, length, protein, kc)
    torch.cuda.synchronize()
    _same(got, want)
