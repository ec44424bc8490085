"""The port's session, mesh and ingest winnow on a CUDA card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_device.py -m cuda

Each test holds the CUDA run against the same code on the CPU and
against the host engines, with exact equality.
"""

import numpy as np
import pytest
import torch

import pyfastani_tpu
import pyfastani_tpu_torch as pt
from pyfastani_tpu.models._engine_np import winnow_sequence
from pyfastani_tpu.models._params import Parameters
from pyfastani_tpu_torch.models._engine_torch import winnow_sequence_device
from pyfastani_tpu_torch.ops import fragments, l2
from pyfastani_tpu_torch.parallel.mesh import make_mesh
from pyfastani_tpu_torch.parallel.sharded import ShardedSession
from pyfastani_tpu_torch.session import Session

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the session's L2 kernel is CUDA C++ with no CPU mode)")


def _key(hits):
    return [(h.name, h.identity, h.matches, h.fragments) for h in hits]


@pytest.fixture(scope="module")
def panel():
    _needs_card()
    rng = np.random.default_rng(7)
    refs = [rng.choice(_ACGT, size=n).tobytes() for n in (60_000, 45_000, 52_000)]
    queries = []
    for i in range(4):
        q = np.frombuffer(refs[i % 3], np.uint8).copy()
        mut = rng.random(q.shape[0]) < 0.02 + 0.01 * i
        q[mut] = rng.choice(_ACGT, size=int(mut.sum()))
        queries.append(q.tobytes())
    host = pyfastani_tpu.Sketch(backend="numpy")
    port = pt.Sketch(device="cpu")
    for i, r in enumerate(refs):
        host.add_genome(f"g{i}", r)
        port.add_genome(f"g{i}", r)
    host = host.index()
    return port.index(), queries, [host.query_genome(q) for q in queries]


@pytest.mark.cuda
def test_pipelined_session_never_waits_inside_a_pass(panel):
    """Two groups through the pinned slots, under the sync check."""
    _needs_card()
    mapper, queries, host = panel
    session = Session(mapper, device="cuda", q_capacity=2, frag_capacity=256)
    batch = [[q] for q in queries]
    warm = session.query_many(batch)
    l2.launches, l2.reference_calls = 0, 0
    fragments.launches, fragments.reference_calls = 0, 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        steady = session.query_many(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert l2.launches > 0 and l2.reference_calls == 0
    assert fragments.launches > 0 and fragments.reference_calls == 0
    assert [_key(h) for h in steady] == [_key(h) for h in warm] == [_key(h) for h in host]
    assert all(host)


@pytest.mark.cuda
def test_mesh_on_one_card_equals_cpu_mesh(panel):
    _needs_card()
    mapper, queries, host = panel
    batch = [[q] for q in queries]
    got = ShardedSession(mapper, make_mesh(2, 2, devices=["cuda"] * 4)).query_many(batch)
    want = ShardedSession(mapper, make_mesh(2, 2, devices=["cpu"] * 4)).query_many(batch)
    assert [_key(h) for h in got] == [_key(h) for h in want] == [_key(h) for h in host]


@pytest.mark.cuda
@pytest.mark.parametrize("protein", [False, True])
def test_ingest_winnow_on_card_equals_host(protein):
    _needs_card()
    rng = np.random.default_rng(13)
    alphabet = b"ACDEFGHIKLMNPQRSTVWY" if protein else b"ACGT"
    data = rng.choice(np.frombuffer(alphabet, np.uint8), size=300_000)
    params = Parameters(kmer_size=5 if protein else 16, window_size=8 if protein else 24,
                        alphabet_size=20 if protein else 4)
    got = winnow_sequence_device(data, params, device="cuda")
    for g, w in zip(got, winnow_sequence(data, params)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
