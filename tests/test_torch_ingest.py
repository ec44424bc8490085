"""Port parity: the device ingest winnow and the profiling helpers.

`winnow_sequence_device` / `ops.fragments.winnow_long_sequence` winnow a
long sequence in chunks with a carried boundary state; they must equal
the host ``_engine_np.winnow_sequence`` (pinned to the reference deque
loop by ``tests/test_winnow.py``) and the JAX package's
``winnow_long_sequence`` bitwise, at every chunk size -- also chunks
smaller than the window.
"""

import json
import os

import numpy as np
import pytest
import torch

from pyfastani_tpu.models._engine_np import winnow_sequence
from pyfastani_tpu.models._params import Parameters
from pyfastani_tpu.ops.codec import to_bytes
from pyfastani_tpu_torch.models._engine_torch import winnow_sequence_device
from pyfastani_tpu_torch.ops.fragments import winnow_long_sequence
from pyfastani_tpu_torch.utils.profiling import device_time_ms, timed, trace


def _params(k, w, protein):
    return Parameters(kmer_size=k, window_size=w, alphabet_size=20 if protein else 4)


def _port_chunked(data, k, w, protein, chunk):
    h, p = winnow_long_sequence(torch.from_numpy(np.array(data)), k, w, protein, chunk=chunk)
    return h.numpy().astype(np.uint32), p.numpy()


@pytest.mark.parametrize("protein", [False, True])
@pytest.mark.parametrize("k,w", [(3, 5), (5, 4), (16, 24), (16, 5), (7, 7), (16, 1)])
def test_chunked_winnow_matches_host_at_every_chunk_size(k, w, protein):
    rng = np.random.default_rng(hash((k, w, protein)) % 2**32)
    alphabet = np.frombuffer(b"ACGTNacgtRYSWn", dtype=np.uint8)
    for _ in range(3):
        n = int(rng.integers(k + w - 1, 2500))
        data = to_bytes(rng.choice(alphabet, size=n).tobytes())
        want = winnow_sequence(data, _params(k, w, protein))
        for chunk in (w - 1 if w > 1 else 7, 37, 1024):  # w - 1: a chunk narrower than w
            got = _port_chunked(data, k, w, protein, chunk)
            for g, x in zip(got, want):
                np.testing.assert_array_equal(g, x, err_msg=str((k, w, n, chunk)))
        got = winnow_sequence_device(data, _params(k, w, protein), device="cpu")
        for g, x in zip(got, want):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(g, x)


def test_quirk_cases_across_chunk_boundaries():
    """The low-complexity inputs of ``tests/test_winnow2d.py``: the tie to
    the later position and the window-0 suppression quirk, with chunks
    small enough that the carry crosses every recurrence."""
    seqs = [
        b"A" * 500,
        b"AT" * 300,
        b"ACG" * 200,
        b"AAAT" + b"A" * 400,
        b"A" * 100 + b"CGTAC" * 80,
    ]
    for seq in seqs:
        data = to_bytes(seq)
        for k, w in [(4, 3), (16, 24), (5, 1), (3, 7)]:
            if len(seq) < k + w - 1:
                continue
            want = winnow_sequence(data, _params(k, w, False))
            for chunk in (3, 17, 256):
                got = _port_chunked(data, k, w, False, chunk)
                for g, x in zip(got, want):
                    np.testing.assert_array_equal(g, x, err_msg=str((seq[:6], k, w, chunk)))


@pytest.mark.parametrize("protein", [False, True])
def test_long_sequence_matches_jax(protein):
    from pyfastani_tpu.ops.fragments import winnow_long_sequence as jax_winnow_long_sequence

    rng = np.random.default_rng(11)
    alphabet = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY" if protein else b"ACGT", np.uint8)
    data = rng.choice(alphabet, size=70_000)
    k, w = (5, 8) if protein else (16, 24)
    want = jax_winnow_long_sequence(data, k, w, protein, chunk=1 << 14)
    for chunk in (1 << 14, 5000, None):
        got = _port_chunked(data, k, w, protein, chunk)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(x))
    host = winnow_sequence(data, _params(k, w, protein))
    assert all(np.array_equal(g, x) for g, x in zip(got, host))


def test_dense_minimizers_retry_with_a_larger_cap(monkeypatch):
    """A period-5 repeat records a minimizer every 5 windows, past the
    compaction buffer's 4 / (w + 1): the chunk is compacted again into a
    buffer that fits, and the result still equals the host winnow."""
    from pyfastani_tpu_torch.ops import fragments

    rng = np.random.default_rng(0)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=50).tobytes() + b"ACGTA" * 8000
    data = to_bytes(seq)
    caps = []
    compact = fragments._compact

    def spy(record, rank, values, cap):
        caps.append(cap)
        return compact(record, rank, values, cap)

    monkeypatch.setattr(fragments, "_compact", spy)
    got = _port_chunked(data, 16, 24, False, 12_800)
    assert min(caps) == 2048 and max(caps) > 2048  # 4 * 12800 / 25, then a retry
    for g, x in zip(got, winnow_sequence(data, _params(16, 24, False))):
        np.testing.assert_array_equal(g, x)


def test_short_input_and_default_device():
    params = _params(16, 24, False)
    h, p = winnow_sequence_device(np.frombuffer(b"ACGT" * 5, np.uint8), params, device="cpu")
    assert h.dtype == np.uint32 and p.dtype == np.int32 and h.size == p.size == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            winnow_sequence_device(np.frombuffer(b"ACGT" * 50, np.uint8), params)


def test_profiling_trace_and_timed(tmp_path):
    rng = np.random.default_rng(3)
    data = to_bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=20_000).tobytes())
    sink = []
    with timed("winnow", sink), trace(str(tmp_path)) as prof:
        winnow_sequence_device(data, _params(16, 24, False), device="cpu")
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)
    assert [label for label, _ in sink] == ["winnow"] and sink[0][1] > 0
    assert device_time_ms(prof) == 0.0  # no device work on the CPU
