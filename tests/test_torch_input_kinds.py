"""Port parity: every kind of query sequence through the device route.

The session stages the raw bytes of each contig and uppercases them on
the device (`session._toupper`); a genome with a non-ASCII ``str`` contig
is converted on the host by ``codec.to_bytes`` instead, and a group that
holds one is uppercased on the host whole.  Each input kind, on one small
panel, goes through ``Session(device="cpu").query_many`` and
``Mapper.query_draft`` and must equal the JAX package's
``ShardedSession`` on the same input and the port's host engine
(``Mapper._query_host``, which keeps ``codec.to_bytes``).  Tolerance:
exact (names, identity ``==``, matches, fragments).
"""

import warnings

import numpy as np
import pytest
import torch

import pyfastani_tpu
import pyfastani_tpu_torch
from pyfastani_tpu.ops import codec as jax_codec
from pyfastani_tpu.parallel import sharded as jsh
from pyfastani_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pyfastani_tpu_torch.ops import codec
from pyfastani_tpu_torch.session import Session, _toupper

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_BUDGETS = dict(hmax=512, ivmax=16, cmax=128, rmax=384, t_chunks=52, bin_max=64, smax=256)
_SHORT = b"ACGTACGT"  # shorter than k: warns, maps nothing


def _key(hits):
    return [(h.name, h.identity, h.matches, h.fragments) for h in hits]


def _mixed(contig: bytes) -> bytes:
    """``contig`` with about half of its letters lowercase."""
    arr = np.frombuffer(contig, np.uint8).copy()
    arr[np.random.default_rng(len(contig)).random(arr.shape[0]) < 0.5] |= 0x20
    return arr.tobytes()


def _non_ascii(contig: bytes) -> str:
    """Mixed case, with code points whose low byte is ``a`` or ``z``
    (U+0161, U+017A) at every 97th and 89th position."""
    chars = list(_mixed(contig).decode("ascii"))
    chars[::97] = "š" * len(chars[::97])
    chars[5::89] = "ź" * len(chars[5::89])
    return "".join(chars)


KINDS = {
    "bytes": lambda c: c,
    "bytearray": bytearray,
    "memoryview": memoryview,
    "lowercase_bytes": bytes.lower,
    "mixed_case_bytes": _mixed,
    "lowercase_str": lambda c: c.decode("ascii").lower(),
    "uint8_ndarray": lambda c: np.frombuffer(_mixed(c), np.uint8).copy(),
    "int16_ndarray": lambda c: np.frombuffer(_mixed(c), np.int16).copy(),
    "non_ascii_str": _non_ascii,
}


@pytest.fixture(scope="module")
def panel():
    """Five references indexed by both packages, and two query genomes
    of two contigs and a short one each, as uppercase bytes (every
    contig of even length, so that the int16 view keeps every byte)."""
    rng = np.random.default_rng(17)
    refs = [rng.choice(_ACGT, size=n).tobytes() for n in (40_000, 25_000, 31_000, 18_000, 22_000)]
    queries = []
    for ref, rate in ((refs[1], 0.04), (refs[3], 0.03)):
        q = np.frombuffer(ref, np.uint8).copy()
        mut = rng.random(q.shape[0]) < rate
        q[mut] = rng.choice(_ACGT, size=int(mut.sum()))
        q = q.tobytes()
        queries.append([q[:12_000], q[12_000:], _SHORT])
    jax_sketch = pyfastani_tpu.Sketch(backend="numpy")
    port_sketch = pyfastani_tpu_torch.Sketch(device="cpu")
    for i, r in enumerate(refs):
        jax_sketch.add_genome(f"g{i}", r)
        port_sketch.add_genome(f"g{i}", r)
    jax_mapper, port_mapper = jax_sketch.index(), port_sketch.index()
    return dict(
        jax_mapper=jax_mapper,
        port_mapper=port_mapper,
        queries=queries,
        jax_session=jsh.ShardedSession(jax_mapper, jax_make_mesh(1, 1), **_BUDGETS),
        session=Session(port_mapper, device="cpu", **_BUDGETS),
    )


def _quiet(run):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return run()


@pytest.mark.parametrize("kind", list(KINDS))
def test_input_kind_matches_jax_and_host_engine(panel, kind):
    mapper = panel["port_mapper"]
    batch = [[KINDS[kind](c) for c in genome] for genome in panel["queries"]]
    for genome in batch:
        for contig in genome:
            raw = codec.raw_bytes(contig)
            if kind == "non_ascii_str":
                assert raw is None
            else:
                np.testing.assert_array_equal(codec._UPPER_LUT[raw], jax_codec.to_bytes(contig))

    want = _quiet(lambda: panel["jax_session"].query_many(batch))
    with pytest.warns(UserWarning, match="short sequence") as caught:
        got = panel["session"].query_many(batch)
    assert {w.filename for w in caught} == {__file__}  # the warning's stacklevel
    with pytest.warns(UserWarning, match="short sequence"):
        drafts = [mapper.query_draft(genome) for genome in batch]
    host = _quiet(lambda: [mapper._query_host(genome) for genome in batch])
    assert all(got)
    assert [_key(h) for h in got] == [_key(h) for h in want] == [_key(h) for h in host]
    assert [_key(h) for h in drafts] == [_key(h) for h in host]
    if kind != "non_ascii_str":  # the same bases as the uppercase bytes
        upper = _quiet(lambda: [mapper._query_host(genome) for genome in panel["queries"]])
        assert [_key(h) for h in got] == [_key(h) for h in upper]


@pytest.mark.parametrize("q_capacity, groups", [(16, 1), (1, 3)])
def test_non_ascii_and_raw_genomes_in_one_or_separate_groups(panel, q_capacity, groups, monkeypatch):
    """A non-ASCII ``str`` genome beside a lowercase ``bytes`` and a
    mixed-case ``ndarray`` one: in one group the host uppercases all
    three and the device none; in three groups only the ``str`` group
    skips the device's uppercase.

    JAX's CPU backend may alias a host array in ``device_put``, and the
    JAX session rewrites a staging buffer once that "transfer" is ready,
    which can be before its asynchronous program has read it: the
    reference then maps another group's fragments.  Its arrays are
    staged as copies here, as a transfer to a device makes them."""
    put = jsh._put
    monkeypatch.setattr(jsh, "_put", lambda arr, sharding: put(np.array(arr, copy=True), sharding))
    q0, q1 = panel["queries"]
    batch = [
        [_non_ascii(c) for c in q0],
        [c.lower() for c in q1],
        [np.frombuffer(_mixed(c), np.uint8) for c in q0],
    ]
    session = Session(panel["port_mapper"], device="cpu", q_capacity=q_capacity, **_BUDGETS)
    routes = []
    run_pass = session._pass

    def record(frags, frag_qg, m_values, slot=None, toupper=True):
        routes.append(toupper)
        return run_pass(frags, frag_qg, m_values, slot, toupper)

    session._pass = record
    got = _quiet(lambda: session.query_many(batch))
    jax_session = jsh.ShardedSession(
        panel["jax_mapper"], jax_make_mesh(1, 1), q_capacity=q_capacity, **_BUDGETS
    )
    want = _quiet(lambda: jax_session.query_many(batch))
    host = _quiet(lambda: [panel["port_mapper"]._query_host(genome) for genome in batch])
    assert all(got)
    assert [_key(h) for h in got] == [_key(h) for h in want] == [_key(h) for h in host]
    assert session.stats["dispatches"] == groups
    assert sorted(routes) == ([False] if groups == 1 else [False, True, True])


def test_device_toupper_is_the_codec_table():
    """On all 256 byte values, in a zero-padded block like a staged one."""
    block = torch.zeros((3, 260), dtype=torch.uint8)
    block[1, :256] = torch.arange(256, dtype=torch.uint8)
    out = _toupper(block)
    assert out.dtype == torch.uint8 and out.shape == block.shape
    np.testing.assert_array_equal(out[1, :256].numpy(), jax_codec._UPPER_LUT)
    np.testing.assert_array_equal(out[1, :256].numpy(), codec._UPPER_LUT)
    assert not out[0].any() and not out[2].any() and not out[1, 256:].any()
    np.testing.assert_array_equal(block[1, :256].numpy(), np.arange(256))  # not in place
