"""Port parity at the shape of the all-vs-all: many genomes per shard.

The panel is ``bench.py``'s all-vs-all (families of four 3% mutants of an
ancestor, every second family descending from the one before at 9%) at
32 genomes of 100-250 kb, generated by ``chip_smoke.ava_genomes``, the
copy the smoke test runs on the card.  Each fragment's candidates lie in
eight genomes, so the sessions below run with several genomes on every
shard and with **presized** budgets: the presizer is under test.  The
port's ``ShardedSession`` runs on CPU meshes of the shapes the JAX
``ShardedSession`` runs on the 8 virtual devices of ``tests/conftest.py``;
hits, budgets and counters must be equal, and every genome must hit
exactly the eight genomes of its family and its sibling family, itself at
identity 100.
"""

import numpy as np
import pytest

import bench
import chip_smoke
import pyfastani_tpu
import pyfastani_tpu_torch
from pyfastani_tpu.parallel import sharded as jsh
from pyfastani_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pyfastani_tpu_torch import index as tidx
from pyfastani_tpu_torch.parallel.mesh import make_mesh
from pyfastani_tpu_torch.parallel.sharded import ShardedSession

_N = 32  # one turn of the length cycle: 4 lengths x 2 families x 4 genomes
_LENGTHS = (100_000, 150_000, 200_000, 250_000)
# a quarter of the default capacity: 1856 fragments in two full passes
_FRAG_CAPACITY = 1024
_COUNTERS = ("dispatches", "fragments_dispatched", "fragments_padded", "budget_escalations")


def _key(hits):
    return [(h.name, h.identity, h.matches, h.fragments) for h in hits]


@pytest.fixture(scope="module")
def panel():
    genomes = chip_smoke.ava_genomes(_N, _LENGTHS)
    jax_sketch = pyfastani_tpu.Sketch(backend="numpy")
    port_sketch = pyfastani_tpu_torch.Sketch(device="cpu")
    for i, g in enumerate(genomes):
        jax_sketch.add_genome(f"g{i}", g)
        port_sketch.add_genome(f"g{i}", g)
    return genomes, jax_sketch.index(), port_sketch.index()


@pytest.mark.parametrize("n_genomes,lengths", [(12, (3000, 5000, 7000, 11000)), (10, (4000,))])
def test_generator_copy_equals_bench(monkeypatch, n_genomes, lengths):
    """The smoke test's copy of the generator gives ``bench.py``'s bytes,
    a partial last family included."""
    monkeypatch.setattr(bench, "AVA_GENOMES", n_genomes)
    monkeypatch.setattr(bench, "AVA_LENGTHS", lengths)
    monkeypatch.setattr(bench, "AVA_CROSS", True)
    assert chip_smoke.ava_genomes(n_genomes, lengths) == bench._ava_genomes()


def test_full_panel_constants_equal_bench():
    assert chip_smoke.AVA_GENOMES == bench.AVA_GENOMES == 512
    assert (chip_smoke.AVA_LENGTHS, chip_smoke.AVA_FAMILY) == (bench.AVA_LENGTHS, bench.AVA_FAMILY)
    assert (chip_smoke.MUT_RATE, chip_smoke.CROSS_RATE) == (bench.MUT_RATE, bench.CROSS_RATE)
    lengths = [len(g) for g in chip_smoke.ava_genomes(64, (1, 2, 3, 5))]
    # the 512-genome panel is 16 turns of a 32-genome cycle of 88 units
    assert sum(lengths[:32]) == 88 and lengths[32:] == lengths[:32]


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_all_vs_all_equals_jax_sharded_session(panel, shape):
    genomes, jax_mapper, port_mapper = panel
    batch = [[g] for g in genomes]
    session = ShardedSession(
        port_mapper, make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1])),
        frag_capacity=_FRAG_CAPACITY,
    )
    got = session.query_many(batch)
    want_session = jsh.ShardedSession(jax_mapper, jax_make_mesh(*shape), frag_capacity=_FRAG_CAPACITY)
    want = want_session.query_many(batch)
    assert [_key(h) for h in got] == [_key(h) for h in want]
    assert session.budgets == want_session.budgets
    assert {k: session.stats[k] for k in _COUNTERS} == {k: want_session.stats[k] for k in _COUNTERS}
    assert session.stats["budget_escalations"] == 0 and session.stats["dispatches"] == 2
    for i, hits in enumerate(got):
        assert {h.name for h in hits} == chip_smoke.ava_expected(i), i
        assert [h.identity for h in hits if h.name == f"g{i}"] == [100.0]
    assert sum(len(h) for h in got) == chip_smoke.AVA_HITS_PER_GENOME * _N


@pytest.mark.parametrize("n_shards", [3, 4])
def test_index_split_by_genome_equals_jax(panel, n_shards):
    """Eight genomes or more on each shard: every array of the sharded
    index the port builds from its own mapper equals the JAX package's."""
    _, jax_mapper, port_mapper = panel
    got = tidx.build_sharded_index(port_mapper, n_shards)
    want = jsh.build_sharded_index(jax_mapper, n_shards)
    for name, value in vars(got).items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(value, getattr(want, name), err_msg=name)
        else:
            assert value == getattr(want, name), name


def test_version_equals_the_jax_package():
    assert pyfastani_tpu_torch.__version__ == pyfastani_tpu.__version__
    assert isinstance(pyfastani_tpu_torch.__version__, str)
