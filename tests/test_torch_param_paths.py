"""Port parity on the port's other parameter paths: protein (k 16, w 1,
100-residue fragments), k 14 with 1 kb fragments, 5 kb fragments (on
the card, the winnow kernel's long route), k 15, k 21 with 5 kb
fragments, and the 95% species gate with a minimum fraction of 0.5.

Tiny panels of ``chip_smoke.py`` phase 15's six configurations
(``chip_smoke.PARAM_PATHS``, ``chip_smoke.param_panel``) go through the
port's ``ShardedSession`` on a CPU mesh, the JAX package's
``ShardedSession`` on ``make_mesh(1, 1)`` and the host NumPy engine: hits
equal (identity ``==``), and the budgets and the session counters equal
the JAX session's.  The winnow's plain version, and its tile twin where
the card takes the tile route, are held against the JAX
``_winnow_fragments_impl`` at each configuration's shapes (tolerance 0:
every output is an integer).  The ``cuda`` cases run the same panels
through the card against the port's CPU route and skip without a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_param_paths.py -m cuda

JAX is imported inside the CPU cases only, so the ``cuda`` cases run
where JAX is absent.
"""

import numpy as np
import pytest
import torch

import pyfastani_tpu_torch as pt
from pyfastani_tpu_torch._common import hashes_to_numpy
from pyfastani_tpu_torch.ops.fragments import winnow_fragments_blocked, winnow_fragments_reference
from pyfastani_tpu_torch.parallel.mesh import make_mesh
from pyfastani_tpu_torch.parallel.sharded import ShardedSession
from pyfastani_tpu_torch.session import Session

import chip_smoke
from chip_smoke import PARAM_PATHS, PARAM_ROUTES

_COUNTERS = ("dispatches", "fragments_padded", "budget_escalations")
# the panels divided to a few members: 8 protein drafts, 8 phages, two
# species families of 77 and 154 kb
_SCALE = {"protein_bgc": 256, "nucl_k14_f1000": 128, "nucl_k15": 128, "nucl_species95": 13}
# queries held against the JAX session: one pass of the smallest capacity
_QUERIED = 2


def _key(hits):
    return [(h.name, h.identity, h.matches, h.fragments) for h in hits]


def _panel(name):
    """``chip_smoke.param_panel`` of ``name``, small; the configurations
    on phase 4's panel on three 150 kb references and two queries mutated
    at 3%."""
    if chip_smoke.PARAM_PANELS[name] != "phase 4":
        return chip_smoke.param_panel(name, scale=_SCALE[name])
    rng = np.random.default_rng(5)
    refs = [rng.choice(chip_smoke._ACGT, size=150_000) for _ in range(3)]
    queries = [chip_smoke.substitute(rng, refs[i], 0.03, chip_smoke._ACGT).tobytes()
               for i in range(2)]
    return chip_smoke.param_panel(name, [r.tobytes() for r in refs], queries)


def _index(name, references, device):
    sketch = pt.Sketch(**PARAM_PATHS[name], device=device)
    for ref, contigs in references:
        sketch.add_draft(ref, contigs)
    return sketch.index()


@pytest.fixture(scope="module", params=list(PARAM_PATHS))
def path(request):
    """A configuration's name, its small panel and the port's CPU mapper."""
    name = request.param
    references, queries, expected, self_hit = _panel(name)
    return name, references, queries, expected, self_hit, _index(name, references, "cpu")


def _fragment_rows(contigs, l: int) -> np.ndarray:
    """The ``(n, l + 4)`` uint8 fragment rows a session stages for
    ``contigs`` (each contig cut into whole ``l``-long fragments)."""
    rows = [np.frombuffer(c, np.uint8)[: len(c) // l * l].reshape(-1, l) for c in contigs]
    block = np.concatenate([r for r in rows if r.size])
    return np.pad(block, ((0, 0), (0, 4)))


def test_session_matches_jax_and_host_engine(path):
    import pyfastani_tpu
    from pyfastani_tpu.parallel import sharded as jsh
    from pyfastani_tpu.parallel.mesh import make_mesh as jax_make_mesh

    name, references, queries, expected, self_hit, mapper = path
    queries, expected = queries[:_QUERIED], expected[:_QUERIED]
    if PARAM_PATHS[name].get("protein"):  # and X, stops and lowercase in a third
        queries.append(chip_smoke.odd_residues(queries[1][:8]))
        expected.append(expected[1])
    jax_sketch = pyfastani_tpu.Sketch(**PARAM_PATHS[name], backend="numpy")
    for ref, contigs in references:
        jax_sketch.add_draft(ref, contigs)
    want_session = jsh.ShardedSession(jax_sketch.index(), jax_make_mesh(1, 1))
    want = want_session.query_many(queries)
    session = ShardedSession(mapper, make_mesh(1, 1, devices=["cpu"]))
    got = session.query_many(queries)
    host = [mapper._query_host(q) for q in queries]
    assert [_key(h) for h in got] == [_key(h) for h in want] == [_key(h) for h in host]
    assert session.budgets == want_session.budgets
    assert {k: session.stats[k] for k in _COUNTERS} == {k: want_session.stats[k] for k in _COUNTERS}
    for qi, (hits, names) in enumerate(zip(got, expected)):
        assert sorted(h.name for h in hits) == sorted(names)
        assert not self_hit or qi >= _QUERIED or 100.0 in [h.identity for h in hits]


def test_winnow_matches_jax_at_the_path_shapes(path):
    """The winnow's plain version (and, where the card takes the tile
    route, the tile twin) against the JAX package on the first query's
    fragments, at the session's sketch width ``kc``; for protein also on
    the MIBiG drafts' real residues."""
    import jax.numpy as jnp

    from pyfastani_tpu.ops.fragments import _winnow_fragments_impl

    name, _, queries, _, _, mapper = path
    p = mapper._param
    k, w, l = p.kmer_size, p.window_size, p.min_read_length
    kc = min(Session(mapper, device="cpu").budgets["smax"] + 128, l)
    contigs = list(queries[0])
    if p.protein:
        contigs += [c for draft in chip_smoke.mibig_golden() for c in draft]
    frags = _fragment_rows(contigs, l)
    j_ovf, _, j_q, j_s = _winnow_fragments_impl(jnp.asarray(frags), k, w, l, p.protein, kc)
    twins = [winnow_fragments_reference]
    if PARAM_ROUTES[name].startswith("tile"):
        twins.append(winnow_fragments_blocked)
    for twin in twins:
        ovf, q, s = twin(torch.from_numpy(frags), k, w, l, p.protein, kc)
        assert bool(ovf) == bool(j_ovf) is False
        np.testing.assert_array_equal(hashes_to_numpy(q), np.asarray(j_q))
        np.testing.assert_array_equal(s.numpy(), np.asarray(j_s))


def test_mibig_golden_through_every_cpu_route():
    """``chip_smoke.golden_runs`` on the CPU: query_draft, query_many,
    mappers pickled before and after ``index()`` and the host engine all
    give the golden, with one identity."""
    runs = chip_smoke.golden_runs("cpu")
    for hits in runs.values():
        assert [(h.name, h.matches, h.fragments) for h in hits] == chip_smoke.MIBIG_GOLDEN
        assert _key(hits) == _key(runs["query_draft"])


def test_panels_follow_their_generators():
    """Phase 15's panels: protein drafts of 24 proteins of 150-600 of the
    20 amino acids, phages of 30-80 kb of ACGT, families of four that
    differ at about the stated rate, one query in 64 or 32; the species
    panel's families of five and their first members queried."""
    drafts = chip_smoke.bgc_panel(8)
    assert len(drafts) == 8 and all(len(d) == chip_smoke.BGC_PROTEINS for d in drafts)
    lengths = [len(p) for d in drafts for p in d]
    assert min(lengths) >= 150 and max(lengths) <= 600
    assert set(b"".join(drafts[0])) <= set(chip_smoke._AMINO.tobytes())
    a, b = (np.frombuffer(b"".join(d), np.uint8) for d in drafts[:2])
    assert 0.07 < (a != b).mean() < 0.12  # two mutants at 5% of 20 letters
    assert [len(p) for p in drafts[0]] == [len(p) for p in drafts[3]]
    assert [len(p) for p in drafts[0]] != [len(p) for p in drafts[4]]
    phages = chip_smoke.phage_panel(8)
    assert all(30_000 <= len(g[0]) <= 80_000 for g in phages)
    a, b = (np.frombuffer(g[0], np.uint8) for g in phages[:2])
    assert 0.03 < (a != b).mean() < 0.06  # two mutants at 3% of 4 letters
    assert chip_smoke.bgc_panel(8) == drafts
    assert (chip_smoke.BGC_DRAFTS, chip_smoke.PHAGE_GENOMES) == (2048, 1024)
    _, queries, expected, _ = chip_smoke.param_panel("protein_bgc", scale=16)
    assert len(queries) == chip_smoke.PARAM_QUERIES and expected[1] == {"g4", "g5", "g6", "g7"}
    # species: families of five, three members at 3%, another species at
    # 20%, a chimera whose first 35% follows the first member
    species = chip_smoke.species_panel(2, [60_000, 90_000])
    assert [len(g[0]) for g in species] == [60_000] * 5 + [90_000] * 5
    a, b, _, far, chimera = (np.frombuffer(g[0], np.uint8) for g in species[:5])
    cut = int(chip_smoke.SPECIES_SHARE * 60_000)
    assert 0.03 < (a != b).mean() < 0.06 and 0.15 < (a != far).mean() < 0.19
    assert (a[:cut] != chimera[:cut]).mean() < 0.03 and (a[cut:] != chimera[cut:]).mean() > 0.7
    lengths = chip_smoke.AVA_LENGTHS
    assert sum(lengths[f % 4] for f in range(chip_smoke.SPECIES_FAMILIES)) * 5 == 345_000_000
    _, queries, expected, _ = chip_smoke.param_panel("nucl_species95", scale=13)
    assert expected == [{"g0", "g1", "g2"}, {"g5", "g6", "g7"}] and len(queries) == 2


def test_species_gate_and_fraction_drop_pairs():
    """The smoke's check of the species panel (`chip_smoke.species_defaults`)
    on the small panel on the CPU: at (95, 0.5) each query keeps its three
    members, at the defaults (80, 0.2) its whole family, both equal to the
    host engine, and the defaults' hits are a strict superset: the 95%
    gate drops the other species, the fraction 0.5 the chimera."""
    references, queries, expected, _ = _panel("nucl_species95")
    mapper = _index("nucl_species95", references, "cpu")
    strict = Session(mapper, device="cpu").query_many(queries)
    assert [_key(h) for h in strict] == [_key(mapper._query_host(q)) for q in queries]
    assert [{h.name for h in hits} for hits in strict] == expected
    chip_smoke.species_defaults("species", "cpu", references, queries, strict,
                                mapper._param.min_read_length, device="cpu")


def test_k21_pairs_on_one_shared_minimizer_match_jax():
    """Above k 16 a fragment of an unrelated pair maps on one shared
    minimizer hash, at an identity near 75, under the gate's 80; a query
    of five fragments then keeps the pair.  The port's session reports
    the same pairs as the JAX package's and the host engine."""
    import pyfastani_tpu
    from pyfastani_tpu.parallel import sharded as jsh
    from pyfastani_tpu.parallel.mesh import make_mesh as jax_make_mesh

    rng = np.random.default_rng(21)
    references = [(f"ref{i}", [rng.choice(chip_smoke._ACGT, size=1_000_000).tobytes()])
                  for i in range(2)]
    queries = [[rng.choice(chip_smoke._ACGT, size=25_000).tobytes()] for _ in range(8)]
    mapper = _index("nucl_k21_f5000", references, "cpu")
    jax_sketch = pyfastani_tpu.Sketch(**PARAM_PATHS["nucl_k21_f5000"], backend="numpy")
    for ref, contigs in references:
        jax_sketch.add_draft(ref, contigs)
    want = jsh.ShardedSession(jax_sketch.index(), jax_make_mesh(1, 1)).query_many(queries)
    got = ShardedSession(mapper, make_mesh(1, 1, devices=["cpu"])).query_many(queries)
    assert [_key(h) for h in got] == [_key(h) for h in want] == [
        _key(mapper._query_host(q)) for q in queries]
    kept = [h for hits in got for h in hits]
    assert len(kept) >= 2 and all(h.matches == 1 and 74 < h.identity < 76 for h in kept)


def test_k_above_16_warns_like_jax():
    """``Sketch(k=...)`` warns above 16 in the port as in the JAX package:
    the same category, message and caller's file.  From k 512 both raise
    the same errors: ``OverflowError`` (the p-value's ``4.0 ** k``) up to
    `MAX_KMER_SIZE`, ``BufferError`` past it."""
    import warnings

    import pyfastani_tpu

    def made(make, k):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            make(k)
        return [(w.category, str(w.message), w.filename) for w in caught]

    for k in (15, 16, 17, 21, 511):
        port = made(lambda k: pt.Sketch(k=k, device="cpu"), k)
        assert port == made(lambda k: pyfastani_tpu.Sketch(k=k, backend="numpy"), k)
        assert [m for _, m, _ in port] == (
            [f"Using k-mer size greater than 16 ({k}), accuracy will be degraded."] if k > 16
            else [])
        assert {f for _, _, f in port} <= {__file__}
    for k, error in ((512, OverflowError), (pt.MAX_KMER_SIZE, OverflowError),
                     (pt.MAX_KMER_SIZE + 1, BufferError)):
        for make in (lambda: pt.Sketch(k=k, device="cpu"),
                     lambda: pyfastani_tpu.Sketch(k=k, backend="numpy")):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with pytest.raises(error):
                    make()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PARAM_PATHS))
def test_param_path_on_card(name):
    """The configuration's small panel on the card (``query_draft`` and
    ``Session.query_many``) equals the port's CPU route; for protein, the
    MIBiG golden on the card equals the CPU route's on every route."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the path's kernels are CUDA C++ with no CPU mode)")
    references, queries, expected, _ = _panel(name)
    card = _index(name, references, "cuda")
    cpu = _index(name, references, "cpu")
    want = [_key(cpu.query_draft(q)) for q in queries]
    assert [_key(card.query_draft(q)) for q in queries] == want
    assert [_key(h) for h in Session(card, q_capacity=16).query_many(queries)] == want
    assert [sorted(h[0] for h in hits) for hits in want] == [sorted(e) for e in expected]
    if PARAM_PATHS[name].get("protein"):
        runs, cpu_runs = chip_smoke.golden_runs(), chip_smoke.golden_runs("cpu")
        assert {r: _key(h) for r, h in runs.items()} == {r: _key(h) for r, h in cpu_runs.items()}
