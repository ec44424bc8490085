"""The port stands alone: it imports nothing of JAX or of ``pyfastani_tpu``.

``pyfastani_tpu_torch`` keeps its own copies of the host code it shares
with the JAX package (``stats``, ``Parameters``, ``codec``, the host NumPy
engine and its hashing and winnowing, the FASTA reader, the C extension
``fastamod.c``, the result types and the facade).  These tests pin that:

* no module of the port, nor ``chip_smoke.py``, imports ``jax`` or
  ``pyfastani_tpu`` (read from their syntax trees);
* a process that imports every module of the port and runs sketch, index,
  query, session, pickle and the ``.npz`` checkpoint ends with neither
  loaded;
* each copy equals the JAX package's original bitwise on the same seeded
  inputs.
"""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import pyfastani_tpu
import pyfastani_tpu_torch
from pyfastani_tpu_torch import _native as port_native
from pyfastani_tpu_torch import stats as port_stats
from pyfastani_tpu_torch.models import _engine_np as port_engine
from pyfastani_tpu_torch.models._params import Parameters as PortParameters
from pyfastani_tpu_torch.ops import codec as port_codec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "pyfastani_tpu_torch"
_ACGT = np.frombuffer(b"ACGT", np.uint8)

# the port, its smoke test and its tools
_SOURCES = sorted(glob.glob(os.path.join(ROOT, PACKAGE, "**", "*.py"), recursive=True)) + [
    os.path.join(ROOT, name)
    for name in ("chip_smoke.py", "tools/torch_query_profile.py", "tools/l2_kernel_compare.py")
]


def _foreign(name: str) -> bool:
    return any(name == top or name.startswith(top + ".") for top in ("jax", "pyfastani_tpu"))


def _imports(path: str):
    """``(line, absolute module name)`` of every import in ``path``, with
    relative imports resolved against the file's package."""
    rel = os.path.relpath(path, ROOT)
    package = rel[:-3].split(os.sep)[:-1]
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=rel)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.lineno, node.module
                continue
            if node.level > len(package):
                yield node.lineno, "<relative import above the package>"
                continue
            base = package[: len(package) - node.level + 1]
            yield node.lineno, ".".join(base + ([node.module] if node.module else []))


@pytest.mark.parametrize("path", _SOURCES, ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_of_jax_or_the_jax_package(path):
    found = list(_imports(path))
    bad = [(line, name) for line, name in found if _foreign(name) or name.startswith("<")]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
    assert found or path.endswith(("__init__.py", "_version.py"))


def test_sources_cover_the_whole_package():
    names = {os.path.relpath(p, ROOT) for p in _SOURCES}
    for path in glob.glob(os.path.join(ROOT, PACKAGE, "**", "*.py"), recursive=True):
        assert os.path.relpath(path, ROOT) in names
    assert "chip_smoke.py" in names


def test_a_whole_run_loads_neither_jax_nor_the_jax_package():
    script = textwrap.dedent(
        f"""
        import importlib, os, pickle, pkgutil, sys, tempfile
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import pyfastani_tpu_torch as pt
        for mod in pkgutil.walk_packages(pt.__path__, "pyfastani_tpu_torch."):
            importlib.import_module(mod.name)
        from pyfastani_tpu_torch.index import ShardedIndex, build_sharded_index
        from pyfastani_tpu_torch.session import Session

        rng = np.random.default_rng(0)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        refs = [rng.choice(acgt, size=30_000).tobytes() for _ in range(2)]
        query = np.frombuffer(refs[1], np.uint8).copy()
        mut = rng.random(query.shape[0]) < 0.02
        query[mut] = rng.choice(acgt, size=int(mut.sum()))
        query = query.tobytes()

        sk = pt.Sketch(device="cpu")
        for i, r in enumerate(refs):
            sk.add_genome(f"ref{{i}}", r)
        mapper = sk.index()
        hits = mapper.query_genome(query)
        assert hits and hits[0].name == "ref1", hits
        many = Session(mapper, device="cpu").query_many([[query], [refs[0]]])
        assert many[0] == hits and many[1][0].name == "ref0", many
        clone = pickle.loads(pickle.dumps(mapper))
        assert type(clone) is pt.Mapper and clone.query_genome(query) == hits
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "index.npz")
            build_sharded_index(mapper, 1).save(path)
            restored = Session.from_index(ShardedIndex.load(path), device="cpu")
            assert restored.query([query]) == hits
        loaded = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith("jax.") or m == "pyfastani_tpu"
            or m.startswith("pyfastani_tpu.")
        )
        assert not loaded, loaded
        print("ok")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, env=env, timeout=300,
        cwd=ROOT,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


# --- the host C extension ---------------------------------------------------


def _c_cases(tmp_path):
    """Seeded arguments for each function of ``fastamod.c``."""
    rng = np.random.default_rng(21)
    raw = rng.integers(0, 256, size=5000, dtype=np.uint8).tobytes()
    seq = rng.choice(np.frombuffer(b"ACGTNacgtn", np.uint8), size=60_000).tobytes()
    prot = rng.choice(np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8), size=20_000).tobytes()
    keys = rng.integers(0, 1 << 20, size=50_000).astype(np.uint32)
    vals = rng.integers(-(2**31), 2**31 - 1, size=50_000).astype(np.int32)
    idx = rng.integers(0, vals.shape[0], size=30_000).astype(np.int32)
    ascending = np.sort(rng.integers(0, 1 << 24, size=40_000)).astype(np.int32)
    fasta = tmp_path / "x.fa"
    fasta.write_text(">a desc\nacgt\nACGTNn\n>b\n" + "A" * 5000 + "\n\n>c\n\ngattaca\n")
    return {
        "parse_fasta": [(str(fasta),)],
        "copy_upper": [(raw,)],
        "reverse_complement": [(raw,), (seq,)],
        "murmur3_32": [(raw[:n], 42) for n in (0, 1, 3, 4, 5, 16, 33)] + [(raw[:21], 7)],
        "winnow": [(seq.upper(), 16, 24), (seq.upper(), 5, 1, False), (prot, 5, 8, True)],
        "sort_u32_perm": [(keys.data,)],
        "take32": [(vals.data, idx.data)],
        "csr_bounds": [(np.sort(keys).data,)],
        "hist_prefix": [(keys.data, 4, 16), (keys.data, 8, 12)],
        "max_window_count": [(ascending.data, 3000), (ascending.data, 1)],
    }


_C_FUNCTIONS = [
    "parse_fasta", "copy_upper", "reverse_complement", "murmur3_32", "winnow",
    "sort_u32_perm", "take32", "csr_bounds", "hist_prefix", "max_window_count",
]


@pytest.mark.parametrize("name", _C_FUNCTIONS)
def test_c_extension_copy_equals_the_original(name, tmp_path):
    from pyfastani_tpu._native import _native as original

    for args in _c_cases(tmp_path)[name]:
        got = getattr(port_native, name)(*args)
        want = getattr(original, name)(*args)
        assert type(got) is type(want)
        assert got == want, (name, args[1:] if len(args) > 1 else "")


def test_c_extension_builds_into_the_build_directory():
    path = port_native._library_path()
    assert os.path.dirname(path) == os.path.join(ROOT, "build", PACKAGE)
    port_native.load()
    assert os.path.exists(path)
    assert port_native.load() is port_native.load()
    with pytest.raises(AttributeError):
        port_native.no_such_function


def test_a_failed_c_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(port_native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(
        port_native, "_compiler",
        lambda: [sys.executable, "-c", "import sys; print('no compiler here'); sys.exit(3)"],
    )
    with pytest.raises(RuntimeError, match="no compiler here"):
        port_native._compile(str(tmp_path / "x.so"))
    assert os.listdir(tmp_path) == []  # the temporary file is gone


# --- the host engine, stats, codec, parameters, FASTA ------------------------


@pytest.mark.parametrize(
    "alphabet,k,w",
    [(b"ACGTN", 16, 24), (b"ACGT", 13, 7), (b"ACDEFGHIKLMNPQRSTVWY", 5, 8)],
    ids=["nucleotide-16-24", "nucleotide-13-7", "protein-5-8"],
)
def test_host_winnow_equals_the_original(alphabet, k, w):
    """The host NumPy winnow (``ops/_host.py`` under ``_engine_np``)
    against the JAX package's, and against the port's C winnow."""
    from pyfastani_tpu.models import _engine_np as original
    from pyfastani_tpu.models._params import Parameters

    protein = len(alphabet) == 20
    rng = np.random.default_rng(22)
    data = rng.choice(np.frombuffer(alphabet, np.uint8), size=40_000)
    data[:3000] = ord("A")  # a run that keeps the window-0 quirk active
    kw = dict(kmer_size=k, window_size=w, alphabet_size=20 if protein else 4)
    got = port_engine.winnow_sequence(data, PortParameters(**kw))
    want = original.winnow_sequence(data, Parameters(**kw))
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
    assert got[0].shape[0] > 1000
    native_h, native_p = port_native.winnow(data.tobytes(), k, w, protein)
    np.testing.assert_array_equal(np.frombuffer(native_h, np.uint32), got[0])
    np.testing.assert_array_equal(np.frombuffer(native_p, np.int32), got[1])


def test_host_engine_hits_and_minimizers_equal_the_original():
    rng = np.random.default_rng(23)
    refs = [rng.choice(_ACGT, size=n).tobytes() for n in (40_000, 25_000, 31_000)]
    queries = []
    for i in range(3):
        q = np.frombuffer(refs[i], np.uint8).copy()
        mut = rng.random(q.shape[0]) < 0.01 * (i + 1)
        q[mut] = rng.choice(_ACGT, size=int(mut.sum()))
        queries.append(q.tobytes())
    queries.append(rng.choice(_ACGT, size=30_000).tobytes())
    port = pyfastani_tpu_torch.Sketch(device="cpu")
    host = pyfastani_tpu.Sketch(backend="numpy")
    for i, r in enumerate(refs):
        port.add_draft(f"g{i}", [r[:12_000], r[12_000:]])
        host.add_draft(f"g{i}", [r[:12_000], r[12_000:]])
    for g, w in zip(port.minimizers._arrays(), host.minimizers._arrays()):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    pm, hm = port.index(), host.index()
    for field in ("mini_hash", "uniq_hash", "row_start", "row_len", "post_seqid",
                  "post_wpos", "hash_bucket", "order"):
        np.testing.assert_array_equal(getattr(pm._index, field), getattr(hm._index, field))
    assert pm._index.freq_threshold == hm._index.freq_threshold
    assert pm._index.bucket_steps == hm._index.bucket_steps

    def key(hits):
        return [(h.name, h.identity, h.matches, h.fragments) for h in hits]

    for q in queries:
        assert key(pm._query_host([q])) == key(hm.query_genome(q))
    assert key(pm._query_host([queries[0]]))  # the panel maps
    assert pm._query_host([queries[-1]]) == []
    assert pm.lookup_index[int(pm._index.uniq_hash[0])] != []


def test_store_search_equals_the_original():
    """The host engine's lower bound on (seqId, wpos), searched per contig
    block, equals the original's search over every built key: contigs
    present and absent, positions before, inside and past a block, a
    negative position and one past int32."""
    from pyfastani_tpu.models import _engine_np as original

    rng = np.random.default_rng(41)
    seqid = np.sort(rng.choice([0, 1, 2, 4, 5, 9], size=3000)).astype(np.int32)
    wpos = np.empty(3000, np.int32)
    for c in np.unique(seqid):
        at = np.flatnonzero(seqid == c)
        wpos[at] = np.sort(rng.integers(0, 50_000, size=at.size))
    index = port_engine.build_index(rng.integers(0, 1 << 20, size=3000).astype(np.uint32), seqid, wpos)
    probes = [(c, w) for c in range(-1, 11) for w in (-5, 0, 1, 777, 25_000, 49_999, 60_000, 2**31 + 5)]
    probes += [(int(c), int(w)) for c, w in zip(seqid[::97], wpos[::97])]
    for c, w in probes:
        assert port_engine._search_pos(index, c, w) == original._search_pos(index, c, w), (c, w)


def test_stats_tables_equal_the_original(monkeypatch):
    from pyfastani_tpu import stats as original

    # the on-disk cache is shared by both packages: compute each afresh
    monkeypatch.setenv("PYFASTANI_TPU_CACHE_DIR", "0")
    for k, pid in ((16, 80.0), (12, 95.0)):
        for name in ("min_hits_relaxed_table", "l2_gate_table"):
            got = getattr(port_stats, name).__wrapped__(300, k, pid)
            want = getattr(original, name).__wrapped__(300, k, pid)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    got = port_stats.identity_table.__wrapped__(96, 16)
    want = original.identity_table.__wrapped__(96, 16)
    np.testing.assert_array_equal(got, want)
    assert port_stats.recommended_window_size(1e-3, 16, 4, 80.0, 3000, 5_000_000) == 24
    for s in (0, 1, 17, 240, 400):
        assert port_stats.estimate_minimum_hits_relaxed(s, 16, 80.0) == (
            original.estimate_minimum_hits_relaxed(s, 16, 80.0)
        )
    from pyfastani_tpu.utils.jaxconfig import _default_cache_dir

    assert port_stats._default_cache_dir() == _default_cache_dir()


def test_codec_and_parameters_equal_the_original():
    from pyfastani_tpu.models._params import Parameters
    from pyfastani_tpu.ops import codec as original

    rng = np.random.default_rng(24)
    raw = rng.integers(0, 256, size=4000, dtype=np.uint8)
    inputs = [
        "acgtNNxyz", "ACgté中\U0001f600a", raw.tobytes(), bytearray(raw.tobytes()),
        memoryview(raw.tobytes()), raw, raw.view(np.int8), raw[::2],
    ]
    for x in inputs:
        np.testing.assert_array_equal(port_codec.to_bytes(x), original.to_bytes(x))
    np.testing.assert_array_equal(port_codec.complement_table(), original.complement_table())
    np.testing.assert_array_equal(port_codec.upper_inplace(raw), original.upper_inplace(raw))
    np.testing.assert_array_equal(
        port_codec.reverse_complement(raw), original.reverse_complement(raw)
    )
    for kw in ({}, dict(k=12, fragment_length=1000), dict(protein=True, percentage_identity=91.5)):
        assert PortParameters.from_user(**kw).to_state() == Parameters.from_user(**kw).to_state()
    with pytest.raises(BufferError):
        PortParameters.from_user(k=pyfastani_tpu_torch.MAX_KMER_SIZE + 1)


def test_fasta_reader_equals_the_original(tmp_path):
    from pyfastani_tpu._fasta import Parser as Original

    from pyfastani_tpu_torch._fasta import Parser

    path = tmp_path / "x.fa"
    path.write_text(">a desc\nacgt\nACGTNn\n>b\n" + "A" * 5000 + "\n\n>c\n\n")
    got = [(r.id, r.seq) for r in Parser(str(path))]
    assert got == [(r.id, r.seq) for r in Original(str(path))]
    assert got[0] == ("a desc", b"ACGTACGTNN") and len(got[1][1]) == 5000
    bad = tmp_path / "bad.fa"
    bad.write_text("ACGT\n>a\nACGT\n")
    assert list(Parser(str(bad))) == []
