"""`Sketch` and `Mapper`: the user-facing engine classes of the port.

The JAX package's ``pyfastani_tpu/models/_sketch.py``, merged into the port
so that it imports nothing of that package; behavioral parity targets in
the reference are pyfastani's ``_fastani.pyx:449-806`` (``Sketch``) and
``:809-1200`` (``Mapper``).

* minimizers live in three flat arrays (SoA); the posting index is a CSR
  over hash-sorted minimizers (`_engine_np.build_index`);
* reference ingestion winnows on the host, in one C pass of the port's
  extension (`_native.winnow`);
* `Mapper` queries run on a cached one-device `session.Session`, rebuilt
  when the index is rebuilt or edited (``PostingIndex.version``); the
  ``threads`` argument is accepted and validated for compatibility.  An
  empty index, and `Mapper._query_host`, take the host NumPy engine.

Both classes take a ``device``: ``cuda`` by default, which raises without
a GPU; pass ``device="cpu"`` for the plain torch path on the CPU.  The
device travels through pickling.
"""

from __future__ import annotations

import threading
import warnings

import numpy as np

from .. import _native
from ..ops import codec
from . import _engine_np as np_engine
from ._params import MAX_KMER_SIZE, Parameters
from ._types import Hit, MinimizerIndex, Minimizers

__all__ = ["Sketch", "Mapper", "MAX_KMER_SIZE"]


def _device_state(device):
    return None if device is None else str(device)


class _Parameterized:
    """Base class holding a `Parameters` value (``_fastani.pyx:364-446``)."""

    _param: Parameters

    def __getstate__(self):
        return self._param.to_state()

    def __setstate__(self, state):
        self._param = Parameters.from_state(state)

    @property
    def k(self):
        """`int`: The k-mer size used for sketching."""
        return self._param.kmer_size

    @property
    def window_size(self):
        """`int`: The window size used for sketching."""
        return self._param.window_size

    @property
    def fragment_length(self):
        """`int`: The minimum read length to use for mapping."""
        return self._param.min_read_length

    @property
    def minimum_fraction(self):
        """`float`: The minimum genome fraction required to trust ANI values."""
        return self._param.min_fraction

    @property
    def percentage_identity(self):
        """`float`: The identity threshold for similarity when estimating hits."""
        return self._param.percentage_identity

    @property
    def p_value(self):
        """`float`: The p-value threshold for similarity when estimating hits."""
        return self._param.p_value

    @property
    def protein(self):
        """`bool`: Whether or not the object expects peptides or nucleotides."""
        return self._param.protein


class _MinimizerStore:
    """Growable SoA store of (hash, seq_id, wpos) minimizer records."""

    def __init__(self):
        self.clear()

    def append(self, hashes: np.ndarray, seq_id: int, wpos: np.ndarray):
        if hashes.shape[0] == 0:
            return
        self.chunks_hash.append(np.asarray(hashes, dtype=np.uint32))
        self.chunks_seqid.append(np.full(hashes.shape[0], seq_id, dtype=np.int32))
        self.chunks_wpos.append(np.asarray(wpos, dtype=np.int32))
        self._cached = None

    def arrays(self):
        if self._cached is None:
            if not self.chunks_hash:
                self._cached = (
                    np.zeros(0, np.uint32),
                    np.zeros(0, np.int32),
                    np.zeros(0, np.int32),
                )
            else:
                self._cached = (
                    np.concatenate(self.chunks_hash),
                    np.concatenate(self.chunks_seqid),
                    np.concatenate(self.chunks_wpos),
                )
        return self._cached

    def set_arrays(self, hashes, seq_ids, wpos):
        self.chunks_hash = [np.asarray(hashes, dtype=np.uint32)]
        self.chunks_seqid = [np.asarray(seq_ids, dtype=np.int32)]
        self.chunks_wpos = [np.asarray(wpos, dtype=np.int32)]
        self._cached = None

    def clear(self):
        self.chunks_hash = []
        self.chunks_seqid = []
        self.chunks_wpos = []
        self._cached = None


class Sketch(_Parameterized):
    """An index computing minimizers over the reference genomes.

    Use this class to add reference genomes with the `add_genome` or
    `add_draft` methods, then call the `index` method to obtain a `Mapper`
    that can be used to map query genomes.

    Attributes:
        minimizers (`~pyfastani_tpu_torch.Minimizers`): A view over the
            minimizers currently recorded in the sketch.
    """

    def __init__(
        self,
        *,
        k=16,
        fragment_length=3000,
        minimum_fraction=0.2,
        p_value=1e-03,
        percentage_identity=80.0,
        reference_size=5_000_000,
        protein=False,
        device=None,
    ):
        """Create a new FastANI sequence sketch.

        Keyword Arguments:
            k (`int`): The size of the k-mers. FastANI authors recommend
                a size of at most 16, but any positive number up to
                `MAX_KMER_SIZE` will work.
            fragment_length (`int`): The lengths the blocks should have
                when splitting the query. Queries smaller than this number
                won't be processed.
            minimum_fraction (`float`): The minimum fraction of genome that
                must be shared for a hit to be reported. If reference and
                query genome size differ, the smaller one among the two is
                considered.
            p_value (`float`): The p-value cutoff. *Used to determine the
                recommended window size.*
            percentage_identity (`float`): An identity percentage above which
                ANI values between two sequences can be trusted. *Used to
                determine the recommended window size.*
            reference_size (`int`): An estimate of the reference length.
                *Used to determine the recommended window size.*
            protein (`bool`): Whether or not protein sequences are expected.
                If `True`, the alphabet size is changed from 4 to 20,
                minimizers are not computed on the "reverse" strand, and the
                window size is set to 1.
            device: where the `Mapper` queries run (``None`` = ``cuda``).
                An extension over the reference API.
        """
        self._param = Parameters.from_user(
            k=k,
            fragment_length=fragment_length,
            minimum_fraction=minimum_fraction,
            p_value=p_value,
            percentage_identity=percentage_identity,
            reference_size=reference_size,
            protein=protein,
        )
        self._device = device
        self._lock = threading.Lock()
        self._store = _MinimizerStore()
        self.minimizers = Minimizers(self)
        self.clear()

    # --- internal hooks for the Minimizers view -----------------------------

    def _minimizer_arrays(self):
        return self._store.arrays()

    def _set_minimizer_arrays(self, hashes, seq_ids, wpos):
        self._store.set_arrays(hashes, seq_ids, wpos)

    # --- pickling ------------------------------------------------------------

    def __getstate__(self):
        return {
            "parameters": _Parameterized.__getstate__(self),
            "counter": self._counter,
            "lengths": [int(x) for x in self._lengths],
            "names": list(self._names),
            "sketch": {
                "sequencesByFileInfo": [int(x) for x in self._sequences_by_file],
                "minimizers": self.minimizers.__getstate__(),
            },
            "device": _device_state(self._device),
        }

    def __setstate__(self, state):
        _Parameterized.__setstate__(self, state["parameters"])
        if not hasattr(self, "_lock"):
            self._lock = threading.Lock()
            self._store = _MinimizerStore()
            self.minimizers = Minimizers(self)
        self._device = state.get("device")
        self._counter = state["counter"]
        self._lengths = list(state["lengths"])
        self._names = list(state["names"])
        self._sequences_by_file = list(state["sketch"]["sequencesByFileInfo"])
        self.minimizers.__setstate__(state["sketch"]["minimizers"])

    # --- properties ----------------------------------------------------------

    @property
    def occurences_threshold(self):
        """`int`: The occurrence threshold above which minimizers are ignored.

        Like the reference, this is INT_MAX until `index` computes the
        frequency histogram (the threshold lives on the `Mapper` afterwards).
        """
        return np_engine.INT_MAX

    @property
    def names(self):
        """`list` of `str`: The names of the sequences currently sketched."""
        return self._names[:]

    # --- methods -------------------------------------------------------------

    def _winnow(self, data: np.ndarray):
        # one C pass on the host (murmur3 + monotone deque, the reference's
        # semantics): the index build consumes the minimizers on the host;
        # `_engine_torch.winnow_sequence_device` serves sequences that
        # already live on the device
        param = self._param
        h, p = _native.winnow(
            data.tobytes(), param.kmer_size, param.window_size, param.alphabet_size != 4
        )
        return np.frombuffer(h, dtype=np.uint32), np.frombuffer(p, dtype=np.int32)

    def _add_draft(self, name, contigs):
        param = self._param
        total = 0
        for contig in contigs:
            data = codec.to_bytes(contig)
            slen = int(data.shape[0])
            if slen >= param.window_size and slen >= param.kmer_size:
                hashes, wpos = self._winnow(data)
                self._store.append(hashes, self._counter, wpos)
            else:
                warnings.warn(
                    (
                        "Sketch received a short contig relative to parameters, "
                        "minimizers will not be added."
                    ),
                    UserWarning,
                    stacklevel=3,
                )
            total += (slen // param.min_read_length) * param.min_read_length
            self._counter += 1
        self._names.append(name)
        self._lengths.append(total)
        self._sequences_by_file.append(self._counter)

    def add_draft(self, name, contigs):
        """Add a reference draft genome to the sketcher.

        Using this method is fine even when the genome has a single contig,
        although `Sketch.add_genome` is easier to use in that case.

        Arguments:
            name (`object`): The name of the genome to add. When a reference
                matches this query genome, ``name`` will be exposed as the
                `Hit.name` attribute of the corresponding hit.
            contigs (iterable of `str` or `bytes`): The contigs of the genome.

        Returns:
            `Sketch`: the object itself, for method chaining.

        Hint:
            Contigs smaller than the window size and the k-mer size will
            be skipped.
        """
        with self._lock:
            self._add_draft(name, contigs)
        return self

    def add_genome(self, name, sequence):
        """Add a reference genome to the sketcher.

        This method is a shortcut for `Sketch.add_draft` when a genome is
        complete (i.e. only contains a single contig).
        """
        with self._lock:
            self._add_draft(name, (sequence,))
        return self

    def clear(self):
        """Reset the `Sketch`, removing any reference genome it may contain.

        Returns:
            `Sketch`: the object itself, for method chaining.
        """
        self._names = []
        self._lengths = []
        self._counter = 0
        self._sequences_by_file = []
        self._store.clear()
        return self

    def index(self):
        """Index the reference genomes for fast lookups using the minimizers.

        Once all the reference sequences have been added to the `Sketch`,
        use this method to create an efficient mapper, dropping the most
        common minimizers among the reference sequences.

        Returns:
            `~pyfastani_tpu_torch.Mapper`: An indexed mapper that can be
            used for fast querying, on this sketch's device.

        Note:
            Calling this method will effectively transfer ownership of
            the data to the `Mapper`, and reset the internals of this
            `Sketch`. It will be essentially cleared, but should remain
            usable.
        """
        mapper = Mapper.__new__(Mapper)
        mapper._param = self._param
        mapper._device = self._device
        mapper._names = self._names.copy()
        mapper._lengths = list(self._lengths)
        mapper._sequences_by_file = list(self._sequences_by_file)
        hashes, seq_ids, wpos = self._store.arrays()
        mapper._index = np_engine.build_index(hashes, seq_ids, wpos)
        mapper._session = None
        mapper.minimizers = Minimizers(mapper)
        self.clear()
        return mapper


class Mapper(_Parameterized):
    """A genome mapper using Murmur3 hashes and k-mers to compute ANI.

    Attributes:
        minimizers (`~pyfastani_tpu_torch.Minimizers`): A view over the
            minimizers recorded in the mapper.
    """

    def __init__(self, *args, **kwargs):
        raise TypeError("Mapper cannot be instantiated, use `Sketch.index` instead.")

    # --- internal hooks ------------------------------------------------------

    def _minimizer_arrays(self):
        idx = self._index
        return idx.mini_hash, idx.mini_seqid, idx.mini_wpos

    def _set_minimizer_arrays(self, hashes, seq_ids, wpos):
        self._index = np_engine.build_index(
            np.asarray(hashes, np.uint32),
            np.asarray(seq_ids, np.int32),
            np.asarray(wpos, np.int32),
        )
        self._session = None

    # --- pickling ------------------------------------------------------------

    def __getstate__(self):
        return {
            "parameters": _Parameterized.__getstate__(self),
            "lengths": [int(x) for x in self._lengths],
            "names": list(self._names),
            "sketch": {
                "sequencesByFileInfo": [int(x) for x in self._sequences_by_file],
                "minimizers": self.minimizers.__getstate__(),
            },
            "device": _device_state(self._device),
        }

    def __setstate__(self, state):
        _Parameterized.__setstate__(self, state["parameters"])
        self._device = state.get("device")
        self._names = list(state["names"])
        self._lengths = list(state["lengths"])
        self._sequences_by_file = list(state["sketch"]["sequencesByFileInfo"])
        self._session = None
        self.minimizers = Minimizers(self)
        # rebuilds the posting index + frequency histogram, like the
        # reference __setstate__ (``_fastani.pyx:861-865``)
        self.minimizers.__setstate__(state["sketch"]["minimizers"])

    # --- properties ----------------------------------------------------------

    @property
    def occurences_threshold(self):
        """`int`: The occurrence threshold above which minimizers are ignored."""
        return self._index.freq_threshold

    @property
    def names(self):
        """`list` of `str`: The names of the sequences indexed."""
        return self._names[:]

    @property
    def lookup_index(self):
        """`MinimizerIndex`: The index of initial minimizer positions.

        This table is used to retrieve at which positions the minimizers
        appear in the reference genomes.  It is a *live* view: assigning
        or deleting entries patches the posting index the mapper queries,
        like the reference view over ``minimizerPosLookupIndex``
        (``_fastani.pyx:1431-1539``).
        """
        return MinimizerIndex._live(self)

    # --- methods -------------------------------------------------------------

    def _device_session(self):
        """The cached one-genome `Session`, rebuilt after an index rebuild
        or a live ``lookup_index`` edit."""
        idx = self._index
        cached = self._session
        if cached is not None and cached[1] is idx and cached[2] == idx.version:
            return cached[0]
        from ..session import Session

        session = Session(self, device=self._device, q_capacity=1)
        self._session = (session, idx, idx.version)
        return session

    def _query_draft(self, contigs, threads=0):
        if threads < 0:
            raise ValueError(f"`threads` must be positive or null, got {threads!r}")
        if self._names and self._index.n_minimizers:
            return self._device_session().query(contigs)
        # an empty index: the host path returns [] with its usual warnings
        return self._query_host(contigs)

    def _query_host(self, contigs):
        """Hits of one genome from the host NumPy engine (`_engine_np`),
        which runs L1 and L2 without the device: the oracle the device
        path is held against."""
        param = self._param
        min_len = min(param.window_size, param.kmer_size, param.min_read_length)
        contig_arrays = []
        for contig in contigs:
            data = codec.to_bytes(contig)
            if data.shape[0] < min_len:
                warnings.warn(
                    (
                        "Mapper received a short sequence relative to parameters, "
                        "mapping will not be computed."
                    ),
                    UserWarning,
                    stacklevel=4,
                )
                continue
            contig_arrays.append(data)

        mappings, total_fragments, total_length = np_engine.query_contigs_np(
            contig_arrays, self._index, param
        )
        results = np_engine.compute_cgi(
            mappings,
            np.asarray(self._sequences_by_file, dtype=np.int64),
            total_fragments,
            param,
        )
        hits = []
        for genome_id, count_seq, identity in results:
            min_length = min(total_length, self._lengths[genome_id])
            shared_length = count_seq * param.min_read_length
            # C++ compares uint64 against uint64 * float in float32
            if np.float32(shared_length) >= np.float32(min_length) * np.float32(
                param.min_fraction
            ):
                hits.append(
                    Hit(
                        name=self._names[genome_id],
                        identity=identity,
                        matches=count_seq,
                        fragments=total_fragments,
                    )
                )
        hits.sort(key=lambda hit: hit.identity, reverse=True)
        return hits

    def query_draft(self, contigs, threads=0):
        """Query the mapper for a draft genome.

        Arguments:
            contigs (iterable of `str` or `bytes`): The genome to query the
                mapper with.
            threads (`int`): Accepted for API compatibility with the
                reference thread pool; fragment mapping is a batched device
                pass here. Pass *0* (the default) to auto-detect.

        Returns:
            `list` of `~pyfastani_tpu_torch.Hit`: The hits found for the query.

        Hint:
            Sequence must be larger than the window size, the k-mer size,
            and the fragment length to be mapped, otherwise an empty list
            of hits will be returned.
        """
        return self._query_draft(contigs, threads=threads)

    def query_genome(self, sequence, threads=0):
        """Query the mapper for a complete genome.

        Arguments:
            sequence (`str` or `bytes`): The closed genome to query the
                mapper with.
            threads (`int`): Accepted for API compatibility; see
                `query_draft`.

        Returns:
            `list` of `~pyfastani_tpu_torch.Hit`: The hits found for the query.
        """
        return self._query_draft((sequence,), threads=threads)
