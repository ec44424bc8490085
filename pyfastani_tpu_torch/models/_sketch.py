"""`Sketch` and `Mapper` of the port: the JAX package's classes, routed to
the torch `Session`.

Reference ingestion, the posting index and pickling are the JAX package's
host code, reused as they are.  The overrides keep JAX out of the process
and send queries to the device:

* `Sketch.__init__` and both ``__setstate__`` name their backend instead
  of auto-detecting it (auto-detection imports JAX);
* `Sketch.index` builds this module's `Mapper`;
* `Mapper._query_draft` runs on a cached one-genome `Session`, rebuilt
  when the index is rebuilt or edited (``PostingIndex.version``).

Both classes take a ``device``: ``cuda`` by default, which raises without
a GPU; pass ``device="cpu"`` for the plain torch path on the CPU.  The
device travels through pickling.
"""

from __future__ import annotations

import threading

from pyfastani_tpu.models import _engine_np as np_engine
from pyfastani_tpu.models import _sketch as base
from pyfastani_tpu.models._types import Minimizers

__all__ = ["Sketch", "Mapper"]

_BACKEND = "torch"


def _device_state(device):
    return None if device is None else str(device)


class Sketch(base.Sketch):
    """A reference sketch whose `Mapper` queries through the torch port.

    Takes the keyword arguments of ``pyfastani_tpu.Sketch`` except
    ``backend``, plus ``device`` (``None`` = ``cuda``).
    """

    def __init__(self, *, device=None, **kwargs):
        if "backend" in kwargs:
            raise TypeError("the port has one backend; pass device= instead")
        super().__init__(backend=_BACKEND, **kwargs)
        self._device = device

    def __getstate__(self):
        state = super().__getstate__()
        state["device"] = _device_state(self._device)
        return state

    def __setstate__(self, state):
        if not hasattr(self, "_lock"):
            self._backend = _BACKEND
            self._lock = threading.Lock()
            self._store = base._MinimizerStore()
            self.minimizers = Minimizers(self)
        self._device = state.get("device")
        super().__setstate__(state)

    def index(self):
        """Index the reference genomes and return this port's `Mapper`
        (see ``pyfastani_tpu.Sketch.index``); the sketch is cleared."""
        mapper = Mapper.__new__(Mapper)
        mapper._param = self._param
        mapper._backend = _BACKEND
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


class Mapper(base.Mapper):
    """A genome mapper whose queries run on the torch `Session`."""

    def __getstate__(self):
        state = super().__getstate__()
        state["device"] = _device_state(self._device)
        return state

    def __setstate__(self, state):
        base._Parameterized.__setstate__(self, state["parameters"])
        self._backend = _BACKEND
        self._device = state.get("device")
        self._names = list(state["names"])
        self._lengths = list(state["lengths"])
        self._sequences_by_file = list(state["sketch"]["sequencesByFileInfo"])
        self._session = None
        self.minimizers = Minimizers(self)
        # rebuilds the posting index and the frequency threshold
        self.minimizers.__setstate__(state["sketch"]["minimizers"])

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
        return super()._query_draft(contigs, threads=threads)

