"""Result and introspection types of the public API.

Behavioral parity targets:
  * ``Hit``            -- ``pyfastani: src/pyfastani/_fastani.pyx:1271-1324``
  * ``MinimizerInfo``  -- ``:1327-1379``
  * ``Position``       -- ``:1382-1428``
  * ``Minimizers``     -- ``:1203-1268`` (read-only sequence view)
  * ``MinimizerIndex`` -- ``:1431-1539`` (mutable mapping view)

Unlike the reference (views over C++ vectors/unordered_maps), the backing
store here is three flat NumPy integer arrays (hash, seqId, wpos) in
structure-of-arrays form -- the layout the device index is built from and
the only thing that needs serializing (the posting index is always rebuilt,
matching ``_fastani.pyx:861-865``).

A copy of ``pyfastani_tpu/models/_types.py``, so that the port imports
nothing of the JAX package.  These are the port's own classes: a `Hit` of
the port never equals one of the JAX package (compare fields), and a
pickled port object names the port's classes.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Hit", "MinimizerInfo", "Position", "Minimizers", "MinimizerIndex"]


class Hit:
    """A single hit found when querying a `Mapper` with a genome.

    Attributes:
        name (`object`): The name of the genome that produced a hit, as
            given to `Sketch.add_genome` or `Sketch.add_draft`.
        matches (`int`): The number of fragments that matched the target
            genome.
        fragments (`int`): The total number of fragments used to compare
            the query and target genomes.
        identity (`float`): The average nucleotide identity between the
            two genomes, given as a percentage.
    """

    __slots__ = ("name", "matches", "fragments", "identity")

    def __init__(self, name, identity, matches, fragments):
        self.name = name
        # the reference stores identity as a C float; mirror the rounding
        self.identity = float(np.float32(identity))
        self.matches = int(matches)
        self.fragments = int(fragments)

    def __repr__(self):
        return "{}(name={!r}, identity={!r}, matches={!r}, fragments={!r})".format(
            type(self).__name__, self.name, self.identity, self.matches, self.fragments
        )

    def __eq__(self, other):
        if not isinstance(other, Hit):
            return NotImplemented
        return (
            self.name == other.name
            and self.matches == other.matches
            and self.fragments == other.fragments
            and self.identity == other.identity
        )

    def __reduce__(self):
        return (Hit, (self.name, self.identity, self.matches, self.fragments))


class MinimizerInfo:
    """The information about a single minimizer."""

    __slots__ = ("hash", "sequence_id", "window_position")

    def __init__(self, hash, sequence_id, window_position):
        self.hash = int(hash)
        self.sequence_id = int(sequence_id)
        self.window_position = int(window_position)

    def __repr__(self):
        return "{}(hash={!r}, sequence_id={!r}, window_position={!r})".format(
            type(self).__name__, self.hash, self.sequence_id, self.window_position
        )

    def __eq__(self, other):
        if not isinstance(other, MinimizerInfo):
            return NotImplemented
        return (
            self.hash == other.hash
            and self.sequence_id == other.sequence_id
            and self.window_position == other.window_position
        )

    def __reduce__(self):
        return (MinimizerInfo, (self.hash, self.sequence_id, self.window_position))


class Position:
    """A (sequence id, window position) location of a minimizer."""

    __slots__ = ("sequence_id", "window_position")

    def __init__(self, sequence_id, window_position):
        self.sequence_id = int(sequence_id)
        self.window_position = int(window_position)

    def __repr__(self):
        return "{}(sequence_id={!r}, window_position={!r})".format(
            type(self).__name__, self.sequence_id, self.window_position
        )

    def __eq__(self, other):
        if not isinstance(other, Position):
            return NotImplemented
        return (
            self.sequence_id == other.sequence_id
            and self.window_position == other.window_position
        )

    def __reduce__(self):
        return (Position, (self.sequence_id, self.window_position))


class Minimizers:
    """A read-only sequence view over the minimizers of a `Sketch`/`Mapper`.

    Backed by the owner's structure-of-arrays minimizer store; indexing
    materializes `MinimizerInfo` objects lazily like the reference view.
    """

    def __init__(self, owner=None):
        self._owner = owner
        # detached storage, only used when unpickling a standalone view
        self._state = None

    def _arrays(self):
        """Return (hashes, seq_ids, wpos) uint64/int64 numpy arrays."""
        if self._owner is not None:
            return self._owner._minimizer_arrays()
        if self._state is not None:
            return self._state
        z = np.zeros(0, dtype=np.int64)
        return z, z, z

    def __len__(self):
        return int(self._arrays()[0].shape[0])

    def __getitem__(self, index):
        hashes, ids, offsets = self._arrays()
        length = hashes.shape[0]
        idx = int(index)
        if idx < 0:
            idx += length
        if idx < 0 or idx >= length:
            raise IndexError(index)
        return MinimizerInfo(hashes[idx], ids[idx], offsets[idx])

    def __iter__(self):
        hashes, ids, offsets = self._arrays()
        for h, i, o in zip(hashes, ids, offsets):
            yield MinimizerInfo(h, i, o)

    def __getstate__(self):
        hashes, ids, offsets = self._arrays()
        return {
            "hashes": [int(x) for x in hashes],
            "ids": [int(x) for x in ids],
            "offsets": [int(x) for x in offsets],
            "length": int(hashes.shape[0]),
        }

    def __setstate__(self, state):
        hashes = np.asarray(state["hashes"], dtype=np.uint32)
        ids = np.asarray(state["ids"], dtype=np.int32)
        offsets = np.asarray(state["offsets"], dtype=np.int32)
        if self._owner is not None:
            self._owner._set_minimizer_arrays(hashes, ids, offsets)
        else:
            self._state = (hashes, ids, offsets)


class MinimizerIndex:
    """The index mapping minimizer hash values to their positions.

    A *live* MutableMapping view over the owner `Mapper`'s CSR posting
    index, mirroring the reference's view over the C++
    ``minimizerPosLookupIndex`` (``_fastani.pyx:1431-1539``): writes and
    deletes patch the arrays the mapper's L1 stage actually probes, so
    subsequent queries see the edit.  Like the reference, edits do NOT
    touch the position-ordered minimizer store (L2's ``searchIndex``) or
    the already-computed frequency threshold.

    Rows materialize lazily on `__getitem__`; `__len__` is O(1) and
    iteration is O(U).  A detached instance (no owner) falls back to a
    plain dict, which is what unpickling produces -- the reference's view
    also pickles by value (``:1518-1525``).
    """

    def __init__(self):
        self._map = {}
        self.owner = None

    @classmethod
    def _live(cls, owner):
        self = cls.__new__(cls)
        self._map = None
        self.owner = owner
        return self

    @classmethod
    def _from_dict(cls, mapping, owner):
        self = cls.__new__(cls)
        self._map = mapping
        self.owner = owner
        return self

    # --- CSR helpers (live mode) ---------------------------------------------

    def _index(self):
        return self.owner._index

    def _find(self, item):
        """Return the CSR row of hash ``item`` or None."""
        idx = self._index()
        try:
            h = int(item)
        except (TypeError, ValueError):
            return None
        if h < 0 or h > 0xFFFFFFFF:
            return None
        u = int(np.searchsorted(idx.uniq_hash, np.uint32(h)))
        if u < idx.n_unique and int(idx.uniq_hash[u]) == h:
            return u
        return None

    def __len__(self):
        if self._map is not None:
            return len(self._map)
        return self._index().n_unique

    def __iter__(self):
        if self._map is not None:
            return iter(self._map)
        return (int(h) for h in self._index().uniq_hash)

    def __contains__(self, item):
        if self._map is not None:
            return int(item) in self._map
        return self._find(item) is not None

    def __getitem__(self, item):
        if self._map is not None:
            try:
                return list(self._map[int(item)])
            except KeyError:
                raise KeyError(item) from None
        u = self._find(item)
        if u is None:
            raise KeyError(item)
        idx = self._index()
        start = int(idx.row_start[u])
        length = int(idx.row_len[u])
        return [
            Position(int(idx.post_seqid[start + i]), int(idx.post_wpos[start + i]))
            for i in range(length)
        ]

    def __setitem__(self, item, value):
        positions = [
            Position(p.sequence_id, p.window_position) for p in value
        ]
        if self._map is not None:
            self._map[int(item)] = positions
            return
        from . import _engine_np as np_engine

        np_engine.set_posting_row(
            self._index(),
            int(item),
            np.asarray([p.sequence_id for p in positions], dtype=np.int32),
            np.asarray([p.window_position for p in positions], dtype=np.int32),
        )
        self.owner._session = None

    def __delitem__(self, item):
        if self._map is not None:
            try:
                del self._map[int(item)]
            except KeyError:
                raise KeyError(item) from None
            return
        from . import _engine_np as np_engine

        if not np_engine.delete_posting_row(self._index(), int(item)):
            raise KeyError(item)
        self.owner._session = None

    def __reduce__(self):
        return (MinimizerIndex, (), None, None, self.items())

    def items(self):
        if self._map is not None:
            for key, positions in self._map.items():
                yield key, list(positions)
        else:
            for key in self:
                yield key, self[key]
