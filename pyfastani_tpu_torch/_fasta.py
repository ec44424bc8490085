"""Minimal FASTA reader (parity with pyfastani's ``src/pyfastani/_fasta.pyx``).

Reads uncompressed FASTA through the port's C extension
(``_native.parse_fasta``): sequence lines are uppercased (C locale) and
concatenated; records are ``Record(id: str, seq: bytes)``; a file that does
not start with a header holds no records.  The C reader of the JAX
package's ``pyfastani_tpu/_fasta.py`` (its ``_NativeParser``), copied so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from . import _native

__all__ = ["Record", "Parser"]


class Record:
    """A FASTA record with an identifier and a sequence."""

    __slots__ = ("id", "seq")

    def __init__(self, id: str, seq: bytes):
        self.id = id
        self.seq = seq


class Parser:
    """An iterator over the records of an (uncompressed) FASTA file."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            first = f.read(1)
        # no leading header, no records (the line reader stops at the
        # first non-header line)
        self._records = iter(_native.parse_fasta(path) if first == b">" else ())

    def __iter__(self):
        return self

    def __next__(self):
        record_id, seq = next(self._records)
        return Record(record_id, seq)
