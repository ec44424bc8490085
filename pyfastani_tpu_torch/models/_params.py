"""Engine parameters (``skch::Parameters`` equivalent).

A frozen dataclass mirroring the POD of
``pyfastani: include/fastani/map/map_parameters.pxd:7-24`` plus the
constructor validation of ``Sketch.__init__``
(``pyfastani: src/pyfastani/_fastani.pyx:484-560``), including the
exception types raised by Cython's C-integer conversions (TypeError for
non-integers, OverflowError for out-of-range).

A copy of ``pyfastani_tpu/models/_params.py``, so that the port imports
nothing of the JAX package.  Values compare equal field by field with the
JAX package's, and both pickle to the same state.
"""

from __future__ import annotations

import dataclasses
import operator
import warnings

from .. import stats

__all__ = ["Parameters", "MAX_KMER_SIZE"]

MAX_KMER_SIZE = 2048  # _MAX_KMER_SIZE, ``_fastani.pyx:103``


def _as_uint(value, bits: int):
    """Convert like a Cython ``unsigned`` parameter: TypeError for
    non-integers, OverflowError outside [0, 2**bits)."""
    if isinstance(value, float):
        raise TypeError(f"an integer is required, got {value!r}")
    ivalue = operator.index(value)
    if ivalue < 0 or ivalue >= (1 << bits):
        raise OverflowError(f"value out of range for unsigned {bits}-bit int: {value!r}")
    return ivalue


def _as_float(value, name: str) -> float:
    if not isinstance(value, (int, float)):
        raise TypeError(f"{name} must be a number, got {type(value).__name__!r}")
    return float(value)


@dataclasses.dataclass(frozen=True)
class Parameters:
    kmer_size: int = 16
    window_size: int = 24
    min_read_length: int = 3000
    min_fraction: float = 0.2
    threads: int = 1
    alphabet_size: int = 4
    reference_size: int = 5_000_000
    percentage_identity: float = 80.0
    p_value: float = 1e-3

    @property
    def protein(self) -> bool:
        return self.alphabet_size == 20

    @classmethod
    def from_user(
        cls,
        *,
        k=16,
        fragment_length=3000,
        minimum_fraction=0.2,
        p_value=1e-3,
        percentage_identity=80.0,
        reference_size=5_000_000,
        protein=False,
    ) -> "Parameters":
        """Validate constructor arguments exactly like ``Sketch.__init__``."""
        # Cython converts arguments before the function body runs, so the
        # conversion errors (TypeError / OverflowError) come first.
        k = _as_uint(k, 32)
        fragment_length = _as_uint(fragment_length, 32)
        minimum_fraction = _as_float(minimum_fraction, "minimum_fraction")
        p_value = _as_float(p_value, "p_value")
        percentage_identity = _as_float(percentage_identity, "percentage_identity")
        reference_size = _as_uint(reference_size, 64)
        protein = bool(protein)

        if minimum_fraction > 1 or minimum_fraction < 0:
            raise ValueError(
                f"minimum_fraction must be between 0 and 1, got {minimum_fraction!r}"
            )
        if fragment_length <= 0:
            raise ValueError(
                f"fragment_length must be strictly positive, got {fragment_length!r}"
            )
        if p_value <= 0:
            raise ValueError(f"p_value must be positive, got {p_value!r}")
        if percentage_identity > 100 or percentage_identity < 0:
            raise ValueError(
                f"percentage_identity must be between 0 and 100, got {percentage_identity!r}"
            )
        if k <= 0:
            raise ValueError(f"k must be strictly positive, got {k!r}")
        elif k > MAX_KMER_SIZE:
            raise BufferError(f"k must be smaller than {MAX_KMER_SIZE}, got {k}")
        elif k > 16:
            warnings.warn(
                f"Using k-mer size greater than 16 ({k!r}), accuracy will be degraded.",
                UserWarning,
                stacklevel=3,
            )

        if protein:
            alphabet_size = 20
            window_size = 1
        else:
            alphabet_size = 4
            window_size = stats.recommended_window_size(
                p_value,
                k,
                alphabet_size,
                float(stats._f32(percentage_identity)),
                fragment_length,
                reference_size,
            )

        return cls(
            kmer_size=k,
            window_size=window_size,
            min_read_length=fragment_length,
            min_fraction=float(stats._f32(minimum_fraction)),
            alphabet_size=alphabet_size,
            reference_size=reference_size,
            percentage_identity=float(stats._f32(percentage_identity)),
            p_value=p_value,
        )

    # --- pickling (key names match the reference _Parameterized state) ------

    def to_state(self) -> dict:
        return {
            "kmerSize": self.kmer_size,
            "windowSize": self.window_size,
            "minReadLength": self.min_read_length,
            "minFraction": self.min_fraction,
            "threads": self.threads,
            "alphabetSize": self.alphabet_size,
            "referenceSize": self.reference_size,
            "percentageIdentity": self.percentage_identity,
            "p_value": self.p_value,
        }

    @classmethod
    def from_state(cls, state: dict) -> "Parameters":
        return cls(
            kmer_size=state["kmerSize"],
            window_size=state["windowSize"],
            min_read_length=state["minReadLength"],
            min_fraction=state["minFraction"],
            threads=state["threads"],
            alphabet_size=state["alphabetSize"],
            reference_size=state["referenceSize"],
            percentage_identity=state["percentageIdentity"],
            p_value=state["p_value"],
        )
