"""PyTorch/CUDA port of pyfastani-tpu: whole-genome ANI on an NVIDIA GPU.

The same public API as ``pyfastani_tpu`` (the JAX package, which stays
the reference): reference genomes go into a `Sketch`, `Sketch.index`
returns a `Mapper`, and ``Mapper.query_genome`` / ``query_draft`` return
`Hit`\\ s.  Queries run through ``session.ShardedSession`` on a
("data", "shard") device mesh (``parallel.mesh.make_mesh``; the
`Mapper` uses its one-device case, ``session.Session``), whose L2 chunk
evaluator is a hand-written CUDA kernel (``csrc/l2_chunks.cu``).

    >>> import pyfastani_tpu_torch as pyfastani
    >>> sketch = pyfastani.Sketch()            # device="cuda" by default
    >>> sketch.add_genome("genome1", sequence)
    >>> mapper = sketch.index()
    >>> hits = mapper.query_genome(query_sequence)

The default device is ``cuda``; without a GPU that raises.  Pass
``device="cpu"`` to run the plain torch path on the CPU.  The package
imports ``torch`` and never ``jax``, and nothing of ``pyfastani_tpu``: it
keeps its own copies of the host code it shares with that package, and
builds its host C extension (``_native``) and its CUDA library
(``_build``) at first use.
"""

from ._version import __version__
from .models._params import MAX_KMER_SIZE
from .models._types import (
    Hit,
    MinimizerIndex,
    MinimizerInfo,
    Minimizers,
    Position,
)

from .models import Mapper, Sketch

__all__ = [
    "Sketch",
    "Mapper",
    "Hit",
    "Minimizers",
    "MinimizerInfo",
    "MinimizerIndex",
    "Position",
    "MAX_KMER_SIZE",
]
