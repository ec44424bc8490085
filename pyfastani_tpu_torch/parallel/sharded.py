"""The sharded query path under the JAX package's names.

Counterpart of ``pyfastani_tpu/parallel/sharded.py``: the session lives in
`pyfastani_tpu_torch.session` (one implementation, of which
``session.Session`` is the one-device case) and the index in
`pyfastani_tpu_torch.index`; this module gathers them as ``ShardedSession``,
``ShardedIndex`` and ``build_sharded_index``, beside the one-shot
`sharded_query`.

    from pyfastani_tpu_torch.parallel.mesh import make_mesh
    from pyfastani_tpu_torch.parallel.sharded import ShardedSession

    session = ShardedSession(mapper, make_mesh(n_data=2))
    hits = session.query_many([[query]])
"""

from ..index import ShardedIndex, build_sharded_index
from ..session import ShardedSession
from .mesh import Mesh

__all__ = ["ShardedIndex", "ShardedSession", "build_sharded_index", "sharded_query"]


def sharded_query(mapper, contigs, mesh: Mesh, **budgets):
    """One-shot convenience wrapper around `ShardedSession`."""
    return ShardedSession(mapper, mesh, **budgets).query(contigs)
