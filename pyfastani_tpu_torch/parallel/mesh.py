"""The ("data", "shard") device mesh of the port.

Port of ``pyfastani_tpu/parallel/mesh.py``.  A `Mesh` is an
``(n_data, n_shard)`` grid of ``torch.device``: ``data`` splits each
fragment block, ``shard`` partitions the reference index by genome.  A
device may fill several cells; its cells then run one after another, which
is how a CPU run or a single card holds a multi-cell mesh.

When ``torch.distributed`` is initialized the mesh spans processes: each
rank contributes its local devices, and the global list is ordered by
rank, as ``jax.devices()`` orders the devices of several processes.  Every
cell records the rank that runs it.
"""

from __future__ import annotations

import dataclasses

import torch

from .._common import resolve_device

__all__ = ["Mesh", "make_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ``(n_data, n_shard)`` grid of devices and of the ranks that own
    them; ``distributed`` is true when the cells span processes."""

    devices: tuple  # n_data tuples of n_shard torch.device
    ranks: tuple  # the same grid of owning process ranks
    distributed: bool = False

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "shard": len(self.devices[0])}

    @property
    def rank(self) -> int:
        """This process's rank in the mesh's process group (0 when local)."""
        return torch.distributed.get_rank() if self.distributed else 0

    def local_cells(self):
        """``[(d, s, device)]`` of the cells this process runs, row-major."""
        return [
            (d, s, dev)
            for d, row in enumerate(self.devices)
            for s, dev in enumerate(row)
            if self.ranks[d][s] == self.rank
        ]


def _visible_devices() -> list:
    if not torch.cuda.is_available():
        return [resolve_device(None)]  # raises: the port defaults to cuda
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: int = 1, n_shard: int | None = None, devices=None) -> Mesh:
    """Build a ("data", "shard") mesh.

    ``devices`` lists this process's devices and may name one device
    several times; by default every visible CUDA device (raising without
    a GPU).  Under ``torch.distributed`` every rank passes its own list,
    and the mesh is laid over the rank-ordered union.  ``n_shard``
    defaults to all devices over ``n_data``; extra devices are left out.
    """
    local = [resolve_device(d) for d in devices] if devices is not None else _visible_devices()
    dist = torch.distributed
    distributed = dist.is_available() and dist.is_initialized()
    if distributed:
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, [str(d) for d in local])
        flat = [(r, torch.device(d)) for r, devs in enumerate(gathered) for d in devs]
    else:
        flat = [(0, d) for d in local]
    if n_shard is None:
        n_shard = len(flat) // n_data
    if n_data < 1 or n_shard < 1 or n_data * n_shard > len(flat):
        raise ValueError(
            f"a ({n_data}, {n_shard}) mesh needs {n_data * n_shard} devices, "
            f"have {len(flat)}"
        )
    grid = [flat[d * n_shard : (d + 1) * n_shard] for d in range(n_data)]
    return Mesh(
        devices=tuple(tuple(dev for _, dev in row) for row in grid),
        ranks=tuple(tuple(r for r, _ in row) for row in grid),
        distributed=distributed,
    )
