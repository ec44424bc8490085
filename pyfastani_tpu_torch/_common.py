"""Conventions every module of the port shares: the device and hashes.

**Device.** The port runs on ``cuda`` unless the caller names another
device.  With the default and no usable GPU it raises instead of carrying
on on the CPU: a silent CPU run of a GPU program is a different program.

**Hashes.** Minimizer hashes are unsigned 32-bit values.  PyTorch's CPU
kernels do not implement ``<``, ``>>``, ``<<``, ``minimum`` or
``searchsorted`` for ``uint32``, so the plain torch code carries hashes
as **int64 values in [0, 2^32)**, with the pad ``UMAX = 0xFFFFFFFF``;
every operation on them that can leave that range is masked with
``MASK32``.  Index hash planes parked on the device are **int32 tensors
holding the uint32 bit pattern** (`bits_to_i32`): half the memory, and a
CUDA kernel reads them as ``uint32_t``.  `i32_to_hash` turns a gathered
slice back into int64 hashes.  Hashes become ``np.uint32`` only at the
test boundary (`hashes_to_numpy`).
"""

from __future__ import annotations

import numpy as np
import torch

UMAX = 0xFFFFFFFF
MASK32 = 0xFFFFFFFF
# window-position pad (contig-local coordinates), as in the JAX package
BIG = 2**30
# global-position pad: per-shard global coordinates exceed 2^30 once a
# shard holds > ~1 Gbp, so gpos pads sit near the int32 ceiling
GBIG = 2**31 - 2**20


def resolve_device(device=None) -> torch.device:
    """The device to run on: ``cuda`` by default, raising without a GPU.
    A CUDA device without an index gets the current one, so that one card
    has one name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pyfastani_tpu_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain torch path on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def bits_to_i32(arr: np.ndarray) -> np.ndarray:
    """A uint32 (or int32) array as int32 holding the same bit pattern."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.itemsize != 4:
        raise TypeError(f"expected a 4-byte integer array, got {arr.dtype}")
    return arr.view(np.int32)


def i32_to_hash(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 hashes in [0, 2^32)."""
    return t.to(torch.int64) & MASK32


def hash_to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 hashes in [0, 2^32) -> int32 tensors with the same bits."""
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)


def hashes_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 hashes -> ``np.uint32`` (the test boundary)."""
    return t.detach().cpu().numpy().astype(np.uint32)
