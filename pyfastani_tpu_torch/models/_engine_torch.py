"""Device ingest of the port: the chunked long-sequence winnow.

Port of ``pyfastani_tpu/models/_engine_jax.py``.  `Sketch` ingestion
winnows on the host (the C winnow of the port's ``_native``), as in
the JAX package; this entry point serves pipelines whose sequences
already live on the device, and equals the host winnow bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .._common import hashes_to_numpy, resolve_device
from ..ops.fragments import winnow_long_sequence

__all__ = ["winnow_sequence_device"]


def winnow_sequence_device(data: np.ndarray, params, device=None) -> tuple:
    """Device equivalent of ``_engine_np.winnow_sequence`` on ``device``
    (``cuda`` by default): ``(hashes u32, wpos i32)`` numpy arrays of one
    uppercased uint8 sequence."""
    k, w = params.kmer_size, params.window_size
    n = int(data.shape[0])
    if n - k + 1 < 1 or n - k + 1 - w + 1 < 1:
        return (np.zeros(0, np.uint32), np.zeros(0, np.int32))
    seq = torch.from_numpy(np.require(data, np.uint8, ["C", "W"])).to(resolve_device(device))
    hashes, wpos = winnow_long_sequence(seq, k, w, params.alphabet_size != 4)
    return hashes_to_numpy(hashes), wpos.cpu().numpy()
