"""Batched fragment winnowing and sketch construction.

Port of ``pyfastani_tpu/ops/fragments.py::_winnow_fragments_impl``: every
query fragment of a dispatch is winnowed in one batch (the fragment axis
is the leading dimension, where the JAX package ``vmap``s), then each
fragment's recorded minimizer hashes are sorted and compacted to its
sketch -- the sorted unique hashes, ``UMAX``-padded.  All outputs are
integers, so the port and the JAX package agree bitwise.
"""

from __future__ import annotations

import torch

from .._common import UMAX
from .winnow import nucl_canonical, prot_hashes, winnow

__all__ = ["winnow_fragments"]


def winnow_fragments(
    frags: torch.Tensor, k: int, w: int, length: int, protein: bool, kc: int
):
    """Sketch every fragment of a batch.

    Args:
        frags: ``(F, length + pad)`` uint8 fragments (``pad >= 4``).
        k, w: k-mer and window size.
        length: fragment length in bases.
        protein: forward-only hashing (no canonical strand).
        kc: width of the returned sketch axis.

    Returns:
        ``(rec_ovf, q_sorted, s)``: a 0-d bool flagging a fragment with
        more than ``kc`` sketch hashes, the ``(F, min(kc, P))`` int64
        sorted sketches (``UMAX`` pad) and the ``(F,)`` int32 sketch sizes.
    """
    n_pos = length - k + 1
    hashes = prot_hashes if protein else nucl_canonical
    canon, valid = hashes(frags, length, k, n_pos)
    record, win_hash = winnow(canon, valid, w)

    masked = torch.where(record, win_hash, UMAX)
    s_sorted = torch.sort(masked, dim=1).values
    # first occurrence of each hash; the UMAX padding collapses into the tail
    first = torch.ones_like(record)
    first[:, 1:] = s_sorted[:, 1:] != s_sorted[:, :-1]
    first &= s_sorted != UMAX
    q_sorted = torch.sort(torch.where(first, s_sorted, UMAX), dim=1).values
    s = first.sum(dim=1).to(torch.int32)
    rec_ovf = (s > kc).any()
    return rec_ovf, q_sorted[:, : min(kc, q_sorted.shape[1])], s
