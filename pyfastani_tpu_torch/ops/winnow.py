"""Batched minimizer winnowing (``skch::CommonFunc::addMinimizers``).

Port of ``pyfastani_tpu/ops/winnow.py`` (`nucl_canonical`, `prot_hashes`,
`winnow`, `winnow_chunk`); `winnow` takes the fragment axis as an explicit
leading batch dimension, and `winnow_chunk` winnows one chunk of a long
sequence with the boundary state carried from the chunk before.
The observable semantics are the JAX package's, which it documents in
full: palindromic k-mers are skipped, the canonical hash is
``min(fwd, bwd)``, window minima break ties to the latest position, a
record is emitted when the chosen occurrence changes, and the reference's
window-0 suppression quirk is reproduced.  Hashes are int64 in
``[0, 2^32)`` (`pyfastani_tpu_torch._common`).
"""

from __future__ import annotations

import functools

import torch

from .._common import UMAX
from .codec import complement_table
from .murmur3 import kmer_hashes

__all__ = ["nucl_canonical", "prot_hashes", "record_rule", "winnow", "winnow_chunk"]


@functools.cache
def _complement_lut(device: torch.device) -> torch.Tensor:
    """The complement table on ``device``, copied there once: a copy per
    call would make every query pass wait for the device."""
    return torch.from_numpy(complement_table()).to(device)


def nucl_canonical(data: torch.Tensor, n: int, k: int, n_positions: int):
    """Canonical nucleotide k-mer hashes and validity at every position.

    Args:
        data: ``(B, L_pad)`` uint8 uppercased sequences, padded so that
            ``L_pad >= n_positions + k - 1 + 4``.
        n: real sequence length (the same for every row).
        k: k-mer size.
        n_positions: positions to emit.

    Returns:
        ``(canon, valid)``: ``(B, n_positions)`` int64 hashes and bool mask.

    The reverse-complement hash at position ``i`` is the forward hash of
    the complemented, reversed buffer at ``L_pad - k - i``, so both strands
    hash with the same rolling-word code and one flip.
    """
    L_pad = data.shape[-1]
    crev = _complement_lut(data.device)[data.to(torch.int64)].flip(-1)
    fwd = kmer_hashes(data, k, out_len=n_positions)
    rr = kmer_hashes(crev, k, out_len=L_pad - k + 1)
    bwd = rr.flip(-1)[..., :n_positions]
    idx = torch.arange(n_positions, device=data.device)
    valid = (idx <= n - k) & (fwd != bwd)
    return torch.minimum(fwd, bwd), valid


def prot_hashes(data: torch.Tensor, n: int, k: int, n_positions: int):
    """Forward-only hashes and validity (the protein path)."""
    fwd = kmer_hashes(data, k, out_len=n_positions)
    idx = torch.arange(n_positions, device=data.device)
    valid = (idx <= n - k).expand_as(fwd)
    return fwd, valid


def _shift_left(x: torch.Tensor, d: int, fill: int) -> torch.Tensor:
    if d == 0:
        return x
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., d:], pad], dim=-1)


def _pair_min(h_a, p_a, h_b, p_b):
    """(hash, pos) minimum: the smaller hash wins, a tie goes to the later
    position."""
    take_b = (h_b < h_a) | ((h_b == h_a) & (p_b > p_a))
    return torch.where(take_b, h_b, h_a), torch.where(take_b, p_b, p_a)


def _window_min(canon, valid, pos, w: int):
    """``(hash, pos)`` minimum of every ``w``-wide window along the last
    axis (``N - w + 1`` windows), ties to the later position."""
    g_h = torch.where(valid, canon, UMAX)
    # invalid entries carry pos 0 so a real UMAX-valued hash beats them
    g_p = torch.where(valid, pos, 0)
    # sliding minimum by log doubling: g covers windows of size `size`
    size = 1
    while size * 2 <= w:
        g_h, g_p = _pair_min(
            g_h, g_p, _shift_left(g_h, size, UMAX), _shift_left(g_p, size, 0)
        )
        size *= 2
    rem = w - size
    win_h, win_p = _pair_min(
        g_h, g_p, _shift_left(g_h, rem, UMAX), _shift_left(g_p, rem, 0)
    )
    P = canon.shape[-1] - w + 1
    return win_h[..., :P], win_p[..., :P]


def winnow(canon: torch.Tensor, valid: torch.Tensor, w: int):
    """Evaluate every window and flag which ones record a minimizer.

    Args:
        canon: ``(B, N)`` int64 hashes.
        valid: ``(B, N)`` bool mask.
        w: window size (>= 1).

    Returns:
        ``(record, win_hash)`` of shape ``(B, P)`` with ``P = N - w + 1``:
        ``record[b, p]`` means window ``p`` appends ``(win_hash[b, p], p)``.
    """
    B, N = canon.shape
    P = N - w + 1
    dev = canon.device
    if P <= 0:
        return (
            torch.zeros((B, 0), dtype=torch.bool, device=dev),
            torch.zeros((B, 0), dtype=torch.int64, device=dev),
        )

    win_h, win_p = _window_min(canon, valid, torch.arange(N, device=dev), w)
    return record_rule(win_h, win_p, valid, w), win_h


def record_rule(win_h: torch.Tensor, win_p: torch.Tensor, valid: torch.Tensor, w: int):
    """Which windows record, from each window's chosen ``(hash, pos)``
    (``(B, P)``) and the positions' validity (``(B, N)``): `winnow`'s
    rule, the window-0 quirk included."""
    B, N = valid.shape
    P = N - w + 1
    dev = valid.device
    # window p is evaluated iff its last k-mer (p + w - 1) is valid
    evaluated = valid[:, w - 1 : w - 1 + P]

    # the previous evaluated window's chosen position: pack (window index,
    # chosen position) into one int64 and take one exclusive cummax
    idx = torch.arange(P, device=dev)
    packed = torch.where(evaluated, idx * N + win_p, -1)
    prev_packed = torch.cat(
        [
            torch.full((B, 1), -1, dtype=torch.int64, device=dev),
            torch.cummax(packed, dim=1).values[:, :-1],
        ],
        dim=1,
    )
    first_eval = prev_packed < 0
    prev_pos = prev_packed % N
    is_new = evaluated & (first_eval | (win_p != prev_pos))

    # window-0 suppression quirk: if a sequence's first evaluated window is
    # p == 0, equal-hash occurrence changes are swallowed while every
    # evaluated window so far carried the same hash h0
    first_is_zero = evaluated[:, :1]
    same_h0 = (~evaluated) | (win_h == win_h[:, :1])
    prefix_ok = torch.cummin(same_h0.to(torch.int32), dim=1).values.bool()
    suppress = first_is_zero & (idx > 0) & prefix_ok
    return is_new & ~suppress


def winnow_chunk(canon, valid, w: int, carry, base: int, first_chunk: bool):
    """Winnow the windows ``[base, base + P)`` of one long sequence.

    Args:
        canon, valid: ``(P + w - 1,)`` hashes and validity of the k-mers
            at positions ``[base, base + P + w - 1)``.
        w: window size.
        carry: 0-d tensors ``(has_prev, prev_pos, phantom, h0)`` from the
            chunk before: whether an evaluated window came before, the
            position it chose (global), whether the window-0 suppression
            quirk is still active, and the hash it compares against.
        base: global position of the chunk's first window.
        first_chunk: the chunk holds window 0, where the quirk anchors.

    Returns:
        ``(record, win_hash, carry)``: ``(P,)`` flags and hashes of the
        chunk's windows (window ``base + p`` appends
        ``(win_hash[p], base + p)`` iff ``record[p]``) and the carry for
        the next chunk.  Nothing here waits for the device.
    """
    has_prev, prev_pos, phantom, h0 = carry
    dev = canon.device
    N = canon.shape[0]
    P = N - w + 1
    pos = base + torch.arange(N, device=dev)
    win_h, win_p = _window_min(canon, valid, pos, w)
    evaluated = valid[w - 1 : w - 1 + P]

    # the previous evaluated window: in the chunk, or carried across.  A
    # chunk is one long row, where torch's cummax/cummin scan serially, so
    # both scans are cumsums: the last evaluated window up to p is the
    # count(p)-th one, found through a scatter of each one's index
    idx = torch.arange(P, device=dev)
    count = torch.cumsum(evaluated, dim=0)
    nth = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    nth.scatter_(0, torch.where(evaluated, count - 1, P), idx)
    last = torch.where(count > 0, nth[(count - 1).clamp(min=0)], -1)
    prev_in = torch.cat([torch.full((1,), -1, dtype=torch.int64, device=dev), last[:-1]])
    first_eval = prev_in < 0
    prev_pos_eff = torch.where(first_eval, prev_pos, win_p[prev_in.clamp(min=0)])
    have_prev = ~first_eval | has_prev
    is_new = evaluated & (~have_prev | (win_p != prev_pos_eff))

    # the window-0 suppression quirk, carried while every evaluated window
    # since window 0 carried hash h0
    if first_chunk:
        phantom, h0 = evaluated[0], win_h[0]
    same_h0 = ~evaluated | (win_h == h0)
    prefix_ok = torch.cumsum(~same_h0, dim=0) == 0
    suppress = phantom & prefix_ok
    if first_chunk:
        suppress = suppress & (idx > 0)  # window 0 itself records
    record = is_new & ~suppress

    any_eval = last[-1] >= 0
    new_prev = torch.where(any_eval, win_p[last[-1].clamp(min=0)], prev_pos)
    return record, win_h, (has_prev | any_eval, new_prev, phantom & prefix_ok[-1], h0)
