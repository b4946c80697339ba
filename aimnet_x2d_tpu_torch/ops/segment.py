"""Segment reductions keyed by an integer id per row (counterpart of
aimnet_x2d_tpu/ops/segment.py).

The flat layout pools atoms into molecules with these: ``atom_mol`` gives
each atom's molecule, and padded atoms carry the id ``num_segments`` (one
past the end), which every reduction drops, as JAX's scatter does with an
out-of-range id.  The JAX package runs them as XLA ops with no kernel, so
plain PyTorch is their port; they are differentiable by autograd.

- :func:`segment_sum` and :func:`segment_mean` (empty segments give 0);
- :func:`segment_max`: an empty segment gives ``empty_value``; the
  gradient of a maximum that several rows share is split evenly among them,
  as JAX's scatter-max does;
- :func:`segment_softmax` over the last axis, with the JAX rules: masked
  rows get -inf scores and weight 0, an empty segment's -inf maximum
  becomes 0, and the denominator is floored at 1e-16.
"""

from __future__ import annotations

from typing import Optional

import torch


def _safe_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Ids as int64, every id outside [0, num_segments) sent to the extra
    row ``num_segments`` that the reductions drop."""
    ids = segment_ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, torch.full_like(ids, num_segments))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum of ``data`` rows (dim 0) per segment, in ``data``'s dtype."""
    ids = _safe_ids(segment_ids, num_segments)
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    return out.index_add(0, ids, data)[:num_segments]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Mean of ``data`` rows per segment; empty segments give 0."""
    totals = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(torch.ones(segment_ids.shape, dtype=data.dtype, device=data.device),
                         segment_ids, num_segments)
    counts = counts.clamp(min=1.0)
    return totals / (counts[:, None] if data.dim() > 1 else counts)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                empty_value: float = 0.0) -> torch.Tensor:
    """Max of ``data`` rows per segment; empty segments give ``empty_value``.
    The reduction starts from -inf, so only rows of the segment tie."""
    ids = _safe_ids(segment_ids, num_segments)
    idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full((num_segments + 1,) + tuple(data.shape[1:]), float("-inf"))
    out = out.scatter_reduce(0, idx, data, "amax")[:num_segments]
    return torch.where(torch.isneginf(out), torch.full_like(out, empty_value), out)


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax over the entries of the last axis that share a segment id:
    ``scores`` (..., N), ``segment_ids`` (N,), ``mask`` (N,) bool marks the
    valid entries (the rest get weight 0)."""
    ids = _safe_ids(segment_ids, num_segments)
    lead = scores.shape[:-1]
    s = scores.reshape(-1, scores.shape[-1])
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, float("-inf")))
    idx = ids[None, :].expand_as(s)
    m = s.new_full((s.shape[0], num_segments + 1), float("-inf"))
    m = m.scatter_reduce(1, idx, s, "amax")
    m = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    expd = torch.exp(s - torch.gather(m, 1, idx))
    if mask is not None:
        expd = torch.where(mask, expd, torch.zeros_like(expd))
    denom = s.new_zeros((s.shape[0], num_segments + 1)).scatter_add(1, idx, expd)
    out = expd / torch.gather(denom, 1, idx).clamp(min=1e-16)
    return out.reshape(lead + (scores.shape[-1],))
