"""Concatenated multi-feature embedding, feature-major (counterpart of
aimnet_x2d_tpu/ops/embed.py::embed_concat_onehot_t).

The JAX package computes the lookup as one block-diagonal one-hot matmul
in XLA; a product with a one-hot matrix is exactly the gather, so the port
gathers.  An id outside its table's range gives a zero embedding, as the
one-hot product does.
"""

from __future__ import annotations

from typing import Sequence

import torch


def embed_concat_onehot_t(
    tables: Sequence[torch.Tensor],
    ids: Sequence[torch.Tensor],
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``concat([T_i[ids_i] for i])`` as a feature-major (sum of dims, A)
    array in ``dtype`` (table values rounded to ``dtype``)."""
    rows = []
    for t, i in zip(tables, ids):
        i = i.long()
        valid = (i >= 0) & (i < t.shape[0])
        emb = t.to(dtype)[i.clamp(0, t.shape[0] - 1)]
        rows.append(emb * valid.to(dtype)[:, None])
    return torch.cat(rows, dim=1).T.contiguous()
