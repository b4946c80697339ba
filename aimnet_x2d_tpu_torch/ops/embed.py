"""Concatenated multi-feature embedding, feature-major (counterpart of
aimnet_x2d_tpu/ops/embed.py::embed_concat_onehot_t).

The JAX package computes the lookup as one block-diagonal one-hot matmul
in XLA; a product with a one-hot matrix is exactly the gather, so the port
gathers.  An id outside its table's range gives a zero embedding, as the
one-hot product does.  The gather runs on the fp32 tables and rounds after
(the same values as rounding first), so in training the tables' gradient
accumulates in fp32, as the one-hot product's transpose does.  It goes
through ``F.embedding``, whose backward sums the many repeats of an id
(most atoms are C or H) with a sort instead of the per-element
accumulation of ``table[ids]``'s backward.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


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
        emb = F.embedding(i.clamp(0, t.shape[0] - 1), t).to(dtype)
        rows.append(emb * valid.to(dtype)[:, None])
    return torch.cat(rows, dim=1).T.contiguous()
