"""Concatenated multi-feature embedding, row-major (counterpart of
aimnet_x2d_tpu/ops/embed.py::embed_concat_onehot, and of the fp32 gather
concat of the JAX model's flat path) and feature-major (::
embed_concat_onehot_t).

The JAX package computes the lookup as one block-diagonal one-hot matmul
in XLA; a product with a one-hot matrix is exactly the gather, so the port
gathers.  An id outside its table's range gives a zero embedding, as the
one-hot product does.  The gather runs on the fp32 tables and rounds after
(the same values as rounding first), so in training the tables' gradient
accumulates in fp32, as the one-hot product's transpose does.  It goes
through ``F.embedding``, whose backward sums the many repeats of an id
(most atoms are C or H) with a sort instead of the per-element
accumulation of ``table[ids]``'s backward.

The embedding fold (``AIMNET_EMBED_FOLD=1``, ops/bin_attnpool.py::
embed_fold_enabled; kernel 1c-vocab) hands the fused kernels the raw code
rows (:func:`code_rows`, (F, A) int32) and the fp32 block-diagonal table
(:func:`blockdiag_table_t`, (E, sum of V)) instead of the (E, A) array: the
kernels look each atom's embedding up themselves and their backward emits
the table's cotangent ``d_bd``, whose diagonal blocks autograd hands to the
four tables through the pad and concatenation.  :func:`embed_from_codes` and
:func:`table_grad` are the plain versions of the lookup and of that
cotangent (the JAX ``onehot_rows`` products).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def embed_concat_onehot(
    tables: Sequence[torch.Tensor],
    ids: Sequence[torch.Tensor],
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """``concat([T_i[ids_i] for i])`` as a row-major (A, sum of dims) array
    in ``dtype`` (table values rounded to ``dtype``)."""
    rows = []
    for t, i in zip(tables, ids):
        i = i.long()
        valid = (i >= 0) & (i < t.shape[0])
        emb = F.embedding(i.clamp(0, t.shape[0] - 1), t).to(dtype)
        rows.append(emb * valid.to(dtype)[:, None])
    return torch.cat(rows, dim=1)


def embed_concat_onehot_t(
    tables: Sequence[torch.Tensor],
    ids: Sequence[torch.Tensor],
    dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The same as a feature-major (sum of dims, A) array."""
    return embed_concat_onehot(tables, ids, dtype).T.contiguous()


# ---- the embedding fold (kernel 1c-vocab) --------------------------------- #


def code_rows(ids: Sequence[torch.Tensor]) -> torch.Tensor:
    """The features' code rows stacked as (F, A) int32 (JAX models/gnn.py
    ``jnp.stack([f.astype(jnp.int32) ...])``)."""
    return torch.stack([i.to(torch.int32) for i in ids]).contiguous()


def onehot_rows(codes: torch.Tensor, vocab_sizes: Sequence[int], dt: torch.dtype) -> torch.Tensor:
    """Concatenated one-hot (sum of V, A) of the code rows (F, A): feature
    f's block lights row ``off_f + code``; a code outside ``[0, V_f)``
    lights no row (JAX ops/embed.py::onehot_rows)."""
    blocks = [codes[f].long()[None, :] == torch.arange(v, device=codes.device)[:, None]
              for f, v in enumerate(vocab_sizes)]
    return torch.cat(blocks).to(dt)


def blockdiag_table_t(tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fp32 tables (V_f, D_f) as the transposed block-diagonal master
    (sum of D, sum of V): plain differentiable pad, concatenation and
    transpose, so autograd gives each table its diagonal block of ``d_bd``
    and drops the rest (JAX ops/embed.py::blockdiag_table_t)."""
    D = sum(int(t.shape[1]) for t in tables)
    rows, c0 = [], 0
    for t in tables:
        d = int(t.shape[1])
        rows.append(F.pad(t, (c0, D - c0 - d)))
        c0 += d
    return torch.cat(rows, dim=0).T


@dataclasses.dataclass
class VocabTable:
    """The block-diagonal table in the kernels' form: ``bd`` (E, sum of V)
    rounded to the compute dtype, contiguous; ``sizes`` the vocabulary of
    each feature.  Each feature owns ``E // F`` consecutive rows (the model's
    four tables share one embedding width), so row e belongs to feature
    ``e // Df`` and its only nonzero columns are that feature's block."""

    bd: torch.Tensor
    sizes: Tuple[int, ...]

    @property
    def E(self) -> int:
        return self.bd.shape[0]

    @property
    def Df(self) -> int:
        return self.E // len(self.sizes)

    @property
    def offsets(self) -> Tuple[int, ...]:
        out = [0]
        for v in self.sizes:
            out.append(out[-1] + v)
        return tuple(out)


def prep_vocab(bd_t: torch.Tensor, vocab_sizes: Sequence[int], dt: torch.dtype) -> VocabTable:
    """bd_t (E, sum of V) fp32 master -> :class:`VocabTable` in ``dt``."""
    sizes = tuple(int(v) for v in vocab_sizes)
    E, SV = bd_t.shape
    if SV != sum(sizes) or not sizes or E % len(sizes):
        raise ValueError(f"embedding table {tuple(bd_t.shape)} for vocabularies {sizes}: need "
                         f"sum of V columns and E a multiple of the feature count")
    return VocabTable(bd_t.detach().to(dt).contiguous(), sizes)


def embed_from_codes(codes: torch.Tensor, vt: VocabTable) -> torch.Tensor:
    """Plain version of the fold's lookup: ``rnd(bd) @ onehot`` with fp32
    accumulation, rounded to the compute dtype (E, A); exactly the gather
    of each feature's rounded table row (JAX bin_attnpool.py:191-194)."""
    oh = onehot_rows(codes, vt.sizes, torch.float32)
    return torch.matmul(vt.bd.float(), oh).to(vt.bd.dtype)


def diag_mask(vt: VocabTable, device) -> torch.Tensor:
    """(E, sum of V) bool: the diagonal blocks of the table."""
    row_f = torch.arange(vt.E, device=device) // vt.Df
    col_f = torch.cat([torch.full((v,), f, device=device) for f, v in enumerate(vt.sizes)])
    return row_f[:, None] == col_f[None, :]


def table_grad(demb: torch.Tensor, codes: torch.Tensor, vt: VocabTable) -> torch.Tensor:
    """Plain version of the fold's table cotangent: ``d_bd = demb @ onehotᵀ``
    in fp32 from the compute-dtype demb (E, A) (JAX bin_mp.py:736-742,
    bin_attnpool.py:301-306), kept on the diagonal blocks (the only part
    the tables receive); (E, sum of V) fp32."""
    d = torch.matmul(demb.float(), onehot_rows(codes, vt.sizes, torch.float32).T)
    return torch.where(diag_mask(vt, d.device), d, torch.zeros((), device=d.device))


def expand_diag(compact: torch.Tensor, vt: VocabTable) -> torch.Tensor:
    """The kernels' compact diagonal blocks (feature by feature, each
    (Df, V_f) row-major) -> (E, sum of V) fp32 with zeros elsewhere."""
    off, Df = vt.offsets, vt.Df
    out = compact.new_zeros(vt.E, off[-1])
    for f, v in enumerate(vt.sizes):
        out[f * Df : (f + 1) * Df, off[f] : off[f + 1]] = \
            compact[Df * off[f] : Df * off[f + 1]].view(Df, v)
    return out
