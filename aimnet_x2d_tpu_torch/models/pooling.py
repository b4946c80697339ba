"""Pooling over the binned, feature-major layout (counterpart of
aimnet_x2d_tpu/models/pooling.py).

Atoms are laid out bins x ab and molecules bins x mb; ``pool_mat[b, m, a]``
marks membership.  Per-molecule sums are products with the membership
matrix, run by the weighted-pool kernel (ops/bin_wpool.py); the softmax is
plain PyTorch with the JAX package's -1e30 mask and 1e-16 floor.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.bin_attnpool import binned_attnpool_proj_t
from ..ops.bin_wpool import binned_wpool_t
from .layers import Linear, mm32

POOLING_TYPES = ("attention", "mean", "sum")


def _pool_dtype(xT: torch.Tensor) -> torch.dtype:
    return xT.dtype if xT.dtype == torch.bfloat16 else torch.float32


def binned_sum_pool_t(xT: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    """xT (D, A) -> pooledT (D, nb*mb) fp32."""
    ones = torch.ones(xT.shape[1], dtype=torch.float32, device=xT.device)
    return binned_wpool_t(xT.to(_pool_dtype(xT)), ones, pool_mat)


def binned_mean_pool_t(xT: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    tot = binned_sum_pool_t(xT, pool_mat)
    cnt = pool_mat.sum(dim=2).float().clamp(min=1.0)
    return tot / cnt.reshape(1, -1)


def binned_attention_softmax_t(scores: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    """Per-molecule masked softmax of per-atom scores (H, A) -> (H, A);
    padding and uncovered atoms get weight 0."""
    nb, mb, ab = pool_mat.shape
    H = scores.shape[0]
    ohf = pool_mat.float()
    s = scores.reshape(H, nb, ab)
    cover = pool_mat.sum(dim=1) > 0  # (nb, ab)
    neg = torch.tensor(-1e30, dtype=torch.float32, device=scores.device)
    smax = torch.where(pool_mat[None] > 0, s[:, :, None, :], neg).amax(dim=3)  # (H, nb, mb)
    satom = torch.einsum("bma,hbm->hba", ohf, smax)
    e = torch.where(cover[None], torch.exp(s - satom), torch.zeros((), device=s.device))
    denom = torch.einsum("bma,hba->hbm", ohf, e)
    denom_atom = torch.einsum("bma,hbm->hba", ohf, denom)
    w = e / denom_atom.clamp(min=1e-16)
    return w.reshape(H, nb * ab)


def binned_attention_coverage(attn: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    """Sum over each molecule's atoms of the head-mean weight: the factor the
    pooled bias picks up when pooling commutes past a linear projection."""
    nb, mb, ab = pool_mat.shape
    wbar = attn.mean(dim=0).reshape(nb, ab)
    return torch.einsum("bma,ba->bm", pool_mat.float(), wbar.float()).reshape(nb * mb)


def binned_attention_pool_t(xT: torch.Tensor, attn: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    """Head-averaged weighted pool: xT (D, A), attn (H, A) -> (D, nb*mb)
    fp32 (the head mean commutes with the membership sum)."""
    return binned_wpool_t(xT.to(_pool_dtype(xT)), attn.mean(dim=0), pool_mat)


def pool_then_project(
    pooled_parts: Sequence[torch.Tensor],
    factor: torch.Tensor,
    k_cs: torch.Tensor,
    b_cs: torch.Tensor,
    dt: torch.dtype,
) -> torch.Tensor:
    """``pool(x) K + b * factor`` per molecule, from the pooled concat parts
    (d_p, B) and the (in, out) projection kernel ``k_cs``: pooling commutes
    past the linear concat_self_other projection, so no (A, hidden) array
    is formed.  Returns (B, hidden) fp32."""
    mol = b_cs * factor.float()[:, None]
    row = 0
    for pp in pooled_parts:
        d_p = pp.shape[0]
        mol = mol + mm32(pp.T, k_cs[row : row + d_p], dt)
        row += d_p
    return mol


class MultiHeadAttentionPooling(nn.Module):
    """Multi-head attention pooling on the binned, feature-major path with
    the concat_self_other projection folded in (``pre_proj``): scores use
    the folded kernel K_cs K_heads, and each concat part pools on its own."""

    def __init__(self, in_features: int, num_heads: int = 4):
        super().__init__()
        self.temperature = nn.Parameter(torch.ones(()))
        self.attention_weights = nn.ModuleList(Linear(in_features, 1) for _ in range(num_heads))

    def _score_fold(self, k_cs: torch.Tensor, b_cs: torch.Tensor):
        """The heads' scores folded through concat_self_other: (in, H), (H,)."""
        kernel = torch.cat([h.weight.T for h in self.attention_weights], dim=1)  # (D, H)
        bias = torch.cat([h.bias for h in self.attention_weights])  # (H,)
        return k_cs @ kernel, b_cs @ kernel + bias

    def forward_train(
        self,
        embT: torch.Tensor,
        k_self: torch.Tensor,
        b_self: torch.Tensor,
        act: str,
        x_other: torch.Tensor,
        pool_mat: torch.Tensor,
        pre_proj: Tuple[torch.Tensor, torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training path (the JAX fused branch): the fused op recomputes
        x_self = act(k_self^T emb + b_self) in its kernels, with the score
        kernel folded through concat_self_other and divided by the
        temperature outside it, in plain autograd.  Returns (mol (B, hidden)
        fp32, attention weights (H, A))."""
        k_cs, b_cs = pre_proj
        score_k, score_b = self._score_fold(k_cs, b_cs)
        xs = k_self.shape[1]
        T = self.temperature
        ps, po, cov, attn = binned_attnpool_proj_t(
            embT, k_self, b_self, act, x_other, pool_mat,
            score_k[:xs] / T, score_k[xs:] / T, score_b / T,
        )
        return pool_then_project([ps, po], cov, k_cs, b_cs, embT.dtype), attn

    def forward(
        self,
        parts: List[torch.Tensor],
        pool_mat: torch.Tensor,
        pre_proj: Tuple[torch.Tensor, torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """parts: feature-major [x_self (d_s, A), x_other (d_o, A)];
        pre_proj: (k_cs (in, out), b_cs).  Returns (mol (B, hidden) fp32,
        attention weights (H, A))."""
        k_cs, b_cs = pre_proj
        dt = parts[0].dtype
        score_k, score_b = self._score_fold(k_cs, b_cs)
        scores32 = score_b[:, None]
        row = 0
        for p in parts:
            blk = score_k[row : row + p.shape[0]]
            scores32 = scores32 + mm32(blk.T, p, p.dtype)
            row += p.shape[0]
        scores = scores32 / self.temperature
        attn = binned_attention_softmax_t(scores, pool_mat)
        pooled = [binned_attention_pool_t(p, attn, pool_mat) for p in parts]
        cov = binned_attention_coverage(attn, pool_mat)
        return pool_then_project(pooled, cov, k_cs, b_cs, dt), attn
