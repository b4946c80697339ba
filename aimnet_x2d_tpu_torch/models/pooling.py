"""Pooling (counterpart of aimnet_x2d_tpu/models/pooling.py).

Binned, feature-major layout: atoms are laid out bins x ab and molecules
bins x mb; ``pool_mat[b, m, a]`` marks membership.  Per-molecule sums are
products with the membership matrix, run by the weighted-pool kernels
(ops/bin_wpool.py, forward and backward); the softmax is plain PyTorch with
the JAX package's -1e30 mask and 1e-16 floor.

Binned, row-major layout (the route of true per-hop aggregation): the
attention pool is kernel 6 (ops/bin_pool.py: scores, per-molecule softmax
and both weighted pools in one kernel per direction); mean and sum pool the
[x_self, x_other] concat with the membership matrix in plain PyTorch (XLA
einsums in JAX).

Flat, row-major layout: per-molecule segment reductions keyed by
``atom_mol`` (ops/segment.py; padded atoms carry id B and are dropped), as
the JAX package runs them in XLA with no kernel.

Max pooling has no TPU kernel on either layout and stays plain PyTorch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.bin_attnpool import binned_attnpool_proj_t
from ..ops.bin_pool import binned_attention_pool_fused
from ..ops.bin_wpool import binned_wpool_t
from ..ops.segment import segment_max, segment_mean, segment_softmax, segment_sum
from ..parallel.mesh import Axis
from .layers import Linear, mm32

POOLING_TYPES = ("attention", "mean", "max", "sum")


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


def binned_sum_pool(x: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    """Row-major x (A, D) -> (nb*mb, D) fp32: each molecule slot's sum over
    its member atoms (bf16 stays bf16 up to the fp32 sums)."""
    nb, mb, ab = pool_mat.shape
    xb = x.to(_pool_dtype(x)).float().reshape(nb, ab, -1)
    return torch.einsum("bma,bad->bmd", pool_mat.float(), xb).reshape(nb * mb, -1)


def binned_mean_pool(x: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    cnt = pool_mat.sum(dim=2).float().clamp(min=1.0).reshape(-1, 1)
    return binned_sum_pool(x, pool_mat) / cnt


def binned_max_pool(x: torch.Tensor, pool_mat: torch.Tensor) -> torch.Tensor:
    """x (A, D) -> (nb*mb, D) in x's compute dtype (bf16 stays bf16): each
    molecule slot's max over its member atoms, empty slots 0 (JAX
    ``binned_max_pool``).  A scatter-max keyed by each atom's slot (atoms of
    no molecule go to a dropped extra row), so no (nb, mb, ab, D) array is
    formed; its backward splits the gradient evenly among tied atoms, as
    JAX's ``max`` does."""
    nb, mb, ab = pool_mat.shape
    xf = x.to(_pool_dtype(x))
    slot_in_bin = (pool_mat.long() * torch.arange(mb, device=x.device)[None, :, None]).sum(1)
    first = torch.arange(nb, device=x.device)[:, None] * mb
    slot = torch.where(pool_mat.sum(1) > 0, first + slot_in_bin, nb * mb).reshape(-1)
    # start from -inf (a start of 0 would tie with a max of exactly 0 in the
    # backward and take half its gradient), then empty slots -> 0
    out = xf.new_full((nb * mb + 1, xf.shape[1]), float("-inf"))
    out = out.scatter_reduce(0, slot[:, None].expand_as(xf), xf, "amax")[: nb * mb]
    return torch.where(torch.isneginf(out), torch.zeros((), dtype=xf.dtype, device=x.device), out)


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


def _masked(x: torch.Tensor, atom_mask: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.where(atom_mask[:, None], x, torch.full((), fill, dtype=x.dtype, device=x.device))


def _seg_ids(atom_mol: torch.Tensor, atom_mask: torch.Tensor, num_graphs: int) -> torch.Tensor:
    return torch.where(atom_mask, atom_mol.long(), torch.full_like(atom_mol, num_graphs).long())


def mean_pool(x: torch.Tensor, atom_mol: torch.Tensor, atom_mask: torch.Tensor,
              num_graphs: int, axis: Optional[Axis] = None) -> torch.Tensor:
    """Flat mean pool: x (A, D) -> (B, D) in x's dtype, empty molecules 0.
    With a graph ``axis`` (halo shards) the per-molecule sums and atom
    counts are fp32 partials psummed over it first, the mean rounded once
    to x's dtype (in bf16 the JAX package sums in bf16, whose running sum
    and count lose a molecule of hundreds of atoms' low bits; the port sums
    scatters in fp32 throughout)."""
    seg = _seg_ids(atom_mol, atom_mask, num_graphs)
    x = _masked(x, atom_mask, 0.0)
    if axis is None:
        return segment_mean(x, seg, num_graphs)
    totals = axis.psum(segment_sum(x.float(), seg, num_graphs))
    counts = axis.psum(segment_sum(atom_mask.float(), seg, num_graphs))
    return (totals / counts.clamp(min=1.0)[:, None]).to(x.dtype)


def sum_pool(x: torch.Tensor, atom_mol: torch.Tensor, atom_mask: torch.Tensor,
             num_graphs: int, axis: Optional[Axis] = None) -> torch.Tensor:
    """Flat sum pool: x (A, D) -> (B, D) in x's dtype (over a graph
    ``axis``: fp32 partials psummed, rounded once, as :func:`mean_pool`)."""
    seg = _seg_ids(atom_mol, atom_mask, num_graphs)
    if axis is None:
        return segment_sum(_masked(x, atom_mask, 0.0), seg, num_graphs)
    return axis.psum(segment_sum(_masked(x.float(), atom_mask, 0.0), seg, num_graphs)).to(x.dtype)


def max_pool(x: torch.Tensor, atom_mol: torch.Tensor, atom_mask: torch.Tensor,
             num_graphs: int, axis: Optional[Axis] = None) -> torch.Tensor:
    """Flat max pool: x (A, D) -> (B, D) in x's dtype, empty molecules 0; a
    maximum shared by several atoms splits its gradient evenly among them
    (JAX ``segment_max``).  Over a graph ``axis``: each rank's maxima are
    gathered and maxed (differentiable to the rank holding the maximum)."""
    xm = _masked(x, atom_mask, float("-inf"))
    seg = _seg_ids(atom_mol, atom_mask, num_graphs)
    if axis is None:
        return segment_max(xm, seg, num_graphs)
    out = segment_max(xm, seg, num_graphs, empty_value=float("-inf"))
    out = axis.all_gather(out).amax(dim=0)
    return torch.where(torch.isneginf(out), torch.zeros((), dtype=out.dtype, device=out.device),
                       out)


def atom_counts(atom_mol: torch.Tensor, atom_mask: torch.Tensor, num_graphs: int) -> torch.Tensor:
    """(B,) fp32: real atoms per molecule slot."""
    return segment_sum(atom_mask.float(), _seg_ids(atom_mol, atom_mask, num_graphs), num_graphs)


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
    """Multi-head attention pooling with the concat_self_other projection
    folded in (``pre_proj``): scores use the folded kernel K_cs K_heads, and
    each concat part pools on its own.  ``forward`` and ``forward_train``
    take the binned feature-major parts, ``forward_rows`` the binned
    row-major ones, ``forward_flat`` the flat ones."""

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
        embed_spec=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training path (the JAX fused branch): the fused op recomputes
        x_self = act(k_self^T emb + b_self) in its kernels, with the score
        kernel folded through concat_self_other and divided by the
        temperature outside it, in plain autograd.  With ``embed_spec``
        (codes, block-diagonal table, vocabulary sizes) the kernels also
        look the embeddings up (the fold) and embT may be None.  Returns
        (mol (B, hidden) fp32, attention weights (H, A))."""
        k_cs, b_cs = pre_proj
        score_k, score_b = self._score_fold(k_cs, b_cs)
        xs = k_self.shape[1]
        T = self.temperature
        ps, po, cov, attn = binned_attnpool_proj_t(
            embT, k_self, b_self, act, x_other, pool_mat,
            score_k[:xs] / T, score_k[xs:] / T, score_b / T, embed_spec=embed_spec,
        )
        return pool_then_project([ps, po], cov, k_cs, b_cs, x_other.dtype), attn

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

    def forward_rows(
        self,
        parts: List[torch.Tensor],
        pool_mat: torch.Tensor,
        pre_proj: Tuple[torch.Tensor, torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The binned row-major route (the JAX branch of binned batches that
        are not feature-major): parts [x_self (A, d_s), x_other (A, d_o)] in
        the compute dtype go through kernel 6 with the folded score kernel
        and bias over the temperature (plain autograd, so d/dT flows), then
        concat_self_other on the pooled parts, its bias scaled by each
        slot's coverage.  Returns (mol (B, hidden) fp32, attention weights
        (H, A) fp32)."""
        k_cs, b_cs = pre_proj
        score_k, score_b = self._score_fold(k_cs, b_cs)
        T = self.temperature
        ps, po, cov, attn = binned_attention_pool_fused(parts[0], parts[1], pool_mat,
                                                        score_k / T, score_b / T)
        return pool_then_project([ps.T, po.T], cov, k_cs, b_cs, parts[0].dtype), attn

    def forward_flat(
        self,
        parts: List[torch.Tensor],
        atom_mol: torch.Tensor,
        atom_mask: torch.Tensor,
        num_graphs: int,
        pre_proj: Tuple[torch.Tensor, torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The flat layout (the JAX segment branch): parts row-major
        [x_self (A, d_s), x_other (A, d_o)] in the compute dtype.  Scores
        take each part by its row block of the folded kernel (cast to the
        part's dtype, fp32 sums) over the temperature; a per-molecule
        softmax; the head-mean weight pools each part promoted to fp32, and
        the bias picks up each molecule's summed weight.  Returns (mol
        (B, hidden) fp32, attention weights (H, A) fp32)."""
        k_cs, b_cs = pre_proj
        score_k, score_b = self._score_fold(k_cs, b_cs)
        scores32 = score_b
        row = 0
        for p in parts:
            scores32 = scores32 + mm32(p, score_k[row : row + p.shape[1]], p.dtype)
            row += p.shape[1]
        scores = scores32.T / self.temperature  # (H, A)
        seg = _seg_ids(atom_mol, atom_mask, num_graphs)
        attn = segment_softmax(scores, seg, num_graphs, mask=atom_mask)
        wbar = attn.mean(dim=0)
        pooled = [segment_sum(p.float() * wbar[:, None], seg, num_graphs).T for p in parts]
        cov = segment_sum(wbar, seg, num_graphs)
        return pool_then_project(pooled, cov, k_cs, b_cs, torch.float32), attn

    def forward_halo(self, x: torch.Tensor, atom_mol: torch.Tensor, atom_mask: torch.Tensor,
                     num_graphs: int, axis: Axis) -> Tuple[torch.Tensor, torch.Tensor]:
        """Halo shards (the JAX segment branch with ``graph_axis``): x the
        rank's atom embeddings (A_loc, hidden) in the compute dtype, pooled
        without the concat fold.  Scores x K_heads (K rounded to x's dtype,
        fp32 sums) + bias over the temperature; a per-molecule softmax
        across the graph axis: the stop-gradient pmax of the segment maxima,
        then psums of the denominators, of the head-mean weighted pools
        (fp32 partials, rounded once to x's dtype, as :func:`mean_pool`) --
        the molecules split across ranks are exact.  Returns (mol (B,
        hidden) in x's dtype, attention weights (H, A_loc) fp32)."""
        kernel = torch.cat([h.weight.T for h in self.attention_weights], dim=1)  # (D, H)
        bias = torch.cat([h.bias for h in self.attention_weights])
        scores = (bias + mm32(x, kernel, x.dtype)).T / self.temperature  # (H, A)
        seg = _seg_ids(atom_mol, atom_mask, num_graphs)
        neg = torch.full((), float("-inf"), device=scores.device)
        masked = torch.where(atom_mask[None, :], scores, neg)
        idx = seg[None, :].expand_as(masked)
        smax = masked.new_full((masked.shape[0], num_graphs + 1), float("-inf"))
        smax = smax.scatter_reduce(1, idx, masked.detach(), "amax")[:, :num_graphs]
        smax = axis.pmax(smax)
        smax = torch.where(torch.isneginf(smax), torch.zeros_like(smax), smax)
        smax = torch.cat([smax, smax.new_zeros(smax.shape[0], 1)], dim=1)
        zero = torch.zeros((), device=scores.device)
        expd = torch.where(atom_mask[None, :], torch.exp(masked - torch.gather(smax, 1, idx)), zero)
        denom = expd.new_zeros(expd.shape[0], num_graphs + 1).scatter_add(1, idx, expd)
        denom = axis.psum(denom[:, :num_graphs])
        denom = torch.cat([denom, denom.new_zeros(denom.shape[0], 1)], dim=1)
        attn = expd / torch.gather(denom, 1, idx).clamp(min=1e-16)
        wbar = attn.mean(dim=0)
        pooled = axis.psum(segment_sum(x.float() * wbar[:, None], seg, num_graphs))
        return pooled.to(x.dtype), attn

