"""Boundary-atom halo exchange and the binned aggregation around it
(counterpart of aimnet_x2d_tpu/ops/halo.py).

On a halo shard (parallel/halo.py) each graph rank owns a block of atoms;
every edge lives on the owner of its destination atom, and the remote source
rows its edges read -- the halo -- arrive once per message-passing layer
through one ``all_to_all`` over the graph axis.  Feature-major layout (the
binned halo stack): x is (D, A_loc); the halo buffer (D, G*Hp) holds in
columns p*Hp .. (p+1)*Hp the atoms rank p sent here, in p's send order (the
host's index rewrite).  Row-major layout (flat shards and per-hop models):
x (A_loc, D), the halo (G*Hp, D) in the same order.

The two aggregation products are plain products that the JAX package leaves
to XLA outside any Pallas kernel, so here they are ``torch.matmul``: their
operands are rounded to the compute dtype (the adjacencies are int8 counts)
and they return fp32, as JAX's ``preferred_element_type=float32`` does.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import Axis


class _HaloExchange(torch.autograd.Function):
    """Gather the rows this rank sends (a -1 slot sends a zero row), then
    ``all_to_all`` over the graph axis.  Backward: the reverse exchange of
    the cotangents, then their sum into the sent rows (``index_add``: one
    atom may be sent to several peers).  Feature-major, x (D, A), or
    row-major (``rows``), x (A, D): the atoms on dim 1 or dim 0."""

    @staticmethod
    def forward(ctx, x, send_idx, ax, rows):
        if rows:
            x = x.T
        D, A = x.shape
        G, Hp = send_idx.shape
        valid = (send_idx >= 0).reshape(-1)
        safe = send_idx.long().clamp(0, max(A - 1, 0)).reshape(-1)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        buf = torch.where(valid[None, :], x.index_select(1, safe), zero)
        buf = buf.reshape(D, G, Hp).permute(1, 0, 2).contiguous()  # chunk g -> rank g
        recv = ax.all_to_all_raw(buf)  # chunk p <- rank p
        ctx.save_for_backward(safe, valid)
        ctx.ax, ctx.A, ctx.rows = ax, A, rows
        out = recv.permute(1, 0, 2).reshape(D, G * Hp)
        return out.T.contiguous() if rows else out

    @staticmethod
    def backward(ctx, g):
        safe, valid = ctx.saved_tensors
        if ctx.rows:
            g = g.T
        D = g.shape[0]
        G = ctx.ax.size
        back = ctx.ax.all_to_all_raw(g.reshape(D, G, -1).permute(1, 0, 2).contiguous())
        back = back.permute(1, 0, 2).reshape(D, -1)
        back = torch.where(valid[None, :], back, torch.zeros((), dtype=back.dtype,
                                                             device=back.device))
        dx = back.new_zeros(D, ctx.A).index_add_(1, safe, back)
        return (dx.T.contiguous() if ctx.rows else dx), None, None, None


def halo_exchange_t(xT: torch.Tensor, send_idx: torch.Tensor, ax: Axis) -> torch.Tensor:
    """xT (D, A_loc) -> the halo buffer (D, G*Hp) (module docstring);
    ``send_idx`` (G, Hp) int32 lists the local atoms sent to each rank, -1
    padding; ``ax`` is the graph axis (parallel/mesh.py)."""
    if send_idx.shape[0] != ax.size:
        raise ValueError(f"send map for {send_idx.shape[0]} ranks on a graph axis of {ax.size}")
    return _HaloExchange.apply(xT, send_idx, ax, False)


def halo_exchange(x: torch.Tensor, send_idx: torch.Tensor, ax: Axis) -> torch.Tensor:
    """Row-major twin of :func:`halo_exchange_t` (JAX ``halo_exchange``):
    x (A_loc, D) -> the halo rows (G*Hp, D), rows p*Hp .. (p+1)*Hp the atoms
    rank p sent here in its send order; an edge of the shard reads source
    row s of ``[x ; halo]``."""
    if send_idx.shape[0] != ax.size:
        raise ValueError(f"send map for {send_idx.shape[0]} ranks on a graph axis of {ax.size}")
    return _HaloExchange.apply(x, send_idx, ax, True)


def binned_local_agg_t(xT: torch.Tensor, bin_adj: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """aggT[d, b*ab + i] = sum_j bin_adj[b, i, j] xT[d, b*ab + j] over the
    shard's own bins: (D, A_loc) fp32, operands rounded to ``dt``."""
    nb, ab, _ = bin_adj.shape
    D = xT.shape[0]
    x3 = xT.to(dt).float().reshape(D, nb, ab).permute(1, 0, 2)  # (nb, D, ab)
    agg = torch.matmul(x3, bin_adj.to(dt).float().transpose(1, 2))
    return agg.permute(1, 0, 2).reshape(D, nb * ab)


def halo_agg_contrib_t(haloT: torch.Tensor, halo_adj: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The halo rows' part of the aggregation: (D, G*Hp) x the (G*Hp, A_loc)
    int8 multiplicities -> (D, A_loc) fp32, operands rounded to ``dt``."""
    return torch.matmul(haloT.to(dt).float(), halo_adj.to(dt).float())
