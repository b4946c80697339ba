"""Core layers (counterpart of aimnet_x2d_tpu/models/layers.py).

``Linear`` keeps the JAX package's cast points: with a compute dtype the
operands are rounded to it, the product accumulates in fp32, the result is
rounded to the compute dtype and the bias is added in it.  Without one it
is a plain fp32 layer.  Weights are torch-oriented (out, in); the flax
kernel is the transpose (checkpoint.params_from_flax).

Parameters are created zero-filled: a model's weights come from an
artifact or from ``checkpoint.init_params`` (the initializers live there).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..ops.fused_edge import fused_edge_aggregate
from ..ops.halo import halo_exchange
from ..utils.activation import get_activation_function


def mm32(a: torch.Tensor, b: torch.Tensor, dt: Optional[torch.dtype]) -> torch.Tensor:
    """``a @ b`` on operands rounded to ``dt`` (when given), accumulated and
    returned in fp32."""
    if dt is not None:
        a, b = a.to(dt), b.to(dt)
    return torch.matmul(a.float(), b.float())


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype  # compute dtype; parameters stay fp32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            y = mm32(x, self.weight.T, self.dtype).to(self.dtype)
        else:
            y = torch.matmul(x, self.weight.T.to(x.dtype))
        return y + self.bias.to(y.dtype)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep with probability
    1 - rate, scale kept values by 1/(1 - rate) in x's dtype.  The mask is
    drawn from ``generator`` (its device must be x's); without one, or at
    rate 0, x is returned unchanged.  Flax's threefry stream cannot be
    reproduced, so masks agree with the JAX package in distribution only."""
    if generator is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class LinearBlock(nn.Module):
    """Linear -> act -> dropout -> Linear, with an identity skip when the
    widths match.  Dropout runs only when ``forward`` gets a generator:
    serving passes none, and the training forward raises without one."""

    def __init__(self, in_features: int, features: int, activation_type: str = "silu",
                 use_skip: bool = True, dtype: Optional[torch.dtype] = None,
                 dropout: float = 0.0):
        super().__init__()
        self.linear1 = Linear(in_features, features, dtype)
        self.linear2 = Linear(features, features, dtype)
        self.act = get_activation_function(activation_type)
        self.use_skip = use_skip and in_features == features
        self.rate = dropout

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.linear2(dropout(self.act(self.linear1(x)), self.rate, generator))
        if self.use_skip:
            out = out + x.to(out.dtype)
        return out


class MultiLayerPerceptron(nn.Module):
    """Stack of LinearBlocks: first and last blocks without skip."""

    def __init__(self, in_features: int, hidden_dim: int, output_dim: int, num_layers: int = 2,
                 activation_type: str = "silu", use_skip: bool = True,
                 dtype: Optional[torch.dtype] = None, dropout: float = 0.0):
        super().__init__()
        act, d = activation_type, dropout
        if num_layers == 1:
            blocks = [LinearBlock(in_features, output_dim, act, False, dtype, d)]
        else:
            blocks = [LinearBlock(in_features, hidden_dim, act, False, dtype, d)]
            blocks += [
                LinearBlock(hidden_dim, hidden_dim, act, use_skip, dtype, d)
                for _ in range(num_layers - 2)
            ]
            blocks.append(LinearBlock(hidden_dim, output_dim, act, False, dtype, d))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for block in self.blocks:
            x = block(x, generator)
        return x


def hop_aggregate(x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                  edge_hop: torch.Tensor, edge_mask: torch.Tensor, num_hops: int,
                  num_dst: Optional[int] = None) -> torch.Tensor:
    """True per-hop aggregation (the JAX layer's per-hop branch): x (A, D) ->
    (K, A, D) fp32, where slice h sums, for each atom, the source rows of its
    real edges of hop h + 1.  The source rows are gathered in fp32 (exact
    for a bf16 x) and masked, then summed by ``index_add`` keyed by
    (hop - 1) * A + dst, masked edges going to a dropped extra row.  Both
    directions are ``index_add`` scatters in fp32: the backward of
    ``index_select`` is one, where that of bf16 advanced indexing is a
    sort-based kernel that took 95% of a flagship training step's device
    time on an H100.  On a halo shard x is ``[own atoms ; halo rows]`` and
    ``num_dst`` the own atoms, the only destinations."""
    A = x.shape[0] if num_dst is None else num_dst
    D = x.shape[1]
    K = num_hops
    zero = torch.zeros((), device=x.device)
    feat = torch.where(edge_mask[:, None], x.float().index_select(0, edge_src.long()), zero)
    idx = torch.where(edge_mask, (edge_hop.long() - 1) * A + edge_dst.long(),
                      torch.full_like(edge_dst, K * A, dtype=torch.long))
    agg = feat.new_zeros(K * A + 1, D).index_add(0, idx, feat)
    return agg[: K * A].reshape(K, A, D)


class ShellConvolutionLayer(nn.Module):
    """One shell-convolution layer.

    The parameters have the JAX layer's full shapes: the input and skip
    projections take (K+1)*D inputs.  Under quirk Q1 (``parity_mode``, the
    union of hops) only the first 2D rows ever see data; with true per-hop
    aggregation every row block takes its hop.  On the binned layout in
    parity mode the layer's arithmetic runs in the fused stack
    (ops/bin_mp.py), and :meth:`stack_weights` hands it the flat weight
    tuple; otherwise :meth:`forward` runs it row-major."""

    def __init__(self, dim: int, num_hops: int = 3, num_mlp_layers: int = 2,
                 activation_type: str = "silu", dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, parity_mode: bool = True):
        super().__init__()
        in_dim = dim * (num_hops + 1)
        self.dim = dim
        self.num_hops = num_hops
        self.parity_mode = parity_mode
        self.dtype = dtype  # compute dtype of the row-major path; parameters stay fp32
        self.act = get_activation_function(activation_type)
        self.rate = dropout
        self.input_proj = Linear(in_dim, dim)
        self.global_skip_proj = Linear(in_dim, dim)
        self.mlp = nn.ModuleList(
            nn.ModuleList([Linear(dim, dim, dtype), Linear(dim, dim, dtype)])
            for _ in range(num_mlp_layers)
        )

    def stack_weights(self) -> List[torch.Tensor]:
        """``(w_in0, w_in1, b_in, w_s0, w_s1, b_s, [w1, b1, w2, b2] x blocks)``
        with kernels in (in, out) orientation, as the JAX layer hands them
        to its stack kernel (layers.py ``_megakernel_weights``)."""
        D = self.dim
        w_in, w_s = self.input_proj.weight.T, self.global_skip_proj.weight.T
        out = [w_in[:D], w_in[D : 2 * D], self.input_proj.bias,
               w_s[:D], w_s[D : 2 * D], self.global_skip_proj.bias]
        for lin1, lin2 in self.mlp:
            out += [lin1.weight.T, lin1.bias, lin2.weight.T, lin2.bias]
        return out

    def forward(self, x: torch.Tensor, batch, generator: Optional[torch.Generator] = None,
                ax=None) -> torch.Tensor:
        """The layer row-major: x (A, D), in the compute dtype or, after a
        charge equilibration, fp32; ``batch`` a MolBatch on x's device.

        agg: in parity mode the union of hops on a flat batch (kernel 7,
        ops/fused_edge.py, from ``batch.fused_fwd``/``fused_bwd``), else one
        sum per hop (:func:`hop_aggregate` over the batch's edge lists, on
        either layout).  With a graph axis ``ax`` the edges are summed by
        ``index_add`` in fp32, as JAX's ``segment_sum`` (JAX takes no kernel
        with a graph axis): the union of hops in parity mode (every real
        edge as hop 1), or one sum per hop.  On a halo shard
        (``batch.halo_send_idx``) the edges read ``[x ; halo_exchange(x)]``
        (ops/halo.py) and every destination is local, so the sum is whole.
        Otherwise the batch is an edge shard (data/batching.py
        ``shard_edges``: every atom replicated, a slice of the edges), and
        the fp32 partial sum is psummed over ``ax`` before the cast, as the
        JAX layer's edge-replicated branch does; parts =
        [x, agg... in x's dtype]; the input and skip projections take each
        part by its row block of the kernel (fp32
        products of compute-dtype operands, summed, cast once, then the bias
        in the compute dtype); then the activation, the MLP blocks with
        their inner skip, and ``h + global_skip``.  With a ``generator`` the
        blocks' dropout runs after the first Linear's activation; its masks
        agree with flax's ``nn.Dropout`` in distribution only (the JAX
        package draws them from its threefry stream)."""
        D, cdt = self.dim, self.dtype
        edges = (batch.edge_src, batch.edge_dst, batch.edge_hop, batch.edge_mask)
        if ax is not None:
            halo = batch.halo_send_idx is not None
            x_src = torch.cat([x, halo_exchange(x, batch.halo_send_idx, ax)]) if halo else x
            if self.parity_mode:  # the union of hops: every real edge as hop 1
                edges = edges[:2] + (torch.ones_like(batch.edge_hop), batch.edge_mask)
            agg = hop_aggregate(x_src, *edges, 1 if self.parity_mode else self.num_hops,
                                num_dst=x.shape[0])
            aggs = (agg if halo else ax.psum(agg)).unbind(0)
        elif self.parity_mode:
            aggs = [fused_edge_aggregate(x, batch.fused_fwd, batch.fused_bwd, exact=cdt is None)]
        else:
            aggs = hop_aggregate(x, *edges, self.num_hops).unbind(0)
        parts = (x, *(a.to(x.dtype) for a in aggs))

        def proj(lin: Linear) -> torch.Tensor:
            w = lin.weight.T  # (in, out), one row block per part
            if cdt is not None:
                y = sum(mm32(p, w[i * D : (i + 1) * D], cdt) for i, p in enumerate(parts))
                return y.to(cdt) + lin.bias.to(cdt)
            return sum(p @ w[i * D : (i + 1) * D] for i, p in enumerate(parts)) + lin.bias

        h = self.act(proj(self.input_proj))
        global_skip = proj(self.global_skip_proj)
        for lin1, lin2 in self.mlp:
            skip = h
            h = lin2(dropout(self.act(lin1(h)), self.rate, generator)) + skip
        return h + global_skip
