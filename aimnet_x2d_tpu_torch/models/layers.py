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


class LinearBlock(nn.Module):
    """Linear -> act -> (dropout) -> Linear, with an identity skip when the
    widths match.  Serving runs without dropout."""

    def __init__(self, in_features: int, features: int, activation_type: str = "silu",
                 use_skip: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear1 = Linear(in_features, features, dtype)
        self.linear2 = Linear(features, features, dtype)
        self.act = get_activation_function(activation_type)
        self.use_skip = use_skip and in_features == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.linear2(self.act(self.linear1(x)))
        if self.use_skip:
            out = out + x.to(out.dtype)
        return out


class MultiLayerPerceptron(nn.Module):
    """Stack of LinearBlocks: first and last blocks without skip."""

    def __init__(self, in_features: int, hidden_dim: int, output_dim: int, num_layers: int = 2,
                 activation_type: str = "silu", use_skip: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if num_layers == 1:
            blocks = [LinearBlock(in_features, output_dim, activation_type, False, dtype)]
        else:
            blocks = [LinearBlock(in_features, hidden_dim, activation_type, False, dtype)]
            blocks += [
                LinearBlock(hidden_dim, hidden_dim, activation_type, use_skip, dtype)
                for _ in range(num_layers - 2)
            ]
            blocks.append(LinearBlock(hidden_dim, output_dim, activation_type, False, dtype))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class ShellConvolutionLayer(nn.Module):
    """Parameter holder of one shell-convolution layer.

    The parameters have the JAX layer's full shapes: the input and skip
    projections take (K+1)*D inputs although, under quirk Q1 (union of
    hops), only the first 2D rows ever see data.  The layer's arithmetic
    runs in the fused stack (ops/bin_mp.py); :meth:`stack_weights` hands it
    the flat weight tuple."""

    def __init__(self, dim: int, num_hops: int = 3, num_mlp_layers: int = 2):
        super().__init__()
        in_dim = dim * (num_hops + 1)
        self.dim = dim
        self.input_proj = Linear(in_dim, dim)
        self.global_skip_proj = Linear(in_dim, dim)
        self.mlp = nn.ModuleList(
            nn.ModuleList([Linear(dim, dim), Linear(dim, dim)]) for _ in range(num_mlp_layers)
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
