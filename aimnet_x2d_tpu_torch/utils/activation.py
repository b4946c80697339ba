"""Activation factory (counterpart of aimnet_x2d_tpu/utils/activation.py).

- ``gelu`` is the exact (erf) form, torch's default.
- ``leakyrelu`` uses negative_slope 0.01.
- the default activation is silu.

On a bf16 tensor each function computes in fp32 and rounds once to bf16.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F

_ACTIVATIONS: dict[str, Callable] = {
    "relu": F.relu,
    "leakyrelu": partial(F.leaky_relu, negative_slope=0.01),
    "elu": F.elu,
    "gelu": partial(F.gelu, approximate="none"),
    "silu": F.silu,
}

# Codes shared with the CUDA kernels (csrc/mp_stack.cu ``act_fn``).
ACTIVATION_CODES: dict[str, int] = {
    "silu": 0, "relu": 1, "leakyrelu": 2, "elu": 3, "gelu": 4,
}


def get_activation_function(name: str = "silu") -> Callable:
    try:
        return _ACTIVATIONS[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unsupported activation: {name}. Supported: {sorted(_ACTIVATIONS)}"
        ) from None


def activation_grad(name: str, u: torch.Tensor) -> torch.Tensor:
    """Derivative of activation ``name`` at ``u``, computed in fp32 and
    rounded once to ``u``'s dtype (the kernels' ``act_grad``).  The
    piecewise activations compare in fp32, as the JAX kernels do."""
    name = name.lower()
    uf = u.float()
    if name == "silu":
        s = torch.sigmoid(uf)
        g = s * (1.0 + uf * (1.0 - s))
    elif name == "relu":
        g = (uf > 0).float()
    elif name == "leakyrelu":
        g = torch.where(uf >= 0, 1.0, 0.01)
    elif name == "elu":
        g = torch.where(uf > 0, torch.ones_like(uf), torch.exp(uf))
    elif name == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(uf * 0.7071067811865476))
        g = cdf + uf * 0.3989422804014327 * torch.exp(-0.5 * uf * uf)
    else:
        raise ValueError(f"Unsupported activation: {name}")
    return g.to(u.dtype)
