"""Activation factory (counterpart of aimnet_x2d_tpu/utils/activation.py).

- ``gelu`` is the exact (erf) form, torch's default.
- ``leakyrelu`` uses negative_slope 0.01.
- the default activation is silu.

On a bf16 tensor each function computes in fp32 and rounds once to bf16.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

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
