"""Loss functions (counterpart of aimnet_x2d_tpu/models/losses.py).

Every loss is ``loss(preds, targets, graph_mask) -> scalar`` on padded
(B, .) tensors; ``graph_mask`` marks real molecules, so padding rows add
nothing and means run over real rows only.  As in the JAX package, the
unweighted l1/mse/evidential losses take the mean over ALL real elements,
and the weighted (multitask) forms sum over tasks and then take the mean
over molecules: the two differ by a factor of the number of tasks.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    # x: (B,) or (B, T); mask: (B,) in x's dtype
    if x.ndim == 2:
        total = (x * mask[:, None]).sum()
        count = mask.sum() * x.shape[1]
    else:
        total = (x * mask).sum()
        count = mask.sum()
    return total / torch.clamp(count, min=1.0)


def l1_loss(preds, targets, graph_mask):
    return _masked_mean((preds - targets).abs(), graph_mask.to(preds.dtype))


def mse_loss(preds, targets, graph_mask):
    return _masked_mean((preds - targets) ** 2, graph_mask.to(preds.dtype))


def _weighted(elementwise: Callable, weights: Sequence[float]) -> Callable:
    w32 = torch.tensor(list(weights), dtype=torch.float32)

    def loss(preds, targets, graph_mask):
        elem = elementwise(preds, targets) * w32.to(preds.device)
        return _masked_mean(elem.sum(dim=1), graph_mask.to(elem.dtype))

    return loss


def weighted_l1_loss(weights):
    return _weighted(lambda p, t: (p - t).abs(), weights)


def weighted_mse_loss(weights):
    return _weighted(lambda p, t: (p - t) ** 2, weights)


def evidential_params(outputs: torch.Tensor, num_tasks: int):
    """Raw (B, 4T) outputs -> constrained NIG parameters (gamma, nu, alpha,
    beta): nu = softplus + 1, alpha = softplus + 1, beta = softplus."""
    o = outputs.reshape(outputs.shape[0], num_tasks, 4)
    gamma = o[:, :, 0]
    nu = F.softplus(o[:, :, 1]) + 1.0
    alpha = F.softplus(o[:, :, 2]) + 1.0
    beta = F.softplus(o[:, :, 3])
    return gamma, nu, alpha, beta


def _evidential_elementwise(outputs, targets, lambda_reg):
    gamma, nu, alpha, beta = evidential_params(outputs, targets.shape[1])
    diff = targets - gamma
    nll = (
        0.5 * torch.log(math.pi / nu)
        - alpha * torch.log(2.0 * beta)
        + torch.lgamma(alpha)
        - torch.lgamma(alpha + 0.5)
        + (alpha + 0.5) * torch.log(beta + nu * diff**2 / 2.0)
    )
    return nll + lambda_reg * (2.0 * beta + alpha)


def evidential_loss(lambda_reg: float = 1.0):
    def loss(preds, targets, graph_mask):
        elem = _evidential_elementwise(preds, targets, lambda_reg)
        return _masked_mean(elem, graph_mask.to(elem.dtype))

    return loss


def weighted_evidential_loss(weights, lambda_reg: float = 1.0):
    return _weighted(lambda p, t: _evidential_elementwise(p, t, lambda_reg), weights)


def create_loss_function(
    loss_type: str,
    task_type: str = "regression",
    multitask_weights: Optional[Sequence[float]] = None,
    lambda_reg: float = 1.0,
) -> Callable:
    weighted = task_type == "multitask" and multitask_weights is not None
    if loss_type == "l1":
        return weighted_l1_loss(multitask_weights) if weighted else l1_loss
    if loss_type == "mse":
        return weighted_mse_loss(multitask_weights) if weighted else mse_loss
    if loss_type == "evidential":
        if weighted:
            return weighted_evidential_loss(multitask_weights, lambda_reg)
        return evidential_loss(lambda_reg)
    raise ValueError(
        f"Unsupported loss type: {loss_type}. Supported: ['l1', 'mse', 'evidential']"
    )
