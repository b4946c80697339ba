"""The port's losses (models/losses.py) against the JAX package's, with a
padding mask, on inputs made from a seed with numpy.  fp32 on both sides,
so the repo's fp32 bar applies: rtol 5e-4 / atol 5e-5 (both compute the
same elementwise formula and differ only in summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aimnet_x2d_tpu.models import losses as jax_losses
from aimnet_x2d_tpu_torch.models import losses

CASES = [
    ("l1", "regression", None),
    ("mse", "regression", None),
    ("evidential", "regression", None),
    ("l1", "multitask", [1.0, 0.5, 2.0]),
    ("mse", "multitask", [0.3, 1.0, 1.5]),
    ("evidential", "multitask", [1.0, 2.0, 0.25]),
    ("l1", "multitask", None),
]


@pytest.mark.parametrize("loss_type,task_type,weights", CASES)
def test_loss_matches_jax(loss_type, task_type, weights):
    rng = np.random.default_rng(len(loss_type) + (weights is not None))
    B, T = 11, 3
    width = 4 * T if loss_type == "evidential" else T
    preds = rng.normal(size=(B, width)).astype(np.float32)
    targets = rng.normal(size=(B, T)).astype(np.float32)
    mask = np.arange(B) < 8  # three padding rows
    preds[~mask] = 1e3  # padding must not leak into the loss
    ref = jax_losses.create_loss_function(loss_type, task_type, weights, lambda_reg=0.7)(
        jnp.asarray(preds), jnp.asarray(targets), jnp.asarray(mask))
    tp = torch.from_numpy(preds).requires_grad_(True)
    got = losses.create_loss_function(loss_type, task_type, weights, lambda_reg=0.7)(
        tp, torch.from_numpy(targets), torch.from_numpy(mask))
    print(f"{loss_type} {task_type}: port {float(got):.6f} jax {float(ref):.6f}")
    np.testing.assert_allclose(float(got), float(ref), rtol=5e-4, atol=5e-5)
    got.backward()
    assert torch.isfinite(tp.grad).all() and not tp.grad[~torch.from_numpy(mask)].any()


def test_unknown_loss_raises():
    with pytest.raises(ValueError):
        losses.create_loss_function("huber")
