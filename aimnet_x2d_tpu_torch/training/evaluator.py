"""Evaluation: batched forward, loss and regression metrics (counterpart of
aimnet_x2d_tpu/training/evaluator.py).

The loss is on the preprocessed scale; MAE / RMSE / R^2 are on predictions
and targets mapped back through the preprocessing pipeline.  For multitask
models each metric is the mean over tasks of the per-task value, and for
evidential models the gamma (mean) head is scored.  Metrics accumulate as
per-task sums (float64), so a split is never held whole in host memory.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..models.losses import create_loss_function


def compute_metrics(preds: np.ndarray, targets: np.ndarray, per_task: bool = True) -> Dict[str, Any]:
    """MAE / RMSE / R^2 with scikit-learn's conventions (R^2 of constant
    targets is 0); multitask values are means over tasks."""
    preds = np.asarray(preds, np.float64)
    targets = np.asarray(targets, np.float64)
    err = preds - targets

    def r2(p, t):
        ss_res = np.sum((t - p) ** 2)
        ss_tot = np.sum((t - t.mean(axis=0)) ** 2)
        return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0

    if preds.ndim == 2 and preds.shape[1] > 1:
        T = preds.shape[1]
        mae_t = [float(np.mean(np.abs(err[:, t]))) for t in range(T)]
        rmse_t = [float(np.sqrt(np.mean(err[:, t] ** 2))) for t in range(T)]
        r2_t = [r2(preds[:, t], targets[:, t]) for t in range(T)]
        out: Dict[str, Any] = {"mae": float(np.mean(mae_t)), "rmse": float(np.mean(rmse_t)),
                               "r2": float(np.mean(r2_t))}
        if per_task:
            out["per_task"] = {"mae": mae_t, "rmse": rmse_t, "r2": r2_t}
        return out
    return {"mae": float(np.mean(np.abs(err))), "rmse": float(np.sqrt(np.mean(err**2))),
            "r2": r2(preds, targets)}


class MetricAccumulator:
    """Per-task sufficient statistics for MAE / RMSE / R^2; the finalized
    numbers equal :func:`compute_metrics` on the concatenated arrays."""

    def __init__(self, num_tasks: int):
        self.n = 0.0
        self.abs_err = np.zeros(num_tasks, np.float64)
        self.sq_err = np.zeros(num_tasks, np.float64)
        self.t_sum = np.zeros(num_tasks, np.float64)
        self.t_sq = np.zeros(num_tasks, np.float64)

    def update(self, preds: np.ndarray, targets: np.ndarray) -> None:
        p = np.asarray(preds, np.float64)
        t = np.asarray(targets, np.float64)
        e = p - t
        self.n += len(p)
        self.abs_err += np.abs(e).sum(axis=0)
        self.sq_err += (e**2).sum(axis=0)
        self.t_sum += t.sum(axis=0)
        self.t_sq += (t**2).sum(axis=0)

    def finalize(self, per_task: bool = True) -> Dict[str, Any]:
        n = max(self.n, 1.0)
        mae_t = self.abs_err / n
        rmse_t = np.sqrt(self.sq_err / n)
        ss_tot = self.t_sq - self.t_sum**2 / n
        r2_t = np.where(ss_tot > 0, 1.0 - self.sq_err / np.where(ss_tot > 0, ss_tot, 1.0), 0.0)
        out: Dict[str, Any] = {"mae": float(mae_t.mean()), "rmse": float(rmse_t.mean()),
                               "r2": float(r2_t.mean())}
        if per_task and len(mae_t) > 1:
            out["per_task"] = {"mae": [float(v) for v in mae_t],
                               "rmse": [float(v) for v in rmse_t],
                               "r2": [float(v) for v in r2_t]}
        return out


def evaluate(
    model,
    loader,
    device: "str | torch.device",
    *,
    config=None,
    loss_fn: Optional[Callable] = None,
    pipeline=None,
    grid=None,
) -> Dict[str, Any]:
    """Loss (preprocessed scale, mean over real molecules) and metrics
    (inverse-transformed scale) of ``model`` over ``loader`` on ``device``,
    with the serving forward (no dropout).  Over a rank grid (``grid``,
    parallel/mesh.py) the loader is the whole, unsharded split, as in the
    JAX runner: rank 0 evaluates it and every rank returns rank 0's
    metrics."""
    if grid is not None and grid.size > 1:
        from ..parallel.multihost import broadcast_pyobj

        metrics = evaluate(model, loader, device, config=config, loss_fn=loss_fn,
                           pipeline=pipeline) if grid.rank == 0 else None
        return broadcast_pyobj(metrics)
    if loss_fn is None:
        loss_fn = create_loss_function(config.loss_function, config.task_type,
                                       config.multitask_weights,
                                       lambda_reg=getattr(config, "evidential_lambda", 1.0))
    acc: Optional[MetricAccumulator] = None
    loss_sum, n_sum = 0.0, 0
    with torch.inference_mode():
        for batch in loader:
            preds = model(batch.to(device)).predictions.float().cpu().numpy()
            mask = np.asarray(batch.graph_mask)
            p, t = preds[mask], np.asarray(batch.targets)[mask]
            n = len(p)
            if n == 0:
                continue
            loss_sum += n * float(loss_fn(torch.from_numpy(p), torch.from_numpy(t),
                                          torch.ones(n, dtype=torch.bool)))
            n_sum += n
            T = t.shape[1]
            pm = p.reshape(n, T, 4)[:, :, 0] if p.shape[1] == 4 * T else p
            if pipeline is not None:
                pm = pipeline.inverse_transform(pm)
                t = pipeline.inverse_transform(t)
            if acc is None:
                acc = MetricAccumulator(T)
            acc.update(pm, t)
    metrics = acc.finalize() if acc is not None else {"mae": 0.0, "rmse": 0.0, "r2": 0.0}
    metrics["loss"] = loss_sum / max(n_sum, 1)
    return metrics
