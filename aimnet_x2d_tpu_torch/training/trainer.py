"""Training loop (counterpart of aimnet_x2d_tpu/training/trainer.py).

One train step is: the training forward (``GNN.forward(train=True)``,
dropout on) -> loss on the real molecules -> backward through the kernels'
autograd functions -> global-norm clip -> Adam -> parameters updated in
place, as the JAX step's ``value_and_grad -> optax.clip_by_global_norm ->
optax.scale_by_adam -> scale(-lr)``:

- the clip is optax's: when the global norm exceeds ``grad_clip`` every
  gradient is scaled by ``grad_clip / norm``, and nothing changes otherwise
  (``torch.nn.utils.clip_grad_norm_`` differs: it always rescales, by
  ``max / (norm + 1e-6)``);
- Adam is optax's ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8 added
  after the square root, both moments bias-corrected), and the learning
  rate is applied as data, so the host-side schedulers change it freely.

``train`` runs the epochs: shuffled training batches (a new order every
epoch), validation, the LR scheduler, early stopping, and a copy of the
best parameters, restored at the end.  Transfer learning, freeze masks,
layer-wise LR decay, checkpoint/resume, trackers and multi-device steps are
later slices of the port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.batching import MolBatch
from ..models.gnn import GNN
from ..models.losses import create_loss_function
from .evaluator import evaluate
from .schedulers import create_scheduler


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 50
    learning_rate: float = 0.00025
    loss_function: str = "l1"
    task_type: str = "regression"
    multitask_weights: Optional[Sequence[float]] = None
    evidential_lambda: float = 1.0
    grad_clip: float = 1.0
    early_stopping: bool = False
    patience: int = 25
    lr_scheduler: str = "ReduceLROnPlateau"
    lr_reduce_factor: float = 0.5
    lr_patience: int = 10
    lr_cosine_t_max: int = 10
    lr_step_size: int = 10
    lr_step_gamma: float = 0.1
    lr_exp_gamma: float = 0.95


@dataclasses.dataclass
class TrainResult:
    state_dict: Dict[str, torch.Tensor]  # the best epoch's parameters (a copy)
    best_val_loss: float
    best_epoch: int
    history: List[Dict[str, float]]
    avg_epoch_seconds: float


class Optimizer:
    """Global-norm clip, then Adam, with optax's arithmetic (see the module
    docstring).  ``step(lr)`` updates every parameter that has a gradient;
    a parameter that never gets one (the dead parameters kept for
    checkpoint parity) keeps zero moments and never moves, as under optax."""

    def __init__(self, params: Sequence[torch.nn.Parameter], grad_clip: float = 1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.grad_clip, self.b1, self.b2, self.eps = grad_clip, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def clip(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """optax.clip_by_global_norm in place; returns the global norm."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.grad_clip is not None:
            # g * (max / norm) where norm >= max, else g exactly; no host sync
            factor = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            torch._foreach_mul_(grads, factor)
        return norm

    @torch.no_grad()
    def step(self, lr: float) -> torch.Tensor:
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        params = [self.params[i] for i in live]
        grads = [self.params[i].grad for i in live]
        mu = [self.mu[i] for i in live]
        nu = [self.nu[i] for i in live]
        norm = self.clip(grads)
        self.count += 1
        # mu = (1 - b1) g + b1 mu ; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - self.b2))
        c1 = float(1.0 - np.float32(self.b1) ** np.float32(self.count))
        c2 = float(1.0 - np.float32(self.b2) ** np.float32(self.count))
        mu_hat = torch._foreach_div(mu, c1)
        nu_hat = torch._foreach_div(nu, c2)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        return norm


def make_loss_fn(config: TrainConfig) -> Callable:
    return create_loss_function(config.loss_function, config.task_type, config.multitask_weights,
                                lambda_reg=config.evidential_lambda)


def train_step(model: GNN, optimizer: Optimizer, batch: MolBatch, lr: float, loss_fn: Callable,
               drop_seed: Optional[int] = None, generator: Optional[torch.Generator] = None):
    """One step on a batch already on the model's device.  Returns the loss
    (a 0-d tensor, still on the device; reading it syncs)."""
    optimizer.zero_grad()
    out = model(batch, train=True, drop_seed=drop_seed, generator=generator)
    loss = loss_fn(out.predictions, batch.targets, batch.graph_mask)
    loss.backward()
    optimizer.step(lr)
    return loss.detach()


def train(
    model: GNN,
    train_loader,
    val_loader,
    config: TrainConfig,
    *,
    device: "str | torch.device" = "cuda",
    seed: int = 0,
    pipeline=None,
) -> TrainResult:
    """Epoch loop with validation, LR scheduling, early stopping and
    best-parameter restore.  ``model`` is on ``device``; ``seed`` seeds the
    dropout generators (the stack's per-step seed is drawn on the host, the
    FFN's masks on the device)."""
    device = torch.device(device)
    optimizer = Optimizer(model.parameters(), config.grad_clip)
    loss_fn = make_loss_fn(config)
    scheduler = create_scheduler(
        config.lr_scheduler, config.learning_rate,
        lr_reduce_factor=config.lr_reduce_factor, lr_patience=config.lr_patience,
        lr_cosine_t_max=config.lr_cosine_t_max, lr_step_size=config.lr_step_size,
        lr_step_gamma=config.lr_step_gamma, lr_exp_gamma=config.lr_exp_gamma,
    )
    host_gen = torch.Generator().manual_seed(seed)
    dev_gen = torch.Generator(device=device).manual_seed(seed)
    best_val, best_epoch = float("inf"), -1
    best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    epochs_no_improve = 0
    history: List[Dict[str, Any]] = []
    lr = config.learning_rate
    epoch_times: List[float] = []

    for epoch in range(config.epochs):
        t0 = time.time()
        train_loader.set_epoch(epoch)
        model.train()
        losses, counts = [], []
        for batch in train_loader:
            n = int(batch.graph_mask.sum())
            drop_seed = int(torch.randint(-(2**31), 2**31 - 1, (1,), generator=host_gen))
            loss = train_step(model, optimizer, batch.to(device), lr, loss_fn, drop_seed, dev_gen)
            losses.append(loss)
            counts.append(n)
        # one read per epoch, not one sync per step
        step_losses = torch.stack(losses).float().cpu().numpy() if losses else np.zeros(0)
        train_loss = float((step_losses * np.asarray(counts)).sum() / max(sum(counts), 1))
        model.eval()
        val_metrics = evaluate(model, val_loader, device, loss_fn=loss_fn, pipeline=pipeline)
        val_loss = val_metrics["loss"]
        lr = scheduler.step(epoch, val_loss)
        seconds = time.time() - t0
        epoch_times.append(seconds)
        record = {"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss, "lr": lr,
                  "seconds": seconds,
                  **{f"val_{k}": v for k, v in val_metrics.items()
                     if k != "loss" and not isinstance(v, dict)}}
        history.append(record)
        print(f"[epoch {epoch:3d}] train {train_loss:.5f}  val {val_loss:.5f}  "
                  f"lr {lr:.2e}  ({seconds:.1f}s)", flush=True)
        if val_loss < best_val:
            best_val, best_epoch = val_loss, epoch
            best_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
            epochs_no_improve = 0
        else:
            epochs_no_improve += 1
        if config.early_stopping and epochs_no_improve >= config.patience and val_loss >= best_val:
            print(f"[early stop] epoch {epoch}, best {best_val:.5f} @ {best_epoch}")
            break

    model.load_state_dict(best_state)
    return TrainResult(
        state_dict=best_state,
        best_val_loss=best_val,
        best_epoch=best_epoch,
        history=history,
        avg_epoch_seconds=float(np.mean(epoch_times)) if epoch_times else 0.0,
    )
