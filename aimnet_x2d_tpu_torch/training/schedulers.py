"""Learning-rate controllers with torch scheduler semantics (counterpart of
aimnet_x2d_tpu/training/schedulers.py).

The optimizer takes the learning rate as data each step, so these are small
host-side controllers: call ``step(epoch, val_loss)`` after each epoch's
validation and read the returned rate.
"""

from __future__ import annotations

import math


class _Scheduler:
    _STATE_FIELDS = ("lr",)

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr

    def step(self, epoch: int, val_loss: float) -> float:
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {k: float(getattr(self, k)) for k in self._STATE_FIELDS}

    def load_state_dict(self, d: dict) -> None:
        for k in self._STATE_FIELDS:
            if k in d:
                setattr(self, k, d[k])


class ReduceLROnPlateau(_Scheduler):
    """torch ReduceLROnPlateau (mode=min, threshold=1e-4 relative,
    cooldown=0, min_lr=0)."""

    _STATE_FIELDS = ("lr", "best", "num_bad")

    def __init__(self, base_lr: float, factor: float = 0.5, patience: int = 10):
        super().__init__(base_lr)
        self.factor = factor
        self.patience = patience
        self.best = math.inf
        self.num_bad = 0

    def step(self, epoch: int, val_loss: float) -> float:
        if val_loss < self.best * (1.0 - 1e-4):
            self.best = val_loss
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr


class CosineAnnealing(_Scheduler):
    """torch CosineAnnealingLR with eta_min=0."""

    def __init__(self, base_lr: float, t_max: int = 10):
        super().__init__(base_lr)
        self.t_max = t_max

    def step(self, epoch: int, val_loss: float) -> float:
        self.lr = self.base_lr * (1 + math.cos(math.pi * (epoch + 1) / self.t_max)) / 2
        return self.lr


class StepDecay(_Scheduler):
    """torch StepLR."""

    def __init__(self, base_lr: float, step_size: int = 10, gamma: float = 0.1):
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma

    def step(self, epoch: int, val_loss: float) -> float:
        self.lr = self.base_lr * self.gamma ** ((epoch + 1) // self.step_size)
        return self.lr


class ExponentialDecay(_Scheduler):
    """torch ExponentialLR."""

    def __init__(self, base_lr: float, gamma: float = 0.95):
        super().__init__(base_lr)
        self.gamma = gamma

    def step(self, epoch: int, val_loss: float) -> float:
        self.lr = self.base_lr * self.gamma ** (epoch + 1)
        return self.lr


def create_scheduler(
    name: str,
    base_lr: float,
    *,
    lr_reduce_factor: float = 0.5,
    lr_patience: int = 10,
    lr_cosine_t_max: int = 10,
    lr_step_size: int = 10,
    lr_step_gamma: float = 0.1,
    lr_exp_gamma: float = 0.95,
) -> _Scheduler:
    name = (name or "ReduceLROnPlateau").lower()
    if name == "reducelronplateau":
        return ReduceLROnPlateau(base_lr, lr_reduce_factor, lr_patience)
    if name in ("cosineannealinglr", "cosine"):
        return CosineAnnealing(base_lr, lr_cosine_t_max)
    if name in ("steplr", "step"):
        return StepDecay(base_lr, lr_step_size, lr_step_gamma)
    if name in ("exponentiallr", "exponential"):
        return ExponentialDecay(base_lr, lr_exp_gamma)
    raise ValueError(f"Unsupported lr_scheduler: {name}")
