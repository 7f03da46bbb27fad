"""Optimizer and learning-rate schedule (counterpart of
``singa_tpu/train/optim.py``; reference utils/misc.py:43-125, 226-272).

Adam with the reference's betas (0.99, 0.999) as ``torch.optim.Adam`` (or
``AdamW`` when a weight decay is set), optional clipping to a global gradient
norm, and the host-side plateau controller and early stopping, stepped at
validation time and saved in checkpoints. The learning rate lives in the
optimizer's parameter groups.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Iterable

import torch

from singa_tpu_torch.config import OptimizerConfig, SchedulerConfig


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: OptimizerConfig) -> torch.optim.Optimizer:
    """Adam (eps 1e-8, as optax's), decoupled weight decay when set. Clipping
    is ``clip_by_global_norm_``, applied by the caller before ``step``."""
    kw = dict(lr=cfg.lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    if cfg.weight_decay:
        return torch.optim.AdamW(params, weight_decay=cfg.weight_decay, **kw)
    return torch.optim.Adam(params, **kw)


def global_norm(params: Iterable[torch.nn.Parameter]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (``optax.global_norm``)."""
    sq = [(p.grad.to(torch.float32) ** 2).sum() for p in params if p.grad is not None]
    return torch.sqrt(torch.stack(sq).sum())


def clips(cfg: OptimizerConfig) -> bool:
    return bool(cfg.max_grad_norm) and math.isfinite(cfg.max_grad_norm)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float, norm: torch.Tensor) -> None:
    """Scale every gradient by ``max_norm / norm`` when ``norm`` exceeds it,
    as ``optax.clip_by_global_norm`` does (no epsilon in the ratio)."""
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for p in params:
        if p.grad is not None:
            p.grad.mul_(scale.to(p.grad.dtype))


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclass
class PlateauState:
    """ReduceLROnPlateau (reference misc.py:238-272 'plateau' type, torch
    semantics: factor, patience, min_lr) with optional linear warmup
    ('warmup_plateau', misc.py:43-103)."""

    cfg: SchedulerConfig
    best: float = float("inf")
    bad_epochs: int = 0
    lr: float = 0.0
    base_lr: float = 0.0

    @classmethod
    def create(cls, cfg: SchedulerConfig, base_lr: float) -> "PlateauState":
        return cls(cfg=cfg, lr=base_lr, base_lr=base_lr)

    def warmup_lr(self, step: int) -> float:
        """LR for a given step during warmup (1-indexed steps)."""
        if self.cfg.warmup_iters and step <= self.cfg.warmup_iters:
            return self.base_lr * step / self.cfg.warmup_iters
        return self.lr

    def step_schedule(self, step: int) -> "PlateauState":
        """Non-plateau schedules stepped per validation: 'expmin' decays
        exponentially toward min_lr (reference misc.py:107-125)."""
        if self.cfg.type not in ("expmin", "expmin_milestone"):
            return self
        new = dataclasses.replace(self)
        new.lr = max(self.lr * self.cfg.factor, self.cfg.min_lr)
        return new

    def step_metric(self, metric: float) -> "PlateauState":
        """Validation-time update; returns the new state."""
        new = dataclasses.replace(self)
        if metric < self.best - 1e-12:
            new.best = metric
            new.bad_epochs = 0
        else:
            new.bad_epochs = self.bad_epochs + 1
            if new.bad_epochs > self.cfg.patience:
                new.lr = max(self.lr * self.cfg.factor, self.cfg.min_lr)
                new.bad_epochs = 0
        return new

    def to_dict(self) -> dict:
        return {"best": self.best, "bad_epochs": self.bad_epochs, "lr": self.lr,
                "base_lr": self.base_lr}

    @classmethod
    def from_dict(cls, cfg: SchedulerConfig, d: dict) -> "PlateauState":
        return cls(cfg=cfg, **d)


@dataclass
class EarlyStopping:
    """Min-mode early stopping with delta (reference utils/Stopping.py:3-42);
    unlike the reference's loop (train.py:240-242), the trainer stops."""

    patience: int = 20
    delta: float = 5e-5
    best: float = float("inf")
    counter: int = 0
    should_stop: bool = False

    def update(self, metric: float) -> bool:
        """Returns True if this metric is an improvement."""
        if metric < self.best - self.delta:
            self.best = metric
            self.counter = 0
            return True
        self.counter += 1
        if self.counter >= self.patience:
            self.should_stop = True
        return False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EarlyStopping":
        return cls(**d)
