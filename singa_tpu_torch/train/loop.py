"""The training loop: the optimizer step with microbatch accumulation,
validation, warm-up and plateau learning rate, early stopping,
checkpointing, metrics (counterpart of ``singa_tpu/train/loop.py``;
reference train.py).

The step runs the full SINGA forward (both embedding stages, the kNN encoder,
Encoder2 and the teacher-forced decoder), the token cross-entropy, the
backward through the hand-written kernels and one Adam update, with TF32
off, at the config's ``train.compute_dtype``: float32, or bfloat16 as the
JAX package's mixed precision (``singa_tpu_torch/dtypes.py``: parameters,
geometry, Adam state and checkpoints float32, network compute bfloat16,
weight gradients float32). bfloat16 runs where every kernel of the path has
a bfloat16 instance: the gate FFN (K2/K2b) or the s2 FFN (K4/K4b, at lmax
1..6 and up to 16 sphere channels), the separable S2 attention (K3/K3b)
and the encoder attention in any of its forms (K1/K1b; K7/K7b under
``SINGA_TPU_HYBRID_ATTN``, K8/K8b under ``SINGA_TPU_DENSE_ATTN``):
``Config()``'s path and ``configs/train_corpus.yml``'s, with either
switch. The JAX package's data-parallel mesh is
not ported; one process trains on one device.

CLI: python -m singa_tpu_torch.train.loop --data data/corpus --max-iters 2
[--config configs/train.yml]. The CLI keeps a config's bfloat16 on those
paths and runs any other path in float32 (``training_config``), printing
which; ``Trainer`` itself refuses bfloat16 off them, and float16, as the
adversarial trainer does (``train/gan.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import threading
import time
from typing import Optional

import numpy as np
import torch

from singa_tpu_torch.config import Config, load_config
from singa_tpu_torch.data.batch import ComplexBatch
from singa_tpu_torch.data.dataset import BucketedNpzDataset, SyntheticDataset
from singa_tpu_torch.data.pipeline import Prefetcher
from singa_tpu_torch.dtypes import compute_dtype_scope
from singa_tpu_torch.models.singa import SINGA, cross_entropy_loss
from singa_tpu_torch.ops.cuda.so3_ffn import s2_bf16_takes
from singa_tpu_torch.train.checkpointing import CheckpointManager, save_config
from singa_tpu_torch.train.optim import (
    EarlyStopping,
    PlateauState,
    clip_by_global_norm_,
    clips,
    get_learning_rate,
    global_norm,
    make_optimizer,
    set_learning_rate,
)


class MetricsWriter:
    """One JSON object per line in ``<logdir>/metrics.jsonl``."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a")

    def write(self, step: int, **scalars):
        self._f.write(json.dumps({"step": step, "time": time.time(), **scalars}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def float32_config(cfg: Config) -> Config:
    """``cfg`` with float32 compute."""
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype="float32"))


def bf16_blockers(config: Config) -> list[str]:
    """The kernels without a bfloat16 instance that training ``config``
    runs (K4/K4b at the s2 FFN's widths, if their bfloat16 instances do not
    take them), with the option that selects them; empty on the paths that
    train in bfloat16 (every other kernel, K6/K6b under
    ``SINGA_TPU_FUSED_SO2`` included, has one)."""
    emb = config.embedding
    out = []
    C = emb.sphere_channels
    if emb.ffn_activation == "s2" and not s2_bf16_takes(emb.lmax, C, C):
        out.append(f"K4/K4b at lmax {emb.lmax}, {C} sphere channels (ffn_activation: s2; "
                   "their bfloat16 instances take lmax 1..6 and 4..16 channels, a multiple "
                   "of 4)")
    return out


def check_precision(config: Config) -> None:
    """Raise unless the port trains ``config`` at its precision: float32
    parameters, and float32 compute, or bfloat16 where every kernel of the
    path has a bfloat16 instance (``bf16_blockers``)."""
    tc = config.train
    if tc.param_dtype != "float32" or tc.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"compute_dtype {tc.compute_dtype!r} / param_dtype {tc.param_dtype!r}: the port "
            "trains float32 parameters in float32 or bfloat16 compute only"
        )
    blockers = bf16_blockers(config) if tc.compute_dtype == "bfloat16" else []
    if blockers:
        raise ValueError(
            f"compute_dtype 'bfloat16': this path trains in float32 only; "
            f"{', '.join(blockers)} have no bfloat16 instance yet (ROADMAP, Queue 1 item 2: "
            "bf16 training)"
        )


def training_config(cfg: Config) -> tuple[Config, str]:
    """The CLI's precision: ``cfg`` as it is where ``check_precision`` takes
    it, else with float32 compute; and the line that says which."""
    tc = cfg.train
    blockers = bf16_blockers(cfg) if tc.compute_dtype == "bfloat16" else []
    if tc.compute_dtype == "float32" or (tc.compute_dtype == "bfloat16" and not blockers):
        return cfg, f"train.compute_dtype={tc.compute_dtype}"
    why = f": {', '.join(blockers)} have no bfloat16 instance yet" if blockers else ""
    return float32_config(cfg), (
        f"train.compute_dtype=float32 (the port trains this path in float32, not in the "
        f"config's {tc.compute_dtype}{why}; ROADMAP, Queue 1 item 2)"
    )


class Trainer:
    def __init__(self, config: Config, logdir: str = "runs/default", device="cuda"):
        check_precision(config)
        tc = config.train
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device cuda asked for, but CUDA is not available")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.logdir = logdir
        self.model = SINGA(config, device=self.device, seed=tc.seed)
        self.params = list(self.model.parameters())
        self.optimizer = make_optimizer(self.params, tc.optimizer)
        self.metrics = MetricsWriter(logdir)
        self.ckpt = CheckpointManager(os.path.join(logdir, "checkpoints"))
        save_config(logdir, config)
        self.sched = PlateauState.create(tc.scheduler, tc.optimizer.lr)
        self.stopper = EarlyStopping(patience=tc.early_stop_patience, delta=tc.early_stop_delta)
        self.step = 0
        self._initialised = False
        self._preempted = False
        if threading.current_thread() is threading.main_thread():
            signal.signal(signal.SIGTERM, self._on_sigterm)

    # ------------- steps -------------

    def loss(self, batch: ComplexBatch) -> torch.Tensor:
        return cross_entropy_loss(self.model(batch), batch.tokens.target)

    def train_step(self, batch: ComplexBatch):
        """One optimizer step on ``batch`` (on the model's device). With
        ``train.microbatch`` set, the batch runs in equal microbatches whose
        losses and gradients are averaged: the same update at bounded
        memory. Returns (loss, global gradient norm before clipping), as
        0-d tensors on the device."""
        self.model.train()
        b = batch.batch_size
        micro = self.config.train.microbatch
        k = 1 if not micro or micro >= b else b // micro
        if b % k:
            raise ValueError(f"batch {b} is not a multiple of microbatch {micro}")
        self.optimizer.zero_grad(set_to_none=True)
        total = torch.zeros((), device=self.device)
        for i in range(k):
            mb = batch if k == 1 else batch.rows(i * micro, (i + 1) * micro)
            with compute_dtype_scope(self.config.train.compute_dtype):
                loss = self.loss(mb)
                (loss / k).backward()
            total = total + loss.detach()
        gnorm = global_norm(self.params)
        ocfg = self.config.train.optimizer
        if clips(ocfg):
            clip_by_global_norm_(self.params, ocfg.max_grad_norm, gnorm)
        self.optimizer.step()
        return total / k, gnorm

    @torch.no_grad()
    def eval_step(self, batch: ComplexBatch) -> torch.Tensor:
        self.model.eval()
        with compute_dtype_scope(self.config.train.compute_dtype):
            return self.loss(batch)

    def validate(self, dataset) -> float:
        losses = [float(self.eval_step(b.to(self.device))) for b in dataset.epoch()]
        return float(np.mean(losses)) if losses else float("nan")

    # ------------- state -------------

    def init_state(self) -> int:
        """Resume from the latest checkpoint under the logdir, if any;
        returns the step."""
        restored = self.ckpt.restore(self.model, self.optimizer)
        if restored is not None:
            self.step, aux = restored
            self.sched = PlateauState.from_dict(
                self.config.train.scheduler, aux.get("scheduler", self.sched.to_dict())
            )
            self.stopper = EarlyStopping.from_dict(aux.get("early_stop", self.stopper.to_dict()))
        self._initialised = True
        return self.step

    def num_params(self) -> int:
        return sum(p.numel() for p in self.params)

    def save(self, reason: str = "step"):
        aux = {"scheduler": self.sched.to_dict(), "early_stop": self.stopper.to_dict(),
               "reason": reason}
        self.ckpt.save(self.step, self.model, self.optimizer, aux)

    def _on_sigterm(self, *_):
        self._preempted = True

    # ------------- loop -------------

    def fit(self, train_data, val_data=None, test_data=None, max_iters: Optional[int] = None,
            log_every: int = 10):
        cfg = self.config.train
        max_iters = max_iters or cfg.max_iters
        if not self._initialised:
            self.init_state()
        it = iter(train_data)
        t_last = time.time()
        start_step = self.step
        loss = torch.tensor(float("nan"))
        while self.step < max_iters:
            self.step += 1
            set_learning_rate(self.optimizer, self.sched.warmup_lr(self.step))
            batch = next(it).to(self.device)
            loss, gnorm = self.train_step(batch)

            if self.step % log_every == 0 or self.step == start_step + 1:
                loss_val = float(loss)  # waits for the queued steps
                dt = time.time() - t_last
                n = log_every if self.step > start_step + 1 else 1
                self.metrics.write(
                    self.step,
                    **{
                        "train/loss": loss_val,
                        "train/grad": float(gnorm),
                        "train/lr": get_learning_rate(self.optimizer),
                        "train/graphs_per_sec": batch.batch_size * n / max(dt, 1e-9),
                    },
                )
                t_last = time.time()

            if val_data is not None and (self.step % cfg.val_freq == 0 or self.step == max_iters):
                val_loss = self.validate(val_data)
                if cfg.scheduler.type in ("plateau", "warmup_plateau"):
                    self.sched = self.sched.step_metric(val_loss)
                else:
                    self.sched = self.sched.step_schedule(self.step)
                improved = self.stopper.update(val_loss)
                self.metrics.write(self.step, **{"val/loss": val_loss, "val/improved": int(improved)})
                if self.step % cfg.ckpt_every == 0 and self.step > cfg.ckpt_after:
                    self.save()
                if test_data is not None:
                    self.metrics.write(self.step, **{"val/loss2": self.validate(test_data)})
                if self.stopper.should_stop:
                    self.metrics.write(self.step, **{"train/early_stop": 1})
                    break

            if self._preempted:
                self.save(reason="preempted")
                break

        self.save(reason="final")
        return float(loss)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--logdir", type=str, default="runs/train")
    ap.add_argument("--data", type=str, default=None, help=".npz shard directory")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument(
        "--timestamped", action="store_true",
        help="append a timestamp to --logdir (reference get_new_log_dir, misc.py:168)",
    )
    args = ap.parse_args(argv)
    if args.timestamped:
        args.logdir = f"{args.logdir}_{time.strftime('%Y_%m_%d__%H_%M_%S')}"

    cfg, precision = training_config(load_config(args.config) if args.config else Config())
    print(f"config: {args.config or 'Config()'} with {precision}")
    bs = args.batch_size or cfg.train.batch_size

    if args.synthetic or not args.data:
        tgt = cfg.model.decoder.tgt_len
        train_data = SyntheticDataset(bs, cfg.shapes, tgt, seed=0)
        val_data = SyntheticDataset(bs, cfg.shapes, tgt, seed=100, num_distinct=2)
    else:
        train_data = BucketedNpzDataset(os.path.join(args.data, "train"), bs)
        val_dir = os.path.join(args.data, "val")
        # a corpus without a val split validates on train (an overfit anchor)
        val_data = BucketedNpzDataset(
            val_dir if os.path.isdir(val_dir) else os.path.join(args.data, "train"), bs,
            shuffle=False,
        )
    train_data = Prefetcher(train_data, depth=2, device=args.device)

    trainer = Trainer(cfg, logdir=args.logdir, device=args.device)
    trainer.init_state()
    print(f"params: {trainer.num_params() / 1e6:.2f}M  device: {trainer.device}")
    loss = trainer.fit(train_data, val_data, max_iters=args.max_iters)
    train_data.close()
    print(f"final loss: {loss:.4f}")


if __name__ == "__main__":
    main()
