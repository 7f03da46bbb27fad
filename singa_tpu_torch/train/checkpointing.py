"""Checkpoints with save/restore symmetry (counterpart of
``singa_tpu/train/checkpointing.py``, which uses orbax).

One directory per step under the checkpoint root, ``<root>/<step>/``, with
``state.pt`` (step, model and optimizer state dicts, by ``torch.save``) and
``aux.json`` (scheduler and early-stopping state, the reason for the save).
At most ``max_to_keep`` steps are kept. A save writes into a temporary
directory and renames it, so a half-written checkpoint is never read.
Reading the JAX package's orbax checkpoints is not ported.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from typing import Optional

import torch
import yaml

from singa_tpu_torch.config import Config


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory) if d.isdigit())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
             aux: Optional[dict] = None) -> str:
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(
            {"step": step, "model": model.state_dict(), "optimizer": optimizer.state_dict()},
            os.path.join(tmp, "state.pt"),
        )
        with open(os.path.join(tmp, "aux.json"), "w") as f:
            json.dump(aux or {}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return final

    def restore(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer | None = None,
                step: int | None = None):
        """Load the checkpoint of ``step`` (default: the latest) into
        ``model`` (and ``optimizer``); returns ``(step, aux)``, or None when
        there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, str(step))
        device = next(model.parameters()).device
        state = torch.load(os.path.join(path, "state.pt"), map_location=device, weights_only=True)
        model.load_state_dict(state["model"])
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"])
        with open(os.path.join(path, "aux.json")) as f:
            aux = json.load(f)
        return state["step"], aux


def save_config(directory: str, cfg: Config) -> None:
    """Write the config and the code's provenance into the run directory:
    ``config.yml`` and ``provenance.json`` (package and torch versions, argv,
    git commit and a dirty-tree summary), as the JAX package does."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.yml"), "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
    with open(os.path.join(directory, "provenance.json"), "w") as f:
        json.dump(_provenance(), f, indent=1)


def _provenance() -> dict:
    import singa_tpu_torch

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    info: dict = {
        "singa_tpu_torch_version": getattr(singa_tpu_torch, "__version__", "unknown"),
        "torch_version": torch.__version__,
        "argv": sys.argv,
    }

    def _git(*args):
        res = subprocess.run(("git", "-C", repo) + args, capture_output=True, text=True, timeout=10)
        return res.stdout.strip() if res.returncode == 0 else ""

    try:
        info["git_commit"] = _git("rev-parse", "HEAD") or "unavailable: not a git checkout"
        dirty = _git("diff", "--stat", "HEAD")
        info["git_dirty"] = dirty.splitlines()[-1] if dirty else ""
    except (OSError, subprocess.SubprocessError) as e:  # no git on this machine
        info["git_commit"] = f"unavailable: {type(e).__name__}"
    return info
