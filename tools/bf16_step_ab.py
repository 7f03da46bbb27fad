"""The bfloat16 training step (``configs/train.yml``: Config()'s path at its
own bfloat16) of several checkouts of the port, each run in a process of its
own on one card: the host time of timed steps after a warm-up, and of one
more step under torch.profiler its device busy time, idle share and K3's and
K3b's kernels by name (``chip_smoke.py``'s ``device_profile`` and
``ClockSampler``). Give the checkouts in alternation (A B B A) to compare
them within one call, on one card at one clock.

    python3 tools/bf16_step_ab.py <checkout> [<checkout> ...] [--steps 3]
        [--out f.json]

A checkout is a directory that holds ``singa_tpu_torch/`` (``git archive``
of a commit, say); ``data/``, ``configs/`` and ``chip_smoke.py`` are this
one's. Each builds its own kernels under its own ``build/``. Prints the
card's name and power limit, then one JSON line a run. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = r'''
import json, os, statistics, sys, tempfile, time
root, here, steps = os.path.abspath(sys.argv[1]), sys.argv[2], int(sys.argv[3])
sys.path[:0] = [root, here]
import torch
import chip_smoke as cs
from singa_tpu_torch.config import load_config
from singa_tpu_torch.data.dataset import BucketedNpzDataset
from singa_tpu_torch.data.pipeline import Prefetcher
from singa_tpu_torch.ops.cuda import build
from singa_tpu_torch.train.loop import Trainer

assert build.__file__.startswith(root), build.__file__
t0 = time.perf_counter()
build.build_all()
build_s = time.perf_counter() - t0
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
cfg = load_config(os.path.join(here, "configs", "train.yml"))
assert cfg.train.compute_dtype == "bfloat16", cfg.train.compute_dtype
k3 = ("s2_silu_sep_tc_kernel", "s2_silu_sep_bwd_tc_kernel", "cc::s2_silu_sep")
with tempfile.TemporaryDirectory() as tmp:
    trainer = Trainer(cfg, logdir=tmp, device=dev)
    data = Prefetcher(BucketedNpzDataset(os.path.join(here, "data", "corpus", "train"),
                                         cfg.train.batch_size, seed=0), depth=2, device=dev)
    batch = next(iter(data))
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(batch)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with cs.ClockSampler() as clocks:
        prof = cs.device_profile(lambda: trainer.train_step(batch), k3)
    data.close()
print(json.dumps({"build_s": build_s, "step_ms": times, "median_step_ms": statistics.median(times),
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "device_busy_ms": prof["device_busy_ms"], "idle_share": prof["idle_share"],
                  "profiled_wall_ms": prof["wall_ms"], "device_ops": prof["device_ops"],
                  "k3_kernels": prof["matched"], "top": prof["top"][:8],
                  "clocks": clocks.report}))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for checkout in a.checkouts:
        r = subprocess.run([sys.executable, "-c", CHILD, checkout, ROOT, str(a.steps)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"{checkout} failed:\n{r.stderr[-3000:]}")
        runs.append({"checkout": checkout, **json.loads(r.stdout.strip().splitlines()[-1])})
        print(json.dumps(runs[-1]), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"device": smi, "runs": runs}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
