"""K4·bf16, K4b·bf16, K6·bf16, K6b·bf16 and K8b·bf16 of several checkouts of
the port, and the three bfloat16 training steps that run them, each
checkout in a process of its own on one card: each kernel's time by CUDA
events (the median of 10 launches after 2 of warm-up) at a training
microbatch's calls (K4 and K4b: configs/train_corpus.yml's 14,336 nodes,
lmax 6, C = Co = 16, H 512, G 210; K6 and K6b: the default Config's widths
at the stage-1 and stage-2 edges, 31,744 and 7,936), inputs made from a
seed; K8b·bf16 at every distinct call of one step of configs/train.yml
under SINGA_TPU_DENSE_ATTN on the first batch of data/corpus/train
(captured as ``chip_smoke.py`` captures them; ``k8b_bf16_ms`` weighted by
the calls, ``k8b_bf16_calls`` each distinct call's time and count); then,
unless ``--steps 0``, ``train_s2_bf16`` (configs/train_corpus.yml),
``train_so2_bf16`` (configs/train.yml under SINGA_TPU_FUSED_SO2) and
``train_dense_bf16`` (configs/train.yml under SINGA_TPU_DENSE_ATTN): the
host time of timed steps after a warm-up step and one more step under
torch.profiler, its device busy time, idle share and the path's kernels by
name (``chip_smoke.py``'s ``device_profile``). Give the checkouts in
alternation (A B B A) to compare them within one call, on one card at one
clock.

    python3 tools/bf16_kernels_ab.py <checkout> [<checkout> ...] [--steps 2]
        [--out f.json]

A checkout is a directory that holds ``singa_tpu_torch/`` (``git archive``
of a commit, say); ``data/`` and ``configs/`` are this one's. Each builds
its own kernels under its own ``build/``. Prints the card's name and power
limit, then one JSON line a run. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = r'''
import contextlib, json, os, statistics, sys, tempfile, time
root, here, steps = os.path.abspath(sys.argv[1]), sys.argv[2], int(sys.argv[3])
sys.path[:0] = [root, here]
import numpy as np
import torch
import chip_smoke as cs
from singa_tpu_torch.config import load_config
from singa_tpu_torch.data.dataset import BucketedNpzDataset
from singa_tpu_torch.data.pipeline import Prefetcher
from singa_tpu_torch.equivariant.layers import _grid_mats_for
from singa_tpu_torch.ops.cuda import build
from singa_tpu_torch.ops.cuda import so2_attn as k6
from singa_tpu_torch.ops.cuda import so3_ffn as k4
from singa_tpu_torch.ops.cuda.so2_attn import sections
from singa_tpu_torch.train.loop import Trainer

assert build.__file__.startswith(root), build.__file__
t0 = time.perf_counter()
build.build_all()
out = {"build_s": time.perf_counter() - t0}
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
rng = np.random.default_rng(11)
f = lambda *s, sc=1.0, dt=torch.float32: torch.as_tensor(
    (sc * rng.normal(size=s)).astype(np.float32)).to(dev, dt)
bf = torch.bfloat16


def ms(fn):
    for _ in range(2):
        fn()
    times = []
    for _ in range(10):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# K4b·bf16 at the s2 training microbatch's call
N, lmax, C, H = 14336, 6, 16, 512
L = lmax + 1
w = [f(L, C, H, sc=0.2), f(H, sc=0.1), f(C, H, sc=0.2), f(H, sc=0.1), f(L, H, C, sc=0.1)]
tg, fg = (torch.as_tensor(m).to(dev, bf) for m in _grid_mats_for(lmax, lmax, False))
x, dy = f(N, L * L, C, dt=bf), f(N, L * L, C, dt=bf)
out["k4b_bf16_ms"] = ms(lambda: k4.so3_ffn_bwd_cuda(x, *w, tg, fg, lmax, dy))
b2 = f(C, sc=0.1)
out["k4_bf16_ms"] = ms(lambda: k4.so3_ffn_cuda(x, *w, b2, tg, fg, lmax))
del x, dy, w, b2
# K6·bf16 and K6b·bf16 at the default Config's stage-1 and stage-2 calls
C, H, F2, alpha = 32, 128, 112, 224
secs, extra = sections(6, 2), alpha + H
tg, fg = (torch.as_tensor(m).to(dev) for m in _grid_mats_for(6, 2, True))
w1s = [f(r * C, r * H + (extra if i == 0 else 0), sc=0.1) for i, r in enumerate(secs)]
w2s = [f(r * H, r * F2, sc=0.05) for r in secs]
b1, b2 = f(secs[0] * H + extra, sc=0.3), f(secs[0] * F2, sc=0.3)
for E in (31744, 7936):
    x, rad = f(E, 49, C, dt=bf), (1.0 + f(E, sum(secs), C, sc=0.3)).to(bf)
    phi = torch.as_tensor(rng.uniform(-np.pi, np.pi, E).astype(np.float32)).to(dev)
    beta = torch.as_tensor(rng.uniform(0, np.pi, E).astype(np.float32)).to(dev)
    cts = [f(E, r * F2, dt=bf) for r in secs] + [f(E, extra, dt=bf)]
    args = [x, rad, phi, beta, w1s, b1, w2s, b2, tg, fg, 6, 2, H, F2, alpha]
    out[f"k6_bf16_ms_{E}"] = ms(lambda: k6.so2_attn_cuda(*args))
    out[f"k6b_bf16_ms_{E}"] = ms(lambda: k6.so2_attn_bwd_cuda(*args[:7], *args[8:], *cts))
    del x, rad, cts, args
torch.cuda.empty_cache()


def dense_calls():
    """K8b·bf16 at every distinct call of one step of configs/train.yml
    under the dense switch: (time a launch weighted by the calls, [[ms,
    calls], ...])."""
    cfg = load_config(os.path.join(here, "configs", "train.yml"))
    mods = cs.kernel_modules()
    # the batch loaded here, not by a Prefetcher, whose thread would load
    # more batches beside the timed calls
    batch = next(iter(BucketedNpzDataset(os.path.join(here, "data", "corpus", "train"),
                                         cfg.train.batch_size, seed=0))).to(dev)
    with cs.switched(cs.DENSE_ATTN), tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, logdir=tmp, device=dev)
        captured = cs.capture([cs.K8B_BF16], mods, lambda: trainer.train_step(batch))
        del trainer
    fn = mods["dense_edge_attn"].dense_edge_attn_bwd_cuda
    calls = [[ms(lambda: fn(*a, **kw)), n] for a, kw, n in
             captured["dense_edge_attn_bwd_cuda"].values()]
    del captured
    torch.cuda.empty_cache()
    return sum(t * n for t, n in calls) / sum(n for _, n in calls), calls


out["k8b_bf16_ms"], out["k8b_bf16_calls"] = dense_calls()


def step(cfg_file, switch, kernels):
    cfg = load_config(os.path.join(here, "configs", cfg_file))
    assert cfg.train.compute_dtype == "bfloat16", cfg.train.compute_dtype
    on = cs.switched(switch) if switch else contextlib.nullcontext()
    with on, tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, logdir=tmp, device=dev)
        data = Prefetcher(BucketedNpzDataset(os.path.join(here, "data", "corpus", "train"),
                                             cfg.train.batch_size, seed=0), depth=2, device=dev)
        batch = next(iter(data))
        trainer.train_step(batch)
        times = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        prof = cs.device_profile(lambda: trainer.train_step(batch), kernels)
        data.close()
    torch.cuda.empty_cache()
    return {"step_ms": times, "device_busy_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"], "device_ops": prof["device_ops"],
            "kernels": prof["matched"], "top": prof["top"][:8]}


if steps > 0:
    out["train_s2_bf16"] = step("train_corpus.yml", None,
                                ("ffn_bwd", "ffn_tc_kernel", "ffn_fwd_bf16_kernel"))
    out["train_so2_bf16"] = step("train.yml", cs.FUSED_SO2,
                                 ("so2::grid_", "so2::gemm_kernel", "so2::rotate"))
    out["train_dense_bf16"] = step("train.yml", cs.DENSE_ATTN,
                                   ("list_bwd_pair_kernel<2", "list_dkdv_kernel<2",
                                    "attn_bwd_pair_kernel<2", "csr_dkdv_kernel<2",
                                    "attn_fwd_kernel<2"))
print(json.dumps(out))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="+")
    ap.add_argument("--steps", type=int, default=2)
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
