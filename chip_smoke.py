"""Chip smoke test of the PyTorch/CUDA port: the generation path on one GPU.

    python3 chip_smoke.py

Needs one CUDA card; exits non-zero without one (there is no CPU fallback).
Imports nothing of JAX or of the JAX package. Phases, one JSON line each:

  1. device   name and power limit (nvidia-smi), torch and CUDA versions
  2. build    every kernel of ``singa_tpu_torch/csrc`` built from source
              (one nvcc per source, all started together), with the seconds
  3. kernel   for K1/K2/K3: the inputs the main path hands the kernel (8
              pockets, default Config), the kernel against its plain PyTorch
              version on the card (max error vs the stated tolerance),
              kernel_ms / plain_ms (CUDA events, median of 20 after warm-up)
              and bound_ms (the larger of bytes over 3.35 TB/s and float32
              operations over 67 TFLOP/s)
  4. main     default Config(), seeded weights on cuda, the first 8 sorted
              val pockets through generate_for_pocket (20 beams, max length
              200, grammar mask, length penalty 0.7): launch counts per
              encode_pocket (K3 = 3, K2 = 3, K1 = 6), encode_ms / decode_ms,
              molecules/s, finite scores, a few SMILES
     profile  torch.profiler over one encode_pocket and the first 40 decode
              steps: device busy time, idle share, the costliest kernels
  5. vs_cpu  encode_pocket on the card (kernels) vs on the CPU (plain
              versions) with the same weights, 2 pockets
  6. cli      generate.main(... --device cuda) on one pocket writes its CSV
then the card's name and power limit as nvidia-smi prints them, the kernels
line, and ``{"ok": true, "device": {...}}`` last. Any failed check raises.
TF32 is off for matmuls and cuDNN, so every product runs in full float32.
"""
from __future__ import annotations

import csv
import glob
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
TOL = {"atol": 1e-4, "rtol": 1e-4}  # kernel vs plain: reordered float32 sums
CPU_TOL = {"atol": 2e-3, "rtol": 2e-3}  # whole encoder, card vs CPU
PROFILE_STEPS = 40  # decode steps traced by the profile phase


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_profile(fn) -> dict:
    """Device time of fn() by kernel under torch.profiler, beside the wall
    time of the same call unprofiled. The device's busy time is the sum of
    its kernels' times (one stream, so they do not overlap); the idle share
    is the rest of the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:8]
    return {
        "wall_ms": wall_ms,
        # None: the profiler saw no device work here, so busy time is not measured
        "device_busy_ms": busy_ms if ops else None,
        "idle_share": 1.0 - busy_ms / wall_ms if ops else None,
        "device_ops": sum(e.count for e in ops),
        "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in top],
    }


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_mem = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def k3_cost(args, out):
    x, s, tg, fg = args
    E, I, C = x.shape
    G = tg.shape[0]
    # to-grid and from-grid contractions, 2 operations per multiply-add
    return nbytes(x, s, tg, fg, out), 2.0 * E * C * G * (2 * I - 1)


def k2_cost(args, out):
    x, w1, b1, wg, bg, w2, b2, lmax = args
    N, I, C = x.shape
    H, Co = w1.shape[2], w2.shape[2]
    flops = 2.0 * N * (I * C * H + C * lmax * H + I * H * Co)
    return nbytes(x, w1, b1, wg, bg, w2, b2, out), flops


def k1_cost(args, out):
    (qt, k, v, nbr, nbr_mask, dist, ds, dv, centers,
     wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, coeff) = args
    H = ds.shape[2]
    kd, vd, De = qt.shape[2] // H, v.shape[2] // H, centers.shape[0]
    pairs = float(nbr_mask.sum().item())  # the work this data needs: live pairs
    per_pair = 2 * (De * kd + kd * kd + De * vd + vd * vd) + 3 * H * (kd + vd) + 4 * De
    b = nbytes(qt, k, v, nbr, nbr_mask, dist, ds, dv, centers,
               wk1, bk1, wk2, bk2, wv1, bv1, wv2, bv2, out)
    return b, pairs * per_pair


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from singa_tpu_torch.config import Config
    from singa_tpu_torch.data.batch import load_npz
    from singa_tpu_torch.generate.beam import beam_generate
    from singa_tpu_torch.generate.generate import generate_for_pocket
    from singa_tpu_torch.generate.generate import main as cli_main
    from singa_tpu_torch.models.singa import SINGA
    from singa_tpu_torch.ops.cuda import build
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1
    from singa_tpu_torch.ops.cuda import s2_act as k3
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "tf32": False})

    t0 = time.perf_counter()
    logs = build.build_all()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": sorted(logs), "ptxas": ptxas})

    # the main path's batch and model
    files = sorted(glob.glob(os.path.join(ROOT, "data", "corpus", "val", "*.npz")))[:8]
    if len(files) != 8:
        raise RuntimeError(f"expected 8 val pockets, found {len(files)}")
    cfg = Config()
    batch = load_npz(files).to(dev)
    model = SINGA(cfg, device=dev, seed=0).eval()

    # capture each kernel's first inputs on the main path (also a warm-up)
    kernels = [
        ("neighbor_attn_fused", k1, "neighbor_attn", "singa_tpu_torch/csrc/neighbor_attn.cu",
         "singa_tpu/ops/pallas/neighbor_attn.py:306", k1_cost),
        ("so3_gate_ffn_fused", k2, "so3_gate_ffn", "singa_tpu_torch/csrc/so3_gate_ffn.cu",
         "singa_tpu/ops/pallas/so3_ffn.py:497", k2_cost),
        ("s2_silu_sep", k3, "s2_silu_sep", "singa_tpu_torch/csrc/s2_act.cu",
         "singa_tpu/ops/pallas/s2_act.py:230", k3_cost),
    ]
    captured, originals = {}, {}
    for name, mod, fn, *_ in kernels:
        orig = getattr(mod, f"{fn}_cuda")
        originals[name] = (mod, fn, orig)

        def rec(*args, _name=name, _orig=orig):
            if _name not in captured:
                captured[_name] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            return _orig(*args)

        setattr(mod, f"{fn}_cuda", rec)
    with torch.inference_mode():
        model.encode_pocket(batch)
    for mod, fn, orig in originals.values():
        setattr(mod, f"{fn}_cuda", orig)
    torch.cuda.synchronize()

    results = {}
    for name, mod, fn, source, replaces, cost in kernels:
        args = captured[name]
        launch = getattr(mod, f"{fn}_cuda")
        plain = getattr(mod, f"{fn}_plain")
        with torch.inference_mode():
            got = launch(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs()
            max_abs = err.max().item()
            max_rel = (err / (want.abs() + TOL["atol"] / TOL["rtol"])).max().item()
            ok = bool(torch.allclose(got, want, **TOL))
            k_ms = time_ms(lambda: launch(*args))
            p_ms = time_ms(lambda: plain(*args))
        b, f = cost(args, got)
        bms, by = bound_ms(b, f)
        results[name] = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None,
        }
        emit({"phase": "kernel", "name": name,
              "shapes": [list(a.shape) for a in args if torch.is_tensor(a)],
              "max_abs_err": max_abs, "max_rel_err": max_rel, "tolerance": TOL, "ok": ok,
              "kernel_ms": k_ms, "plain_ms": p_ms, "bound_ms": bms, "bound_by": by,
              "bytes": b, "flops": f, "fraction_of_bound": bms / k_ms})
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain version ({max_abs})")

    # main path: counts set to 0 just before, read just after
    for _, mod, *_ in kernels:
        mod.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smiles, scores = generate_for_pocket(model, batch, cfg)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    counts = {name: mod.launches for name, mod, *_ in kernels}
    expected = {"neighbor_attn_fused": cfg.model.encoder.num_interactions,
                "so3_gate_ffn_fused": cfg.embedding.num_layers,
                "s2_silu_sep": cfg.embedding.num_layers}
    for name in counts:
        results[name]["launches"] = counts[name]
    if counts != expected:
        raise AssertionError(f"launches per encode_pocket {counts}, expected {expected}")
    if len(smiles) != 8 * cfg.generate.topk:
        raise AssertionError(f"expected {8 * cfg.generate.topk} molecules, got {len(smiles)}")
    finite = bool(torch.isfinite(torch.as_tensor(scores)).all())
    if not finite:
        raise AssertionError(f"non-finite beam scores: {scores}")

    # the two halves timed on their own (warm)
    with torch.inference_mode():
        enc_times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            enc, pad = model.encode_pocket(batch)
            torch.cuda.synchronize()
            enc_times.append((time.perf_counter() - t1) * 1e3)
        prop = torch.tensor([cfg.generate.prop] * 8, dtype=torch.float32, device=dev)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        g = cfg.generate
        beam_generate(model, enc, pad, prop, num_beams=g.num_beams, max_length=g.max_length,
                      length_penalty=g.length_penalty, topk=g.topk,
                      grammar_mask=g.grammar_mask, allow_dot=g.allow_dot)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t1) * 1e3
    emit({"phase": "main", "pockets": 8, "launches_per_encode_pocket": counts,
          "generate_for_pocket_s": total_s, "molecules_per_s": len(smiles) / total_s,
          "encode_ms": statistics.median(enc_times), "decode_ms": decode_ms,
          "decode_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "scores_finite": finite, "scores": [float(s) for s in scores],
          "smiles": [s[:80] for s in smiles[:4]]})

    # where the time goes: device busy and idle share of one encode_pocket and
    # of the first PROFILE_STEPS decode steps
    with torch.inference_mode():
        enc_prof = device_profile(lambda: model.encode_pocket(batch))
        dec_prof = device_profile(lambda: beam_generate(
            model, enc, pad, prop, num_beams=g.num_beams, max_length=PROFILE_STEPS + 1,
            length_penalty=g.length_penalty, topk=g.topk, grammar_mask=g.grammar_mask,
            allow_dot=g.allow_dot))
    emit({"phase": "profile", "encode_pocket": enc_prof,
          f"decode_{PROFILE_STEPS}_steps": dec_prof})

    # the card (kernels) vs the CPU (plain versions), same weights, 2 pockets
    cpu_model = SINGA(cfg, device="cpu", seed=0).eval()
    small = load_npz(files[:2])
    with torch.inference_mode():
        enc_gpu, _ = model.encode_pocket(small.to(dev))
        enc_cpu, _ = cpu_model.encode_pocket(small)
    diff = (enc_gpu.cpu() - enc_cpu).abs()
    ok = bool(torch.allclose(enc_gpu.cpu(), enc_cpu, **CPU_TOL))
    emit({"phase": "vs_cpu", "pockets": 2, "max_abs_err": diff.max().item(),
          "mean_abs_err": diff.mean().item(), "max_abs_value": enc_cpu.abs().max().item(),
          "tolerance": CPU_TOL, "ok": ok})
    if not ok:
        raise AssertionError("card encode_pocket disagrees with the CPU")

    # the CLI on one pocket with the seeded weights
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "weights.pt")
        out = os.path.join(tmp, "out.csv")
        torch.save(model.state_dict(), ckpt)
        t1 = time.perf_counter()
        cli_main(["--checkpoint", ckpt, "--input", files[0], "--output", out,
                  "--device", "cuda"])
        cli_s = time.perf_counter() - t1
        with open(out) as f:
            rows = list(csv.reader(f))
    if rows[0] != ["smiles", "score"] or len(rows) != 1 + cfg.generate.topk:
        raise AssertionError(f"unexpected CLI csv: {rows}")
    emit({"phase": "cli", "seconds": cli_s, "rows": [[r[0][:80], r[1]] for r in rows[1:]]})

    print(smi, flush=True)
    emit({"kernels": [results[name] for name, *_ in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
