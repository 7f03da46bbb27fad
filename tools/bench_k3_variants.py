"""K3's and K3b's (float32 and bfloat16), and K5's and K5b's, tensor-core
kernels at variants of their compile-time constants, timed on the card:
K3/K3b at a training microbatch's stage-1 call (31,744 edges) and a
serving call (7,936), I 29, C 128, G 70, at float32 and at bfloat16 (x,
the scalars, the grid matrices and the cotangent cast); K5/K5b at the two
inputs chip_smoke.py's kernel_s2act holds them on, the s2 FFN's hidden of
a serving encode (3,584 nodes, I 49, C 512, G 210) and a stage-1
attention message (7,936 edges, I 29, C 128, G 70).

    python3 tools/bench_k3_variants.py [--out build/k3_variants/results.json]
        [--variants final,k5_no_tail,...]

Each variant is a copy of ``singa_tpu_torch`` under ``build/k3_variants/``
with ``csrc/s2_act.cu``'s constants replaced as VARIANTS lists (``final``:
the source as it is); every variant is built at once, one nvcc each, then
each is run in a process of its own; each call is timed by CUDA events over
30 launches after 3 of warm-up (host time included, which the card's time
hides at these sizes), and ``final`` also times the CUDA-core instances.
The bfloat16 calls are held to their bfloat16 twins (``*_bf16_err``: the
largest error over the output's largest magnitude). Prints one JSON line a
variant and the card's name and power limit. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    "final": [],
    "fwd_12_warps": [(r"kFwdWarps = 16;", "kFwdWarps = 12;")],
    "fwd_14_warps": [(r"kFwdWarps = 16;", "kFwdWarps = 14;")],
    "fwd_64_columns": [(r"kFwdCT = 2;", "kFwdCT = 4;"), (r"kFwdWarps = 16;", "kFwdWarps = 8;")],
    "bwd_32_columns": [(r"kBwdCT = 1;", "kBwdCT = 2;"), (r"kBwdWarps = 15;", "kBwdWarps = 7;")],
    "one_step_a_pass": [(r"kSteps = 3;", "kSteps = 1;")],
    # K5 and K5b above 32 rows: 32-column warp tiles; every row of I 49
    # through mma (7 k steps, 4 m16 tiles); K5b's tg staged twice always
    "k5_wide_ct2": [(r"kWideCT = 1;", "kWideCT = 2;")],
    "k5_no_tail": [(r"kTailRow = true;", "kTailRow = false;")],
    "k5b_tg_twice": [(r"return bwd_launch<Form::kBCT>\(one\)\.warps > "
                      r"bwd_launch<Form::kBCT>\(two\)\.warps \? one : two;", "return two;")],
}


def _bf16_map(kernel: str, ct: int, warps: int) -> list:
    """K3's (kernel "Fwd") or K3b's ("Bwd") bfloat16 instance at warp tiles
    of ct 16-column groups and at most ``warps`` warps a block."""
    return [(rf"k{kernel}CTBf16 = \d+;", f"k{kernel}CTBf16 = {ct};"),
            (rf"k{kernel}WarpsBf16 = \d+;", f"k{kernel}WarpsBf16 = {warps};")]


VARIANTS.update({f"bf16_fwd_{16 * ct}_columns_{w}_warps": _bf16_map("Fwd", ct, w)
                 for ct, w in ((2, 12), (2, 16), (2, 20), (2, 24), (2, 32), (4, 8), (4, 12),
                               (4, 16))})
VARIANTS.update({f"bf16_bwd_{16 * ct}_columns_{w}_warps": _bf16_map("Bwd", ct, w)
                 for ct, w in ((1, 15), (1, 24), (1, 32), (2, 8), (2, 12), (2, 15))})
CHILD = r'''
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from singa_tpu_torch.equivariant.layers import _grid_mats_for
from singa_tpu_torch.ops.cuda import s2_act as k3

def ms(fn, iters=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters

def rel_err(got, want):
    got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
    return max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
               for a, b in zip(got, want))

tg, fg = (torch.as_tensor(m).cuda() for m in _grid_mats_for(6, 2, True))
out = {}
for E in (31744, 7936):
    rng = np.random.default_rng(E)
    x, g = (torch.as_tensor(rng.normal(size=(E, 29, 128)).astype(np.float32)).cuda()
            for _ in range(2))
    s = torch.as_tensor(rng.normal(size=(E, 128)).astype(np.float32)).cuda()
    r = {"k3_ms": ms(lambda: k3.s2_silu_sep_cuda(x, s, tg, fg)),
         "k3b_ms": ms(lambda: k3.s2_silu_sep_bwd_cuda(x, s, tg, fg, g)),
         "k3_max_abs_err": (k3.s2_silu_sep_cuda(x, s, tg, fg)
                            - k3.s2_silu_sep_plain(x, s, tg, fg)).abs().max().item()}
    b = [t.to(torch.bfloat16) for t in (x, s, tg, fg, g)]
    r["k3_bf16_ms"] = ms(lambda: k3.s2_silu_sep_cuda(*b[:4]))
    r["k3b_bf16_ms"] = ms(lambda: k3.s2_silu_sep_bwd_cuda(*b))
    r["k3_bf16_err"] = rel_err(k3.s2_silu_sep_cuda(*b[:4]), k3.s2_silu_sep_plain(*b[:4]))
    r["k3b_bf16_err"] = rel_err(k3.s2_silu_sep_bwd_cuda(*b), k3.s2_silu_sep_bwd_plain(*b))
    r["bf16_residency"] = [k3.sep_residency(29, 128, 70, bwd=d, bf16=True) for d in (0, 1)]
    if sys.argv[2] == "1":
        r["k3_cuda_cores_ms"] = ms(lambda: k3.s2_silu_sep_cuda(x, s, tg, fg, cuda_cores=True))
        r["k3b_cuda_cores_ms"] = ms(
            lambda: k3.s2_silu_sep_bwd_cuda(x, s, tg, fg, g, cuda_cores=True))
        r["k3_bf16_cuda_cores_ms"] = ms(lambda: k3.s2_silu_sep_cuda(*b[:4], cuda_cores=True))
        r["k3b_bf16_cuda_cores_ms"] = ms(lambda: k3.s2_silu_sep_bwd_cuda(*b, cuda_cores=True))
    out[E] = r
    del x, g, b
for name, (lmax, mmax, m_primary, N, C) in {"k5_hidden": (6, 6, False, 3584, 512),
                                            "k5_message": (6, 2, True, 7936, 128)}.items():
    tg, fg = (torch.as_tensor(m).cuda() for m in _grid_mats_for(lmax, mmax, m_primary))
    rng = np.random.default_rng(N)
    x, g = (torch.as_tensor(rng.normal(size=(N, tg.shape[1], C)).astype(np.float32)).cuda()
            for _ in range(2))
    r = {"k5_ms": ms(lambda: k3.s2_silu_cuda(x, tg, fg)),
         "k5b_ms": ms(lambda: k3.s2_silu_bwd_cuda(x, tg, fg, g)),
         "k5_max_abs_err": (k3.s2_silu_cuda(x, tg, fg)
                            - k3.s2_silu_plain(x, tg, fg)).abs().max().item(),
         "k5b_max_abs_err": (k3.s2_silu_bwd_cuda(x, tg, fg, g)
                             - k3.s2_silu_bwd_plain(x, tg, fg, g)).abs().max().item(),
         "residency": [k3.silu_residency(tg.shape[1], C, tg.shape[0], bwd=b) for b in (0, 1)]}
    if sys.argv[2] == "1":
        r["k5_cuda_cores_ms"] = ms(lambda: k3.s2_silu_cuda(x, tg, fg, cuda_cores=True))
        r["k5b_cuda_cores_ms"] = ms(lambda: k3.s2_silu_bwd_cuda(x, tg, fg, g, cuda_cores=True))
    out[name] = r
    del x, g
print(json.dumps(out))
'''

# builds one variant's s2_act.cu; prints its kernels' registers and spills
BUILD = r'''
import json, re, subprocess, sys
sys.path.insert(0, sys.argv[1])
from singa_tpu_torch.ops.cuda import build
log = build.build_all(["s2_act"])["s2_act"]
res, cur = {}, None
for ln in log.splitlines():
    if "Compiling entry function" in ln:
        cur = ln.split("'")[1]
        res[cur] = {}
    elif cur and "Used" in ln and "registers" in ln:
        res[cur]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    elif cur and "spill stores" in ln:
        res[cur]["spills"] = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
names = subprocess.run(["c++filt"], input="\n".join(res), capture_output=True,
                       text=True).stdout.splitlines()
print(json.dumps({n.replace("(anonymous namespace)", "anon").split("(")[0]: res[m]
                  for n, m in zip(names, res)}))
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "k3_variants", "results.json"))
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS to run")
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    names = a.variants.split(",")
    builds = {}
    for name in names:
        subs = VARIANTS[name]
        root = os.path.join(ROOT, "build", "k3_variants", name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "singa_tpu_torch"),
                        os.path.join(root, "singa_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = os.path.join(root, "singa_tpu_torch", "csrc", "s2_act.cu")
        text = open(src).read()
        for pattern, repl in subs:
            if not re.search(pattern, text):
                raise SystemExit(f"{name}: {pattern!r} is not in csrc/s2_act.cu")
            text = re.sub(pattern, repl, text)
        with open(src, "w") as f:
            f.write(text)
        builds[name] = subprocess.Popen(
            [sys.executable, "-c", BUILD, root], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    logs = {name: p.communicate()[0] for name, p in builds.items()}
    results = {}
    for name in names:
        root = os.path.join(ROOT, "build", "k3_variants", name)
        if builds[name].returncode != 0:
            raise SystemExit(f"{name} did not build:\n{logs[name][-3000:]}")
        ptxas = {k: v for k, v in json.loads(logs[name].strip().splitlines()[-1]).items()
                 if "s2_silu_sep" in k and "tc_kernel" in k}
        r = subprocess.run([sys.executable, "-c", CHILD, root, "1" if name == "final" else "0"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"{name} failed:\n{r.stderr[-3000:]}")
        results[name] = {**json.loads(r.stdout.strip().splitlines()[-1]), "ptxas": ptxas}
        print(json.dumps({"variant": name, **results[name]}), flush=True)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump({"device": smi.stdout.strip(), "variants": results}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
