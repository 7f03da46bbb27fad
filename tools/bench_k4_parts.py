"""Where K4's and K4b's time goes: their kernels with one part of the work
taken out at a time, timed on the card at the s2 training microbatch's
call (configs/train_corpus.yml: 14,336 nodes, lmax 6, C = Co = 16, H 512,
G 210), at float32 and at bfloat16 (x, the grid matrices and the
cotangent cast). A variant without a part computes a wrong result on
purpose: its time, set beside ``final``'s, is what that part costs; no
result of a variant but ``final`` is used.

    python3 tools/bench_k4_parts.py [--out build/k4_parts/results.json]
        [--variants final,bwd_no_chain,...]

Each variant is a copy of ``singa_tpu_torch`` under ``build/k4_parts/``
with ``csrc/so3_ffn.cu`` or ``csrc/so3_ffn_bwd.cu`` changed as VARIANTS
lists (``final``: the sources as they are): K4b without its grid chain
(the four sphere-grid transforms on the tensor cores: at float32
``grid_chain_tc``, at bfloat16 ``grid_chain_mma16_bwd``), without the
weight-gradient sums, without dx, without the chain and the sums; K4
without its chain (at float32 ``grid_chain_tc_fwd``, at bfloat16
``grid_chain_mma16_fwd``). Every variant is built at once, one nvcc each, then
each is run in a process of its own; each call is timed by CUDA events
over 10 launches after 2 of warm-up. Prints one JSON line a variant and
the card's name and power limit. Needs one CUDA card.
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
BWD, FWD = "so3_ffn_bwd.cu", "so3_ffn.cu"
NO_CHAIN_BWD = (BWD, r"singa::grid_chain_tc<kNCOL, (?:49|0)>\([^;]*\);", "(void)0;")
NO_CHAIN_BWD_BF16 = (BWD, r"singa::grid_chain_mma16_bwd<I0>\([^;]*\);",
                     "for (auto& m : om) for (auto& j : m) for (auto& q : j) q = 0.f; "
                     "for (auto& m : od) for (auto& j : m) for (auto& q : j) q = 0.f; "
                     "tm[0] = tm[1] = td[0] = td[1] = 0.f;")
NO_SUMS = (BWD, r"swsum\[e\] \+= v;", "(void)v;")
NO_BLOCK_SUMS = (BWD, r"swsum\[w1b \?[^;]*\+= acc\[u\]\[v\];", "(void)acc;")  # K4b·bf16's
VARIANTS = {
    "final": [],
    "bwd_no_chain": [NO_CHAIN_BWD, NO_CHAIN_BWD_BF16],
    "bwd_no_sums": [NO_SUMS, NO_BLOCK_SUMS],
    "bwd_no_dx": [(BWD, r"if \(dx_job\) \{(\s+const int l = degree_of\(dx_i\);)",
                   r"if (false) {\1")],
    "bwd_no_chain_sums": [NO_CHAIN_BWD, NO_CHAIN_BWD_BF16, NO_SUMS, NO_BLOCK_SUMS],
    "fwd_no_chain": [(FWD, r"singa::grid_chain_tc_fwd<I0,[^;]*;",
                      "for (auto& m : acc) for (auto& j : m) for (auto& q : j) q = 0.f; "
                      "for (auto& t : tl) t = 0.f;"),
                     (FWD, r"singa::grid_chain_mma16_fwd<I0>\([^;]*\);",
                      "for (auto& m : om) for (auto& j : m) for (auto& q : j) q = 0.f; "
                      "tm[0] = tm[1] = 0.f;")],
}
CHILD = r'''
import json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from singa_tpu_torch.equivariant.layers import _grid_mats_for
from singa_tpu_torch.ops.cuda import so3_ffn as k4

def ms(fn, iters=10):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters

N, lmax, C, H = 14336, 6, 16, 512
L, I = lmax + 1, (lmax + 1) ** 2
rng = np.random.default_rng(7)
f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32)).cuda()
w = [0.2 * f(L, C, H), 0.1 * f(H), 0.2 * f(C, H), 0.1 * f(H), 0.1 * f(L, H, C), 0.1 * f(C)]
tg, fg = (torch.as_tensor(m).cuda() for m in _grid_mats_for(lmax, lmax, False))
x, dy = f(N, I, C), f(N, I, C)
out = {}
for dt, name in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
    xd, tgd, fgd, dyd = (t.to(dt) for t in (x, tg, fg, dy))
    out["k4" + name + "_ms"] = ms(lambda: k4.so3_ffn_cuda(xd, *w, tgd, fgd, lmax))
    out["k4b" + name + "_ms"] = ms(lambda: k4.so3_ffn_bwd_cuda(xd, *w[:5], tgd, fgd, lmax, dyd))
print(json.dumps(out))
'''

# builds one variant's two sources; prints their kernels' registers and spills
BUILD = r'''
import json, re, subprocess, sys
sys.path.insert(0, sys.argv[1])
from singa_tpu_torch.ops.cuda import build
logs = build.build_all(["so3_ffn", "so3_ffn_bwd"])
res, cur = {}, None
for ln in (logs["so3_ffn"] + logs["so3_ffn_bwd"]).splitlines():
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
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "k4_parts", "results.json"))
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS to run")
    a = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    names = a.variants.split(",")
    builds = {}
    for name in names:
        root = os.path.join(ROOT, "build", "k4_parts", name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "singa_tpu_torch"),
                        os.path.join(root, "singa_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        for source, pattern, repl in VARIANTS[name]:
            src = os.path.join(root, "singa_tpu_torch", "csrc", source)
            text, n = re.subn(pattern, repl, open(src).read())
            if n == 0:
                raise SystemExit(f"{name}: {pattern!r} is not in csrc/{source}")
            with open(src, "w") as f:
                f.write(text)
        builds[name] = subprocess.Popen(
            [sys.executable, "-c", BUILD, root], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    logs = {name: p.communicate()[0] for name, p in builds.items()}
    results = {}
    for name in names:
        root = os.path.join(ROOT, "build", "k4_parts", name)
        if builds[name].returncode != 0:
            raise SystemExit(f"{name} did not build:\n{logs[name][-3000:]}")
        ptxas = {k: v for k, v in json.loads(logs[name].strip().splitlines()[-1]).items()
                 if "ffn_tc_kernel<2, 49" in k or "ffn_fwd_bf16_kernel<49" in k
                 or "ffn_bwd_" in k}
        r = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True, text=True)
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
