"""The tensor-core instructions in the SASS of the port's kernels: for every
kernel of the named ``csrc/<name>.cu`` sources (built as the port builds
them, ``ops/cuda/build.py``), how many ``HMMA`` instructions of each kind
``cuobjdump -sass`` shows, and whether the kernels that must issue a kind
do (CHECKS).

    python3 tools/sass_mma.py [--out sass.json] [name ...]

``HMMA.16816.F32.BF16`` is ``mma.sync.aligned.m16n8k16`` on bfloat16
operands with float32 accumulation (``csrc/mma_bf16.cuh``);
``HMMA.1688.F32.TF32`` is ``mma.sync.aligned.m16n8k8`` TF32
(``csrc/mma_tf32.cuh``). Prints one JSON object and exits non-zero if a
check fails. Needs ``nvcc`` and ``cuobjdump`` (the card's machine).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from singa_tpu_torch.ops.cuda import build  # noqa: E402

BF16 = "HMMA.16816.F32.BF16"
TF32 = "HMMA.1688.F32.TF32"

# (source, kernel name pattern, kinds it must issue, kinds it must not):
# K4·bf16's and K4b·bf16's kernels and the bfloat16 GEMM of K6·bf16 and
# K6b·bf16 on bfloat16 m16n8k16 alone; K6's bfloat16 grid stages and
# K8b·bf16's tensor-core pair kernel (the list kernels' dense form) on the
# tensor cores (one TF32 product a product); the float32 GEMM in split
# TF32; the helper's test kernel
CHECKS = [
    ("so3_ffn", r"ffn_fwd_bf16_kernel<", [BF16], [TF32]),
    ("so3_ffn_bwd", r"ffn_bwd_bf16_kernel<", [BF16], [TF32]),
    ("neighbor_attn_bwd", r"list_bwd_pair_kernel<2, ", [TF32], []),
    ("so2_attn", r"gemm_kernel<.*Bf16In", [BF16], [TF32]),
    ("so2_attn_bwd", r"gemm_kernel<.*Bf16In", [BF16], [TF32]),
    ("so2_attn", r"grid_fwd_tc_kernel<", [TF32], []),
    ("so2_attn_bwd", r"grid_fwd_tc_kernel<", [TF32], []),
    ("so2_attn_bwd", r"grid_bwd_tc_kernel<", [TF32], []),
    ("so2_attn", r"gemm_kernel<\w+, \w+, \w+, float>", [TF32], [BF16]),
    ("mma_tf32", r"bf16_tile_kernel", [BF16], [TF32]),
]


def sass_counts(name: str) -> dict:
    """{demangled kernel: {HMMA kind: count}} of one built source."""
    lib = build._lib_path(name)
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True)
    counts, cur = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            counts[cur] = Counter()
        elif cur is not None:
            for op in re.findall(r"\bHMMA\.[0-9A-Z.]+", ln):
                counts[cur][op] += 1
    names = list(counts)
    demangled = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    return {d: dict(counts[n]) for n, d in zip(names, demangled)}


def check(names=None) -> dict:
    """Build the sources, count their HMMA kinds and hold CHECKS; returns
    {"kernels": {source: {kernel: counts}}, "checks": [...], "ok": bool}."""
    names = names or sorted({c[0] for c in CHECKS})
    build.build_all(names)
    kernels = {n: sass_counts(n) for n in names}
    checks = []
    for src, pattern, must, must_not in CHECKS:
        if src not in kernels:
            continue
        hit = {k: v for k, v in kernels[src].items() if re.search(pattern, k)}
        ok = bool(hit) and all(v.get(m, 0) > 0 for v in hit.values() for m in must) and all(
            v.get(m, 0) == 0 for v in hit.values() for m in must_not)
        checks.append({"source": src, "pattern": pattern, "must": must, "must_not": must_not,
                       "kernels": hit, "ok": ok})
    return {"kernels": kernels, "checks": checks, "ok": all(c["ok"] for c in checks)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", help="csrc/<name>.cu sources (default: CHECKS')")
    ap.add_argument("--out", help="write the whole result here as JSON")
    args = ap.parse_args()
    res = check(args.names or None)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps({"checks": [{k: c[k] for k in ("source", "pattern", "kernels", "ok")}
                                 for c in res["checks"]], "ok": res["ok"]}))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
