"""ptxas's registers, spills and stack for every kernel of the port's CUDA
sources in two checkouts, built side by side with the port's own nvcc
flags, and the kernels whose numbers differ: a change that must leave a
kernel's code as it was (say, its float32 instance when a template gains a
storage type) shows none.

    python3 tools/ptxas_compare.py --parent <checkout> [--out cmp.json] [name ...]

Compares ``<parent>/singa_tpu_torch/csrc/<name>.cu`` with this checkout's
(every ``csrc/*.cu`` when no name is given). Kernels are matched by their
demangled names, with ``, float>`` read as ``>`` and ``<float>`` as
nothing (a template parameter ``class T = float`` added to a kernel, or a
kernel made a template on it: a template's name also starts with its
return type, ``void``, which is dropped). Prints one line a source and exits
non-zero if any kernel both trees have differs, or if a kernel that
MUST_MATCH names is not in both trees. Needs ``nvcc`` (the card's
machine); builds into a temporary directory.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from singa_tpu_torch.ops.cuda.build import NVCC_FLAGS, _nvcc  # noqa: E402


# kernels that must be in both trees (and so compared), by source: K1b's and
# K7b's pair kernel, plan and dk/dv stage at either storage type (their
# templates also take the dense form, K8b·bf16's), K4's float32
# tensor-core kernel and split (their bfloat16 instances are gone)
MUST_MATCH = {
    "neighbor_attn_bwd": [rf"{k}<{f}, {t}>" for k in ("list_bwd_pair_kernel", "list_dkdv_kernel")
                          for f in (0, 1) for t in ("float", "__nv_bfloat16")]
    + [r"list_plan_kernel<float>", r"list_plan_kernel<__nv_bfloat16>"],
    "so3_ffn": [rf"ffn_tc_kernel<{kc}, {i0}>" for kc in (1, 2) for i0 in (0, 49)]
    + [r"ffn_wsplit_kernel<8>", r"ffn_wsplit_kernel<16>"],
}


def ptxas(checkout: str, name: str, out_dir: str) -> dict:
    """{demangled kernel: {"registers", "spills": [stack, store, load]}} of
    one source of one checkout."""
    csrc = os.path.join(checkout, "singa_tpu_torch", "csrc")
    out = os.path.join(out_dir, f"{abs(hash(checkout))}_{name}.so")
    p = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", csrc, "-o", out,
                        os.path.join(csrc, f"{name}.cu")], capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(f"nvcc failed for {checkout} {name}:\n{p.stdout}{p.stderr}")
    res, cur = {}, None
    for ln in (p.stdout + p.stderr).splitlines():
        if "Compiling entry function" in ln:
            cur = ln.split("'")[1]
            res[cur] = {}
        elif cur and "Used" in ln and "registers" in ln:
            res[cur]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
        elif cur and "spill stores" in ln:
            res[cur]["spills"] = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
    names = list(res)
    demangled = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                               text=True).stdout.splitlines()
    return {d: res[n] for n, d in zip(names, demangled)}


def key(demangled: str) -> str:
    return (demangled.replace("(anonymous namespace)", "anon").split("(")[0]
            .removeprefix("void ").replace(", float>", ">").replace("<float>", ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="the other checkout's root")
    ap.add_argument("--out", help="write the comparison as JSON here")
    ap.add_argument("names", nargs="*", help="csrc/<name>.cu sources (default: all)")
    args = ap.parse_args(argv)
    names = args.names or sorted(os.path.splitext(os.path.basename(p))[0] for p in
                                 glob.glob(os.path.join(ROOT, "singa_tpu_torch", "csrc", "*.cu")))
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(os.cpu_count() or 4) as ex:
        jobs = {(c, n): ex.submit(ptxas, c, n, tmp) for n in names for c in (args.parent, ROOT)}
        built = {k: j.result() for k, j in jobs.items()}
    report, differ = {}, False
    for n in names:
        a = {key(k): v for k, v in built[(args.parent, n)].items()}
        b = {key(k): v for k, v in built[(ROOT, n)].items()}
        diff = {k: [a[k], b[k]] for k in a if k in b and a[k] != b[k]}
        report[n] = {"same": sum(1 for k in a if k in b and a[k] == b[k]), "differ": diff,
                     "only_parent": sorted(set(a) - set(b)), "only_here": {k: b[k] for k in b
                                                                            if k not in a}}
        # the rendering of key(): ", float>" read as ">", "<float>" as nothing
        want = [m.replace(", float>", ">").replace("<float>", "") for m in MUST_MATCH.get(n, [])]
        missing = [m for m in want if not any(k.endswith(m) and k in b for k in a)]
        if want:
            report[n]["must_match"] = {"kernels": want, "missing": missing}
        differ |= bool(diff) or bool(missing)
        print(n, json.dumps({k: v for k, v in report[n].items() if k != "only_here"}),
              "new:", len(report[n]["only_here"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
