"""K2b's (or K4's, K3's, K3b's) outputs on the card at seeded inputs, for
holding two trees' kernel bit for bit (a change that only moves its code,
or leaves it as it was, must not change a bit).

    python3 tools/k2b_outputs.py --root <checkout> --out a.json [--compare b.json]
        [--kernel k2b|k4|k3|k3b]

Imports ``singa_tpu_torch`` from ``--root`` (so a checkout of another commit
can be run by this script), runs ``so3_gate_ffn_bwd_cuda`` (``--kernel
k4``: ``so3_ffn_cuda`` on the lmax-6 / lmax-6 grid, H 512) at lmax 6 and 4
with 16 channels in and out (14,336 nodes: a training microbatch) and at
lmax 6 with 8 or 16 (37 nodes; H 512 or 40); ``--kernel k3`` / ``k3b``:
``s2_silu_sep_cuda`` / ``s2_silu_sep_bwd_cuda`` on the m-primary mmax-2
grids of lmax 6, 4 and 2 (31,744 edges: a training microbatch's stage-1
call; 37, 9 and 1 edges at C 64 or 16); writes the SHA-256 of the bytes of
each output of each case to ``--out``, and with ``--compare`` prints, per
case and output, whether the two files agree, and exits non-zero if any
differs. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

CASES = [(6, 14336, 512, 16, 16), (4, 14336, 512, 16, 16), (6, 37, 512, 8, 8), (6, 37, 40, 16, 8)]
NAMES = ("dx", "dw1", "db1", "dwg", "dbg", "dw2", "db2")
SEP_CASES = [(6, 31744, 128), (6, 37, 64), (4, 37, 64), (2, 9, 16), (6, 1, 64)]  # lmax, E, C


def sep_outputs(kernel: str, seed: int) -> dict:
    """K3's (or K3b's) output hashes at SEP_CASES."""
    from singa_tpu_torch.equivariant.layers import _grid_mats_for
    from singa_tpu_torch.ops.cuda import s2_act as k3

    out = {}
    for lmax, E, C in SEP_CASES:
        rng = np.random.default_rng(seed + E + lmax)
        tg, fg = (torch.as_tensor(m).cuda() for m in _grid_mats_for(lmax, 2, True))
        f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32)).cuda()
        x, s, g = f(E, tg.shape[1], C), f(E, C), f(E, tg.shape[1], C)
        if kernel == "k3":
            outs, names = (k3.s2_silu_sep_cuda(x, s, tg, fg),), ("out",)
        else:
            outs, names = k3.s2_silu_sep_bwd_cuda(x, s, tg, fg, g), ("dx", "ds")
        out[f"lmax{lmax}_E{E}_C{C}"] = {
            n: hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest() for n, o in zip(names, outs)}
    return out


def outputs(kernel: str, seed: int = 97) -> dict:
    if kernel in ("k3", "k3b"):
        return sep_outputs(kernel, seed)
    from singa_tpu_torch.equivariant.layers import _grid_mats_for
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    out = {}
    for lmax, N, H, C, Co in CASES:
        L = lmax + 1
        rng = np.random.default_rng(seed + N + lmax)
        f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32)).cuda()
        if kernel == "k4":
            tg, fg = (torch.as_tensor(m).cuda() for m in _grid_mats_for(lmax, lmax, False))
            args = [f(N, L * L, C), 0.2 * f(L, C, H), 0.1 * f(H), 0.2 * f(C, H), 0.1 * f(H),
                    0.1 * f(L, H, Co), 0.1 * f(Co), tg, fg, lmax]
            outs = (k2.so3_ffn_cuda(*args),)
        else:
            args = [f(N, L * L, C), 0.3 * f(L, C, H), 0.1 * f(H), 0.3 * f(C, lmax * H),
                    0.1 * f(lmax * H), 0.1 * f(L, H, Co), lmax, f(N, L * L, Co)]
            outs = k2.so3_gate_ffn_bwd_cuda(*args)
        names = ("y",) if kernel == "k4" else NAMES
        out[f"lmax{lmax}_N{N}_H{H}_C{C}_Co{Co}"] = {
            n: hashlib.sha256(g.cpu().numpy().tobytes()).hexdigest() for n, g in zip(names, outs)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--compare")
    ap.add_argument("--kernel", choices=("k2b", "k4", "k3", "k3b"), default="k2b")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2b_outputs: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(a.root))
    got = outputs(a.kernel)
    with open(a.out, "w") as f:
        json.dump(got, f)
    if not a.compare:
        return 0
    with open(a.compare) as f:
        ref = json.load(f)
    same = {case: {n: got[case][n] == ref[case][n] for n in got[case]} for case in got}
    print(json.dumps({"bit_for_bit": same}))
    return 0 if all(all(v.values()) for v in same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
