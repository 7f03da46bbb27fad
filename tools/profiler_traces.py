"""How often torch.profiler returns a trace with no device event for one
traced call, traced as ``tests/test_torch_cuda.py``'s ``_kernels_run``
traces it (one ``torch.profiler.profile`` a call, CPU and CUDA activities,
the call and a synchronize inside).

    python3 tools/profiler_traces.py [--traces 1000] [--calls a,b] [--pad-before-ms 0]
        [--pad-after-ms 0] [--out traces.jsonl]

Traces ``--traces`` calls of each of ``--calls``, in that order (default
all): K1b's bfloat16 backward on its CUDA-core instance
(``k1b_bf16_cuda_cores``, the cuda tests' ``ragged_redo`` case: 2 graphs of
40 nodes, K 30, 3 heads; the case whose trace came back empty), the same
on the tensor-core instance (``k1b_bf16_tensor_cores``, the ``redo`` case),
K2's bfloat16 forward on the tensor cores (``k2_bf16_tensor_cores``,
Config()'s widths, 37 nodes) and one torch elementwise op on 2^20 floats
(``torch_add``). ``--pad-before-ms`` / ``--pad-after-ms``: the host sleeps
that long inside the traced window, before the call and after its
synchronize. Prints one JSON line a call: how many traces held no device
event and, for the first eight, where they fell and how many host events
and which CUDA API calls they held; appends the lines to ``--out``. Needs one CUDA card (and
pytest, which the test module it takes its cases from imports).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def cuda_tests():
    """tests/test_torch_cuda.py as a module, for its seeded cases."""
    spec = importlib.util.spec_from_file_location(
        "test_torch_cuda", os.path.join(ROOT, "tests", "test_torch_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def calls(dev) -> dict:
    from singa_tpu_torch.ops.cuda import neighbor_attn as k1
    from singa_tpu_torch.ops.cuda import so3_ffn as k2

    t = cuda_tests()
    out = {}
    for case, name in (("ragged_redo", "k1b_bf16_cuda_cores"), ("redo", "k1b_bf16_tensor_cores")):
        args = t._bf16(t._list_bwd_case(dev, case), (0, 1, 2, 7, 18))
        offsets, slots = k1.transpose_slots(args[3])
        out[name] = (lambda a=args, o=offsets, s=slots:
                     k1.neighbor_attn_bwd_cuda(*a, offsets=o, slots=s))
    rng = np.random.default_rng(7)
    f = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32), device=dev)
    lmax, N, C, H = 6, 37, 16, 512
    L = lmax + 1
    w = [0.3 * f(L, C, H), 0.1 * f(H), 0.3 * f(C, lmax * H), 0.1 * f(lmax * H),
         0.1 * f(L, H, C), 0.1 * f(C)]
    x = f(N, L * L, C).to(torch.bfloat16)
    out["k2_bf16_tensor_cores"] = lambda: k2.so3_gate_ffn_cuda(x, *w, lmax)
    y = f(1 << 20)
    out["torch_add"] = lambda: y.add_(1.0)
    return out


def trace(fn, before_s: float, after_s: float) -> tuple[list[str], list[str]]:
    """The device events' names and the host events' names of one traced call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(before_s)
        fn()
        torch.cuda.synchronize()
        time.sleep(after_s)
    events = prof.key_averages()
    return ([e.key for e in events if e.device_type == torch.autograd.DeviceType.CUDA],
            [e.key for e in events])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--traces", type=int, default=1000)
    ap.add_argument("--calls", default=None)
    ap.add_argument("--pad-before-ms", type=float, default=0.0)
    ap.add_argument("--pad-after-ms", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    dev = torch.device("cuda")
    fns = calls(dev)
    lines = []
    for name in a.calls.split(",") if a.calls else fns:
        fn = fns[name]
        fn()  # built and loaded before the first trace
        t0, empty = time.perf_counter(), []
        for i in range(a.traces):
            device, host = trace(fn, a.pad_before_ms / 1e3, a.pad_after_ms / 1e3)
            if not device:
                empty.append({"at": i, "host_events": len(host),
                              "api": sorted({k for k in host if k.startswith("cu")})})
        line = {"call": name, "traces": a.traces, "pad_before_ms": a.pad_before_ms,
                "pad_after_ms": a.pad_after_ms, "empty": len(empty),
                "empty_traces": empty[:8], "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if a.out:
        with open(a.out, "a") as fh:
            fh.write("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
