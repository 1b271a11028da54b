#!/usr/bin/env python3
"""Probe: does torch.profiler see the SSD kernel when its library is
built and loaded in a process that has already run a profiling session?

    python3 tools/profiler_probe.py [--out build/profiler_probe/results.jsonl]

Four child processes, started together, one per variant: the CUDA module
loading mode (``CUDA_MODULE_LOADING=LAZY``, PyTorch's default, or
``EAGER``) by whether the kernel is launched once before the profiled
call (``warm``) or first inside it (``cold``).  Each child profiles a
matmul (an earlier session, as a long test process has), then builds
``csrc/ssd.cu`` with nvcc into a fresh directory of its own and loads it
(as a test process that builds in-process does), then profiles one bf16
and one float32 ``ssd_scan`` call and reports the events the profiler
recorded under an SSD name and whether each dtype's kernel is among them.  One
JSON line per variant on stdout and in ``--out``.  Needs one card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = """
import json, sys, torch
from torch.profiler import ProfilerActivity, profile

warm = sys.argv[1] == "warm"
dev = torch.device("cuda")
a = torch.randn((512, 512), device=dev)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
    (a @ a).sum().item()
from repro_torch.kernels.ssd import KERNELS, ssd_scan

gen = torch.Generator(device=dev).manual_seed(5)
out = {}
for dtype in (torch.bfloat16, torch.float32):
    x = (torch.randn((1, 256, 4, 64), generator=gen, device=dev) * 0.5).to(dtype)
    bc = (torch.randn((1, 256, 1, 128), generator=gen, device=dev) * 0.5).to(dtype)
    dt = torch.rand((1, 256, 4), generator=gen, device=dev) * 0.5 + 0.1
    A = -(torch.rand((4,), generator=gen, device=dev) + 0.1)
    if warm:
        ssd_scan(x, dt, A, bc, bc)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ssd_scan(x, dt, A, bc, bc)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "ssd" in e.key.lower()]
    out[str(dtype)] = {"seen": any(f"{KERNELS[dtype]}<" in n for n in names),
                       "names": names}
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "profiler_probe" / "results.jsonl"))
    args = ap.parse_args()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    procs = {}
    for loading in ("LAZY", "EAGER"):
        for warm in ("cold", "warm"):
            env = dict(os.environ, CUDA_MODULE_LOADING=loading, PYTHONPATH=str(ROOT / "src"),
                       REPRO_TORCH_BUILD_DIR=str(ROOT / "build" / "profiler_probe"
                                                 / f"{loading}_{warm}"))
            procs[(loading, warm)] = subprocess.Popen(
                [sys.executable, "-c", CHILD, warm], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ok = True
    with out.open("w") as f:
        for (loading, warm), proc in procs.items():
            stdout, stderr = proc.communicate(timeout=900)
            line = {"loading": loading, "launch": warm, "returncode": proc.returncode}
            if proc.returncode == 0:
                line["result"] = json.loads(stdout.strip().splitlines()[-1])
            else:
                line["stderr"] = stderr[-2000:]
                ok = False
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
