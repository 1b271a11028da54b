#!/usr/bin/env python3
"""Probe: does a torch.profiler session hold every device kernel launched
in it, in a process that has run an earlier session?

    python3 tools/profiler_probe.py [--out build/profiler_probe/results.jsonl]
        [--lead-in 0 512] [--launch cold warm] [--gap SECONDS]

One child process for each variant, started together: the spin kernels
that open each session (``--lead-in``: 0, a plain ``torch.profiler``
session, or ``repro_torch.profiling.device_profile``'s default), and
whether each kernel is launched once before its profiled call (``warm``)
or first inside it (``cold``).  Each child profiles a matmul (a first
session), builds ``csrc/aggregate.cu``, ``flash.cu`` and ``ssd.cu`` with
nvcc into a fresh directory of its own beside ``--out``, idles for
``--gap`` seconds (the profiler's loss at a session's start grows with
the time since the first session), then profiles one call of each kernel
(K1 aggregation, K2 flash attention, K3 the SSD scan) in bfloat16 and in
float32, a session a call, each library loaded as its wrapper first
runs, and then two of PyTorch's own kernels (one launched between
sessions, one first inside its session).  It reports, for each call, the
records of the kernel it launched (``events``: one launch was made in
the session), the session's lead-in records and every device kernel the
session recorded.  One JSON line per variant on stdout and in ``--out``.
Exits 1 if a child fails or a session opened by a lead-in misses a
launch.  Needs one card and nvcc.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = """
import json, sys, time, torch
from repro_torch.kernels import build
from repro_torch.profiling import LEAD_IN_KERNEL, device_profile

warm, lead_in, gap = sys.argv[1] == "warm", int(sys.argv[2]), float(sys.argv[3])
dev = torch.device("cuda")


def session(fn, name):
    with device_profile(lead_in) as prof:
        fn()
    stats = prof.key_averages()
    kernels = [(e.key, e.count) for e in stats
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    return {"events": sum(c for k, c in kernels if name in k),
            "lead_in": sum(c for k, c in kernels if LEAD_IN_KERNEL in k),
            "device": [(k[:60], c) for k, c in kernels if LEAD_IN_KERNEL not in k]}


a = torch.randn((512, 512), device=dev)
first = session(lambda: (a @ a).sum().item(), "gemm")
for name in ("aggregate", "flash", "ssd"):          # nvcc outside any session
    build.build(name)
time.sleep(gap)

from repro_torch.kernels import flash, ssd
from repro_torch.kernels.aggregate import aggregate_flat

gen = torch.Generator(device=dev).manual_seed(5)


def calls(dtype):
    x = (torch.randn((4, 4096), generator=gen, device=dev)).to(dtype)
    w = torch.rand((4,), generator=gen, device=dev)
    q = (torch.randn((1, 256, 4, 64), generator=gen, device=dev) * 0.5).to(dtype)
    kv = (torch.randn((1, 256, 2, 64), generator=gen, device=dev) * 0.5).to(dtype)
    xs = (torch.randn((1, 256, 4, 64), generator=gen, device=dev) * 0.5).to(dtype)
    bc = (torch.randn((1, 256, 1, 128), generator=gen, device=dev) * 0.5).to(dtype)
    dt = torch.rand((1, 256, 4), generator=gen, device=dev) * 0.5 + 0.1
    A = -(torch.rand((4,), generator=gen, device=dev) + 0.1)
    return {"aggregate": ("aggregate_leaves_kernel<", lambda: aggregate_flat(x, w)),
            "flash": (flash.KERNELS[dtype] + "<", lambda: flash.flash_attention(q, kv, kv)),
            "ssd": (ssd.KERNELS[dtype] + "<", lambda: ssd.ssd_scan(xs, dt, A, bc, bc))}


out = {name: {} for name in ("aggregate", "flash", "ssd")}
for dtype in (torch.bfloat16, torch.float32):
    for name, (kernel, fn) in calls(dtype).items():
        if warm:
            fn()
            torch.cuda.synchronize()
        out[name][str(dtype)] = session(fn, kernel)
native = {}
for fn, launch, name in ((torch.special.bessel_j0, "warm", "bessel_j0"),
                         (torch.special.bessel_j1, "cold", "bessel_j1")):
    if launch == "warm":
        fn(a)
        torch.cuda.synchronize()
    native[f"{name} {launch}"] = session(lambda: fn(a), name)
print(json.dumps({"kernels": out, "torch_kernels": native, "first_session": first}))
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "profiler_probe" / "results.jsonl"))
    ap.add_argument("--lead-in", nargs="+", type=int, default=[0, 512])
    ap.add_argument("--launch", nargs="+", default=["cold", "warm"], choices=["cold", "warm"])
    ap.add_argument("--gap", type=float, default=60.0)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    procs = {}
    for lead_in, launch in itertools.product(args.lead_in, args.launch):
        build_dir = out.parent / f"lead{lead_in}_{launch}"
        shutil.rmtree(build_dir, ignore_errors=True)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TORCH_BUILD_DIR=str(build_dir))
        procs[(lead_in, launch)] = subprocess.Popen(
            [sys.executable, "-c", CHILD, launch, str(lead_in), str(args.gap)], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ok = True
    with out.open("w") as f:
        for (lead_in, launch), proc in procs.items():
            stdout, stderr = proc.communicate(timeout=900 + args.gap)
            line = {"lead_in": lead_in, "launch": launch, "gap_s": args.gap,
                    "returncode": proc.returncode}
            if proc.returncode == 0:
                res = json.loads(stdout.strip().splitlines()[-1])
                line["result"] = res
                calls = [r for k in res["kernels"].values() for r in k.values()]
                calls += list(res["torch_kernels"].values())
                line["all_seen"] = all(r["events"] == 1 for r in calls)
                ok = ok and (line["all_seen"] or not lead_in)
            else:
                line["stderr"] = stderr[-2000:]
                ok = False
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
