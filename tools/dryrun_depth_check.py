#!/usr/bin/env python3
"""The dry run's depth extrapolation against a trace of every unit, at
full width: for each pair, the counts a record gives
(``extrapolated_analysis``, from 2-5 units of each layer stack) beside one
run of the step at its full depth.

    PYTHONPATH=src python tools/dryrun_depth_check.py zamba2-1.2b:train_4k \\
        [kimi-k2-1t-a32b:train_4k ...] [--multi-pod]

Prints one JSON line a pair: per-device memory (argument, output and temp
bytes, and their sum less alias, as the records' fit verdicts take it),
collective bytes and FLOPs, each extrapolated and whole, their ratios,
the traced depths and the seconds each took.  A full-depth trace at full
width takes minutes (tens of minutes for 61 layers) on a host CPU.
Imports neither JAX nor the JAX package.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


def per_device(mem) -> float:
    return (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
            + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])


def check(arch: str, shape: str, multi_pod: bool) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    ext = dryrun.extrapolated_analysis(arch, shape, mesh)
    t1 = time.perf_counter()
    full = dryrun.lower_pair(arch, shape, mesh)[0].compile()
    t2 = time.perf_counter()
    whole = {k: getattr(full.memory, k) for k in dryrun._MEM_ATTRS}
    coll = (sum(ext["coll"].values()), sum(dryrun.collective_bytes(full.as_text()).values()))
    rows = {"per_device_bytes": (per_device(ext["memory"]), per_device(whole)),
            **{k: (ext["memory"][k], whole[k]) for k in
               ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes")},
            "collective_bytes": coll, "flops": (ext["flops"], full.flops)}
    return {"arch": arch, "shape": shape, "depth": ext["depth"],
            "traced_depth": ext["traced_depth"],
            **{k: {"extrapolated": float(e), "whole": float(w),
                   "ratio": float(e) / float(w) if w else None}
               for k, (e, w) in rows.items()},
            "extrapolated_s": t1 - t0, "whole_s": t2 - t1}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pairs", nargs="+", help="arch:shape")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args()
    for pair in args.pairs:
        arch, shape = pair.split(":")
        print(json.dumps(check(arch, shape, args.multi_pod)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
