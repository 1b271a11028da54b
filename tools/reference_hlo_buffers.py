#!/usr/bin/env python3
"""The largest per-device arrays in the reference's compiled dry-run
program, beside its memory analysis.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/reference_hlo_buffers.py \\
        --arch gemma-7b --shape train_4k [--top 12]

Runs the JAX package's ``lower_pair`` on its 16 x 16 production mesh
(512 host devices, no allocation), then lists the distinct array shapes
of the partitioned HLO by size, with the instruction that makes each:
the shapes are per device, so a dimension left whole (a global batch of
256) shows as it is.  This is the reference's side of the comparison
that ``chip_smoke.py``'s ``dryrun`` phase prints; it imports JAX and
runs where the JAX package does, never on the card's machine.
"""
import os

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=512 "
                           + os.environ.get("XLA_FLAGS", ""))

import argparse
import json
import re

from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh

_ARRAY = re.compile(r"%?([\w.\-]+) = (bf16|f32|f16|s32|u32|s8|u8|pred)\[([\d,]*)\][^ ]* "
                    r"([\w\-]+)\(")
_BYTES = {"bf16": 2, "f16": 2, "f32": 4, "s32": 4, "u32": 4, "s8": 1, "u8": 1, "pred": 1}


def largest_arrays(hlo_text: str, top: int):
    """The ``top`` largest distinct (dtype, shape) arrays of the HLO, each
    with the first instruction kind that makes it."""
    seen, rows = set(), []
    for name, dtype, dims, op in _ARRAY.findall(hlo_text):
        shape = tuple(int(d) for d in dims.split(",") if d)
        if (dtype, shape) in seen:
            continue
        seen.add((dtype, shape))
        n = 1
        for d in shape:
            n *= d
        rows.append({"bytes": n * _BYTES[dtype], "dtype": dtype, "shape": list(shape),
                     "op": op, "name": name})
    return sorted(rows, key=lambda r: -r["bytes"])[:top]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    lowered, _ = dryrun.lower_pair(args.arch, args.shape, make_production_mesh())
    compiled = lowered.compile()
    mem = compiled.memory_analysis()
    print(json.dumps({"arch": args.arch, "shape": args.shape, "memory": {
        k: int(getattr(mem, k)) for k in ("argument_size_in_bytes", "output_size_in_bytes",
                                          "temp_size_in_bytes", "alias_size_in_bytes")}}))
    for row in largest_arrays(compiled.as_text(), args.top):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
