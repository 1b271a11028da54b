#!/usr/bin/env python3
"""Time this checkout's aggregation kernel against an earlier one, on one
card, with one timer.

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/old
    python3 tools/aggregate_ab.py --old build/old [--out build/aggregate_ab/results.jsonl]

``--old`` holds an earlier checkout's
``src/repro_torch/kernels/csrc/aggregate.cu`` with the one-stream C
interface of the one-thread-per-element kernel (``aggregate_flat_f32``
and ``aggregate_flat_bf16``: x, w, out, K, N, stream).  It is built with
the port's nvcc flags.  On the same (K, N) inputs both kernels are
checked equal, then timed with ``chip_smoke.time_ms`` in turns (old,
new, new, old, three of each), under each L2 flush (``dirty``, ``clean``,
``warm``; see ``chip_smoke.l2_flushes``), with and without the device
spin between the flush and the start event; each side's time is the
median of its turns' medians.  At the FedLEO shapes it also takes each
kernel's own duration under torch.profiler (clean flush).  Then two
probes of the new kernel: the event time of a launch of one tile
(8 x 2048 float32), and one launch over 32 against 33 leaves (the small
against the large leaf table).  Each result is one JSON line on stdout
and in ``--out``.  Needs one card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SHAPES = [(8, 421_642), (5, 421_642), (8, 2**25)]
OLD_KERNEL = "aggregate_kernel<"


def build_old(old: Path) -> ctypes.CDLL:
    from repro_torch.kernels import build

    src = old / "src" / "repro_torch" / "kernels" / "csrc" / "aggregate.cu"
    out = ROOT / "build" / "aggregate_ab" / "libaggregate_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for name in ("aggregate_flat_f32", "aggregate_flat_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def old_flat(torch, lib, x, w):
    """The earlier kernel on a contiguous (K, N) stream; returns (N,)."""
    k, n = x.shape
    out = torch.empty((n,), dtype=x.dtype, device=x.device)
    fn = lib.aggregate_flat_f32 if x.dtype == torch.float32 else lib.aggregate_flat_bf16
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), k, n,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the earlier kernel failed to launch ({err})")
    return out


def turns(torch, fns, flush, spin):
    """Both sides in turns old, new, new, old (three of each); the median
    of each side's three medians, and the turns."""
    got = {name: [] for name in fns}
    for name in ("old", "new", "new", "old", "old", "new"):
        got[name].append(cs.time_ms(torch, fns[name], flush, spin=spin))
    return {name: statistics.median(t) for name, t in got.items()}, got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="directory holding the earlier src/repro_torch/kernels/csrc")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "aggregate_ab" / "results.jsonl")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("aggregate_ab: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels.aggregate import KERNEL, aggregate_flat, aggregate_leaves

    args.out.parent.mkdir(parents=True, exist_ok=True)
    sink = args.out.open("w")

    def emit(**row):
        line = json.dumps(row)
        print(line, flush=True)
        sink.write(line + "\n")

    smi = cs.nvidia_smi()
    dev = torch.device("cuda", 0)
    lib = build_old(args.old)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)   # 256 MB > L2
    flushes = cs.l2_flushes(flush_buf)

    for k, n in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            w = torch.rand((k,), generator=gen, device=dev) + 0.05
            w = w / w.sum()
            fns = {"old": lambda: old_flat(torch, lib, x, w), "new": lambda: aggregate_flat(x, w)}
            equal = torch.equal(fns["old"](), fns["new"]())
            bound, _, nbytes = cs.aggregate_bound_ms(k, n, x.element_size())
            for name, flush in flushes.items():
                if name == "warm" and n == 2**25:
                    continue            # 1.2 GB: no L2 holds it
                for spin in (False, True):
                    ms, raw = turns(torch, fns, flush, spin)
                    row = dict(K=k, N=n, dtype=str(dtype), flush=name, spin=spin,
                               bound_ms=bound, bytes=nbytes, old_ms=ms["old"], new_ms=ms["new"],
                               old_share=bound / ms["old"], new_share=bound / ms["new"],
                               speedup=ms["old"] / ms["new"], old_turns=raw["old"],
                               new_turns=raw["new"], bit_equal=equal, nvidia_smi=smi)
                    if name == "clean" and spin and n != 2**25:
                        row.update(
                            old_alone_ms=cs.kernel_only_ms(torch, fns["old"], flush, OLD_KERNEL),
                            new_alone_ms=cs.kernel_only_ms(torch, fns["new"], flush, KERNEL))
                    emit(what="old against new", **row)
            if not equal:
                raise RuntimeError(f"the two kernels differ at K={k} N={n} {dtype}")
            del x

    # the launch and event latency: a launch that moves one tile
    x1 = torch.randn((8, 2048), generator=gen, device=dev)
    w1 = torch.full((8,), 0.125, device=dev)
    for spin in (False, True):
        emit(what="one-tile launch", K=8, N=2048, dtype="torch.float32", flush="clean", spin=spin,
             ms=cs.time_ms(torch, lambda: aggregate_flat(x1, w1), flushes["clean"], spin=spin),
             alone_ms=cs.kernel_only_ms(torch, lambda: aggregate_flat(x1, w1),
                                        flushes["clean"], KERNEL),
             nvidia_smi=smi)
    # the leaf table's size: 32 leaves take the small table, 33 the large one
    for n_leaves in (32, 33):
        xs = [torch.randn((8, 4096), generator=gen, device=dev) for _ in range(n_leaves)]
        emit(what="leaf table size", K=8, N=4096, leaves=n_leaves, flush="clean",
             ms=cs.time_ms(torch, lambda: aggregate_leaves(xs, w1), flushes["clean"]),
             nvidia_smi=smi)
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
