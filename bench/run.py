"""Run one cell of the benchmark and print its result as the last line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout (``BENCHMARK.json`` names the cells).  The
run needs a CUDA card and measures the PyTorch/CUDA port in ``src/``.
With ``--trace 0`` the result carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, the device's busy time and a
breakdown.  The numbers that decide ``correct`` are printed beside their
limits as the last lines of standard error and under ``checked``, the
result's last key.  The result is not printed, and the exit code is 1,
without a card, without the port, or when a module of JAX or of the JAX
package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # every build of the program stays in the checkout, at a fixed path
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} CUDA device(s); the benchmark measures "
              "the card only", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails here, before any result, without the port)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = harness.driver(cell.kind).run(cell, args.seed, args.seconds, bool(args.trace),
                                        device, T0)
    out = harness.result(cell, run, bool(args.trace))

    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"bench: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 1
    for name, c in out["checked"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
