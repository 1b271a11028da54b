#!/usr/bin/env python3
"""The port's dry run over the whole (architecture x shape) matrix, each
pair in a subprocess of its own, several at once.

    PYTHONPATH=src python tools/dryrun_matrix.py --out build/dryrun/16x16.jsonl \\
        [--multi-pod] [--arch A ...] [--shape S ...] [--jobs 8]

Each pair runs ``python -m repro_torch.launch.dryrun --arch A --shape S``
(one pair a process: a process holds one fake process group, and a pair
that fails leaves DTensor unfit for the next); the records are written to
``--out`` in the matrix's order, with each process's wall seconds.  Exits
1 if a pair fails.  It imports neither JAX nor the JAX package, so it runs
on the card's machine; ``tools/dryrun_table.py`` sets the records beside
the reference's.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES  # noqa: E402


def run_pair(arch: str, shape: str, multi_pod: bool, tmp: Path) -> dict:
    out = tmp / f"{arch}_{shape}.jsonl"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--out", str(out)] + (["--multi-pod"] if multi_pod else [])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
    rec = json.loads(out.read_text().splitlines()[-1]) if out.exists() else {
        "arch": arch, "shape": shape, "ok": False, "error": proc.stderr[-2000:]}
    rec["wall_s"] = time.perf_counter() - t0
    rec["returncode"] = proc.returncode
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--arch", nargs="*", default=list(ARCH_IDS))
    ap.add_argument("--shape", nargs="*", default=list(INPUT_SHAPES))
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args()

    pairs = [(a, s) for a in args.arch for s in args.shape]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(args.jobs) as pool:
        records = list(pool.map(lambda p: run_pair(*p, args.multi_pod, Path(tmp)), pairs))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    failed = [(r["arch"], r["shape"], r.get("error")) for r in records
              if not (r.get("ok") and r["returncode"] == 0)]
    print(json.dumps({"pairs": len(records), "ok": len(records) - len(failed),
                      "failed": failed, "wall_s": time.perf_counter() - t0}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
