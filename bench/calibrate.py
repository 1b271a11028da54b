"""Readings that a cell's limits are set from, on the card at the cell's
own size:

    python3 bench/calibrate.py --workload <cell> --seeds 11 12 ... \\
        [--control-seeds 11 12 13] [--fault-seeds 11 12 13] [--seconds 8] [--out FILE]

For every seed, the program's numbers (``bench/check.py``) against the
plain reference.  On the control seeds, the control's: the reference
itself in the program's place, computed in the precision below the one
the configuration states (float8 e4m3 for bfloat16).  On the fault
seeds, the program's with each fault of ``bench/faults.py`` that the
cell's traffic kind can have.  One JSON line a reading, on standard
output and in ``--out``.  A training cell reads only its set-up (the
checked steps); a prefill cell runs a window of ``--seconds``, enough
for as many calls as a run checks.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench import check, faults, harness
    from bench.reference import model as ref_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = harness.resolve(args.workload)
    drv = harness.driver(cell.kind)
    out = open(args.out, "a") if args.out else None

    def emit(**fields):
        line = json.dumps({"cell": cell.name, **fields})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in dict.fromkeys(args.seeds + args.control_seeds + args.fault_seeds):
        w0 = time.perf_counter()
        if cell.kind == "fedleo_train":
            st = drv.Setup(cell, seed, device)
            prog, fed = st.prog, st.fed
            del st
            torch.cuda.empty_cache()
            r0 = time.perf_counter()
            ref = drv.reference(cell, seed, fed, device)
            ref_s = time.perf_counter() - r0
            numbers = check.train_numbers(prog, ref)
        else:
            run = drv.run(cell, seed, args.seconds, False, device, time.perf_counter())
            numbers, rd = run["numbers"], run["readings"]
            ref_s = None
        if seed in args.seeds:
            emit(seed=seed, side="program", numbers=numbers, seconds=time.perf_counter() - w0,
                 reference_s=ref_s,
                 leaves={"program": prog, "reference": ref} if cell.kind == "fedleo_train" else None)
        if seed in args.control_seeds:
            if cell.kind == "fedleo_train":
                control = drv.reference(cell, seed, fed, device, ref_model.fp8)
                cnum = check.train_numbers(control, ref)
                emit(seed=seed, side="control-leaves", numbers={}, leaves=control)
            else:
                control = [ref_model.last_logits(rd["ref_params"], t, cell.config,
                                                 cell.family.reference.blocks, ref_model.fp8)
                           for t in rd["prompts"]]
                cnum = check.prefill_numbers(control, rd["reference"])
            emit(seed=seed, side="control", numbers=cnum)
        if cell.kind != "fedleo_train":
            del run, rd
        torch.cuda.empty_cache()
        if seed in args.fault_seeds:
            for fault in faults.FAULTS[cell.kind]:
                with faults.planted(fault):
                    if cell.kind == "fedleo_train":
                        st = drv.Setup(cell, seed, device)
                        fprog = st.prog
                        del st
                        fnum = check.train_numbers(fprog, ref)
                    else:
                        fnum = drv.run(cell, seed, args.seconds, False, device,
                                       time.perf_counter())["numbers"]
                torch.cuda.empty_cache()
                emit(seed=seed, side=f"fault:{fault}", numbers=fnum)
    return 0


if __name__ == "__main__":
    sys.exit(main())
