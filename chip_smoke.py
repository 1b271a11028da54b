#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile]

Phases, each printing one JSON line; the first failure raises and the
script exits non-zero without a result line:

  1. device   — the card (nvidia-smi name and power limit, torch name).
  2. build    — nvcc builds src/repro_torch/kernels/csrc/aggregate.cu
                afresh.
  3. check    — each kernel against its plain PyTorch version on the
                card, at ragged shapes and at the main path's shapes.
  4. time     — kernel, plain version and one library call (CUDA
                events, L2 flushed before each launch, median).
  5. main     — the main path: FedLEO rounds on the quickstart scenario
                with the full-width CNN and the CUDA aggregation kernel,
                launch counts reset just before and read just after.
  6. agree    — a small FedLEO round on the card against the same round
                on the CPU (which the CPU tests hold to the JAX package).

With --profile, one more main-path round runs after the launch counts
are read, under torch.profiler: its wall time split into local
training, aggregation, evaluation and the rest (scheduling), each range
closed by a device synchronise, and the device's kernel time by name
with its busy share (phase ``profile``).

Then the kernels line, the nvidia-smi line and, last, the result line.
TF32 is off for matmuls and convolutions, so float32 stays float32.
Exits non-zero when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM, float32 outside the tensor cores
SCENARIO = dict(num_planes=5, sats_per_plane=8, train=1600)
MAIN_ROUNDS = 4
SIM_EPOCHS = 8


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out.splitlines()[0]


def aggregate_bound_ms(k: int, n: int, itemsize: int):
    """Least time for one aggregation: x and w read once, out written
    once, against 2*K*N float32 operations; returns (ms, bound_by, bytes)."""
    nbytes = (k + 1) * n * itemsize + 4 * k
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * k * n / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def time_ms(torch, fn, flush, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, L2 flushed before each."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_task(widths, hidden, num_samples, batch_size, sim_epochs, device):
    """The quickstart scenario's task: non-IID mnist-like data over 5x8
    satellites (a test set a quarter the size of the training set), the
    paper's CNN at the given widths, SGD at 0.05."""
    from repro_torch.core import FederatedTask, TrainHyperparams
    from repro_torch.data import make_classification_dataset, partition_noniid_by_orbit
    from repro_torch.models.cnn import apply_cnn, init_cnn
    from repro_torch.optim import get_optimizer

    train = make_classification_dataset("mnist-like", num_samples=num_samples, seed=0)
    test = make_classification_dataset("mnist-like", num_samples=num_samples // 4, seed=99)
    clients = partition_noniid_by_orbit(
        train, SCENARIO["num_planes"], SCENARIO["sats_per_plane"]
    )
    return FederatedTask(
        init_fn=lambda r: init_cnn(r, (28, 28, 1), 10, widths=widths, hidden=hidden),
        apply_fn=apply_cnn,
        clients=clients,
        test_set=test,
        optimizer=get_optimizer("sgd", 0.05),
        hp=TrainHyperparams(local_epochs=100, learning_rate=0.05, batch_size=batch_size),
        sim_epochs=sim_epochs,
        device=device,
    )


def profile_round(torch, strategy, t: float) -> dict:
    """One main-path round under torch.profiler, its wall time split by
    synchronised ranges around the task's and the aggregation's calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import fedleo

    def ranged(fn, label):
        def call(*args, **kwargs):
            with record_function(label):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            return out
        return call

    task, agg = strategy.task, fedleo.aggregation
    patches = [(task, "local_train", "local_train"), (task, "evaluate", "evaluate"),
               (agg, "partial_aggregate", "aggregate"), (agg, "global_aggregate", "aggregate")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, label in patches:
        setattr(obj, name, ranged(getattr(obj, name), label))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            t_next = strategy.run_round(t)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - w0)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    check(t_next is not None, "profiled round found no feasible schedule")

    # record_function ranges appear twice: the host range (CPU) and its
    # annotation on the device timeline; kernels and copies are the
    # device events that are not annotations
    stats = prof.key_averages()
    ranges = {e.key: e.cpu_time_total / 1e3 for e in stats
              if e.key in ("local_train", "evaluate", "aggregate")
              and e.device_type == DeviceType.CPU}
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in stats
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda r: -r[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    return dict(
        wall_ms=wall_ms,
        host_ranges_ms={**ranges, "other": wall_ms - sum(ranges.values())},
        device_busy_ms=busy_ms if kernels else "not measured",
        device_busy_share=busy_ms / wall_ms if kernels else "not measured",
        aggregate_kernel_ms=sum(ms for k, ms, _ in kernels if "aggregate_kernel" in k),
        top_kernels=[{"name": k[:120], "ms": ms, "count": c} for k, ms, c in kernels[:12]],
        t_next=t_next,
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more main-path round after the checks")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # build afresh into a directory of the checkout that .gitignore lists
    build_root = ROOT / "build" / "chip_smoke"
    shutil.rmtree(build_root, ignore_errors=True)
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build_root)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.aggregate import aggregate_flat
    from repro_torch.kernels.aggregate_ref import aggregate_flat_ref, bf16_ulp_distance
    from repro_torch.models.cnn import init_cnn
    from repro_torch.models.nn import count_params
    from repro_torch.tree import tree_leaves

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda", 0)

    # 2. build
    t0 = time.perf_counter()
    lib = build.build("aggregate")
    emit("build", seconds=time.perf_counter() - t0, library=str(lib.relative_to(ROOT)))

    # 3. each kernel against its plain version, on the card
    n_main = count_params(init_cnn(torch.Generator().manual_seed(0)))
    p = SCENARIO["num_planes"]
    s = SCENARIO["sats_per_plane"]
    main_shapes = [(s, n_main), (p, n_main)]       # plane partial, global
    gen = torch.Generator(device=dev).manual_seed(0)
    main_err = None
    for k, n in [(1, 1_000_003), (5, 1_000_003), (8, 1_000_003), *main_shapes]:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            w = torch.rand((k,), generator=gen, device=dev) + 0.05
            w = w / w.sum()
            got = aggregate_flat(x, w)
            want = aggregate_flat_ref(x, w)
            torch.cuda.synchronize()
            check(got.shape == (n,) and got.dtype == dtype, f"bad output {got.shape} {got.dtype}")
            check(bool(torch.isfinite(got.float()).all()), "non-finite output")
            abs_err = float((got.float() - want.float()).abs().max())
            if dtype == torch.float32:
                rel = abs_err / float(want.abs().max())
                ok, tol = rel <= 1e-5, {"max_rel_err": rel, "limit": 1e-5}
            else:
                ulps = int(bf16_ulp_distance(got, want).max())
                ok, tol = ulps <= 1, {"max_ulp": ulps, "limit_ulp": 1}
            emit("check", kernel="aggregate_flat", K=k, N=n, dtype=str(dtype),
                 max_abs_err=abs_err, ok=ok, **tol)
            check(ok, f"aggregate_flat disagrees with its plain version at K={k} N={n} {dtype}")
            if (k, n) == main_shapes[0] and dtype == torch.float32:
                main_err = abs_err
            del x, got, want

    # 4. times: kernel, plain version, one library call (never used by the port)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)   # 256 MB > L2
    timed = {}
    for k, n in [*main_shapes, (8, 2**25)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            w = torch.full((k,), 1.0 / k, device=dev)
            w_lib = w.to(dtype)
            kern = time_ms(torch, lambda: aggregate_flat(x, w), flush)
            plain = time_ms(torch, lambda: aggregate_flat_ref(x, w), flush)
            lib = time_ms(torch, lambda: torch.matmul(w_lib, x), flush)
            bound, bound_by, nbytes = aggregate_bound_ms(k, n, x.element_size())
            row = dict(K=k, N=n, dtype=str(dtype), bytes=nbytes, bound_ms=bound,
                       bound_by=bound_by, ms=kern, plain_ms=plain, library_ms=lib,
                       achieved_GBps=nbytes / (kern * 1e-3) / 1e9,
                       roofline_share=bound / kern, nvidia_smi=smi)
            emit("time", kernel="aggregate_flat", **row)
            timed[(k, n, dtype)] = row
            del x
    del flush

    # 5. the main path: FedLEO rounds at full CNN width on the card
    from repro_torch.core import FedLEO, SimConfig

    task = make_task((32, 64), 128, SCENARIO["train"], 16, SIM_EPOCHS, None)
    check(task.device.type == "cuda", f"task on {task.device}")
    check(all(l.is_cuda for l in tree_leaves(task.global_params)), "params not on cuda")
    check(task._x_stack.is_cuda and task._test_x.is_cuda, "data not on cuda")
    check(count_params(task.global_params) == n_main, "unexpected model width")
    strategy = FedLEO(task, SimConfig(horizon_hours=72.0, use_kernel=True))
    aggregate_flat.launches = 0
    t, accs, t0 = 0.0, [], time.perf_counter()
    for _ in range(MAIN_ROUNDS):
        r0 = time.perf_counter()
        t_next = strategy.run_round(t, verbose=True)
        torch.cuda.synchronize()
        check(t_next is not None, "round found no feasible schedule")
        h = strategy.history[-1]
        accs.append(h.metrics["accuracy"])
        emit("round", round=h.round_index, t_hours=h.t_hours, wall_s=time.perf_counter() - r0,
             **h.metrics)
        t = t_next
    wall = time.perf_counter() - t0
    launches = aggregate_flat.launches
    if args.profile:
        prof = profile_round(torch, strategy, t)
        t = prof.pop("t_next")
        emit("profile", round=MAIN_ROUNDS + 1, nvidia_smi=smi, **prof)
    strategy.finish(t)
    violations = [str(v) for v in strategy.env.sanitizer.report()]
    expected = MAIN_ROUNDS * (p + 1)
    finite = all(bool(torch.isfinite(l).all()) for l in tree_leaves(strategy.global_params))
    emit("main", rounds=MAIN_ROUNDS, params=n_main, sim_epochs=SIM_EPOCHS,
         payload_bits=task.payload_bits, wall_s=wall, accuracy=accs,
         aggregate_flat_launches=launches, expected_launches=expected, finite=finite,
         schedule_violations=violations)
    check(launches == expected, f"aggregate_flat launched {launches} times, expected {expected}")
    check(finite, "non-finite global params")
    check(not violations, f"schedule sanitizer: {violations}")
    check(accs[-1] > accs[0] and accs[-1] > 0.1, f"no learning: {accs}")

    # 6. a small round on the card agrees with the same round on the CPU
    runs = {}
    for device in ("cuda", "cpu"):
        small = FedLEO(make_task((4, 8), 16, 800, 32, 2, device),
                       SimConfig(horizon_hours=72.0, use_kernel=True))
        res = small.run(max_rounds=1)
        runs[device] = (res, [l.cpu() for l in tree_leaves(small.global_params)])
    (rc, pc), (rh, ph) = runs["cuda"], runs["cpu"]
    param_err = max(float((a - b).abs().max()) for a, b in zip(pc, ph))
    same_sched = (rc.history[0].t_hours == rh.history[0].t_hours
                  and rc.history[0].events == rh.history[0].events)
    emit("agree", param_max_abs_err=param_err, limit=1e-4, same_schedule=same_sched,
         accuracy_cuda=rc.final_accuracy, accuracy_cpu=rh.final_accuracy)
    check(same_sched, "CUDA and CPU schedules differ")
    check(param_err <= 1e-4, f"CUDA and CPU params differ by {param_err}")

    main_row = timed[(s, n_main, torch.float32)]
    print(json.dumps({"kernels": [{
        "name": "aggregate_flat",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/aggregate.cu",
        "replaces": "src/repro/kernels/aggregate.py:33",
        "tpu": "src/repro/kernels/aggregate.py::aggregate_flat",
        "launches": launches,
        "max_abs_err": main_err,
        "max_err": main_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    shutil.rmtree(build_root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
