"""Where a benchmark cell's device time goes, by the program's spans, and
what the step tracer costs.

    python3 tools/step_spans.py --workload fedleo_train.mamba2-780m --seed 7 [--pairs 3]
    python3 tools/step_spans.py --workload prefill.mamba2-780m --seed 7 [--pairs 3]

On the card, from the root of a checkout.  Builds the cell's state as
its benchmark driver does (``bench/drivers/``: the same configuration,
weights, feed and set-up), then:

  1. cost: ``--pairs`` pairs of one tau-cycle (training) or one call
     (prefill) without the tracer and one inside
     ``repro_torch.profiling.recording(device)``, in turns; each local step or
     call on the host clock to a synchronise, as the benchmark's
     ``local_step_s.train`` times it;
  2. the split: the traced turns' spans, read by ``bench/spans.py``
     (device time between each span's events, means per call, replica
     step or replica);
  3. idle: one more cycle or call, traced, under a device-only profiler
     session (``bench/trace.py``), its gaps against its spans: the idle
     share, the share of idle time the host spent inside some span or
     inside the train step's, idle seconds by span, the 10 longest gaps
     labelled; and against the host's own stalls over it: each pass of
     Python's garbage collector (the idle time it holds, for each long
     gap) and the caching allocator's device allocations, frees and
     retries.

Training reuses the driver's ``Setup``.  Prefill builds the model,
weights and token generator as ``bench/drivers/prefill.py`` does and
takes only a mix of one prompt length (the driver's seeded order of a
mix of several lengths is not followed): it refuses any other.

Prints one JSON line and appends it to ``--out``
(``build/step_spans/results.jsonl``).
"""
import argparse
import contextlib
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


ALLOCATOR = ("num_alloc_retries", "num_device_alloc", "num_device_free", "num_sync_all_streams")


@contextlib.contextmanager
def _host_events():
    """The host's own stalls over the block: each pass of Python's cyclic
    garbage collector, [generation, start ns, end ns] on the profiler's
    clock, and the caching allocator's counters' change (device
    allocations and frees, retries)."""
    import torch

    out = {"gc": []}
    opened = {}

    def on_gc(phase, info):
        if phase == "start":
            opened["ns"] = time.time_ns()
        else:
            out["gc"].append([info["generation"], opened.pop("ns", None), time.time_ns()])

    stats0 = torch.cuda.memory_stats()
    gc.callbacks.append(on_gc)
    try:
        yield out
    finally:
        gc.callbacks.remove(on_gc)
        stats1 = torch.cuda.memory_stats()
        out["allocator"] = {k: stats1[k] - stats0[k] for k in ALLOCATOR if k in stats0}


def _stalls(host, gaps_ns):
    """Of each gap (start ns, end ns): the ns of it in a garbage
    collector's pass, and the passes' generations."""
    out = []
    for s, e in gaps_ns:
        passes = [(g, a, b) for g, a, b in host["gc"] if a is not None and a < e and b > s]
        out.append({"gc_ns": sum(min(b, e) - max(a, s) for _, a, b in passes),
                    "gc_generations": sorted({g for g, _, _ in passes})})
    return out


def _train(cell, seed, device, pairs):
    from bench import harness, trace as tracing
    from bench.drivers.fedleo_train import Setup
    from repro_torch import profiling
    from repro_torch.kernels.aggregate import KERNEL, aggregate_flat

    st = Setup(cell, seed, device)
    off, on, recorded = [], [], []
    for _ in range(pairs):
        for traced in (False, True):
            times = {"local_step_s": [], "aggregate_events": []}
            if traced:
                with profiling.recording(device) as rec:
                    st.cycle(times)
                    harness.sync(device)
                recorded.append(rec.records())
            else:
                st.cycle(times)
                harness.sync(device)
            (on if traced else off).extend(times["local_step_s"])

    kept = {}

    def session():
        before = aggregate_flat.launches
        with (tracing.device_profile() as prof, profiling.recording(device) as rec,
              _host_events() as host):
            st.cycle()
        kept["events"], kept["spans"] = list(prof.profiler.kineto_results.events()), rec.records()
        kept["host"] = host
        return tracing.read(prof), [((KERNEL,), aggregate_flat.launches - before)]

    tracing.whole_profile(session)
    return {"local_step_s": {"off": off, "on": on}}, recorded, kept


def _prefill(cell, seed, device, pairs):
    import torch

    from bench import harness, trace as tracing, weights
    from repro_torch import profiling
    from repro_torch.configs import build_model
    from repro_torch.kernels import ssd
    from repro_torch.train import steps as program_steps

    cfg, tf = cell.config, cell.traffic
    if len(set(tf["lengths"])) != 1:
        raise SystemExit(f"step_spans: {cell.name} mixes prompt lengths {tf['lengths']}; "
                         "only a mix of one length is supported")
    sv = cfg["serve"]
    model = build_model(harness.program_config(cfg), attn_impl=sv["attn_impl"],
                        ssd_impl=sv["ssd_impl"], dtype=getattr(torch, sv["compute_dtype"]),
                        device=device)
    params = weights.make(cfg, seed, getattr(torch, sv["param_dtype"]), device)
    step = program_steps.make_prefill_step(model)
    gen = torch.Generator(device=device).manual_seed(weights.seed_for(seed, 1))
    s = tf["lengths"][0]

    def call():
        tokens = torch.randint(0, cfg["vocab_size"], (tf["batch"], s), generator=gen,
                               device=device)
        w0 = time.perf_counter()
        step(params, {"tokens": tokens})
        harness.sync(device)
        return time.perf_counter() - w0

    call()
    off, on, recorded = [], [], []
    for _ in range(pairs):
        off.append(call())
        with profiling.recording(device) as rec:
            on.append(call())
        recorded.append(rec.records())

    kept = {}

    def session():
        before = ssd.ssd_scan.launches
        with (tracing.device_profile() as prof, profiling.recording(device) as rec,
              _host_events() as host):
            call()
        kept["events"], kept["spans"] = list(prof.profiler.kineto_results.events()), rec.records()
        kept["host"] = host
        return tracing.read(prof), [(tuple(ssd.KERNELS.values()), ssd.ssd_scan.launches - before)]

    tracing.whole_profile(session)
    return {"call_s": {"off": off, "on": on}}, recorded, kept


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--out", default=str(ROOT / "build" / "step_spans" / "results.jsonl"))
    args = parser.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import subprocess

    import torch

    from bench import harness, spans, trace as tracing

    if not torch.cuda.is_available():
        print("step_spans: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = harness.resolve(args.workload)
    kind = {"fedleo_train": _train, "prefill": _prefill}[cell.kind]
    cost, recorded, kept = kind(cell, args.seed, device, args.pairs)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    traced = spans.Spans(*recorded)
    profiled = spans.Spans(kept["spans"])
    gaps = spans.Idle(kept["events"])
    prof = gaps.profile
    idle = gaps.intervals()
    idle_ns = sum(e - s for s, e in idle)
    out = {"workload": cell.name, "seed": args.seed, "card": card,
           "torch": torch.__version__,
           "cost": {k: {"off_median": statistics.median(v["off"]),
                        "on_median": statistics.median(v["on"]),
                        "on_over_off": statistics.median(v["on"]) / statistics.median(v["off"]),
                        **v} for k, v in cost.items()},
           "profiled": {"window_s": prof.window_s, "busy_s": prof.busy_s,
                        "idle_share": 1.0 - prof.busy_s / prof.window_s,
                        "idle_s": idle_ns * 1e-9,
                        "idle_in_spans_share": profiled.held(idle) / idle_ns if idle_ns else None,
                        "idle_by_span": spans.idle_by_label(gaps, profiled, depth=2),
                        "idle_by_span_3": dict(list(spans.idle_by_label(gaps, profiled,
                                                                        depth=3).items())[:12]),
                        "idle_gaps": spans.idle_gaps(gaps, profiled)},
           "host": {"allocator": kept["host"]["allocator"],
                    "gc_passes": len(kept["host"]["gc"]),
                    "gc_s": sum(b - a for _, a, b in kept["host"]["gc"] if a is not None) * 1e-9,
                    "idle_gaps": _stalls(kept["host"], sorted(idle, key=lambda g: g[0] - g[1])[:10]),
                    "gc_idle_s": sum(g["gc_ns"] for g in _stalls(kept["host"], idle)) * 1e-9}}
    if cell.kind == "fedleo_train":
        out["split"] = spans.train_split(traced)
        out["split_profiled"] = spans.train_split(profiled)
        out["train_step_idle_ms"] = spans.train_step_idle_ms(gaps, profiled)
        # forward, backward, optimizer and copy-out of every replica over the local step
        parts_ms = sum(r["device_ms"] for r in traced.records
                       if r["name"] in spans.TRAIN_STEP + ("fedleo.copy_out",))
        steps_s = sum(r["device_ms"] for r in traced.named("fedleo.local_step")) * 1e-3
        out["parts_over_local_step"] = parts_ms * 1e-3 / steps_s
    else:
        out["split"] = spans.prefill_split(traced)
        out["split_profiled"] = spans.prefill_split(profiled)
    line = json.dumps(out)
    print(line, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
