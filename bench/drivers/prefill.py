"""Driver of traffic kind ``prefill``: one caller in a closed loop of
prefill calls through ``make_prefill_step``.

Each call sends ``batch`` prompts of one length; the lengths cycle
through ``lengths`` in an order the seed shuffles within each cycle, and
the token ids are drawn on the device from the seed.  Set-up warms up
one call of each length.  The window runs whole cycles until one ends
after ``seconds``; every call is timed on the host clock from its issue
to the synchronise that returns its last-position logits.  With
``trace`` one more cycle runs under the profiler.  After the window the
plain reference recomputes ``checked_prompts`` of the window's prompts,
drawn from the seed with one of the longest among them, in blocks of at
most ``REF_BLOCK`` rows.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import check, counts, harness, trace as tracing, weights
from bench.reference import model as ref_model


def length_order(lengths, seed: int):
    """The prompt length of each call, without end: cycle after cycle,
    each a permutation of ``lengths`` drawn from the seed."""
    rng = np.random.default_rng(weights.seed_for(seed, 2))
    while True:
        yield from (int(x) for x in rng.permutation(lengths))


KEYS = frozenset({"batch", "lengths", "checked_prompts"})
REF_BLOCK = 32


def checked_prompts(calls, seed: int, count: int):
    """(call index, rows) of the prompts the check recomputes: one of the
    longest, and more drawn from the seed, ``count`` in all, each call's
    rows in blocks of at most ``REF_BLOCK``."""
    rng = np.random.default_rng(weights.seed_for(seed, 3))
    every = [(i, r) for i, (_, tokens, _) in enumerate(calls) for r in range(tokens.shape[0])]
    longest = max(s for s, _, _ in calls)
    idx = [k for k, (i, _) in enumerate(every) if calls[i][0] == longest]
    first = int(rng.choice(idx))
    rest = [k for k in range(len(every)) if k != first]
    more = rng.choice(rest, size=min(count - 1, len(rest)), replace=False) if rest else []
    picked = sorted([first, *(int(k) for k in more)])
    by_call = {}
    for k in picked:
        i, r = every[k]
        by_call.setdefault(i, []).append(r)
    return [(i, rows[j:j + REF_BLOCK]) for i, rows in sorted(by_call.items())
            for j in range(0, len(rows), REF_BLOCK)]


def launch_shapes(kernels, made, b: int, lengths) -> dict:
    """The launches of the hand-written kernels in one profiled cycle of
    calls of ``b`` prompts of each of ``lengths``, by key: one shape a
    launch, each use's ``made`` launches spread evenly over the calls."""
    out: dict = {}
    for k, m in zip(kernels, made):
        out.setdefault(k.key, []).extend(k.shape(b, s) for s in lengths
                                         for _ in range(m // len(lengths)))
    return out


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t0: float) -> dict:
    from repro_torch.configs import build_model
    from repro_torch.train import steps as program_steps

    cfg, tf = cell.config, cell.traffic
    sv = cfg["serve"]
    b, lengths = tf["batch"], list(tf["lengths"])
    acfg = harness.program_config(cfg)
    model = build_model(acfg, attn_impl=sv["attn_impl"], ssd_impl=sv["ssd_impl"],
                        dtype=getattr(torch, sv["compute_dtype"]), device=device)
    params = weights.make(cfg, seed, getattr(torch, sv["param_dtype"]), device)
    step = program_steps.make_prefill_step(model)
    gen = torch.Generator(device=device).manual_seed(weights.seed_for(seed, 1))
    on_card = device.type == "cuda"

    def call(s):
        tokens = torch.randint(0, cfg["vocab_size"], (b, s), generator=gen, device=device)
        w0 = time.perf_counter()
        logits = step(params, {"tokens": tokens})
        harness.sync(device)
        return tokens, logits, time.perf_counter() - w0

    for s in lengths:                                  # warm-up: each length once
        call(s)
    harness.sync(device)
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    order = length_order(lengths, seed)
    calls = []                                         # (length, tokens, logits)
    latencies = []
    t_start = time.perf_counter()
    setup_s = t_start - t0
    while True:
        for _ in lengths:
            s = next(order)
            tokens, logits, dt = call(s)
            calls.append((s, tokens, logits))
            latencies.append(dt)
        if time.perf_counter() - t_start >= seconds:
            break
    window_s = time.perf_counter() - t_start
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    failed = sum(int((~torch.isfinite(lg.float())).any(dim=-1).sum()) for _, _, lg in calls)

    profile, launches = None, {}
    if trace and on_card:
        itemsize = torch.empty((), dtype=getattr(torch, sv["compute_dtype"])).element_size()
        kernels = cell.family.prefill_kernels(cfg, itemsize)
        cycle_lengths, made = [], []

        def session():
            nonlocal cycle_lengths, made
            before = [k.count() for k in kernels]
            cycle_lengths = [next(order) for _ in lengths]
            with tracing.device_profile() as prof:
                for s in cycle_lengths:
                    call(s)
            made = [k.count() - n for k, n in zip(kernels, before)]
            return tracing.read(prof), [(k.names, m) for k, m in zip(kernels, made)]

        profile = tracing.whole_profile(session)
        launches = launch_shapes(kernels, made, b, cycle_lengths)

    tokens = sum(b * s for s, _, _ in calls)
    run_record = {
        "cell": cell.name, "config": cfg, "traffic": tf,
        "end_to_end": {"prefill_tokens_per_s": tokens / window_s, "setup_s": setup_s},
        "window": {"seconds": window_s, "calls": len(calls), "tokens": tokens,
                   "flops": sum(counts.prefill_flops(cfg, b, s) for s, _, _ in calls)},
        "spans": {"prefill_call_s": latencies}, "launches": launches, "profile": profile,
        "memory": {"window_peak_bytes": window_peak},
        "attempted": b * len(calls), "failed": failed,
        "device": harness.device_info(device, max(setup_peak, window_peak)),
    }

    # the check, after the window, with the program's weights freed
    picked = checked_prompts(calls, seed, tf["checked_prompts"])
    prog = [calls[i][2][rows] for i, rows in picked]
    prompts = [calls[i][1][rows] for i, rows in picked]
    del params, model, step, calls
    if on_card:
        torch.cuda.empty_cache()
    ref_params = ref_model.as_float32(weights.make(cfg, seed, getattr(torch, sv["param_dtype"]),
                                                   device))
    ref = [ref_model.last_logits(ref_params, t, cfg, cell.family.reference.blocks)
           for t in prompts]
    run_record["numbers"] = check.prefill_numbers(prog, ref)
    run_record["readings"] = {"checked_prompts": picked, "prompts": prompts, "program": prog,
                              "reference": ref, "ref_params": ref_params}
    return run_record
