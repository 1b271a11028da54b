#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile]

Phases, each printing JSON lines; the first failure raises and the
script exits non-zero without a result line:

  1. device      — the card (nvidia-smi name and power limit, torch name).
  2. build       — nvcc builds src/repro_torch/kernels/csrc/aggregate.cu,
                   flash.cu and ssd.cu afresh, all at once; ptxas's
                   registers and spills of each flash and SSD kernel.
  3. check       — each kernel against its plain PyTorch version on the
                   card, at ragged shapes and at the main paths' shapes;
                   the aggregation kernel also over whole leaf lists:
                   the CNN's stacked tree (one launch) and a ragged
                   mixed-dtype list with strided and offset views.
  4. time        — kernel, plain version and one library call (CUDA
                   events, median of 30, a device spin between the flush
                   and the start event), beside the kernel's bound;
                   aggregation at the FedLEO shapes under three flushes
                   of L2 before each launch (``dirty``: a 256 MB
                   ``zero_()``, which leaves L2 full of dirty lines, as
                   for flash and SSD; ``clean``: a read of the same
                   buffer; ``warm``: none, the inputs in L2 as local
                   training leaves them) and at 8 x 2^25 (dirty and
                   clean), the plain version under the dirty flush only,
                   then the pytree route (``torch.cat`` + one
                   ``aggregate_flat`` against one launch over the leaves,
                   with wall time per call and peak device memory) on
                   the CNN's tree and mamba2-780m's; flash (dirty) at
                   gemma-7b's and zamba2-1.2b's prefill shapes, the SSD
                   scan (dirty) at mamba2-780m's and zamba2-1.2b's and
                   at mamba2's with one prompt.
  5. main        — the FedLEO path: rounds on the quickstart scenario
                   with the full-width CNN and the CUDA aggregation
                   kernel, launch counts reset just before and read just
                   after.
  6. agree       — a small FedLEO round on the card against the same
                   round on the CPU (which the CPU tests hold to the JAX
                   package).
  7. serve       — the serving path: gemma-7b at full width and depth in
                   bfloat16, prefill through the CUDA flash kernel
                   (``make_prefill_step``; its tensor-core kernel alone,
                   by the profile's kernel names) and greedy decoding
                   against the KV cache (``make_serve_step``), launch
                   counts reset just before and read just after.
  8. serve_agree — prefill (kernel) against teacher-forced decode (cache
                   path) at full width; smoke configs on the card
                   against the CPU.
  9. ssm_serve   — the SSM serving path, after gemma's weights are freed:
                   mamba2-780m and zamba2-1.2b at full width and depth
                   in bfloat16, prefill through the CUDA SSD kernel (its
                   tensor-core kernel alone, by the profile's kernel
                   names; zamba2's shared attention through the flash
                   kernel), greedy decoding against the recurrent cache,
                   launch counts reset just before and read just after.
 10. ssm_agree   — SSM prefill (kernel) against teacher-forced decode
                   (recurrence, no kernel) at full width; smoke configs
                   on the card against the CPU at a ragged S.

With --profile, one more FedLEO round runs after the launch counts are
read, under torch.profiler: its wall time split into local training,
aggregation, evaluation and the rest (scheduling), each range closed by
a device synchronise, the device's kernel time by name with its busy
share, and what ran inside the aggregation ranges: no concatenation
(phase ``profile``).

Then the kernels line, the nvidia-smi line and, last, the result line.
TF32 is off for matmuls and convolutions, so float32 stays float32.
Exits non-zero when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # H100 SXM, bfloat16 tensor cores, dense
SCENARIO = dict(num_planes=5, sats_per_plane=8, train=1600)
MAIN_ROUNDS = 4
SPIN_CYCLES = 2_000_000            # about 1 ms at the H100's clocks
SIM_EPOCHS = 8

# flash attention: (B, S, H, G, D) checked on the card — gemma-7b's heads,
# phi3-medium's GQA heads, MQA, and two ragged S — in five modes
FLASH_CHECK_SHAPES = [(1, 2048, 16, 16, 256), (1, 1024, 40, 10, 128),
                      (2, 256, 4, 1, 32), (1, 77, 4, 2, 64), (1, 2000, 16, 16, 256)]
FLASH_MODES = {"causal": (True, None, None), "full": (False, None, None),
               "window512": (True, 512, None), "softcap20": (True, None, 20.0),
               "full+window512": (False, 512, None)}
# input scales of q, k and v: scores of std 0.25 (a near-uniform softmax,
# long rows average many keys) and of std 4 (a peaked softmax, where the
# soft-cap bites and a wrong scale or a lost key moves the output a lot)
FLASH_INPUT_SCALES = {"flat": 0.5, "peaked": 2.0}
# Both versions compute in float32 from the same input values, so the
# kernel may differ from the float32 plain version by float32 rounding,
# FLASH_F32_REL of the output's largest value (measured: below 3e-6 of it),
# and in bfloat16 also by its one rounding of the output, half an ulp.
FLASH_F32_REL = 1e-5
BF16_HALF_ULP = 2.0 ** -8
# the serving path: gemma-7b prefill of 4 prompts of 2048 tokens
SERVE_BATCH, SERVE_SEQ = 4, 2048
# flash timed at the prefill shapes (B, S, H, G, D): gemma-7b, full and
# window 512, and zamba2-1.2b's shared attention
FLASH_TIME_CASES = {"causal": ((SERVE_BATCH, SERVE_SEQ, 16, 16, 256), True, None),
                    "window512": ((SERVE_BATCH, SERVE_SEQ, 16, 16, 256), True, 512),
                    "zamba2_causal": ((SERVE_BATCH, SERVE_SEQ, 32, 32, 64), True, None)}
# the library's attention kernels by name (SDPA's flash, memory-efficient
# and cuDNN kernels), which the port must never launch
LIBRARY_ATTENTION = ("pytorch_flash", "fmha", "attentionkernel", "sdpa", "flash_attn")
DECODE_PROMPT, DECODE_GEN = 64, 32
GEMMA_PARAMS = 8_537_680_896
# the SSD scan: (B, S, H, P, G, N) checked on the card — mamba2-780m's and
# zamba2-1.2b's heads, a grouped case, two ragged S — at two input scales:
# the tests' (dt in [0.1, 0.6], A in [-0.6, -0.1]) and the model's (dt =
# softplus of N(0, 1), A = -linspace(1, 16) as init_mamba_block makes it)
SSD_CHECK_SHAPES = [(1, 2048, 48, 64, 1, 128), (1, 2048, 64, 64, 1, 64),
                    (1, 1024, 48, 64, 2, 128), (1, 2000, 48, 64, 1, 128),
                    (1, 77, 64, 64, 1, 64)]
SSD_SCALES = ("tests", "model")
SSD_CHUNK = 128
# the SSD scan timed at the prefill shapes (B, S, H, P, G, N): mamba2-780m's
# (the kernels line's), zamba2-1.2b's, and mamba2-780m's with one prompt
SSD_TIME_CASES = {"mamba2": (SERVE_BATCH, SERVE_SEQ, 48, 64, 1, 128),
                  "zamba2": (SERVE_BATCH, SERVE_SEQ, 64, 64, 1, 64),
                  "mamba2_b1": (1, SERVE_SEQ, 48, 64, 1, 128)}
SSM_MODELS = {"mamba2-780m": 780_148_992, "zamba2-1.2b": 1_104_937_856}


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes of each flash, SSD or aggregation kernel
    in ``nvcc -Xptxas -v`` output, by name and integer template arguments
    (flash: head dim, and the key tile of the CUDA-core kernel; SSD: the
    64-column blocks of N of the tensor-core kernel, P of the CUDA-core
    one; aggregation: K, 0 for any K above 8, and the leaf table's
    capacity), and any warning the assembler printed."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = re.search(r"(flash_fwd(?:_tc)?_kernel|ssd_scan(?:_tc)?_kernel"
                          r"|aggregate_leaves_kernel)I(\w*?)EEEv", mangled)
            args = ",".join(re.findall(r"Li(\d+)", m.group(2))) if m else ""
            name = f"{m.group(1)}<{args}>" if m else mangled
            out[name] = {}
        elif name and "spill stores" in line:
            words = line.split()
            out[name]["spill_store_bytes"] = int(words[words.index("spill") - 2])
            out[name]["spill_load_bytes"] = int(words[words.index("loads") - 3])
        elif name and line.startswith("ptxas info") and "Used" in line:
            words = line.split()
            out[name]["registers"] = int(words[words.index("Used") + 1])
        elif "warning" in line.lower():
            out.setdefault("warnings", []).append(line.strip())
    return out


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


def visible_pairs(s: int, causal: bool, window) -> int:
    """Number of (q, k) pairs the mask lets through, for one head."""
    total = 0
    for q in range(s):
        lo = max(0, q - window + 1) if window else 0
        hi = q + 1 if causal else s
        total += hi - lo
    return total


def flash_bound_ms(b, s, h, g, d, causal, window, itemsize, flops_per_s):
    """Least time for one attention call: q, k, v read once and o written
    once, against 4*D operations (two products) per visible (q, k) pair
    and head; returns (ms, bound_by, bytes, flops)."""
    nbytes = (2 * b * s * h * d + 2 * b * s * g * d) * itemsize
    flops = 4.0 * b * h * d * visible_pairs(s, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flops_per_s
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def l2_flushes(buf) -> dict:
    """What runs before each timed launch: ``dirty`` writes the 256 MB
    buffer (L2 is left full of dirty lines, which the launch then writes
    back as it evicts them), ``clean`` reads it (L2 is left clean),
    ``warm`` does nothing (the launch finds its inputs where the last one
    left them)."""
    return {"dirty": buf.zero_, "clean": buf.sum, "warm": None}


def time_ms(torch, fn, flush, reps: int = 30, warmup: int = 5, spin: bool = True) -> float:
    """Median device time of one call, ``flush`` (if any) run before each.
    With ``spin``, a spin of SPIN_CYCLES clocks on the device follows, so
    the start event is stamped after the host has queued the call, not
    before (without it, a call whose host side outlasts the flush's device
    time counts that host time too)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
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
    from repro_torch.kernels.aggregate import KERNEL

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
    kernels = device_kernels(stats)
    busy_ms = sum(ms for _, ms, _ in kernels)
    agg_ops, agg_kernels = range_contents(prof, "aggregate")
    cats = ([n for n in agg_ops if n in ("aten::cat", "aten::concat", "aten::concatenate")]
            + [n for n in agg_kernels if "CatArray" in n])
    check(not cats, f"the aggregation ranges concatenated: {cats}")
    return dict(
        wall_ms=wall_ms,
        host_ranges_ms={**ranges, "other": wall_ms - sum(ranges.values())},
        device_busy_ms=busy_ms if kernels else "not measured",
        device_busy_share=busy_ms / wall_ms if kernels else "not measured",
        aggregate_kernel_ms=sum(ms for k, ms, _ in kernels if KERNEL in k),
        aggregate_kernel_launches=sum(c for k, _, c in kernels if KERNEL in k),
        aggregate_range={"ops": sorted(set(agg_ops)), "kernels": sorted(set(agg_kernels))},
        top_kernels=[{"name": k[:120], "ms": ms, "count": c} for k, ms, c in kernels[:12]],
        t_next=t_next,
    )


def range_contents(prof, label: str):
    """(CPU op names, device kernel names) inside every host range
    ``label`` of a profile, the range's own kernels included."""
    from torch.autograd import DeviceType

    ops, kernels = [], []

    def walk(event):
        kernels.extend(k.name for k in event.kernels)
        for child in event.cpu_children:
            ops.append(child.name)
            walk(child)

    for event in prof.events():
        if event.name == label and event.device_type == DeviceType.CPU:
            walk(event)
    return ops, kernels


def device_kernels(stats):
    """(name, device ms, count) of the kernels and copies in a profile,
    largest first."""
    from torch.autograd import DeviceType

    return sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in stats
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda r: -r[1])


# --- the aggregation kernel (FedLEO path) -----------------------------------------
def leaves_error(torch, got, want):
    """The kernel's leaves against the plain version's: (max abs error,
    worst float32 error relative to its leaf's largest output, worst
    bfloat16 ulp distance, whether every leaf is within its limit:
    1e-5 relative in float32, 1 ulp in bfloat16).  The plain version
    repeats the kernel's fmaf chain, so the two should also be equal."""
    from repro_torch.kernels.aggregate_ref import bf16_ulp_distance

    abs_err, rel, ulps = 0.0, 0.0, 0
    for g, r in zip(got, want):
        check(g.shape == r.shape and g.dtype == r.dtype, f"bad output {g.shape} {g.dtype}")
        if r.numel() == 0:
            continue
        check(bool(torch.isfinite(g.float()).all()), "non-finite output")
        err = float((g.float() - r.float()).abs().max())
        abs_err = max(abs_err, err)
        if r.dtype == torch.float32:
            rel = max(rel, err / max(float(r.abs().max()), 1e-30))
        else:
            ulps = max(ulps, int(bf16_ulp_distance(g, r).max()))
    return abs_err, rel, ulps, rel <= 1e-5 and ulps <= 1


def cnn_stacked(torch, dev, gen, k, dtype):
    """The paper's CNN at full width (421,642 parameters, 8 leaves)
    stacked over k clients, random values from ``gen``."""
    from repro_torch.models.cnn import init_cnn
    from repro_torch.tree import tree_map

    return tree_map(lambda p: torch.randn((k, *p.shape), generator=gen, device=dev).to(dtype),
                    init_cnn(torch.Generator().manual_seed(0)))


def ragged_mixed_leaves(torch, dev, gen, k):
    """(K, n) leaves of both dtypes and every alignment: rows from 1 to
    1,000,003 elements, and per dtype two views into a matrix with rows
    5000 apart, one a single element in (off 16 bytes), one 16 bytes in."""
    xs = [torch.randn((k, n), generator=gen, device=dev).to(
              torch.float32 if i % 2 else torch.bfloat16)
          for i, n in enumerate([1, 7, 10, 288, 2049, 4096, 12_345, 401_408, 1_000_003])]
    for dtype in (torch.float32, torch.bfloat16):
        big = torch.randn((k, 5000), generator=gen, device=dev).to(dtype)
        step = 16 // big.element_size()
        xs += [big[:, 1:4097], big[:, step:step + 4096]]
    return xs


def check_aggregate(torch, dev, gen, main_shapes):
    from repro_torch.kernels.aggregate import aggregate_flat, aggregate_leaves
    from repro_torch.kernels.aggregate_ref import aggregate_flat_ref, aggregate_leaves_ref
    from repro_torch.tree import tree_leaves

    main_err = None
    for k, n in [(1, 1_000_003), (5, 1_000_003), (8, 1_000_003), (13, 1_000_003), *main_shapes]:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            w = torch.rand((k,), generator=gen, device=dev) + 0.05
            w = w / w.sum()
            got = aggregate_flat(x, w)
            want = aggregate_flat_ref(x, w)
            torch.cuda.synchronize()
            abs_err, rel, ulps, ok = leaves_error(torch, [got], [want])
            tol = ({"max_rel_err": rel, "limit": 1e-5} if dtype == torch.float32
                   else {"max_ulp": ulps, "limit_ulp": 1})
            if k in (1, 5, 8) and n == 1_000_003:
                # the plain version before the fmaf emulation, which the
                # one-thread-per-element kernel equalled bit for bit here
                matmul = (w.float() @ x.float()).to(dtype)
                m_abs, _, _, m_ok = leaves_error(torch, [got], [matmul])
                tol.update(matmul_max_abs_err=m_abs, matmul_bit_equal=bool(torch.equal(got, matmul)))
                check(m_ok, f"aggregate_flat disagrees with w @ x at K={k} N={n} {dtype}")
            emit("check", kernel="aggregate_flat", K=k, N=n, dtype=str(dtype),
                 max_abs_err=abs_err, bit_equal=bool(torch.equal(got, want)), ok=ok, **tol)
            check(ok, f"aggregate_flat disagrees with its plain version at K={k} N={n} {dtype}")
            if (k, n) == main_shapes[0] and dtype == torch.float32:
                main_err = abs_err
            del x, got, want

    cases = [(f"cnn K={k} {str(dtype).replace('torch.', '')}", k,
              [l.reshape(k, -1) for l in tree_leaves(cnn_stacked(torch, dev, gen, k, dtype))])
             for k, _ in main_shapes for dtype in (torch.float32, torch.bfloat16)]
    cases += [(f"ragged mixed K={k}", k, ragged_mixed_leaves(torch, dev, gen, k)) for k in (3, 8, 11)]
    for what, k, xs in cases:
        w = torch.rand((k,), generator=gen, device=dev) + 0.05
        w = w / w.sum()
        before = aggregate_flat.launches
        got = aggregate_leaves(xs, w)
        torch.cuda.synchronize()
        launches = aggregate_flat.launches - before
        want = aggregate_leaves_ref(xs, w)
        abs_err, rel, ulps, ok = leaves_error(torch, got, want)
        emit("check", kernel="aggregate_leaves", what=what, leaves=len(xs),
             views=sum(x.storage_offset() > 0 for x in xs), launches=launches,
             max_abs_err=abs_err, max_rel_err_f32=rel, max_ulp_bf16=ulps,
             bit_equal=all(torch.equal(g, r) for g, r in zip(got, want)), ok=ok)
        check(ok, f"aggregate_leaves disagrees with its plain version on {what}")
        check(launches == 1, f"aggregate_leaves took {launches} launches on {what}")
        del xs, got, want
    return main_err


def kernel_only_ms(torch, fn, flush, name: str, reps: int = 30):
    """Mean duration of the device kernel ``name`` over ``reps`` calls of
    ``fn`` (``flush`` and a spin before each) under torch.profiler: the
    kernel alone, without the launch and event latency that CUDA events
    around one call include."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            torch.cuda._sleep(SPIN_CYCLES)
            fn()
        torch.cuda.synchronize()
    found = [(ms, c) for k, ms, c in device_kernels(prof.key_averages()) if name in k]
    if not found:
        return "not measured"
    return sum(ms for ms, _ in found) / sum(c for _, c in found)


def time_aggregate(torch, dev, gen, flushes, smi, main_shapes):
    """The kernel and ``w @ x`` at the FedLEO shapes under each L2 flush
    and at 8 x 2^25 (dirty and clean), the plain version once a shape
    (dirty); at the FedLEO shapes under the clean flush also the kernel's
    own duration from the profiler."""
    from repro_torch.kernels.aggregate import KERNEL, aggregate_flat
    from repro_torch.kernels.aggregate_ref import aggregate_flat_ref

    timed = {}
    for k, n in [*main_shapes, (8, 2**25)]:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            w = torch.full((k,), 1.0 / k, device=dev)
            w_lib = w.to(dtype)
            bound, bound_by, nbytes = aggregate_bound_ms(k, n, x.element_size())
            for name, flush in flushes.items():
                if name == "warm" and n == 2**25:
                    continue            # 1.2 GB: no L2 holds it
                kern = time_ms(torch, lambda: aggregate_flat(x, w), flush)
                lib = time_ms(torch, lambda: torch.matmul(w_lib, x), flush)
                row = dict(K=k, N=n, dtype=str(dtype), flush=name, bytes=nbytes, bound_ms=bound,
                           bound_by=bound_by, ms=kern, library_ms=lib,
                           achieved_GBps=nbytes / (kern * 1e-3) / 1e9,
                           roofline_share=bound / kern, nvidia_smi=smi)
                if name == "dirty":
                    row["plain_ms"] = time_ms(torch, lambda: aggregate_flat_ref(x, w), flush,
                                              reps=5, warmup=1)
                if name == "clean" and n != 2**25:
                    alone = kernel_only_ms(torch, lambda: aggregate_flat(x, w), flush, KERNEL)
                    row.update(kernel_only_ms=alone,
                               kernel_only_share=(bound / alone if isinstance(alone, float)
                                                  else "not measured"))
                emit("time", kernel="aggregate_flat", **row)
                timed[(k, n, dtype, name)] = row
            del x
    return timed


def concatenated_route(torch, stacked, w):
    """The pytree route of the reference (whose TPU kernel takes one
    array): every leaf concatenated into one (K, N) stream, one
    ``aggregate_flat`` launch, the result split back into views."""
    from repro_torch.kernels.aggregate import aggregate_flat
    from repro_torch.tree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(stacked)
    k = leaves[0].shape[0]
    agg = aggregate_flat(torch.cat([l.reshape(k, -1) for l in leaves], dim=1), w)
    parts = torch.split(agg, [l[0].numel() for l in leaves])
    return tree_unflatten(treedef, [p.reshape(l.shape[1:]) for p, l in zip(parts, leaves)])


def mamba2_stacked(torch, dev, gen, k):
    """mamba2-780m's parameter tree (its real leaf shapes, 780,148,992
    parameters) stacked over k replicas in bfloat16, random values."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.tree import tree_flatten, tree_unflatten

    params = build_model(get_config("mamba2-780m"), ssd_impl="pallas").init(gen)
    leaves, treedef = tree_flatten(params)
    shapes = [tuple(l.shape) for l in leaves]
    del params, leaves
    torch.cuda.empty_cache()
    return tree_unflatten(treedef, [torch.randn((k, *s), generator=gen, device=dev,
                                                dtype=torch.bfloat16) for s in shapes])


def time_pytree(torch, dev, gen, clean, smi):
    """``aggregate_pytree`` (one launch over the leaves) against the
    concatenated route on the same stacked tree in the same call: device
    time (clean flush; three turns of each route, interleaved, the median
    of each route's three medians), host time to enqueue one call
    (the device not waited for), wall time of one call and its result
    (median, synchronised after each call), peak device
    memory above the inputs, launches, and bit-equality of the two
    results (one kernel, the same arithmetic per element)."""
    from repro_torch.kernels.aggregate import aggregate_flat
    from repro_torch.kernels.aggregate_ops import aggregate_pytree
    from repro_torch.tree import tree_leaves

    rows = []
    for tree, k, dtype in (("cnn", 8, torch.float32), ("cnn", 5, torch.float32),
                           ("mamba2-780m", 5, torch.bfloat16)):
        if tree == "cnn":
            stacked, reps = cnn_stacked(torch, dev, gen, k, dtype), 30
        else:
            stacked, reps = mamba2_stacked(torch, dev, gen, k), 10
        leaves = tree_leaves(stacked)
        params = sum(l[0].numel() for l in leaves)
        check(tree == "cnn" or params == SSM_MODELS[tree], f"{tree} has {params} parameters")
        w = torch.rand((k,), generator=gen, device=dev) + 0.05
        w = w / w.sum()
        routes = {"one_launch": lambda: aggregate_pytree(stacked, w),
                  "concatenated": lambda: concatenated_route(torch, stacked, w)}
        outs, peak, launches = {}, {}, {}
        for name, fn in routes.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = aggregate_flat.launches
            outs[name] = tree_leaves(fn())
            torch.cuda.synchronize()
            launches[name] = aggregate_flat.launches - before
            peak[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
        equal = all(torch.equal(a, b) for a, b in zip(outs["one_launch"], outs["concatenated"]))
        del outs
        torch.cuda.empty_cache()
        # in turns, three of each route
        turns = {name: [] for name in routes}
        for name in ("one_launch", "concatenated", "concatenated", "one_launch") * 2:
            if len(turns[name]) < 3:
                turns[name].append(time_ms(torch, routes[name], clean, reps=reps, warmup=2))
        ms = {name: statistics.median(t) for name, t in turns.items()}
        host_us, wall_us = {}, {}
        for name, fn in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):                 # host cost per call, the device kept busy
                fn()
            host_us[name] = 1e6 * (time.perf_counter() - t0) / reps
            torch.cuda.synchronize()
            walls = []
            for _ in range(reps):                 # wall per call: the call, then its result
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append(1e6 * (time.perf_counter() - t0))
            wall_us[name] = statistics.median(walls)
        bound, bound_by, nbytes = aggregate_bound_ms(k, params, leaves[0].element_size())
        row = dict(tree=tree, K=k, dtype=str(dtype), leaves=len(leaves), params=params,
                   flush="clean", bytes=nbytes, bound_ms=bound, bound_by=bound_by,
                   one_launch_ms=ms["one_launch"], concatenated_ms=ms["concatenated"],
                   one_launch_ms_turns=turns["one_launch"],
                   concatenated_ms_turns=turns["concatenated"],
                   one_launch_host_us=host_us["one_launch"],
                   concatenated_host_us=host_us["concatenated"],
                   one_launch_wall_us=wall_us["one_launch"],
                   concatenated_wall_us=wall_us["concatenated"],
                   one_launch_share=bound / ms["one_launch"],
                   one_launch_peak_GB=peak["one_launch"], concatenated_peak_GB=peak["concatenated"],
                   one_launch_launches=launches["one_launch"],
                   concatenated_launches=launches["concatenated"], bit_equal=equal,
                   nvidia_smi=smi)
        emit("time", kernel="aggregate_pytree", **row)
        check(equal, f"the two pytree routes differ on {tree} K={k}")
        check(launches["one_launch"] == 1, f"aggregate_pytree took {launches['one_launch']} "
                                           f"launches on {tree}")
        rows.append(row)
        del stacked, leaves, routes
        torch.cuda.empty_cache()
    return rows


def run_fedleo(torch, args, smi, n_main):
    """The FedLEO path on the card; returns aggregate_flat's launches."""
    from repro_torch.core import FedLEO, SimConfig
    from repro_torch.kernels.aggregate import aggregate_flat
    from repro_torch.models.nn import count_params
    from repro_torch.tree import tree_leaves

    p = SCENARIO["num_planes"]
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
        check(prof["device_busy_ms"] == "not measured" or prof["aggregate_kernel_launches"] == p + 1,
              f"the profiled round ran {prof['aggregate_kernel_launches']} aggregation kernels")
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
    return launches


def agree_fedleo(torch):
    from repro_torch.core import FedLEO, SimConfig
    from repro_torch.tree import tree_leaves

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


# --- the flash-attention kernel (serving path) ----------------------------------------
def flash_inputs(torch, gen, dev, b, s, h, g, d, dtype, scale=FLASH_INPUT_SCALES["flat"]):
    return [torch.randn(shape, generator=gen, device=dev).mul_(scale).to(dtype)
            for shape in ((b, s, h, d), (b, s, g, d), (b, s, g, d))]


def flash_error(torch, q, k, v, causal, window, cap):
    """The kernel against the float32 plain version on the same input
    values: (max abs error, max abs output, whether every element lies
    within its limit)."""
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.flash_ref import flash_attention_ref

    got = flash_attention(q, k, v, causal, window, cap)
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal, window, cap)
    torch.cuda.synchronize()
    check(got.shape == q.shape and got.dtype == q.dtype,
          f"flash output {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got.float()).all()), "non-finite flash output")
    err = (got.float() - want).abs()
    scale = float(want.abs().max())
    allowed = FLASH_F32_REL * scale
    if q.dtype == torch.bfloat16:
        allowed = allowed + BF16_HALF_ULP * want.abs()
    return float(err.max()), scale, bool((err <= allowed).all())


def check_flash(torch, dev, gen):
    for shape in FLASH_CHECK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for inputs, in_scale in FLASH_INPUT_SCALES.items():
                q, k, v = flash_inputs(torch, gen, dev, *shape, dtype, in_scale)
                errs, scales, oks = {}, {}, {}
                for mode, args in FLASH_MODES.items():
                    errs[mode], scales[mode], oks[mode] = flash_error(torch, q, k, v, *args)
                ok = all(oks.values())
                emit("check", kernel="flash_attention", shape=list(shape), dtype=str(dtype),
                     inputs=inputs, max_abs_err=errs, max_abs_out=scales,
                     rel_limit=FLASH_F32_REL,
                     half_ulp=BF16_HALF_ULP if dtype == torch.bfloat16 else None, ok=ok)
                check(ok, f"flash_attention disagrees with its plain version at {shape} "
                          f"{dtype} {inputs}: {errs} (largest outputs {scales})")
                del q, k, v


def time_flash(torch, dev, gen, flush, smi):
    """The kernel at the serving paths' prefill shapes, beside its plain
    version, one SDPA call (a yardstick the port never calls) and its
    bound; returns the rows by case."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.flash_ref import flash_attention_ref

    rows = {}
    for case, ((b, s, h, g, d), causal, window) in FLASH_TIME_CASES.items():
        q, k, v = flash_inputs(torch, gen, dev, b, s, h, g, d, torch.bfloat16)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        err, scale, ok = flash_error(torch, q, k, v, causal, window, None)
        check(ok, f"flash {case} at the prefill shape: {err} (largest output {scale})")
        if window is None:
            lib_fn = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        else:
            pos = torch.arange(s, device=dev)
            band = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
            lib_fn = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)
        kern = time_ms(torch, lambda: flash_attention(q, k, v, causal, window, None), flush)
        plain = time_ms(torch, lambda: flash_attention_ref(q, k, v, causal, window, None), flush)
        lib = time_ms(torch, lib_fn, flush)
        bound, bound_by, nbytes, flops = flash_bound_ms(b, s, h, g, d, causal, window, 2,
                                                        BF16_FLOPS_PER_S)
        row = dict(shape=[b, s, h, g, d], dtype="torch.bfloat16", mode=case, bytes=nbytes,
                   flops=flops, bound_ms=bound, bound_by=bound_by, ms=kern, plain_ms=plain,
                   library_ms=lib, max_abs_err=err, achieved_TFLOPs=flops / (kern * 1e-3) / 1e12,
                   roofline_share=bound / kern, nvidia_smi=smi)
        emit("time", kernel="flash_attention", **row)
        rows[case] = row
        del q, k, v, qt, kt, vt
    return rows


def profile_call(torch, fn):
    """One call of ``fn`` under torch.profiler: its wall time, the
    device's busy share, and device time split into the flash kernels
    and the SSD kernels (tensor-core and CUDA-core apart), the library's
    attention kernels, matrix products (cuBLAS) and the rest."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash import KERNELS
    from repro_torch.kernels.ssd import KERNELS as SSD_KERNELS

    tc_name, core_name = KERNELS[torch.bfloat16] + "<", KERNELS[torch.float32] + "<"
    ssd_tc_name = SSD_KERNELS[torch.bfloat16] + "<"
    ssd_core_name = SSD_KERNELS[torch.float32] + "<"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - w0)
    kernels = device_kernels(prof.key_averages())
    if not kernels:
        return dict(wall_ms=wall_ms, device_busy_ms="not measured")
    busy = sum(ms for _, ms, _ in kernels)
    library = [(n, ms, c) for n, ms, c in kernels
               if any(t in n.lower() for t in LIBRARY_ATTENTION)]
    ours = [(n, ms, c) for n, ms, c in kernels if (n, ms, c) not in library]
    flash_tc = sum(ms for name, ms, _ in ours if tc_name in name)
    flash_core = sum(ms for name, ms, _ in ours if core_name in name)
    flash = flash_tc + flash_core
    ssd_tc = sum(ms for name, ms, _ in kernels if ssd_tc_name in name)
    ssd_core = sum(ms for name, ms, _ in kernels if ssd_core_name in name)
    ssd = ssd_tc + ssd_core
    gemm = sum(ms for name, ms, _ in kernels
               if any(t in name.lower() for t in ("gemm", "gemv", "xmma", "cutlass", "nvjet")))
    return dict(wall_ms=wall_ms, device_busy_ms=busy, device_busy_share=busy / wall_ms,
                launches=sum(c for _, _, c in kernels),
                flash_ms=flash, flash_share=flash / busy, flash_tc_ms=flash_tc,
                flash_tc_launches=sum(c for n, _, c in ours if tc_name in n),
                flash_core_ms=flash_core,
                flash_core_launches=sum(c for n, _, c in ours if core_name in n),
                library_attention=[n[:100] for n, _, _ in library],
                ssd_ms=ssd, ssd_share=ssd / busy, ssd_tc_ms=ssd_tc,
                ssd_tc_launches=sum(c for n, _, c in kernels if ssd_tc_name in n),
                ssd_core_ms=ssd_core,
                ssd_core_launches=sum(c for n, _, c in kernels if ssd_core_name in n),
                gemm_ms=gemm, gemm_share=gemm / busy, other_ms=busy - flash - ssd - gemm,
                top_kernels=[{"name": n[:100], "ms": ms, "count": c} for n, ms, c in kernels[:10]])


def check_tc_only(prof, launches, what):
    """A profiled bf16 prefill ran its attention on the tensor-core flash
    kernel alone: ``launches`` of it, no CUDA-core flash kernel and no
    library attention kernel."""
    if prof.get("device_busy_ms") == "not measured":
        return
    check(prof["flash_tc_launches"] == launches and prof["flash_core_launches"] == 0
          and not prof["library_attention"],
          f"{what}: {prof['flash_tc_launches']} tensor-core flash launches (expected "
          f"{launches}), {prof['flash_core_launches']} CUDA-core, library "
          f"{prof['library_attention']}")


def check_ssd_tc_only(prof, launches, what):
    """A profiled bf16 SSM prefill ran its scan on the tensor-core SSD
    kernel alone: ``launches`` of it and no CUDA-core SSD kernel."""
    if prof.get("device_busy_ms") == "not measured":
        return
    check(prof["ssd_tc_launches"] == launches and prof["ssd_core_launches"] == 0,
          f"{what}: {prof['ssd_tc_launches']} tensor-core SSD launches (expected {launches}), "
          f"{prof['ssd_core_launches']} CUDA-core")


def serve(torch, dev, smi):
    """gemma-7b at full width and depth on the card, in bfloat16: prefill
    through the flash kernel, then greedy decoding against the cache.
    Returns the flash launches of the phase."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.models.nn import count_params, tree_cast
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("gemma-7b")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = build_model(cfg, attn_impl="pallas")
    check(model.device.type == "cuda" and model.dtype == torch.bfloat16,
          f"model on {model.device} in {model.dtype}")
    params32 = model.init(gen)
    params = tree_cast(params32, torch.bfloat16)
    del params32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n_params = count_params(params)
    check(n_params == GEMMA_PARAMS, f"gemma-7b has {n_params} parameters")
    check(all(l.is_cuda and l.dtype == torch.bfloat16 for l in tree_leaves(params)),
          "params not bfloat16 on the card")
    emit("serve_setup", arch=cfg.name, params=n_params, layers=cfg.num_layers,
         init_s=time.perf_counter() - t0,
         param_GB=sum(l.numel() * l.element_size() for l in tree_leaves(params)) / 1e9,
         peak_GB=torch.cuda.max_memory_allocated() / 1e9)

    flash_attention.launches = 0
    prefill_calls = 0
    for window in (None, 512):
        step = make_prefill_step(build_model(cfg, attn_impl="pallas", sliding_window=window))
        for s in (SERVE_SEQ, 2000):
            tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, s), generator=gen,
                                   device=dev)
            logits = step(params, {"tokens": tokens})           # warm-up
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                w0 = time.perf_counter()
                logits = step(params, {"tokens": tokens})
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - w0))
            prefill_calls += 4
            check(logits.shape == (SERVE_BATCH, cfg.vocab_size), f"logits {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits.float()).all()), "non-finite prefill logits")
            ms = statistics.median(times)
            prof = {}
            if window is None and s == SERVE_SEQ:
                prof = profile_call(torch, lambda: step(params, {"tokens": tokens}))
                prefill_calls += 1
                check_tc_only(prof, cfg.num_layers, "gemma-7b prefill")
            emit("prefill", window=window, batch=SERVE_BATCH, seq=s, ms=ms, ms_all=times,
                 tokens_per_s=SERVE_BATCH * s / (ms * 1e-3), nvidia_smi=smi, profile=prof)

    for window in (None, 32):
        model_w = build_model(cfg, attn_impl="pallas", sliding_window=window)
        serve_step = make_serve_step(model_w)
        prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, DECODE_PROMPT),
                               generator=gen, device=dev)
        max_len = DECODE_PROMPT + DECODE_GEN
        cache = model_w.init_cache(SERVE_BATCH, max_len)
        cache_mb = sum(l.numel() * l.element_size() for l in tree_leaves(cache)) / 1e6
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for t in range(DECODE_PROMPT):                     # teacher-forced prompt
            logits, cache = serve_step(params, prompt[:, t:t + 1], cache, t)
        torch.cuda.synchronize()
        prompt_s = time.perf_counter() - w0
        w0 = time.perf_counter()
        out = []
        tok = torch.argmax(logits, dim=-1, keepdim=True)
        for t in range(DECODE_PROMPT, max_len):            # greedy generation
            out.append(tok)
            logits, cache = serve_step(params, tok, cache, t)
            tok = torch.argmax(logits, dim=-1, keepdim=True)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - w0
        toks = torch.cat(out, dim=1)
        # one more step, profiled, against a copy of the cache
        spare = tree_map(torch.clone, cache)
        prof = profile_call(torch, lambda: serve_step(params, tok, spare, max_len - 1))
        del spare
        finite = bool(torch.isfinite(logits.float()).all())
        in_range = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
        emit("decode", window=window, batch=SERVE_BATCH, prompt=DECODE_PROMPT, generated=DECODE_GEN,
             cache_MB=cache_mb, cache_slots=int(cache["block0"].k.shape[2]),
             prompt_tokens_per_s=SERVE_BATCH * DECODE_PROMPT / prompt_s,
             tokens_per_s=SERVE_BATCH * DECODE_GEN / gen_s, ms_per_step=1e3 * gen_s / DECODE_GEN,
             finite=finite, tokens_in_range=in_range, sample=toks[0, :12].tolist(),
             nvidia_smi=smi, profile=prof)
        check(finite, "non-finite decode logits")
        check(in_range, "generated token ids out of range")
        check(cache["block0"].index.tolist() == [max_len] * cfg.num_layers, "cache index")

    launches = flash_attention.launches
    expected = cfg.num_layers * prefill_calls
    emit("serve", prefill_calls=prefill_calls, flash_attention_launches=launches,
         expected_launches=expected, peak_GB=torch.cuda.max_memory_allocated() / 1e9)
    check(launches == expected, f"flash_attention launched {launches} times, expected {expected}")
    del params
    torch.cuda.empty_cache()
    return launches


def serve_agree(torch, dev):
    """The kernel path against the cache path at full width (2 layers,
    float32), and smoke configs on the card against the CPU."""
    from repro_torch.configs import build_model, get_config, get_smoke_config
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config("gemma-7b"), num_layers=2)
    model = build_model(cfg, attn_impl="pallas", dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = model.init(gen)
    prompt = torch.randint(0, cfg.vocab_size, (2, DECODE_PROMPT), generator=gen, device=dev)
    prefill = make_prefill_step(model)(params, {"tokens": prompt})
    step = make_serve_step(model)
    cache = model.init_cache(2, DECODE_PROMPT, dtype=torch.float32)
    for t in range(DECODE_PROMPT):
        logits, cache = step(params, prompt[:, t:t + 1], cache, t)
    scale = float(prefill.abs().max())
    err = float((prefill - logits).abs().max())
    ok = err <= 2e-3 * scale
    emit("serve_agree", what="gemma-7b full width, 2 layers, f32: prefill vs decode at 63",
         max_abs_err=err, limit=2e-3 * scale, ok=ok)
    check(ok, f"prefill and decode logits differ by {err} (largest logit {scale})")
    del params, cache

    for arch in ("gemma-7b", "phi3-medium-14b"):
        scfg = get_smoke_config(arch)
        cpu = build_model(scfg, attn_impl="pallas", dtype=torch.float32, device="cpu")
        card = build_model(scfg, attn_impl="pallas", dtype=torch.float32)
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        tokens = torch.randint(0, scfg.vocab_size, (2, 100),
                               generator=torch.Generator().manual_seed(2))
        want = make_prefill_step(cpu)(p_cpu, {"tokens": tokens})
        got = make_prefill_step(card)(tree_map(lambda p: p.to(dev), p_cpu), {"tokens": tokens})
        err = float((got.cpu() - want).abs().max())
        emit("serve_agree", what=f"{arch} smoke config, f32, S=100: card vs CPU",
             max_abs_err=err, limit=2e-3, ok=err <= 2e-3)
        check(err <= 2e-3, f"{arch} smoke prefill: card and CPU differ by {err}")


# --- the SSD scan (SSM serving path) --------------------------------------------------
def ssd_inputs(torch, gen, dev, b, s, h, p, g, n, dtype, scale):
    """x, dt, A, B, C at the tests' or the model's input scale."""
    x = (torch.randn((b, s, h, p), generator=gen, device=dev) * 0.5).to(dtype)
    Bm = (torch.randn((b, s, g, n), generator=gen, device=dev) * 0.5).to(dtype)
    Cm = (torch.randn((b, s, g, n), generator=gen, device=dev) * 0.5).to(dtype)
    if scale == "tests":
        dt = torch.rand((b, s, h), generator=gen, device=dev) * 0.5 + 0.1
        A = -(torch.rand((h,), generator=gen, device=dev) * 0.5 + 0.1)
    else:
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev))
        A = -torch.linspace(1.0, 16.0, h, device=dev)
    return x, dt, A, Bm, Cm


def ssd_errors(torch, y, state, x, dt, A, Bm, Cm, init, steps: bool):
    """The kernel's y and final state against the float32 chunked scan
    (padded at a ragged S) and, with ``steps``, against S steps of
    ``ssd_decode_step`` (the naive recurrence) on the same input values.
    Each element must lie within the float32 rounding limit
    (``ssd_rounding_limit``), plus half a bfloat16 ulp of y in bfloat16.
    Returns ({what: max abs error}, {what: max abs value}, ok)."""
    from repro_torch.kernels.ssd_ref import ssd_padded, ssd_rounding_limit, ssd_steps

    args = (x.float(), dt, A, Bm.float(), Cm.float())
    y_lim, s_lim = ssd_rounding_limit(*args, SSD_CHUNK, init)
    wants = {"chunked": ssd_padded(*args, SSD_CHUNK, init)}
    if y.dtype == torch.bfloat16:
        y_lim = y_lim + BF16_HALF_ULP * wants["chunked"][0].abs()
    if steps:
        wants["steps"] = ssd_steps(*args, init)
    errs, scales, ok = {}, {}, True
    for what, (y_want, s_want) in wants.items():
        for part, got, want, lim in (("y", y, y_want, y_lim), ("state", state, s_want, s_lim)):
            err = (got.float() - want).abs()
            errs[f"{part}_vs_{what}"] = float(err.max())
            scales[f"{part}_vs_{what}"] = float(want.abs().max())
            ok = ok and bool((err <= lim).all())
    return errs, scales, ok


def check_ssd(torch, dev, gen):
    from repro_torch.kernels.ssd import ssd_scan

    for b, s, h, p, g, n in SSD_CHECK_SHAPES:
        for scale in SSD_SCALES:
            for dtype in (torch.float32, torch.bfloat16):
                x, dt, A, Bm, Cm = ssd_inputs(torch, gen, dev, b, s, h, p, g, n, dtype, scale)
                for init in (None, torch.randn((b, h, p, n), generator=gen, device=dev) * 0.5):
                    y, state = ssd_scan(x, dt, A, Bm, Cm, SSD_CHUNK, init)
                    torch.cuda.synchronize()
                    check(y.shape == x.shape and y.dtype == dtype and state.shape == (b, h, p, n),
                          f"ssd output {tuple(y.shape)} {y.dtype} {tuple(state.shape)}")
                    check(bool(torch.isfinite(y.float()).all() and torch.isfinite(state).all()),
                          "non-finite ssd output")
                    errs, scales, ok = ssd_errors(torch, y, state, x, dt, A, Bm, Cm, init, True)
                    emit("check", kernel="ssd_scan", shape=[b, s, h, p, g, n], chunk=SSD_CHUNK,
                         dtype=str(dtype), inputs=scale, initial_state=init is not None,
                         max_abs_err=errs, max_abs_want=scales, ok=ok)
                    check(ok, f"ssd_scan disagrees with its plain version at {(b, s, h, p, g, n)} "
                              f"{dtype} {scale} init={init is not None}: {errs}")
                del x, dt, A, Bm, Cm


def ssd_bound_ms(b, s, h, p, g, n, chunk, itemsize):
    """Least time for one scan: x, dt, B, C read once, y and the float32
    final state written once, against the FLOPs of the TPU kernel's four
    products per (batch, head, chunk), 2Q^2 N + 2Q^2 P + 4QPN, at the
    bfloat16 tensor-core rate; returns (ms, bound_by, bytes, flops)."""
    nbytes = (2 * b * s * h * p + 2 * b * s * g * n) * itemsize + 4 * b * s * h + 4 * b * h * p * n
    nchunks = -(-s // chunk)
    flops = b * h * nchunks * (2.0 * chunk * chunk * n + 2.0 * chunk * chunk * p
                               + 4.0 * chunk * p * n)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / BF16_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, flops)


def time_ssd(torch, dev, gen, flush, smi):
    """The kernel at the SSM prefill shapes in bfloat16 with the model's
    inputs, beside its plain version and its bound; returns the rows by
    case.  No single PyTorch call computes the scan, so there is no
    library time."""
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.kernels.ssd_ref import ssd_ref

    rows = {}
    for case, (b, s, h, p, g, n) in SSD_TIME_CASES.items():
        x, dt, A, Bm, Cm = ssd_inputs(torch, gen, dev, b, s, h, p, g, n, torch.bfloat16, "model")
        y, state = ssd_scan(x, dt, A, Bm, Cm, SSD_CHUNK)
        errs, scales, ok = ssd_errors(torch, y, state, x, dt, A, Bm, Cm, None, False)
        check(ok, f"ssd_scan {case} at the prefill shape: {errs}")
        kern = time_ms(torch, lambda: ssd_scan(x, dt, A, Bm, Cm, SSD_CHUNK), flush)
        plain = time_ms(torch, lambda: ssd_ref(x, dt, A, Bm, Cm, SSD_CHUNK), flush)
        bound, bound_by, nbytes, flops = ssd_bound_ms(b, s, h, p, g, n, SSD_CHUNK, 2)
        row = dict(shape=[b, s, h, p, g, n], case=case, chunk=SSD_CHUNK, dtype="torch.bfloat16",
                   inputs="model", bytes=nbytes, flops=flops, bound_ms=bound, bound_by=bound_by,
                   ms=kern, plain_ms=plain, library_ms=None,
                   library_note="no single PyTorch call computes the SSD scan",
                   max_abs_err=errs["y_vs_chunked"], max_abs_err_state=errs["state_vs_chunked"],
                   achieved_TFLOPs=flops / (kern * 1e-3) / 1e12, roofline_share=bound / kern,
                   nvidia_smi=smi)
        emit("time", kernel="ssd_scan", **row)
        rows[case] = row
        del x, dt, A, Bm, Cm, y, state
    return rows


def cache_mb(cache) -> float:
    from repro_torch.tree import tree_leaves

    return sum(l.numel() * l.element_size() for l in tree_leaves(cache)) / 1e6


def ssm_serve(torch, dev, smi):
    """mamba2-780m and zamba2-1.2b at full width and depth on the card, in
    bfloat16: prefill through the SSD kernel (and zamba2's shared
    attention through the flash kernel), then greedy decoding against the
    recurrent cache.  Returns the SSD launches of the phase."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.models.nn import count_params, tree_cast
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_leaves, tree_map

    ssd_scan.launches = 0
    flash_attention.launches = 0
    expect_ssd = expect_flash = 0
    for arch, n_expected in SSM_MODELS.items():
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg, ssd_impl="pallas", attn_impl="pallas")
        check(model.device.type == "cuda" and model.dtype == torch.bfloat16,
              f"{arch} on {model.device} in {model.dtype}")
        params32 = model.init(gen)
        params = tree_cast(params32, torch.bfloat16)
        del params32
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        n_params = count_params(params)
        check(n_params == n_expected, f"{arch} has {n_params} parameters")
        check(all(l.is_cuda and l.dtype == torch.bfloat16 for l in tree_leaves(params)),
              "params not bfloat16 on the card")
        attn_uses = getattr(model, "n_attn_uses", 0)
        emit("ssm_setup", arch=arch, params=n_params, mamba_layers=cfg.num_layers,
             attn_uses=attn_uses, init_s=time.perf_counter() - t0,
             param_GB=sum(l.numel() * l.element_size() for l in tree_leaves(params)) / 1e9,
             peak_GB=torch.cuda.max_memory_allocated() / 1e9)

        step = make_prefill_step(model)
        calls = 0
        for s in (SERVE_SEQ, 2000):
            tokens = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, s), generator=gen, device=dev)
            logits = step(params, {"tokens": tokens})           # warm-up
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                w0 = time.perf_counter()
                logits = step(params, {"tokens": tokens})
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - w0))
            calls += 4
            check(logits.shape == (SERVE_BATCH, cfg.vocab_size), f"logits {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits.float()).all()), "non-finite prefill logits")
            prof = {}
            if s == SERVE_SEQ:
                prof = profile_call(torch, lambda: step(params, {"tokens": tokens}))
                calls += 1
                check_tc_only(prof, attn_uses, f"{arch} prefill")
                check_ssd_tc_only(prof, cfg.num_layers, f"{arch} prefill")
            ms = statistics.median(times)
            emit("ssm_prefill", arch=arch, batch=SERVE_BATCH, seq=s, ms=ms, ms_all=times,
                 tokens_per_s=SERVE_BATCH * s / (ms * 1e-3), nvidia_smi=smi, profile=prof)
        expect_ssd += cfg.num_layers * calls
        expect_flash += attn_uses * calls
        check(ssd_scan.launches == expect_ssd and flash_attention.launches == expect_flash,
              f"{arch} prefill: {ssd_scan.launches} ssd and {flash_attention.launches} flash "
              f"launches, expected {expect_ssd} and {expect_flash}")

        serve_step = make_serve_step(model)
        prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, DECODE_PROMPT), generator=gen,
                               device=dev)
        max_len = DECODE_PROMPT + DECODE_GEN
        cache = model.init_cache(SERVE_BATCH, max_len)
        size_mb = cache_mb(cache)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        for t in range(DECODE_PROMPT):                     # teacher-forced prompt
            logits, cache = serve_step(params, prompt[:, t:t + 1], cache, t)
        torch.cuda.synchronize()
        prompt_s = time.perf_counter() - w0
        w0 = time.perf_counter()
        out = []
        tok = torch.argmax(logits, dim=-1, keepdim=True)
        for t in range(DECODE_PROMPT, max_len):            # greedy generation
            out.append(tok)
            logits, cache = serve_step(params, tok, cache, t)
            tok = torch.argmax(logits, dim=-1, keepdim=True)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - w0
        toks = torch.cat(out, dim=1)
        spare = tree_map(torch.clone, cache)
        prof = profile_call(torch, lambda: serve_step(params, tok, spare, max_len - 1))
        del spare
        finite = bool(torch.isfinite(logits.float()).all())
        in_range = bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
        emit("ssm_decode", arch=arch, batch=SERVE_BATCH, prompt=DECODE_PROMPT,
             generated=DECODE_GEN, cache_MB=size_mb,
             prompt_tokens_per_s=SERVE_BATCH * DECODE_PROMPT / prompt_s,
             tokens_per_s=SERVE_BATCH * DECODE_GEN / gen_s, ms_per_step=1e3 * gen_s / DECODE_GEN,
             finite=finite, tokens_in_range=in_range, sample=toks[0, :12].tolist(),
             nvidia_smi=smi, profile=prof)
        check(finite, "non-finite decode logits")
        check(in_range, "generated token ids out of range")
        check(ssd_scan.launches == expect_ssd and flash_attention.launches == expect_flash,
              f"{arch} decode launched a kernel")
        del params, cache, model, step, serve_step
        torch.cuda.empty_cache()

    launches = ssd_scan.launches
    emit("ssm_serve", ssd_scan_launches=launches, expected_ssd=expect_ssd,
         flash_attention_launches=flash_attention.launches, expected_flash=expect_flash,
         peak_GB=torch.cuda.max_memory_allocated() / 1e9)
    return launches


def ssm_agree(torch, dev):
    """SSM prefill (the SSD kernel) against teacher-forced decode (the
    recurrence, no kernel) at full width in float32, and smoke configs on
    the card against the CPU at a ragged S."""
    from repro_torch.configs import build_model, get_config, get_smoke_config
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_map

    # mamba2 cut to 2 layers; zamba2 to 7, one group of 6 and a remainder
    # of 1, so the shared attention block runs at two depths
    for arch, layers in (("mamba2-780m", 2), ("zamba2-1.2b", 7)):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        model = build_model(cfg, ssd_impl="pallas", attn_impl="pallas", dtype=torch.float32)
        gen = torch.Generator(device=dev).manual_seed(1)
        params = model.init(gen)
        prompt = torch.randint(0, cfg.vocab_size, (2, DECODE_PROMPT), generator=gen, device=dev)
        prefill = make_prefill_step(model)(params, {"tokens": prompt})
        step = make_serve_step(model)
        cache = model.init_cache(2, DECODE_PROMPT, dtype=torch.float32)
        for t in range(DECODE_PROMPT):
            logits, cache = step(params, prompt[:, t:t + 1], cache, t)
        scale = float(prefill.abs().max())
        err = float((prefill - logits).abs().max())
        ok = err <= 2e-3 * scale
        emit("ssm_agree", what=f"{arch} full width, {layers} layers, f32: prefill vs decode at 63",
             max_abs_err=err, max_abs_logit=scale, limit=2e-3 * scale, ok=ok)
        check(ok, f"{arch}: prefill and decode logits differ by {err} (largest logit {scale})")
        del params, cache, model

    for arch in SSM_MODELS:
        scfg = get_smoke_config(arch)
        kw = dict(ssd_impl="pallas", attn_impl="pallas", dtype=torch.float32)
        cpu = build_model(scfg, device="cpu", **kw)
        card = build_model(scfg, **kw)
        p_cpu = cpu.init(torch.Generator().manual_seed(0))
        tokens = torch.randint(0, scfg.vocab_size, (2, 100),
                               generator=torch.Generator().manual_seed(2))
        want = make_prefill_step(cpu)(p_cpu, {"tokens": tokens})
        got = make_prefill_step(card)(tree_map(lambda p: p.to(dev), p_cpu), {"tokens": tokens})
        err = float((got.cpu() - want).abs().max())
        emit("ssm_agree", what=f"{arch} smoke config, f32, S=100: card vs CPU",
             max_abs_err=err, limit=2e-3, ok=err <= 2e-3)
        check(err <= 2e-3, f"{arch} smoke prefill: card and CPU differ by {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more FedLEO round after the checks")
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
    from repro_torch.models.cnn import init_cnn
    from repro_torch.models.nn import count_params

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, torch_name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda", 0)

    # 2. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    sources = ("aggregate", "flash", "ssd")
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        libs = dict(zip(sources, ex.map(build.build, sources)))
    nvcc = subprocess.run([build.find_nvcc(), "--version"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()
    emit("build", seconds=time.perf_counter() - t0, nvcc=nvcc[-2:],
         libraries={k: str(v.relative_to(ROOT)) for k, v in libs.items()},
         aggregate_ptxas=ptxas_summary(build.LOGS.get("aggregate", "")),
         flash_ptxas=ptxas_summary(build.LOGS.get("flash", "")),
         ssd_ptxas=ptxas_summary(build.LOGS.get("ssd", "")))

    # 3. each kernel against its plain version, on the card
    n_main = count_params(init_cnn(torch.Generator().manual_seed(0)))
    main_shapes = [(SCENARIO["sats_per_plane"], n_main),      # plane partial
                   (SCENARIO["num_planes"], n_main)]          # global
    gen = torch.Generator(device=dev).manual_seed(0)
    agg_err = check_aggregate(torch, dev, gen, main_shapes)
    check_flash(torch, dev, gen)
    check_ssd(torch, dev, gen)

    # 4. times: kernel, plain version, one library call (never used by the port)
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)   # 256 MB > L2
    flushes = l2_flushes(flush_buf)
    agg_timed = time_aggregate(torch, dev, gen, flushes, smi, main_shapes)
    time_pytree(torch, dev, gen, flushes["clean"], smi)
    flash_timed = time_flash(torch, dev, gen, flushes["dirty"], smi)
    ssd_row = time_ssd(torch, dev, gen, flushes["dirty"], smi)["mamba2"]
    del flush_buf, flushes

    # 5-6. the FedLEO path, and a small round against the CPU
    agg_launches = run_fedleo(torch, args, smi, n_main)
    agree_fedleo(torch)

    # 7-8. the serving path, and its agreement checks
    flash_launches = serve(torch, dev, smi)
    serve_agree(torch, dev)
    gc.collect()                # gemma's weights are gone before the SSM phases
    torch.cuda.empty_cache()

    # 9-10. the SSM serving path, and its agreement checks
    ssd_launches = ssm_serve(torch, dev, smi)
    ssm_agree(torch, dev)

    agg_row = agg_timed[(SCENARIO["sats_per_plane"], n_main, torch.float32, "dirty")]
    flash_row = flash_timed["causal"]
    print(json.dumps({"kernels": [{
        "name": "aggregate_flat",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/aggregate.cu",
        "replaces": "src/repro/kernels/aggregate.py:33",
        "tpu": "src/repro/kernels/aggregate.py::aggregate_flat",
        "launches": agg_launches,
        "max_abs_err": agg_err,
        "max_err": agg_err,
        "ms": agg_row["ms"],
        "plain_ms": agg_row["plain_ms"],
        "bound_ms": agg_row["bound_ms"],
        "bound_by": agg_row["bound_by"],
        "library_ms": agg_row["library_ms"],
        "flush": "dirty",
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash.cu",
        "replaces": "src/repro/kernels/flash.py:94",
        "tpu": "src/repro/kernels/flash.py::flash_attention",
        "launches": flash_launches,
        "max_abs_err": flash_row["max_abs_err"],
        "max_err": flash_row["max_abs_err"],
        "ms": flash_row["ms"],
        "plain_ms": flash_row["plain_ms"],
        "bound_ms": flash_row["bound_ms"],
        "bound_by": flash_row["bound_by"],
        "library_ms": flash_row["library_ms"],
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:66",
        "tpu": "src/repro/kernels/ssd.py::ssd_scan",
        "launches": ssd_launches,
        "max_abs_err": ssd_row["max_abs_err"],
        "max_err": ssd_row["max_abs_err"],
        "ms": ssd_row["ms"],
        "plain_ms": ssd_row["plain_ms"],
        "bound_ms": ssd_row["bound_ms"],
        "bound_by": ssd_row["bound_by"],
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    shutil.rmtree(build_root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
