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
                   the CNN's stacked tree (one launch), a ragged
                   mixed-dtype list with strided and offset views, and
                   the training phase's trees (mamba2-780m's parameters
                   and Adam state over 2 replicas, one launch each).
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
                   gemma-7b's, zamba2-1.2b's, kimi-k2's (head_dim 112)
                   and seamless-m4t's encoder's (not causal) prefill
                   shapes, the SSD
                   scan (dirty) at mamba2-780m's and zamba2-1.2b's and
                   at mamba2's with one prompt.
  5. main        — the FedLEO path: rounds on the quickstart scenario
                   with the full-width CNN and the CUDA aggregation
                   kernel, launch counts reset just before and read just
                   after.
  6. agree       — a small FedLEO round on the card against the same
                   round on the CPU (which the CPU tests hold to the JAX
                   package).
  7. baselines   — Table II: each of the 9 baselines on the main path's
                   scenario and CNN, 2 rounds (FedSpace to its first
                   buffer flush), one K1 launch per ``weighted_average``
                   call; FedLEO's 2-round time below FedAvg's.
  8. baselines_agree — one round of each baseline at phase ``agree``'s
                   size, card against CPU.
  9. unet        — FedLEO with Fig. 5's U-Net at full width (285,970
                   parameters) on the DeepGlobe-like data, 3 rounds, its
                   ``local_train`` share of each round; pixel accuracy
                   must rise; a small U-Net round card against CPU.
 10. fleet       — the main path's FedLEO run on a heterogeneous fleet
                   (gemma-7b and mamba2-780m planes priced by the
                   roofline): round times equal the CPU's and differ from
                   the uniform fleet's; the all-default profile keeps the
                   uniform round times.
 11. multitenant — two jobs (FedLEO, FedAvgStar) under the JobScheduler on
                   one shared ledger; one job through the scheduler
                   against the standalone run.
                   Phases 7, 9, 10 and 11 reset the launch count just
                   before they drive their strategies and read it just
                   after; each also prints its wall seconds on a line of
                   its own (``"phase": "wall"``).
 12. serve       — the serving path: gemma-7b at full width and depth in
                   bfloat16, prefill through the CUDA flash kernel
                   (``make_prefill_step``; its tensor-core kernel alone,
                   by the profile's kernel names) and greedy decoding
                   against the KV cache (``make_serve_step``), launch
                   counts reset just before and read just after.
 13. serve_agree — prefill (kernel) against teacher-forced decode (cache
                   path) at full width; smoke configs on the card
                   against the CPU.
 14. ssm_serve   — the SSM serving path, after gemma's weights are freed:
                   mamba2-780m and zamba2-1.2b at full width and depth
                   in bfloat16, prefill through the CUDA SSD kernel (its
                   tensor-core kernel alone, by the profile's kernel
                   names; zamba2's shared attention through the flash
                   kernel), greedy decoding against the recurrent cache,
                   launch counts reset just before and read just after.
 15. ssm_agree   — SSM prefill (kernel) against teacher-forced decode
                   (recurrence, no kernel) at full width; smoke configs
                   on the card against the CPU at a ragged S.
 16. moe_serve   — the MoE serving path in bfloat16 at full width, weights
                   drawn in bfloat16 leaf by leaf: llama4-maverick cut to
                   1 of 24 units (a dense and a MoE block, 37.1 GB) and
                   kimi-k2 to 1 of 61 layers (38.8 GB), one after the
                   other; prefill of 4 x 2048 tokens through the flash
                   kernel (2 and 1 launches a call; kimi's head_dim is
                   112), the share of (token, choice) pairs dropped, a
                   profile splitting the MoE layers' kernels into expert
                   products and dispatch/combine; greedy decoding (64
                   prompt tokens, 32 generated), no flash launch.
 17. vlm_serve   — internvl2-26b whole (48 layers, 39.7 GB): prefill of
                   256 patch embeddings + 2048 tokens, 4 prompts (48
                   launches a call), then text-only greedy decoding.
 18. audio_serve — seamless-m4t-large-v2 whole (24 + 24 layers): prefill
                   of 1024 frames + 2048 tokens, 4 prompts (24 non-causal
                   and 24 causal launches a call); ``init_cache`` encodes
                   once (24); greedy decoding launches none.
                   Phases 16-18 reset the flash count just before they
                   run and read it just after; each prefill profile must
                   show the tensor-core flash kernel alone.
 19. zoo_agree   — prefill against teacher-forced decode at full width,
                   2 layers, float32 (internvl2's text path, seamless);
                   the smoke configs of the four on the card against the
                   CPU: forward and decode logits, a train step with
                   adam, adafactor and sgd.
 20. train       — the training path: FedLEO orbit replicas of
                   mamba2-780m at full width (remat, Adam), 2 replicas of
                   4 x 2048 tokens, 4 local steps, an aggregation through
                   the aggregation kernel every 2 (2 launches each:
                   parameters, optimizer state); loss, seconds and peak
                   memory per step; replicas apart before each
                   aggregation and equal after it; no flash or SSD launch.
                   Launch counts reset just before and read just after.
 21. train_hybrid — zamba2-1.2b at full width, 2 plain train steps of
                   2 x 2048 tokens (attention ``xla``).
 22. train_dense — gemma-7b at full width, depth cut to 2 units, the same.
 23. train_agree — smoke configs of the three families, card against CPU:
                   a FedLEO local step and its aggregate with Adam, SGD
                   and adafactor; then ``python -m repro_torch.launch.train
                   --smoke --fedleo`` on the card, its checkpoint restored
                   on the card equal to what it saved.
 24. examples    — the four example twins' ``main`` in this process on
                   the card (``examples/*_torch.py``): quickstart and
                   serve_decode as they are, sota_comparison with
                   ``--fast``, train_arch at its default config (~126M
                   parameters, 2 orbit replicas of 4 x 256 tokens, 200
                   steps, tau 10): wall seconds and peak memory of each,
                   train_arch's steps/s and loss from first to last (it
                   must fall); the twins keep the reference examples'
                   defaults, so no kernel launches.
 25. calibrate   — the launch layer: ``measure_smoke_step_s`` (a smoke-config
                   float32 train step of 4 x 128 tokens, min of 3) of each
                   of the 10 architectures on the card, with the card's
                   name and power limit; ``step_time_s(mode="measured")``
                   equal to that calibration scaled by tokens; phase
                   ``fleet``'s run priced in ``measured`` mode (finite
                   round times, apart from the analytic fleet's; one K1
                   launch per aggregation).
 26. compiled    — ``compiled_step_cost(arch, "train_4k")`` of the 10
                   architectures: FLOPs and bytes counted on fake tensors
                   at 4 x 128 and scaled by tokens, the FLOPs held to the
                   CPU tests' band around the analytic 6 N D.
 27. dryrun      — ``python -m repro_torch.launch.dryrun`` on the 16 x 16
                   production mesh (torch's fake process-group backend,
                   no card), one subprocess a pair, all at once: gemma-7b
                   train_4k, kimi-k2 prefill_32k, mamba2-780m decode_32k,
                   zamba2-1.2b train_4k, internvl2-26b prefill_32k and
                   seamless decode_32k; per-device memory, FLOPs, bytes
                   and collective bytes (the largest by shape), whether
                   the per-device bytes fit the card, beside the
                   reference's (``DRYRUN_REFERENCE``); train pairs must
                   show collective traffic, and every pair that fits in
                   the reference must fit in the port.
                   The 40-pair sweep is not run: its time is estimated
                   from the pairs'.

With --profile, one more FedLEO round runs after the launch counts are
read, under torch.profiler, after phase ``main`` and after phase
``unet``, and one more training local step after phase ``train``
(``train_profile``: device busy share, products, the rest, the largest
kernels): a round's wall time split into local training,
aggregation, evaluation and the rest (scheduling), each range closed by
a device synchronise, the device's kernel time by name with its busy
share, and what ran inside the aggregation ranges: no concatenation
(phases ``profile`` and ``unet_profile``).

Then the kernels line, the nvidia-smi line and, last, the result line.
TF32 is off for matmuls and convolutions, so float32 stays float32.
Exits non-zero when no CUDA device is present.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
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
# phi3-medium's GQA heads, MQA, two ragged S, kimi-k2's heads (D = 112,
# two 64-wide boxes of which the second is cut at D), internvl2-26b's (GQA
# 6:1) and llama4-maverick's (GQA 5:1, ragged S) — in five modes
FLASH_CHECK_SHAPES = [(1, 2048, 16, 16, 256), (1, 1024, 40, 10, 128),
                      (2, 256, 4, 1, 32), (1, 77, 4, 2, 64), (1, 2000, 16, 16, 256),
                      (1, 256, 64, 8, 112), (1, 256, 48, 8, 128), (1, 333, 40, 8, 128)]
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
# flash timed (and held against its plain version) at every prefill shape
# of the serving paths (B, S, H, G, D): gemma-7b, full and window 512,
# zamba2-1.2b's shared attention, llama4-maverick's (GQA 5:1), kimi-k2's
# (D = 112, GQA 8:1), internvl2-26b's over 256 patches and 2048 tokens (GQA
# 6:1), and seamless-m4t's encoder over its 1024 frames (not causal) and
# its decoder
FLASH_TIME_CASES = {"causal": ((SERVE_BATCH, SERVE_SEQ, 16, 16, 256), True, None),
                    "window512": ((SERVE_BATCH, SERVE_SEQ, 16, 16, 256), True, 512),
                    "zamba2_causal": ((SERVE_BATCH, SERVE_SEQ, 32, 32, 64), True, None),
                    "llama4_causal": ((SERVE_BATCH, SERVE_SEQ, 40, 8, 128), True, None),
                    "kimi_causal": ((SERVE_BATCH, SERVE_SEQ, 64, 8, 112), True, None),
                    "internvl2_causal": ((SERVE_BATCH, SERVE_SEQ + 256, 48, 8, 128), True, None),
                    "seamless_encoder": ((SERVE_BATCH, 1024, 16, 16, 64), False, None),
                    "seamless_decoder": ((SERVE_BATCH, SERVE_SEQ, 16, 16, 64), True, None)}
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
# Table II's baselines run 2 rounds (server events, for the asynchronous
# ones); FedSpace runs to its 10th arrival, where its buffer (a quarter of
# the 40 clients) first folds into the model, and FedSat-ideal to its
# 784th, where an orbital period (6,950 s) has passed and its buffer of 784
# arrivals first folds in (at the full-width CNN's payload; a narrower
# model's shorter transfers make it tens of thousands of arrivals, so
# phase baselines_agree runs FedSat-ideal for 1 buffered round).
BASELINE_ROUNDS = {"FedSpace": 10, "FedSat-ideal": 784}
AGREE_BASELINE_ROUNDS = {"FedSpace": 10}
# K1's shapes on the FL paths: (K, tree) stacks of the full-width CNN and
# U-Net trees, float32.  K = 2: an asynchronous arrival mixed into the
# global model; 5: FedLEO's global model, and FedISL's; 8: a plane's
# partial; 10: FedSpace's buffer; 40: a star round (FedAvg, FedSatSched,
# FedHAP); 784: FedSat-ideal's first buffer.
FL_TREE_SHAPES = [("cnn", 2), ("cnn", 5), ("cnn", 8), ("cnn", 10), ("cnn", 40), ("cnn", 784),
                  ("unet", 5), ("unet", 8)]
# Fig. 5's U-Net at init_unet's defaults: 20 local epochs executed, as the
# simulated clock charges (at 8, pixel accuracy stays at the all-background
# share for 3 rounds)
UNET_PARAMS, UNET_LEAVES, UNET_ROUNDS, UNET_SIM_EPOCHS = 285_970, 28, 3, 20
FLEET_ARCHS = ["gemma-7b", "mamba2-780m", "gemma-7b", "mamba2-780m", None]
# training: FedLEO orbit replicas of mamba2-780m at full width (its config:
# remat, Adam at 3e-4), R replicas of TRAIN_BATCH x TRAIN_SEQ tokens each,
# an aggregation through K1 every TRAIN_TAU local steps; zamba2-1.2b and
# gemma-7b (depth cut to GEMMA_TRAIN_UNITS units: 28 need ~137 GB of Adam
# state) take plain train steps at PLAIN_TRAIN_BATCH x TRAIN_SEQ
TRAIN_ARCH, TRAIN_REPLICAS, TRAIN_TAU, TRAIN_STEPS = "mamba2-780m", 2, 2, 4
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
PLAIN_TRAIN_BATCH, PLAIN_TRAIN_STEPS, GEMMA_TRAIN_UNITS = 2, 2, 2
# train_agree: the smoke configs of the three ported families, and K1's
# launches per aggregation (one per tree with a replicated leaf)
TRAIN_AGREE_ARCHS = ("gemma-7b", "mamba2-780m", "zamba2-1.2b")
TRAIN_AGREE_LAUNCHES = {"adam": 2, "adafactor": 2, "sgd": 1}
# the zoo's serving paths: llama4-maverick cut to 1 of its 24 units (a
# dense block and a MoE block) and kimi-k2 to 1 of its 61 layers, the only
# cut (one MoE layer's experts are 32.2 GB and 33.8 GB in bfloat16);
# internvl2-26b and seamless-m4t-large-v2 whole
MOE_SERVE = {"llama4-maverick-400b-a17b": 1, "kimi-k2-1t-a32b": 1}
VLM_ARCH, AUDIO_ARCH = "internvl2-26b", "seamless-m4t-large-v2"
ZOO_ARCHS = (*MOE_SERVE, VLM_ARCH, AUDIO_ARCH)
# prefill (the flash kernel) against decode (the cache path) on the zoo's
# paths, as a share of the largest logit.  In float32 the parity tests'
# 1e-4 (summation order only).  In bfloat16 the two paths round K/V,
# scores and the residual stream apart in every layer, and the gap grows
# as a random walk: 2e-2 x sqrt(layers), the tests' 3e-2 at their 2
# layers.  On the card each bfloat16 path lies as far from the float32
# model as from the other, and the gap reads ~1e-2 x sqrt(layers)
# (tools/bf16_gap.py: gemma-7b, internvl2-26b at 8 and 48 layers,
# seamless-m4t-large-v2).
F32_LOGIT_REL, BF16_LOGIT_REL_PER_SQRT_LAYER = 1e-4, 2e-2
GEMM_NAMES = ("gemm", "gemv", "xmma", "cutlass", "nvjet")
# the launch layer: calibrate's smoke step shape (roofline's compile shape);
# the compiled FLOPs' band around the analytic 6 N D (tests/test_torch_launch.py;
# seamless's 1024 source frames are not in the analytic token count); the dry
# run's pairs, one of each family at least, on the 16 x 16 mesh
CALIBRATE_BATCH, CALIBRATE_SEQ = 4, 128
COMPILED_FLOP_BAND, COMPILED_FLOP_BANDS = (0.95, 1.30), {"seamless-m4t-large-v2": (1.5, 1.8)}
DRYRUN_PAIRS = [("gemma-7b", "train_4k"), ("kimi-k2-1t-a32b", "prefill_32k"),
                ("mamba2-780m", "decode_32k"), ("zamba2-1.2b", "train_4k"),
                ("internvl2-26b", "prefill_32k"), ("seamless-m4t-large-v2", "decode_32k")]
DRYRUN_TIMEOUT_S = 480
# profiled prefills: sessions tried for a profile that holds every kernel launched
PROFILE_SESSIONS = 3
# the example twins as phase ``examples`` runs them (train_arch at its default
# ~126M config)
EXAMPLES = [("quickstart_torch", []), ("sota_comparison_torch", ["--fast"]),
            ("serve_decode_torch", []), ("train_arch_torch", [])]
# the reference's dry run of the same pairs (``python -m repro.launch.dryrun
# --arch A --shape S``: XLA's memory_analysis and the collective bytes of its
# HLO on 512 host devices, jax 0.9.0), per device.  A device holds argument +
# output + temp - alias bytes: XLA's aliased outputs reuse their arguments'
# buffers (the port's dry run aliases nothing).
DRYRUN_REFERENCE = {
    ("gemma-7b", "train_4k"): {"argument": 402558984, "output": 400327224,
                               "temp": 162695245592, "alias": 400195592,
                               "collective": 182444633900},
    ("kimi-k2-1t-a32b", "prefill_32k"): {"argument": 16536981504, "output": 655360,
                                         "temp": 39167000600, "alias": 0,
                                         "collective": 27528528000},
    ("mamba2-780m", "decode_32k"): {"argument": 69620768, "output": 39032472,
                                    "temp": 77843232, "alias": 38227968,
                                    "collective": 23999552},
    ("zamba2-1.2b", "train_4k"): {"argument": 55571784, "output": 52532616,
                                  "temp": 262165534912, "alias": 52351304,
                                  "collective": 333268803384},
    ("internvl2-26b", "prefill_32k"): {"argument": 727370752, "output": 5923392,
                                       "temp": 20182170472, "alias": 0,
                                       "collective": 16442049792},
    ("seamless-m4t-large-v2", "decode_32k"): {"argument": 2559192196, "output": 2420018544,
                                              "temp": 5135115720, "alias": 2415919200,
                                              "collective": 100486240},
}


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
    agg_kernels = [name for name, _ in agg_kernels]
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
    """(CPU op names, (device kernel name, ms) pairs) inside every host
    range ``label`` of a profile, the range's own kernels included."""
    from torch.autograd import DeviceType

    ops, kernels = [], []

    def walk(event):
        kernels.extend((k.name, k.duration / 1e3) for k in event.kernels)
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


def model_stacked(torch, dev, gen, model, k, dtype):
    """A model's tree at full width stacked over k clients, random values
    from ``gen``: the paper's CNN (421,642 parameters, 8 leaves) or the
    U-Net at init_unet's defaults (285,970 parameters, 28 leaves)."""
    from repro_torch.models.cnn import init_cnn, init_unet
    from repro_torch.tree import tree_map

    init = {"cnn": init_cnn, "unet": init_unet}[model]
    return tree_map(lambda p: torch.randn((k, *p.shape), generator=gen, device=dev).to(dtype),
                    init(torch.Generator().manual_seed(0)))


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
    """K1 against its plain version: flat (K, N) stacks, the FL paths'
    trees at every (model, K) of FL_TREE_SHAPES, and ragged mixed leaves.
    Returns the largest error at a shape the FL paths give the kernel."""
    from repro_torch.kernels.aggregate import aggregate_flat, aggregate_leaves
    from repro_torch.kernels.aggregate_ref import aggregate_flat_ref, aggregate_leaves_ref
    from repro_torch.tree import tree_leaves

    main_err = 0.0
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
            if (k, n) in main_shapes and dtype == torch.float32:
                main_err = max(main_err, abs_err)
            del x, got, want

    def tree(model, k, dtype):
        return [l.reshape(k, -1) for l in tree_leaves(model_stacked(torch, dev, gen, model, k, dtype))]

    cases = [(f"{model} K={k} float32", True, k, lambda m=model, k=k: tree(m, k, torch.float32))
             for model, k in FL_TREE_SHAPES]
    cases += [(f"cnn K={k} bfloat16", False, k, lambda k=k: tree("cnn", k, torch.bfloat16))
              for k, _ in main_shapes]
    cases += [(f"ragged mixed K={k}", False, k, lambda k=k: ragged_mixed_leaves(torch, dev, gen, k))
              for k in (3, 8, 11)]
    for what, on_path, k, make in cases:
        xs = make()
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
        if on_path:
            main_err = max(main_err, abs_err)
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
            stacked, reps = model_stacked(torch, dev, gen, "cnn", k, dtype), 30
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
    """The FedLEO path on the card; returns aggregate_flat's launches and
    the round times."""
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
    finite = params_finite(torch, strategy.global_params)
    emit("main", rounds=MAIN_ROUNDS, params=n_main, sim_epochs=SIM_EPOCHS,
         payload_bits=task.payload_bits, wall_s=wall, accuracy=accs,
         aggregate_flat_launches=launches, expected_launches=expected, finite=finite,
         schedule_violations=violations)
    check(launches == expected, f"aggregate_flat launched {launches} times, expected {expected}")
    check(finite, "non-finite global params")
    check(not violations, f"schedule sanitizer: {violations}")
    check(accs[-1] > accs[0] and accs[-1] > 0.1, f"no learning: {accs}")
    return launches, [h.t_hours for h in strategy.history[:MAIN_ROUNDS]]


def agree_fedleo(torch):
    from repro_torch.core import FedLEO, SimConfig

    runs = {}
    for device in ("cuda", "cpu"):
        small = FedLEO(make_task((4, 8), 16, 800, 32, 2, device),
                       SimConfig(horizon_hours=72.0, use_kernel=True))
        runs[device] = (small.run(max_rounds=1), small.global_params)
    (rc, pc), (rh, ph) = runs["cuda"], runs["cpu"]
    param_err = max_param_diff(pc, ph)
    same_sched = (rc.history[0].t_hours == rh.history[0].t_hours
                  and rc.history[0].events == rh.history[0].events)
    emit("agree", param_max_abs_err=param_err, limit=1e-4, same_schedule=same_sched,
         accuracy_cuda=rc.final_accuracy, accuracy_cpu=rh.final_accuracy)
    check(same_sched, "CUDA and CPU schedules differ")
    check(param_err <= 1e-4, f"CUDA and CPU params differ by {param_err}")


# --- the rest of the paper's FL stack: every aggregation through K1 -----------------
def reset_aggregation_counts() -> None:
    """Zero K1's launch count and the count of ``weighted_average`` calls,
    through which every strategy aggregates."""
    from repro_torch.core import aggregation
    from repro_torch.kernels.aggregate import aggregate_flat

    aggregate_flat.launches = 0
    aggregation.weighted_average.calls = 0


def aggregation_counts():
    """(K1 launches, weighted_average calls) since the last reset: equal
    when every aggregation took one launch, as trees of up to MAX_LEAVES
    leaves do, and none took the plain path."""
    from repro_torch.core import aggregation
    from repro_torch.kernels.aggregate import aggregate_flat

    return aggregate_flat.launches, aggregation.weighted_average.calls


def phase_wall(name: str, t0: float) -> None:
    emit("wall", of=name, seconds=time.perf_counter() - t0)


def params_finite(torch, params) -> bool:
    from repro_torch.tree import tree_leaves

    return all(bool(torch.isfinite(l).all()) for l in tree_leaves(params))


def max_param_diff(a, b) -> float:
    from repro_torch.tree import tree_leaves

    return max(float((x.cpu() - y.cpu()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def run_baselines(torch, n_main, fedleo_hours):
    """Table II on the card: each baseline on the main path's scenario and
    full-width CNN, one K1 launch per aggregation; returns the launches."""
    from repro_torch.core import SimConfig
    from repro_torch.core.baselines import ALL_BASELINES
    from repro_torch.models.nn import count_params

    t0 = time.perf_counter()
    task = make_task((32, 64), 128, SCENARIO["train"], 16, SIM_EPOCHS, None)
    check(count_params(task.global_params) == n_main, "unexpected model width")
    rows, launches = {}, 0
    for name, cls in ALL_BASELINES.items():
        rounds = BASELINE_ROUNDS.get(name, 2)
        strategy = cls(task, SimConfig(horizon_hours=72.0, use_kernel=True))
        reset_aggregation_counts()
        t, walls = 0.0, []
        for _ in range(rounds):
            r0 = time.perf_counter()
            t_next = strategy.run_round(t)
            torch.cuda.synchronize()
            check(t_next is not None, f"{name}: round found no feasible schedule")
            walls.append(time.perf_counter() - r0)
            t = t_next
        n, calls = aggregation_counts()
        strategy.finish(t)
        violations = [str(v) for v in strategy.env.sanitizer.report()]
        finite = params_finite(torch, strategy.global_params)
        last = slice(-2, None)        # the last two of a long run's rounds
        rows[name] = dict(rounds=rounds, wall_s_total=sum(walls), wall_s=walls[last],
                          accuracy=[h.metrics["accuracy"] for h in strategy.history][last],
                          t_hours=[h.t_hours for h in strategy.history][last],
                          aggregate_flat_launches=n, weighted_average_calls=calls,
                          finite=finite, schedule_violations=violations)
        emit("baseline", name=name, **rows[name])
        check(n == calls, f"{name}: {n} K1 launches for {calls} aggregations")
        check(calls > 0, f"{name}: no aggregation reached the kernel")
        check(finite, f"{name}: non-finite global params")
        check(not violations, f"{name}: schedule sanitizer: {violations}")
        launches += n
    fedavg_hours = rows["FedAvg"]["t_hours"][-1]
    emit("baselines", strategies=len(rows), aggregate_flat_launches=launches,
         fedleo_t_hours=fedleo_hours[1], fedavg_t_hours=fedavg_hours)
    check(fedleo_hours[1] < fedavg_hours,
          f"FedLEO's two rounds ({fedleo_hours[1]} h) not below FedAvg's ({fedavg_hours} h)")
    phase_wall("baselines", t0)
    return launches


def agree_baselines(torch):
    """One round of each baseline (FedSpace to its first buffer flush) at
    the small size of phase ``agree``, card against CPU."""
    from repro_torch.core import SimConfig
    from repro_torch.core.baselines import ALL_BASELINES

    t0 = time.perf_counter()
    tasks = {d: make_task((4, 8), 16, 800, 32, 2, d) for d in ("cuda", "cpu")}
    worst = 0.0
    for name, cls in ALL_BASELINES.items():
        runs = {}
        for device, task in tasks.items():
            strategy = cls(task, SimConfig(horizon_hours=72.0, use_kernel=True))
            runs[device] = (strategy, strategy.run(max_rounds=AGREE_BASELINE_ROUNDS.get(name, 1)))
        (sc, rc), (sh, rh) = runs["cuda"], runs["cpu"]
        same = ([h.t_hours for h in rc.history] == [h.t_hours for h in rh.history]
                and [h.events for h in rc.history] == [h.events for h in rh.history])
        err = max_param_diff(sc.global_params, sh.global_params)
        worst = max(worst, err)
        check(same, f"{name}: CUDA and CPU schedules differ")
        check(err <= 1e-4, f"{name}: CUDA and CPU params differ by {err}")
    emit("baselines_agree", strategies=len(ALL_BASELINES), param_max_abs_err=worst,
         limit=1e-4, same_schedule=True)
    phase_wall("baselines_agree", t0)


def unet_task(device, size=64, num_samples=256, sim_epochs=UNET_SIM_EPOCHS, **unet_kw):
    """Fig. 5's DeepGlobe-like task: the U-Net (``init_unet``'s defaults
    unless ``unet_kw`` narrows it), IID over 5x8 satellites, Adam at
    1e-3."""
    from repro_torch.core import FederatedTask, TrainHyperparams
    from repro_torch.data import make_segmentation_dataset, partition_iid
    from repro_torch.models.cnn import apply_unet, init_unet
    from repro_torch.optim import get_optimizer

    train = make_segmentation_dataset(num_samples=num_samples, size=size, seed=0)
    test = make_segmentation_dataset(num_samples=64, size=size, seed=9)
    return FederatedTask(
        init_fn=lambda r: init_unet(r, **unet_kw),
        apply_fn=apply_unet,
        clients=partition_iid(train, SCENARIO["num_planes"], SCENARIO["sats_per_plane"]),
        test_set=test,
        optimizer=get_optimizer("adam", 1e-3),
        hp=TrainHyperparams(local_epochs=20, learning_rate=0.01, batch_size=4),
        sim_epochs=sim_epochs,
        device=device,
    )


def run_unet(torch, args, smi):
    """FedLEO with the full-width U-Net on the DeepGlobe-like data (with
    --profile, one more round under torch.profiler); returns
    aggregate_flat's launches."""
    from repro_torch.core import FedLEO, SimConfig
    from repro_torch.models.nn import count_params
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    p = SCENARIO["num_planes"]
    task = unet_task(None)
    n = count_params(task.global_params)
    check(task.device.type == "cuda", f"task on {task.device}")
    check(n == UNET_PARAMS and len(tree_leaves(task.global_params)) == UNET_LEAVES,
          f"unexpected U-Net: {n} parameters")
    strategy = FedLEO(task, SimConfig(horizon_hours=72.0, use_kernel=True))
    train_s = []
    local_train = task.local_train

    def timed_local_train(*args, **kwargs):
        l0 = time.perf_counter()
        out = local_train(*args, **kwargs)
        torch.cuda.synchronize()
        train_s[-1] += time.perf_counter() - l0
        return out

    task.local_train = timed_local_train
    torch.cuda.reset_peak_memory_stats()
    reset_aggregation_counts()
    t, walls, accs = 0.0, [], []
    for _ in range(UNET_ROUNDS):
        train_s.append(0.0)
        r0 = time.perf_counter()
        t_next = strategy.run_round(t)
        torch.cuda.synchronize()
        check(t_next is not None, "U-Net round found no feasible schedule")
        walls.append(time.perf_counter() - r0)
        accs.append(strategy.history[-1].metrics["accuracy"])
        t = t_next
    launches, calls = aggregation_counts()
    del task.local_train
    if args.profile:
        prof = profile_round(torch, strategy, t)
        t = prof.pop("t_next")
        emit("unet_profile", round=UNET_ROUNDS + 1, nvidia_smi=smi, **prof)
        check(prof["device_busy_ms"] == "not measured" or prof["aggregate_kernel_launches"] == p + 1,
              f"the profiled round ran {prof['aggregate_kernel_launches']} aggregation kernels")
    strategy.finish(t)
    violations = [str(v) for v in strategy.env.sanitizer.report()]
    expected = UNET_ROUNDS * (p + 1)
    finite = params_finite(torch, strategy.global_params)
    emit("unet", params=n, leaves=UNET_LEAVES, rounds=UNET_ROUNDS, sim_epochs=UNET_SIM_EPOCHS,
         wall_s=walls, local_train_s=train_s,
         local_train_share=[a / b for a, b in zip(train_s, walls)],
         pixel_accuracy=accs, t_hours=[h.t_hours for h in strategy.history],
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         aggregate_flat_launches=launches, expected_launches=expected,
         weighted_average_calls=calls, finite=finite,
         schedule_violations=violations, nvidia_smi=smi)
    check(launches == calls == expected,
          f"aggregate_flat launched {launches} times for {calls} aggregations, expected {expected}")
    check(finite, "non-finite U-Net params")
    check(not violations, f"schedule sanitizer: {violations}")
    check(accs[-1] > accs[0], f"U-Net pixel accuracy did not rise: {accs}")

    # a small U-Net round on the card against the same round on the CPU
    runs = {}
    for device in ("cuda", "cpu"):
        small = FedLEO(unet_task(device, size=32, num_samples=80, sim_epochs=2, base=4, depth=2),
                       SimConfig(horizon_hours=72.0, use_kernel=True))
        runs[device] = (small, small.run(max_rounds=1))
    (sc, rc), (sh, rh) = runs["cuda"], runs["cpu"]
    same = (rc.history[0].t_hours == rh.history[0].t_hours
            and rc.history[0].events == rh.history[0].events)
    err = max_param_diff(sc.global_params, sh.global_params)
    emit("unet_agree", param_max_abs_err=err, limit=1e-4, same_schedule=same,
         accuracy_cuda=rc.final_accuracy, accuracy_cpu=rh.final_accuracy)
    check(same, "U-Net: CUDA and CPU schedules differ")
    check(err <= 1e-4, f"U-Net: CUDA and CPU params differ by {err}")
    phase_wall("unet", t0)
    return launches


def run_fleet(torch, uniform_hours):
    """The main path's FedLEO run on a heterogeneous fleet (gemma-7b and
    mamba2-780m planes on the orbital GPU tier, one plane at the paper's
    uniform timing); returns aggregate_flat's launches and the round
    times."""
    from repro_torch.compute import SatelliteComputeProfile
    from repro_torch.core import FedLEO, SimConfig

    t0 = time.perf_counter()
    p, rounds = SCENARIO["num_planes"], 2
    hetero = SatelliteComputeProfile.per_plane(FLEET_ARCHS, device="orbital-gpu", smoke=False)

    def run(compute, device, sim_epochs):
        task = make_task((32, 64), 128, SCENARIO["train"], 16, sim_epochs, device)
        strategy = FedLEO(task, SimConfig(horizon_hours=72.0, use_kernel=True, compute=compute))
        return strategy, strategy.run(max_rounds=rounds)

    reset_aggregation_counts()
    strategy, res = run(hetero, None, SIM_EPOCHS)
    launches, calls = aggregation_counts()
    hours = [h.t_hours for h in res.history]
    # the clock does not see the executed epochs: one epoch on the CPU
    _, res_cpu = run(hetero, "cpu", 1)
    _, res_default = run(SatelliteComputeProfile(), None, 1)
    cpu_hours = [h.t_hours for h in res_cpu.history]
    default_hours = [h.t_hours for h in res_default.history]
    finite = params_finite(torch, strategy.global_params)
    violations = [str(v) for v in strategy.env.sanitizer.report()]
    expected = rounds * (p + 1)
    emit("fleet", archs=FLEET_ARCHS, device="orbital-gpu", rounds=rounds, t_hours=hours,
         t_hours_cpu=cpu_hours, t_hours_uniform=uniform_hours[:rounds],
         t_hours_default_profile=default_hours,
         accuracy=[h.metrics["accuracy"] for h in res.history],
         plane_seconds_per_sample=[r["seconds_per_sample"] for r in strategy.compute.plane_summary()],
         aggregate_flat_launches=launches, expected_launches=expected,
         weighted_average_calls=calls, finite=finite, schedule_violations=violations)
    check(launches == calls == expected,
          f"aggregate_flat launched {launches} times for {calls} aggregations, expected {expected}")
    check(len(hours) == rounds and hours == cpu_hours,
          f"fleet round times differ on the CPU: {hours} against {cpu_hours}")
    check(hours != uniform_hours[:rounds], "the heterogeneous fleet did not change the round times")
    check(default_hours == uniform_hours[:rounds],
          f"the all-default profile changed the round times: {default_hours}")
    check(finite, "non-finite fleet params")
    check(not violations, f"schedule sanitizer: {violations}")
    phase_wall("fleet", t0)
    return launches, hours


def run_multitenant(torch):
    """Two concurrent jobs (FedLEO and FedAvgStar, each on the full-width
    CNN) under the JobScheduler on one shared ledger; then one job through
    the scheduler against the standalone run.  Returns aggregate_flat's
    launches in the two-job run."""
    from repro_torch.core import FedLEO, SimConfig
    from repro_torch.core.baselines import FedAvgStar
    from repro_torch.multitenant import JobScheduler, JobSpec

    t0 = time.perf_counter()
    sim = SimConfig(horizon_hours=72.0, use_kernel=True)

    def task():
        return make_task((32, 64), 128, SCENARIO["train"], 16, SIM_EPOCHS, None)

    def schedule(jobs):
        sched, runners = JobScheduler(sim, sanitize=True), {}
        for name, cls in jobs:
            def factory(env, name=name, cls=cls):
                runners[name] = cls(task(), sim, env)
                return runners[name]
            sched.submit(JobSpec(name=name, rounds=2), factory)
        return sched.run(), runners

    reset_aggregation_counts()
    records, runners = schedule([("fedleo", FedLEO), ("fedavg", FedAvgStar)])
    launches, calls = aggregation_counts()
    violations = {n: [str(v) for v in r.env.sanitizer.report()] for n, r in runners.items()}
    finite = all(params_finite(torch, r.global_params) for r in runners.values())
    emit("multitenant", jobs=[dataclasses.asdict(r) for r in records],
         t_hours={n: [h.t_hours for h in r.history] for n, r in runners.items()},
         accuracy={n: [h.metrics["accuracy"] for h in r.history] for n, r in runners.items()},
         aggregate_flat_launches=launches, weighted_average_calls=calls,
         finite=finite, schedule_violations=violations)
    check([r.status for r in records] == ["finished", "finished"],
          f"job records: {[r.status for r in records]}")
    check(launches == calls > 0, f"{launches} K1 launches for {calls} aggregations")
    check(not any(violations.values()), f"schedule sanitizer: {violations}")
    check(finite, "non-finite job params")

    # one job through the scheduler is the standalone run, with
    # deterministic cuDNN algorithms so that training repeats exactly
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        alone = FedAvgStar(task(), sim).run(max_rounds=2)
        _, solo = schedule([("solo", FedAvgStar)])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = alone.history, solo["solo"].history
    same = ([h.t_hours for h in a] == [h.t_hours for h in b]
            and [h.round_index for h in a] == [h.round_index for h in b])
    metric_err = max(abs(x.metrics[k] - y.metrics[k]) for x, y in zip(a, b) for k in x.metrics)
    emit("multitenant_solo", same_schedule=same, metrics_max_abs_err=metric_err,
         metrics_equal=[x.metrics for x in a] == [y.metrics for y in b], limit=1e-6,
         cudnn_deterministic=True)
    check(len(a) == len(b) == 2 and same, "the scheduled job's rounds differ from the standalone run")
    check(metric_err <= 1e-6, f"the scheduled job's metrics differ by {metric_err}")
    phase_wall("multitenant", t0)
    return launches


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
            lib_fn = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                            enable_gqa=g != h)
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


def profile_call(torch, fn, moe: bool = False, complete: bool = False):
    """``profile_once``.  With ``complete``, the profile must hold a record
    of every flash and SSD kernel the call launched (by the wrappers'
    counts during its session): a session that dropped some (the
    profiler can miss a ctypes library's kernels, a few or all of them,
    ``tools/profiler_probe.py``) is run again, up to ``PROFILE_SESSIONS``
    sessions, and the profile carries ``sessions``, the calls made, which
    the caller counts.  The checks read the complete profile as any."""
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.ssd import ssd_scan

    for sessions in range(1, PROFILE_SESSIONS + 1):
        before = flash_attention.launches, ssd_scan.launches
        prof = profile_once(torch, fn, moe)
        flash, ssd = flash_attention.launches - before[0], ssd_scan.launches - before[1]
        if not complete or prof.get("device_busy_ms") == "not measured" or (
                prof["flash_tc_launches"] + prof["flash_core_launches"] >= flash
                and prof["ssd_tc_launches"] + prof["ssd_core_launches"] >= ssd):
            break
    return dict(prof, sessions=sessions) if complete else prof


def profile_once(torch, fn, moe: bool = False):
    """One call of ``fn`` under torch.profiler: its wall time, the
    device's busy share, and device time split into the flash kernels
    and the SSD kernels (tensor-core and CUDA-core apart), the library's
    attention kernels, matrix products (cuBLAS) and the rest.  With
    ``moe``, each MoE layer runs in a profiler range and so do its
    routing (router product, softmax, top-k, sort, slots), dispatch (the
    scatter into the expert buffers) and combine (the weighted gather
    back); the experts are the rest of the layer: their products
    (``moe_expert_gemm_ms``, the shared expert's too) and their
    activations (``moe_expert_other_ms``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer

    from repro_torch.kernels.flash import KERNELS
    from repro_torch.kernels.ssd import KERNELS as SSD_KERNELS

    tc_name, core_name = KERNELS[torch.bfloat16] + "<", KERNELS[torch.float32] + "<"
    ssd_tc_name = SSD_KERNELS[torch.bfloat16] + "<"
    ssd_core_name = SSD_KERNELS[torch.float32] + "<"
    ranged = {(transformer, "apply_moe"): "moe", (moe_mod, "route"): "moe_route",
              (moe_mod, "dispatch"): "moe_dispatch", (moe_mod, "combine"): "moe_combine"}
    real = {key: getattr(*key) for key in ranged}

    def in_range(fn_, label):
        def wrapped(*args, **kwargs):
            with record_function(label):
                return fn_(*args, **kwargs)
        return wrapped

    if moe:
        for (mod, name), label in ranged.items():
            setattr(mod, name, in_range(real[(mod, name)], label))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - w0)
    finally:
        for (mod, name), fn_ in real.items():
            setattr(mod, name, fn_)
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
    gemm = sum(ms for name, ms, _ in kernels if any(t in name.lower() for t in GEMM_NAMES))
    split, routed = {}, 0.0
    if moe:
        def times(label):
            ks = range_contents(prof, label)[1]
            return (sum(ms for _, ms in ks),
                    sum(ms for n, ms in ks if any(t in n.lower() for t in GEMM_NAMES)))

        (moe_ms, moe_gemm), (route, route_gemm) = times("moe"), times("moe_route")
        (dispatch, _), (combine, _) = times("moe_dispatch"), times("moe_combine")
        experts = moe_ms - route - dispatch - combine
        routed = route - route_gemm + dispatch + combine   # MoE work outside any product
        split = (dict(moe_ms=moe_ms, moe_route_ms=route, moe_router_gemm_ms=route_gemm,
                      moe_dispatch_ms=dispatch, moe_combine_ms=combine,
                      moe_dispatch_combine_share=(dispatch + combine) / busy,
                      moe_expert_gemm_ms=moe_gemm - route_gemm,
                      moe_expert_other_ms=experts - (moe_gemm - route_gemm))
                 if moe_ms else dict(moe_ms="not measured"))
    return dict(wall_ms=wall_ms, device_busy_ms=busy, device_busy_share=busy / wall_ms, **split,
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
                gemm_ms=gemm, gemm_share=gemm / busy,
                other_ms=busy - flash - ssd - gemm - routed,
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
    from repro_torch.models.nn import count_params
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config("gemma-7b")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = build_model(cfg, attn_impl="pallas")
    check(model.device.type == "cuda" and model.dtype == torch.bfloat16,
          f"model on {model.device} in {model.dtype}")
    params = model.init(gen, dtype=torch.bfloat16)
    torch.cuda.synchronize()
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
            logits, times = timed_prefill(torch, step, params, {"tokens": tokens})
            prefill_calls += 4
            check(logits.shape == (SERVE_BATCH, cfg.vocab_size), f"logits {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits.float()).all()), "non-finite prefill logits")
            ms = statistics.median(times)
            prof = {}
            if window is None and s == SERVE_SEQ:
                prof = profile_call(torch, lambda: step(params, {"tokens": tokens}),
                                    complete=True)
                prefill_calls += prof["sessions"]
                check_tc_only(prof, cfg.num_layers, "gemma-7b prefill")
            emit("prefill", window=window, batch=SERVE_BATCH, seq=s, ms=ms, ms_all=times,
                 tokens_per_s=SERVE_BATCH * s / (ms * 1e-3), nvidia_smi=smi, profile=prof)

    for window in (None, 32):
        model_w = build_model(cfg, attn_impl="pallas", sliding_window=window)
        prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, DECODE_PROMPT),
                               generator=gen, device=dev)
        max_len = DECODE_PROMPT + DECODE_GEN
        cache = model_w.init_cache(SERVE_BATCH, max_len)
        size_mb = cache_mb(cache)
        logits, cache, toks, prompt_s, gen_s, _ = serve_decode(torch, model_w, params, cache,
                                                               prompt, DECODE_GEN)
        # one more step, profiled, against a copy of the cache
        tok = torch.argmax(logits, dim=-1, keepdim=True)
        spare = tree_map(torch.clone, cache)
        prof = profile_call(torch, lambda: make_serve_step(model_w)(params, tok, spare,
                                                                    max_len - 1))
        del spare
        emit("decode", window=window, batch=SERVE_BATCH, prompt=DECODE_PROMPT, generated=DECODE_GEN,
             cache_MB=size_mb, cache_slots=int(cache["block0"].k.shape[2]),
             prompt_tokens_per_s=SERVE_BATCH * DECODE_PROMPT / prompt_s,
             tokens_per_s=SERVE_BATCH * DECODE_GEN / gen_s, ms_per_step=1e3 * gen_s / DECODE_GEN,
             sample=toks[0, :12].tolist(), nvidia_smi=smi, profile=prof)
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
            logits, times = timed_prefill(torch, step, params, {"tokens": tokens})
            calls += 4
            check(logits.shape == (SERVE_BATCH, cfg.vocab_size), f"logits {tuple(logits.shape)}")
            check(bool(torch.isfinite(logits.float()).all()), "non-finite prefill logits")
            prof = {}
            if s == SERVE_SEQ:
                prof = profile_call(torch, lambda: step(params, {"tokens": tokens}),
                                    complete=True)
                calls += prof["sessions"]
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
        logits, cache, toks, prompt_s, gen_s, _ = serve_decode(torch, model, params, cache,
                                                               prompt, DECODE_GEN)
        tok = torch.argmax(logits, dim=-1, keepdim=True)
        spare = tree_map(torch.clone, cache)
        prof = profile_call(torch, lambda: serve_step(params, tok, spare, max_len - 1))
        del spare
        emit("ssm_decode", arch=arch, batch=SERVE_BATCH, prompt=DECODE_PROMPT,
             generated=DECODE_GEN, cache_MB=size_mb,
             prompt_tokens_per_s=SERVE_BATCH * DECODE_PROMPT / prompt_s,
             tokens_per_s=SERVE_BATCH * DECODE_GEN / gen_s, ms_per_step=1e3 * gen_s / DECODE_GEN,
             sample=toks[0, :12].tolist(), nvidia_smi=smi, profile=prof)
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


# --- the zoo's serving paths: MoE, the VLM stub, the encoder-decoder ------------------
def zoo_param_count(cfg) -> int:
    """Parameters of a transformer-family config, counted from its shapes
    alone: attention, norms, GLU FFN or MoE (router, experts, shared
    experts) per layer, embedding, final norm and LM head; for the
    encoder-decoder, encoder blocks and norm, decoder blocks with
    cross-attention and a third norm."""
    d, hd, vocab = cfg.d_model, cfg.resolved_head_dim, cfg.vocab_size
    attn = 2 * d * hd * (cfg.num_heads + cfg.num_kv_heads)
    ffn = 3 * d * cfg.d_ff

    def ffn_of(i):
        m = cfg.moe
        if m is None or i % cfg.moe_every != cfg.moe_every - 1:
            return ffn
        return (d * m.num_experts + 3 * m.num_experts * d * m.d_ff_expert
                + 3 * d * m.d_ff_expert * m.num_shared_experts)

    ends = vocab * d + d + (d * vocab if cfg.encoder is not None or not cfg.tie_embeddings else 0)
    if cfg.encoder is not None:
        enc = cfg.encoder.num_layers * (attn + 2 * d + ffn) + d
        return enc + cfg.num_layers * (2 * attn + 3 * d + ffn) + ends
    return sum(attn + 2 * d + ffn_of(i) for i in range(cfg.num_layers)) + ends


def zoo_init(torch, dev, cfg, phase: str, cut=None):
    """The model through ``build_model`` (flash attention) and random
    bfloat16 weights drawn on the card, each leaf cast as drawn (no
    float32 copy of the tree); checks the count against the config's
    shapes and prints the setup line."""
    from repro_torch.configs import build_model
    from repro_torch.models.nn import count_params
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    model = build_model(cfg, attn_impl="pallas")
    check(model.device.type == "cuda" and model.dtype == torch.bfloat16,
          f"{cfg.name} on {model.device} in {model.dtype}")
    params = model.init(torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = count_params(params)
    check(n_params == zoo_param_count(cfg), f"{cfg.name} has {n_params} parameters, "
                                            f"expected {zoo_param_count(cfg)}")
    check(all(l.is_cuda and l.dtype == torch.bfloat16 for l in tree_leaves(params)),
          "params not bfloat16 on the card")
    emit(phase, arch=cfg.name, layers=cfg.num_layers, cut=cut, params=n_params,
         init_s=time.perf_counter() - t0,
         param_GB=sum(l.numel() * l.element_size() for l in tree_leaves(params)) / 1e9,
         init_peak_GB=torch.cuda.max_memory_allocated() / 1e9)
    return model, params


def zoo_batch(torch, cfg, b, s, gen, device, dtype=None):
    """Tokens, and the stub's patch or frame embeddings (bfloat16 unless
    ``dtype``): (B, P, D) for the vlm family, (B, max_source_len, D) for
    audio."""
    dtype = dtype or torch.bfloat16
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=device)}
    if cfg.family == "vlm":
        batch["extra"] = torch.randn((b, cfg.vision.num_patches, cfg.d_model), generator=gen,
                                     device=device).to(dtype)
    if cfg.family == "audio":
        batch["source"] = torch.randn((b, cfg.encoder.max_source_len, cfg.d_model),
                                      generator=gen, device=device).to(dtype)
    return batch


def timed_prefill(torch, step, params, batch):
    """A warm-up call, then 3 timed: (last logits, wall ms of each)."""
    logits = step(params, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        w0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - w0))
    return logits, times


def moe_drop_share(torch, fn) -> float:
    """Share of (token, choice) pairs past their expert's capacity in one
    call of ``fn``, over every MoE layer it runs."""
    from repro_torch.models import moe

    real, kept, pairs = moe.route, [], []

    def counting(params, xt, cfg):
        out = real(params, xt, cfg)
        kept.append(sum(int(v.sum()) for v in out[2]))
        pairs.append(len(out[2]) * xt.shape[0])
        return out

    moe.route = counting
    try:
        fn()
    finally:
        moe.route = real
    return 1.0 - sum(kept) / sum(pairs)


def serve_decode(torch, model, params, cache, prompt, gen_len):
    """Teacher-forced prompt, then ``gen_len`` greedy tokens through
    ``make_serve_step``: (last logits, cache, generated tokens, prompt
    seconds, generation seconds, the logits after the prompt)."""
    from repro_torch.train.steps import make_serve_step

    serve_step = make_serve_step(model)
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for t in range(prompt.shape[1]):
        logits, cache = serve_step(params, prompt[:, t:t + 1], cache, t)
    torch.cuda.synchronize()
    prompt_s = time.perf_counter() - w0
    w0 = time.perf_counter()
    out, prompt_logits = [], logits
    tok = torch.argmax(logits, dim=-1, keepdim=True)
    for t in range(prompt.shape[1], prompt.shape[1] + gen_len):
        out.append(tok)
        logits, cache = serve_step(params, tok, cache, t)
        tok = torch.argmax(logits, dim=-1, keepdim=True)
    torch.cuda.synchronize()
    toks = torch.cat(out, dim=1)
    check(bool(torch.isfinite(logits.float()).all()), f"{model.cfg.name}: non-finite decode logits")
    check(bool(((toks >= 0) & (toks < model.cfg.vocab_size)).all()),
          f"{model.cfg.name}: generated token ids out of range")
    return logits, cache, toks, prompt_s, time.perf_counter() - w0, prompt_logits


def zoo_prefill(torch, model, params, batch, smi, phase, per_call, moe=False):
    """Prefill through ``make_prefill_step``: 3 timed calls after a
    warm-up, one profiled call (the tensor-core flash kernel alone, by
    name), and with ``moe`` one more counting dropped pairs; the flash
    launches equal ``per_call`` a call.  Returns the prefill line."""
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.train.steps import make_prefill_step

    cfg = model.cfg
    step = make_prefill_step(model)
    before = flash_attention.launches
    logits, times = timed_prefill(torch, step, params, batch)
    check(logits.shape == (SERVE_BATCH, cfg.vocab_size), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits.float()).all()), f"{cfg.name}: non-finite prefill logits")
    prof = profile_call(torch, lambda: step(params, batch), moe=moe, complete=True)
    check_tc_only(prof, per_call, f"{cfg.name} prefill")
    calls = 4 + prof["sessions"]
    fields = {}
    if moe:
        fields["dropped_share"] = moe_drop_share(torch, lambda: step(params, batch))
        calls += 1
    launches = flash_attention.launches - before
    check(launches == per_call * calls,
          f"{cfg.name} prefill: {launches} flash launches, expected {per_call * calls}")
    ms = statistics.median(times)
    tokens = sum(v.shape[0] * v.shape[1] for v in batch.values())   # positions: tokens,
    # patches and frames
    row = dict(arch=cfg.name, layers=cfg.num_layers, batch=SERVE_BATCH,
               seq={k: v.shape[1] for k, v in batch.items()}, ms=ms, ms_all=times,
               tokens_per_s=tokens / (ms * 1e-3), flash_launches_per_call=per_call,
               peak_GB=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=smi,
               profile=prof, **fields)
    emit(phase, **row)
    return row


def zoo_decode(torch, model, params, cache, smi, phase, moe=False, agree=None):
    """Greedy decoding against the cache: no flash launch.  With
    ``agree`` (the served model's prefill: prompt -> last logits, through
    the flash kernel), the prefill of the prompt is held against its
    teacher-forced decode (the cache path), in bfloat16, within
    ``BF16_LOGIT_REL_PER_SQRT_LAYER`` x sqrt(decoder layers) of the
    largest logit."""
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.train.steps import make_serve_step
    from repro_torch.tree import tree_map

    cfg = model.cfg
    gen = torch.Generator(device=model.device).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, DECODE_PROMPT), generator=gen,
                           device=model.device)
    before = flash_attention.launches
    size = cache_mb(cache)
    logits, cache, toks, prompt_s, gen_s, prompt_logits = serve_decode(
        torch, model, params, cache, prompt, DECODE_GEN)
    check(flash_attention.launches == before, f"{cfg.name} decode launched the flash kernel")
    fields = {}
    if agree is not None:
        with torch.no_grad():
            prefill = agree(prompt).float()
        decoded = prompt_logits.float()
        scale = float(prefill.abs().max())
        err = float((prefill - decoded).abs().max())
        limit = BF16_LOGIT_REL_PER_SQRT_LAYER * cfg.num_layers ** 0.5 * scale
        ok = err <= limit
        emit(f"{phase}_agree", what=f"{cfg.name} as served, bf16: prefill vs decode at "
                                    f"{DECODE_PROMPT - 1}", max_abs_err=err, max_abs_logit=scale,
             limit=limit, rms_rel=float((prefill - decoded).norm() / prefill.norm()),
             argmax_equal=float((prefill.argmax(-1) == decoded.argmax(-1)).float().mean()), ok=ok)
        check(ok, f"{cfg.name}: served prefill and decode logits differ by {err} "
                  f"(largest logit {scale})")
    if moe:        # one more step, on a copy of the cache: capacity max(1, int(cf B k / E))
        spare = tree_map(torch.clone, cache)
        tok = toks[:, -1:]
        fields["dropped_share"] = moe_drop_share(
            torch, lambda: make_serve_step(model)(params, tok, spare, DECODE_PROMPT + DECODE_GEN))
        del spare
    emit(phase, arch=cfg.name, batch=SERVE_BATCH, prompt=DECODE_PROMPT, generated=DECODE_GEN,
         cache_MB=size, prompt_tokens_per_s=SERVE_BATCH * DECODE_PROMPT / prompt_s,
         tokens_per_s=SERVE_BATCH * DECODE_GEN / gen_s, ms_per_step=1e3 * gen_s / DECODE_GEN,
         sample=toks[0, :12].tolist(), peak_GB=torch.cuda.max_memory_allocated() / 1e9,
         nvidia_smi=smi, **fields)


def moe_serve(torch, dev, smi):
    """llama4-maverick (1 unit: a dense and a MoE block) and kimi-k2 (1
    layer) at full width in bfloat16, one after the other: prefill of 4 x
    2048 tokens through the flash kernel, then greedy decoding.  Returns
    the flash launches of the phase."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import flash_attention

    flash_attention.launches = 0
    for arch, units in MOE_SERVE.items():
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=units * full.moe_every)
        torch.cuda.reset_peak_memory_stats()
        model, params = zoo_init(torch, dev, cfg, "moe_setup",
                                 cut=f"depth {full.num_layers} -> {cfg.num_layers} layers")
        gen = torch.Generator(device=dev).manual_seed(1)
        batch = zoo_batch(torch, cfg, SERVE_BATCH, SERVE_SEQ, gen, dev)
        zoo_prefill(torch, model, params, batch, smi, "moe_prefill", cfg.num_layers, moe=True)
        cache = model.init_cache(SERVE_BATCH, DECODE_PROMPT + DECODE_GEN + 1)
        zoo_decode(torch, model, params, cache, smi, "moe_decode", moe=True)
        del model, params, cache, batch
        gc.collect()
        torch.cuda.empty_cache()
    return flash_attention.launches


def vlm_serve(torch, dev, smi):
    """internvl2-26b at full width and depth in bfloat16: prefill of 256
    patch embeddings and 2048 tokens, 4 prompts, through the flash kernel
    (48 launches a call), then text-only greedy decoding, held against a
    text-only prefill of its prompt (48 launches more)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import flash_attention

    flash_attention.launches = 0
    cfg = get_config(VLM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model, params = zoo_init(torch, dev, cfg, "vlm_setup")
    batch = zoo_batch(torch, cfg, SERVE_BATCH, SERVE_SEQ, torch.Generator(device=dev).manual_seed(1),
                      dev)
    zoo_prefill(torch, model, params, batch, smi, "vlm_prefill", cfg.num_layers)
    cache = model.init_cache(SERVE_BATCH, DECODE_PROMPT + DECODE_GEN)
    zoo_decode(torch, model, params, cache, smi, "vlm_decode",       # decode is text only
               agree=lambda p: model.forward(params, p, last_only=True)[0][:, -1])
    del model, params, cache, batch
    gc.collect()
    torch.cuda.empty_cache()
    return flash_attention.launches


def audio_serve(torch, dev, smi):
    """seamless-m4t-large-v2 whole in bfloat16: prefill of 1024 frames and
    2048 decoder tokens, 4 prompts (24 non-causal encoder and 24 causal
    decoder flash launches a call); then ``init_cache`` encodes once (24),
    greedy decoding launches none, and a prefill of its prompt over the
    same frames (48) is held against it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash import flash_attention

    flash_attention.launches = 0
    cfg = get_config(AUDIO_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model, params = zoo_init(torch, dev, cfg, "audio_setup")
    batch = zoo_batch(torch, cfg, SERVE_BATCH, SERVE_SEQ, torch.Generator(device=dev).manual_seed(1),
                      dev)
    per_call = cfg.encoder.num_layers + cfg.num_layers
    zoo_prefill(torch, model, params, batch, smi, "audio_prefill", per_call)
    before = flash_attention.launches
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    cache = model.init_cache(params, batch["source"], DECODE_PROMPT + DECODE_GEN)
    torch.cuda.synchronize()
    encode_ms = 1e3 * (time.perf_counter() - w0)
    check(flash_attention.launches - before == cfg.encoder.num_layers,
          f"init_cache launched {flash_attention.launches - before} flash kernels")
    emit("audio_encode", arch=cfg.name, frames=cfg.encoder.max_source_len, ms=encode_ms,
         cross_kv_MB=cache_mb(cache.cross_kv), nvidia_smi=smi)
    zoo_decode(torch, model, params, cache, smi, "audio_decode",
               agree=lambda p: model.forward(params, p, batch["source"], last_only=True)[0][:, -1])
    del model, params, cache, batch
    gc.collect()
    torch.cuda.empty_cache()
    return flash_attention.launches


def zoo_agree(torch, dev):
    """Prefill (the flash kernel) against teacher-forced decode (the cache
    path) at full width in float32, depth cut to 2 layers, within
    ``F32_LOGIT_REL`` of the largest logit: internvl2's text path and
    seamless (2 encoder and 2 decoder layers; the served bfloat16 models
    are held to the same comparison in ``vlm_serve`` and ``audio_serve``,
    where bfloat16's rounding sets a looser limit).  Then the
    smoke configs of the four architectures in float32, card against
    CPU: forward logits, decode logits, and a train step with adam,
    adafactor and sgd, held to ``train_agree``'s bounds."""
    from repro_torch.configs import build_model, get_config, get_smoke_config
    from repro_torch.optim import get_optimizer
    from repro_torch.train.steps import TrainState, make_serve_step, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    for arch in (VLM_ARCH, AUDIO_ARCH):
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=2)
        if cfg.encoder is not None:
            cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
                cfg.encoder, num_layers=2, max_source_len=128))
        model = build_model(cfg, attn_impl="pallas", dtype=torch.float32)
        gen = torch.Generator(device=dev).manual_seed(1)
        params = model.init(gen)
        batch = zoo_batch(torch, cfg, 2, DECODE_PROMPT, gen, dev, torch.float32)
        with torch.no_grad():                       # decode is text only
            if cfg.family == "audio":
                prefill = model.forward(params, batch["tokens"], batch["source"],
                                        last_only=True)[0][:, -1]
                cache = model.init_cache(params, batch["source"], DECODE_PROMPT,
                                         dtype=torch.float32)
            else:
                prefill = model.forward(params, batch["tokens"], last_only=True)[0][:, -1]
                cache = model.init_cache(2, DECODE_PROMPT, dtype=torch.float32)
        step = make_serve_step(model)
        for t in range(DECODE_PROMPT):
            logits, cache = step(params, batch["tokens"][:, t:t + 1], cache, t)
        scale = float(prefill.abs().max())
        err = float((prefill - logits).abs().max())
        ok = err <= F32_LOGIT_REL * scale
        emit("zoo_agree", what=f"{arch} full width, 2 layers, f32: prefill vs decode at "
                               f"{DECODE_PROMPT - 1}", max_abs_err=err, max_abs_logit=scale,
             limit=F32_LOGIT_REL * scale, ok=ok)
        check(ok, f"{arch}: prefill and decode logits differ by {err} (largest logit {scale})")
        del model, params, cache

    def rel(a, b):
        return float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    cpu = torch.device("cpu")
    for arch in ZOO_ARCHS:
        scfg = get_smoke_config(arch)           # audio: 64 frames (max_source_len)
        p_cpu = build_model(scfg, device=cpu).init(torch.Generator().manual_seed(0))
        batch = zoo_batch(torch, scfg, 2, 100, torch.Generator().manual_seed(2), cpu,
                          torch.float32)
        out = {}
        for key, where in (("card", dev), ("cpu", cpu)):
            model = build_model(scfg, attn_impl="pallas", dtype=torch.float32, device=where)
            params = tree_map(lambda p: p.to(where), p_cpu)
            b = tree_map(lambda t: t.to(where), batch)
            with torch.no_grad():
                if scfg.family == "audio":
                    logits, _ = model.forward(params, b["tokens"], b["source"])
                    cache = model.init_cache(params, b["source"], 4, dtype=torch.float32)
                else:
                    logits, _ = model.forward(params, b["tokens"], extra_embeds=b.get("extra"))
                    cache = model.init_cache(2, 4, dtype=torch.float32)
                steps = []
                for t in range(4):
                    step_logits, cache = model.decode_step(params, b["tokens"][:, t:t + 1],
                                                           cache, t)
                    steps.append(step_logits)
            out[key] = (logits.cpu(), torch.cat(steps, dim=1).cpu())
        errs = {"forward": float((out["card"][0] - out["cpu"][0]).abs().max()),
                "decode": float((out["card"][1] - out["cpu"][1]).abs().max())}
        ok = max(errs.values()) <= 2e-3
        emit("zoo_agree", what=f"{arch} smoke config, f32: forward (S=100) and 4 decode steps, "
                               "card vs CPU", max_abs_err=errs, limit=2e-3, ok=ok)
        check(ok, f"{arch} smoke: card and CPU differ by {errs}")

        for opt_name in TRAIN_AGREE_LAUNCHES:
            lr = 0.05 if opt_name == "sgd" else scfg.learning_rate
            res = {}
            for key, where in (("card", dev), ("cpu", cpu)):
                model = build_model(scfg, dtype=torch.float32, device=where)
                opt = get_optimizer(opt_name, lr)
                params = tree_map(lambda p: p.to(where), p_cpu)
                state = TrainState(params, opt.init(params),
                                   torch.zeros((), dtype=torch.int32, device=where))
                res[key] = make_train_step(model, opt)(
                    state, tree_map(lambda t: t.to(where), batch))
            (card, m_card), (host, m_host) = res["card"], res["cpu"]
            errs = {"loss": rel(m_card["total_loss"], m_host["total_loss"]),
                    "opt_state": max([rel(a, b) for a, b in zip(tree_leaves(card.opt_state),
                                                                tree_leaves(host.opt_state))
                                      if b.is_floating_point()], default=0.0),
                    "params_abs": max_param_diff(card.params, host.params)}
            ok = (errs["loss"] <= 1e-4 and errs["opt_state"] <= 1e-4
                  and (opt_name != "sgd" or errs["params_abs"] <= 1e-5)
                  and int(card.step) == int(host.step) == 1)
            emit("zoo_agree", what=f"{arch} smoke, f32, one train step, {opt_name}: card vs CPU",
                 max_rel_err_loss=errs["loss"], max_rel_err_opt_state=errs["opt_state"],
                 max_abs_err_params=errs["params_abs"], limit_rel=1e-4,
                 limit_params_sgd=1e-5, ok=ok)
            check(ok, f"zoo_agree: {arch} {opt_name}: {errs}")
    phase_wall("zoo_agree", t0)


def mamba2_train_trees(torch, dev, gen, k):
    """mamba2-780m's parameter tree and its Adam state at full width,
    each leaf stacked over k replicas in float32 (Adam's step counter
    int32), random values: the trees the ``train`` phase aggregates."""
    from repro_torch.configs import build_model, get_config
    from repro_torch.optim import adam
    from repro_torch.tree import tree_map

    params = build_model(get_config(TRAIN_ARCH)).init(gen)
    opt_state = adam(1e-3).init(params)

    def stacked(p):
        return torch.randn((k, *p.shape), generator=gen, device=dev)

    trees = {"params": tree_map(stacked, params),
             "opt_state": opt_state._replace(
                 step=torch.randint(1, 100, (k,), generator=gen, device=dev, dtype=torch.int32),
                 mu=tree_map(stacked, opt_state.mu),
                 nu=tree_map(lambda p: stacked(p).abs(), opt_state.nu))}
    del params, opt_state
    torch.cuda.empty_cache()
    return trees


def check_train_trees(torch, dev, gen):
    """K1 at the ``train`` phase's trees (K = TRAIN_REPLICAS, mamba2-780m's
    parameters, then its Adam state with the int32 step counter cast to
    float32, as ``aggregate_pytree`` passes them): one launch a tree, the
    plain version's result bit for bit.  The plain version runs on column
    blocks of 2^26 (its float64 emulation of a whole 475M-element leaf
    would not fit beside the trees).  Returns the largest error."""
    from repro_torch.kernels.aggregate import DTYPES, aggregate_flat, aggregate_leaves
    from repro_torch.kernels.aggregate_ref import aggregate_flat_ref
    from repro_torch.tree import tree_leaves

    k, block = TRAIN_REPLICAS, 1 << 26
    trees = mamba2_train_trees(torch, dev, gen, k)
    w = torch.rand((k,), generator=gen, device=dev) + 0.05
    w = w / w.sum()
    err = 0.0
    for name in ("params", "opt_state"):
        xs = [l.reshape(k, -1) if l.dtype in DTYPES else l.reshape(k, -1).float()
              for l in tree_leaves(trees.pop(name))]
        before = aggregate_flat.launches
        got = aggregate_leaves(xs, w)
        torch.cuda.synchronize()
        launches = aggregate_flat.launches - before
        abs_err, rel, bit_equal = 0.0, 0.0, True
        for x, g in zip(xs, got):
            leaf_err, leaf_max = 0.0, 0.0
            for c0 in range(0, x.shape[1], block):
                want = aggregate_flat_ref(x[:, c0:c0 + block], w)
                part = g[c0:c0 + block]
                check(bool(torch.isfinite(part).all()), "non-finite output")
                leaf_err = max(leaf_err, float((part - want).abs().max()))
                leaf_max = max(leaf_max, float(want.abs().max()))
                bit_equal &= bool(torch.equal(part, want))
            abs_err = max(abs_err, leaf_err)
            rel = max(rel, leaf_err / max(leaf_max, 1e-30))
        ok = rel <= 1e-5
        emit("check", kernel="aggregate_leaves", what=f"{TRAIN_ARCH} {name} K={k} float32",
             leaves=len(xs), elements=sum(x.shape[1] for x in xs), launches=launches,
             max_abs_err=abs_err, max_rel_err_f32=rel, bit_equal=bit_equal, ok=ok)
        check(ok and bit_equal, f"aggregate_leaves disagrees with its plain version on {name}")
        check(launches == 1, f"aggregate_leaves took {launches} launches on {name}")
        err = max(err, abs_err)
        del xs, got
        torch.cuda.empty_cache()
    return err


def kernel_launch_counts():
    from repro_torch.kernels.aggregate import aggregate_flat
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.ssd import ssd_scan

    return aggregate_flat.launches, flash_attention.launches, ssd_scan.launches


def check_train_loss(loss: float, vocab: int, what: str, first: bool) -> None:
    """Finite, and at the first step within 1.5 of ln V, as
    tests/test_archs.py::test_train_step holds a fresh model."""
    import math

    check(math.isfinite(loss), f"{what}: loss {loss}")
    if first:
        check(abs(loss - math.log(vocab)) < 1.5, f"{what}: first loss {loss}, ln V {math.log(vocab)}")


def run_train(torch, dev, smi, profile: bool):
    """FedLEO orbit replicas at full width: mamba2-780m, R replicas of
    TRAIN_BATCH x TRAIN_SEQ tokens each from make_token_dataset, a local
    step at a time (``make_fedleo_local_step``), an aggregation through K1
    every TRAIN_TAU steps (``make_fedleo_aggregate(use_kernel=True)``).
    Launch counts reset just before and read just after; with
    ``profile``, one more local step then runs under torch.profiler.
    Returns K1's launches."""
    import math

    import numpy as np

    from repro_torch.configs import build_model, get_config
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.kernels.aggregate import aggregate_flat
    from repro_torch.launch.train import _batches
    from repro_torch.models.nn import count_params
    from repro_torch.optim import get_optimizer
    from repro_torch.train import TrainState
    from repro_torch.train.fedleo_step import (make_fedleo_aggregate, make_fedleo_local_step,
                                               replicate_for_orbits)
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    r = TRAIN_REPLICAS
    model = build_model(cfg)
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    check(cfg.remat and model.ssd_impl == "xla", f"{TRAIN_ARCH}: remat {cfg.remat}, {model.ssd_impl}")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = count_params(params)
    check(n_params == SSM_MODELS[TRAIN_ARCH], f"{TRAIN_ARCH} has {n_params} parameters")
    state = replicate_for_orbits(TrainState(
        params, opt.init(params), torch.zeros((), dtype=torch.int32, device=dev)), r)
    del params
    w0 = time.perf_counter()
    ds = make_token_dataset(num_sequences=2, seq_len=2 * TRAIN_SEQ, vocab_size=cfg.vocab_size,
                            seed=0)
    batches = _batches(ds.x, TRAIN_BATCH, TRAIN_SEQ, np.random.default_rng(0))
    emit("train_setup", arch=TRAIN_ARCH, params=n_params, replicas=r, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, tau=TRAIN_TAU, steps=TRAIN_STEPS, optimizer=cfg.optimizer,
         lr=cfg.learning_rate, remat=cfg.remat, data_s=time.perf_counter() - w0,
         state_GB=sum(l.numel() * l.element_size() for l in tree_leaves(state)) / r / 1e9)
    local_step = make_fedleo_local_step(model, opt)
    aggregate = make_fedleo_aggregate(use_kernel=True)
    weights = torch.ones((r,), device=dev)

    reset_aggregation_counts()
    _, flash0, ssd0 = kernel_launch_counts()
    agg_ms = []
    for i in range(TRAIN_STEPS):
        batch = {"tokens": torch.stack([next(batches)["tokens"][None]
                                        for _ in range(r)]).to(dev)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        w0 = time.perf_counter()
        state, metrics = local_step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        losses = metrics["loss"].tolist()
        emit("train_step", arch=TRAIN_ARCH, step=i + 1, loss=losses, seconds=wall,
             tokens_per_s=r * TRAIN_BATCH * TRAIN_SEQ / wall,
             peak_GB=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=smi)
        for loss in losses:
            check_train_loss(loss, cfg.vocab_size, f"{TRAIN_ARCH} step {i + 1}", i == 0)
        if (i + 1) % TRAIN_TAU:
            continue
        differ = sum(not torch.equal(x[0], x[1]) for x in tree_leaves(state.params))
        check(differ > 0, "the replicas are equal before an aggregation")
        n_agg = sum(x[0].numel() for x in tree_leaves((state.params, state.opt_state))
                    if x.ndim and x.shape[0] == r)
        bound_ms, bound_by, nbytes = aggregate_bound_ms(r, n_agg, 4)
        before = aggregate_flat.launches
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.reset_peak_memory_stats()
        start.record()
        w0 = time.perf_counter()
        state = aggregate(state, weights)
        end.record()
        end.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - w0)
        ms = start.elapsed_time(end)
        launches = aggregate_flat.launches - before
        equal = all(torch.equal(x[0], x[1]) for x in tree_leaves(state))
        agg_ms.append(ms)
        emit("train_aggregate", after_step=i + 1, launches=launches, replicas_equal=equal,
             leaves_differing_before=differ, ms=ms, wall_ms=wall_ms, bound_ms=bound_ms,
             bound_by=bound_by, bytes=nbytes, of_bound=bound_ms / ms,
             peak_GB=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=smi)
        check(launches == 2, f"an aggregation took {launches} K1 launches, expected 2")
        check(equal, "the replicas differ after an aggregation")
    launches, flash_n, ssd_n = kernel_launch_counts()
    expected = 2 * (TRAIN_STEPS // TRAIN_TAU)
    emit("train", aggregate_flat_launches=launches, expected=expected,
         flash_attention_launches=flash_n - flash0, ssd_scan_launches=ssd_n - ssd0,
         aggregate_ms=agg_ms, final_step=state.step.tolist(),
         ln_vocab=math.log(cfg.vocab_size))
    check(launches == expected, f"train: {launches} K1 launches, expected {expected}")
    check(flash_n == flash0 and ssd_n == ssd0, "train launched the flash or SSD kernel")
    phase_wall("train", t0)
    if profile:
        emit("train_profile", arch=TRAIN_ARCH, what="one local step of both replicas",
             nvidia_smi=smi, profile=profile_call(torch, lambda: local_step(state, batch)))
    del state, metrics, local_step, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def run_plain_train(torch, dev, smi, phase, cfg, cut):
    """PLAIN_TRAIN_STEPS ``make_train_step`` steps at PLAIN_TRAIN_BATCH x
    TRAIN_SEQ random tokens, the config's optimizer, the reference
    driver's attention (``xla``) and SSD (the plain chunked scan)."""
    from repro_torch.configs import build_model
    from repro_torch.models.nn import count_params
    from repro_torch.optim import get_optimizer
    from repro_torch.train import TrainState, make_train_step

    t0 = time.perf_counter()
    model = build_model(cfg)
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    state = TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32, device=dev))
    n_params = count_params(params)
    del params
    step = make_train_step(model, opt)
    _, flash0, ssd0 = kernel_launch_counts()
    for i in range(PLAIN_TRAIN_STEPS):
        tokens = torch.randint(0, cfg.vocab_size, (PLAIN_TRAIN_BATCH, TRAIN_SEQ), generator=gen,
                               device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        w0 = time.perf_counter()
        state, metrics = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        loss = float(metrics["loss"])
        emit(f"{phase}_step", arch=cfg.name, step=i + 1, loss=loss, seconds=wall,
             tokens_per_s=PLAIN_TRAIN_BATCH * TRAIN_SEQ / wall,
             peak_GB=torch.cuda.max_memory_allocated() / 1e9, nvidia_smi=smi)
        check_train_loss(loss, cfg.vocab_size, f"{cfg.name} step {i + 1}", i == 0)
    _, flash_n, ssd_n = kernel_launch_counts()
    emit(phase, arch=cfg.name, params=n_params, layers=cfg.num_layers, remat=cfg.remat,
         optimizer=cfg.optimizer, batch=PLAIN_TRAIN_BATCH, seq=TRAIN_SEQ, cut=cut,
         step=int(state.step), params_finite=params_finite(torch, state.params),
         flash_attention_launches=flash_n - flash0, ssd_scan_launches=ssd_n - ssd0)
    check(params_finite(torch, state.params), f"{cfg.name}: non-finite parameters")
    check(flash_n == flash0 and ssd_n == ssd0, f"{phase} launched the flash or SSD kernel")
    phase_wall(phase, t0)
    del state, metrics, step, model
    gc.collect()
    torch.cuda.empty_cache()


def agree_train_step(torch, dev, arch, opt_name):
    """A smoke config's FedLEO local step (2 replicas, tau 1) and its
    aggregate through K1 on the card, the same on the CPU, float32.
    Returns (K1 launches, largest differences)."""
    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.kernels.aggregate import aggregate_flat
    from repro_torch.kernels.aggregate_ref import aggregate_flat_ref
    from repro_torch.optim import get_optimizer
    from repro_torch.train import TrainState
    from repro_torch.train.fedleo_step import (make_fedleo_aggregate, make_fedleo_local_step,
                                               replicate_for_orbits)
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke_config(arch)
    lr = 0.05 if opt_name == "sgd" else cfg.learning_rate
    p_cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 1, 2, 32),
                           generator=torch.Generator().manual_seed(1))
    out = {}
    for key, where in (("card", dev), ("cpu", torch.device("cpu"))):
        model = build_model(cfg, dtype=torch.float32, device=where)
        opt = get_optimizer(opt_name, lr)
        params = tree_map(lambda p: p.to(where), p_cpu)
        state = replicate_for_orbits(TrainState(
            params, opt.init(params), torch.zeros((), dtype=torch.int32, device=where)), 2)
        stepped, metrics = make_fedleo_local_step(model, opt)(state, {"tokens": tokens.to(where)})
        before = aggregate_flat.launches
        agg = make_fedleo_aggregate(use_kernel=True)(stepped, torch.tensor([1.0, 3.0]))
        if where.type == "cuda":
            torch.cuda.synchronize()
        out[key] = (metrics["loss"].cpu(), stepped, agg, aggregate_flat.launches - before)
    loss, stepped, agg, launches = out["card"]
    loss_cpu, stepped_cpu, _, _ = out["cpu"]
    w = torch.tensor([0.25, 0.75], device=dev)
    bit_equal = True                  # the card's aggregate, against K1's plain version
    for x, m in zip(tree_leaves(stepped), tree_leaves(agg)):
        if x.ndim and x.shape[0] == 2:
            want = aggregate_flat_ref(x.reshape(2, -1).float(), w).to(x.dtype).reshape(x.shape[1:])
            bit_equal &= bool(torch.equal(m[0], want) and torch.equal(m[1], want))

    def rel(a, b):
        return float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    errs = {"loss": rel(loss, loss_cpu),
            "opt_state": max([rel(a, b) for a, b in zip(tree_leaves(stepped.opt_state),
                                                         tree_leaves(stepped_cpu.opt_state))
                              if b.is_floating_point()], default=0.0),
            "params_abs": max_param_diff(stepped.params, stepped_cpu.params)}
    steps_equal = all(torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves(stepped.opt_state), tree_leaves(stepped_cpu.opt_state))
        if not b.is_floating_point())
    return launches, bit_equal and steps_equal, errs


def train_agree(torch, dev):
    """Smoke configs of the three families in float32, card against CPU:
    one FedLEO local step and its aggregate with each optimizer; then the
    training driver on the card as a subprocess, whose last checkpoint
    restores on the card equal to what it saved."""
    import numpy as np

    from repro_torch.ckpt import latest_step, restore_checkpoint
    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.optim import get_optimizer
    from repro_torch.train import TrainState
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    for arch in TRAIN_AGREE_ARCHS:
        for opt_name, expected in TRAIN_AGREE_LAUNCHES.items():
            launches, exact, errs = agree_train_step(torch, dev, arch, opt_name)
            # losses and moments: float32 summation order on the two
            # devices; parameters after SGD: that times the learning rate
            ok = (launches == expected and exact and errs["loss"] <= 1e-4
                  and errs["opt_state"] <= 1e-4 and (opt_name != "sgd" or errs["params_abs"] <= 1e-5))
            emit("train_agree", what=f"{arch} smoke, f32, R=2, tau=1, {opt_name}: card vs CPU",
                 launches=launches, expected_launches=expected, aggregate_bit_equal=exact,
                 max_rel_err_loss=errs["loss"], max_rel_err_opt_state=errs["opt_state"],
                 max_abs_err_params=errs["params_abs"], limit_rel=1e-4,
                 limit_params_sgd=1e-5, ok=ok)
            check(ok, f"train_agree: {arch} {opt_name}: {launches} launches, {errs}")

    ckpt_dir = ROOT / "build" / "chip_smoke" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--smoke",
           "--fedleo", "--steps", "4", "--tau", "2", "--ckpt-dir", str(ckpt_dir),
           "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    w0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("[fedleo] step")]
    losses = [float(l.split("loss=")[1].split()[0]) for l in lines]
    emit("train_agree", what="launch.train --smoke --fedleo on the card", returncode=proc.returncode,
         seconds=time.perf_counter() - w0, losses=losses,
         aggregations=sum("[aggregated]" in l for l in lines), stderr=proc.stderr[-2000:])
    check(proc.returncode == 0 and len(losses) == 4
          and sum("[aggregated]" in l for l in lines) == 2, "the training driver failed")
    cfg = get_smoke_config(TRAIN_ARCH)
    last = latest_step(str(ckpt_dir))
    check(last == 4, f"the driver's last checkpoint is at step {last}")
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(1))
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    template = TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32, device=dev))
    restored = restore_checkpoint(str(ckpt_dir), last, template)
    with np.load(ckpt_dir / f"ckpt_{last:08d}.npz") as data:
        saved = [data[k] for k in sorted(data.files, key=lambda k: int(k.split("__")[0]))]
    leaves = tree_leaves(restored)
    equal = len(leaves) == len(saved) and all(
        l.is_cuda and np.array_equal(l.cpu().numpy(), a) for l, a in zip(leaves, saved))
    emit("train_agree", what="the driver's checkpoint restored on the card", step=last,
         leaves=len(leaves), equal=equal, restored_step=int(restored.step))
    check(equal and int(restored.step) == 4, "the restored checkpoint differs from the saved one")
    phase_wall("train_agree", t0)


def _example(name: str):
    """``examples/<name>.py`` as a module (its ``main(argv)`` runs it)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}", ROOT / "examples"
                                                  / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_examples(torch, dev, smi):
    """The four example twins' ``main`` in this process, on the card:
    quickstart and serve_decode as they are, sota_comparison with
    ``--fast``, train_arch at its default config (~126M parameters, 200
    steps, 2 orbits of 4 x 256 tokens, tau 10).  Each keeps the
    reference example's defaults, so none launches a kernel: the counts
    are read around them and must not move."""
    from repro_torch.kernels.aggregate import aggregate_flat
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.ssd import ssd_scan

    t0 = time.perf_counter()
    counts = (aggregate_flat.launches, flash_attention.launches, ssd_scan.launches)
    walls = {}
    for name, argv in EXAMPLES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        w0 = time.perf_counter()
        out = _example(name).main(argv)
        torch.cuda.synchronize(dev)
        walls[name] = time.perf_counter() - w0
        peak = torch.cuda.max_memory_allocated(dev)
        fields = dict(example=f"examples/{name}.py", argv=argv, wall_s=walls[name],
                      max_memory_allocated_bytes=peak, nvidia_smi=smi)
        if name == "quickstart_torch":
            fields.update(rounds=len(out.history), final_accuracy=out.final_accuracy,
                          sim_hours=out.final_time_hours)
            check(len(out.history) == 4 and out.final_time_hours > 0,
                  f"quickstart twin: {len(out.history)} rounds")
        elif name == "sota_comparison_torch":
            fields.update(methods={k: {"accuracy": r.final_accuracy, "sim_hours":
                                       r.final_time_hours, "rounds": len(r.history)}
                                   for k, r in out.items()})
            check(len(out) == 6 and all(r.history for r in out.values()),
                  "sota_comparison twin: a method ran no round")
        elif name == "serve_decode_torch":
            fields.update(generated={k: list(v.shape) for k, v in out.items()})
            check(all(tuple(v.shape) == (4, 32) for v in out.values()),
                  "serve_decode twin: generated shapes")
        else:
            fields.update(params=out["params"], steps=out["steps"],
                          steps_per_s=out["steps_per_s"], first_loss=out["first_loss"],
                          last_loss=out["last_loss"], tail_loss=out["tail_loss"],
                          printed=out["printed"], seconds=out["seconds"])
            check(out["params"] > 100e6 and out["steps"] == 200,
                  f"train_arch twin: {out['params']} parameters, {out['steps']} steps")
            check(out["last_loss"] < out["first_loss"] and math.isfinite(out["tail_loss"]),
                  f"train_arch twin: loss {out['first_loss']} -> {out['last_loss']}")
        emit("examples", **fields)
    after = (aggregate_flat.launches, flash_attention.launches, ssd_scan.launches)
    emit("examples", what="kernel launches by the twins (K1, K2, K3)",
         launches=[b - a for a, b in zip(counts, after)], walls=walls)
    check(after == counts, f"the example twins launched kernels: {counts} -> {after}")
    phase_wall("examples", t0)


def run_calibrate(torch, dev, smi, analytic_hours):
    """``measure_smoke_step_s`` of every architecture on the card, the
    roofline's ``measured`` mode equal to its token-scaled measurement,
    and phase ``fleet``'s run priced in ``measured`` mode; returns
    aggregate_flat's launches."""
    from repro_torch.compute import DEVICE_TIERS, SatelliteComputeProfile, roofline
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
    from repro_torch.core import FedLEO, SimConfig
    from repro_torch.launch import calibrate

    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        seconds = calibrate.measure_smoke_step_s(arch, device=dev)
        emit("calibrate", arch=arch, what="smoke f32 train step, 4 x 128 tokens, min of 3",
             seconds=seconds, nvidia_smi=smi)
        check(math.isfinite(seconds) and seconds > 0, f"calibrate: {arch} step {seconds}")
    # the measured mode scales the calibration it reads by tokens
    measured, real = {}, calibrate.measure_smoke_step_s

    def recording(arch_id, **kw):
        measured[arch_id] = real(arch_id, **kw)
        return measured[arch_id]

    calibrate.measure_smoke_step_s = recording
    try:
        roofline._measured_step_time_s.cache_clear()
        roofline.step_time_s.cache_clear()
        shape = INPUT_SHAPES["train_4k"]
        scale = shape.global_batch * shape.seq_len / (CALIBRATE_BATCH * CALIBRATE_SEQ)
        for arch in ARCH_IDS:
            got = roofline.step_time_s(arch, "train_4k", DEVICE_TIERS["orbital-gpu"],
                                       mode="measured")
            emit("calibrate", arch=arch, what="step_time_s(train_4k, measured)", seconds=got,
                 calibration_s=measured[arch], token_scale=scale, nvidia_smi=smi)
            check(got == measured[arch] * scale,
                  f"measured mode: {got} s is not {measured[arch]} x {scale}")

        rounds = len(analytic_hours)
        # measured mode times the smoke configs (the profile refuses smoke=False)
        profile = SatelliteComputeProfile.per_plane(FLEET_ARCHS, device="orbital-gpu",
                                                    mode="measured")
        task = make_task((32, 64), 128, SCENARIO["train"], 16, SIM_EPOCHS, None)
        reset_aggregation_counts()
        strategy = FedLEO(task, SimConfig(horizon_hours=72.0, use_kernel=True, compute=profile))
        res = strategy.run(max_rounds=rounds)
        launches, calls = aggregation_counts()
    finally:
        calibrate.measure_smoke_step_s = real
    hours = [h.t_hours for h in res.history]
    expected = rounds * (SCENARIO["num_planes"] + 1)
    emit("calibrate", what="phase fleet's run priced in measured mode", archs=FLEET_ARCHS,
         t_hours=hours, t_hours_analytic=analytic_hours,
         plane_seconds_per_sample=[r["seconds_per_sample"]
                                   for r in strategy.compute.plane_summary()],
         aggregate_flat_launches=launches, expected_launches=expected, nvidia_smi=smi)
    check(launches == calls == expected,
          f"aggregate_flat launched {launches} times for {calls} aggregations, expected {expected}")
    check(len(hours) == rounds and all(math.isfinite(h) for h in hours),
          f"measured fleet round times {hours}")
    check(hours != analytic_hours, "the measured fleet kept the analytic round times")
    phase_wall("calibrate", t0)
    return launches


def run_compiled(torch):
    """``compiled_step_cost`` of every architecture (the smoke train step
    counted on fake tensors at 4 x 128, token-scaled to train_4k), its
    FLOPs held to the CPU tests' band around the analytic 6 N D."""
    from repro_torch.compute import roofline
    from repro_torch.configs import ARCH_IDS

    t0 = time.perf_counter()
    for arch in ARCH_IDS:
        w0 = time.perf_counter()
        cost = roofline.compiled_step_cost(arch, "train_4k")
        analytic = roofline.analytic_step_cost(arch, "train_4k", True)
        ratio = cost.flops / analytic.flops
        lo, hi = COMPILED_FLOP_BANDS.get(arch, COMPILED_FLOP_BAND)
        emit("compiled", arch=arch, shape="train_4k", flops=cost.flops, bytes=cost.hbm_bytes,
             tokens=cost.tokens, analytic_flops=analytic.flops, flops_over_analytic=ratio,
             band=[lo, hi], seconds=time.perf_counter() - w0)
        check(lo <= ratio <= hi and cost.hbm_bytes > 0,
              f"compiled: {arch} FLOPs {ratio:.3f}x the analytic count, band [{lo}, {hi}]")
    phase_wall("compiled", t0)


def run_dryrun(torch, dev, smi):
    """``run_pair`` on the 16 x 16 production mesh (the fake backend, each
    pair in a subprocess of its own, all at once): per-device memory,
    FLOPs, bytes and collective bytes; whether the per-device bytes fit
    the card."""
    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "chip_smoke" / "dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    procs = {}
    for arch, shape in DRYRUN_PAIRS:
        out = out_dir / f"{arch}_{shape}.jsonl"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--out", str(out)]
        with open(out.with_suffix(".log"), "w") as log:
            procs[(arch, shape)] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                                     stderr=subprocess.STDOUT),
                                    out, time.perf_counter())
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    records = []
    try:
        for (arch, shape), (proc, out, w0) in procs.items():
            proc.wait(timeout=DRYRUN_TIMEOUT_S)
            rec = json.loads(out.read_text().splitlines()[-1]) if out.exists() else {}
            rec["wall_s"] = time.perf_counter() - w0
            records.append(rec)
            ok = proc.returncode == 0 and rec.get("ok") is True
            if not ok:
                emit("dryrun", arch=arch, shape=shape, ok=False, returncode=proc.returncode,
                     error=rec.get("error"),
                     log=out.with_suffix(".log").read_text()[-2000:])
            check(ok, f"dryrun: {arch} x {shape} failed")
            mem = rec["memory"]
            per_device = (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                          + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
            coll = sum(rec["collective_bytes"].values())
            numbers = [rec["flops"], rec["bytes_accessed"], coll, per_device, *mem.values()]
            ref = DRYRUN_REFERENCE[(arch, shape)]
            ref_bytes = ref["argument"] + ref["output"] + ref["temp"] - ref["alias"]
            fits, ref_fits = per_device <= card_bytes, ref_bytes <= card_bytes
            emit("dryrun", arch=arch, shape=shape, mesh=rec["mesh"], kind=rec["kind"],
                 depth=rec["depth"], traced_depth=rec["traced_depth"],
                 attention=rec.get("attention"), loss=rec.get("loss"),
                 experts=rec.get("experts"), torch_flattens_sharded_dims=rec.get(
                     "dtensor_flattens_sharded_dims"),
                 flops_per_device=rec["flops"], bytes_per_device=rec["bytes_accessed"],
                 collective_bytes=rec["collective_bytes"],
                 top_collectives=rec.get("top_collectives"), memory=mem,
                 per_device_bytes=per_device, card_bytes=card_bytes, fits_card=fits,
                 reference_per_device_bytes=ref_bytes, reference_fits_card=ref_fits,
                 verdict_matches=fits == ref_fits,
                 per_device_over_reference=per_device / ref_bytes,
                 reference_collective_bytes=ref["collective"],
                 collective_over_reference=coll / ref["collective"],
                 seconds=rec["compile_s"], wall_s=rec["wall_s"],
                 host="this run's CPU (fake tensors)", nvidia_smi=smi)
            check(all(math.isfinite(v) and v >= 0 for v in numbers) and rec["flops"] > 0,
                  f"dryrun: {arch} x {shape} counted {numbers}")
            check(rec["kind"] != "train" or coll > 0,
                  f"dryrun: the train pair {arch} x {shape} shows no collective traffic")
            # the port fits wherever the reference does (a verdict apart from
            # the reference's is then one where the port holds less than it)
            check(fits or not ref_fits,
                  f"dryrun: {arch} x {shape} needs {per_device:.4g} B a device, over the "
                  f"card's {card_bytes}, where the reference's {ref_bytes:.4g} B fit")
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    per_pair = statistics.mean(r["compile_s"] for r in records)
    emit("dryrun", what="the 40-pair sweep (10 archs x 4 shapes, 16 x 16) is not run here",
         pairs_run=len(records), mean_pair_s=per_pair, sweep_estimate_s=40 * per_pair,
         command="PYTHONPATH=src python -m repro_torch.launch.dryrun --out dryrun_16x16.jsonl")
    phase_wall("dryrun", t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more FedLEO round and training step after the checks")
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
    agg_err = max(agg_err, check_train_trees(torch, dev, gen))
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
    agg_launches, fedleo_hours = run_fedleo(torch, args, smi, n_main)
    agree_fedleo(torch)

    # 7-11. the rest of the paper's FL stack, every aggregation through K1
    agg_launches += run_baselines(torch, n_main, fedleo_hours)
    agree_baselines(torch)
    agg_launches += run_unet(torch, args, smi)
    fleet_launches, fleet_hours = run_fleet(torch, fedleo_hours)
    agg_launches += fleet_launches
    agg_launches += run_multitenant(torch)
    gc.collect()
    torch.cuda.empty_cache()

    # 12-13. the serving path, and its agreement checks
    flash_launches = serve(torch, dev, smi)
    serve_agree(torch, dev)
    gc.collect()                # gemma's weights are gone before the SSM phases
    torch.cuda.empty_cache()

    # 14-15. the SSM serving path, and its agreement checks
    ssd_launches = ssm_serve(torch, dev, smi)
    ssm_agree(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # 16-19. the zoo's serving paths (MoE, the VLM stub, the encoder-decoder),
    # each model freed before the next is built, and their agreement checks
    for name, phase in (("moe_serve", moe_serve), ("vlm_serve", vlm_serve),
                        ("audio_serve", audio_serve)):
        t0 = time.perf_counter()
        flash_launches += phase(torch, dev, smi)
        phase_wall(name, t0)
    zoo_agree(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # 20-23. training: FedLEO orbit replicas with K1, plain train steps,
    # and their agreement checks
    from repro_torch.configs import get_config

    agg_launches += run_train(torch, dev, smi, args.profile)
    run_plain_train(torch, dev, smi, "train_hybrid", get_config("zamba2-1.2b"), cut=None)
    run_plain_train(torch, dev, smi, "train_dense",
                    dataclasses.replace(get_config("gemma-7b"), num_layers=GEMMA_TRAIN_UNITS),
                    cut=f"depth 28 -> {GEMMA_TRAIN_UNITS} units (28 need ~137 GB of Adam state)")
    train_agree(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # 24. the four example twins on the card
    run_examples(torch, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()

    # 25-27. the launch layer: calibrated step times on the card (and the
    # hetero fleet priced by them), the roofline's compiled mode, the dry run
    agg_launches += run_calibrate(torch, dev, smi, fleet_hours)
    run_compiled(torch)
    run_dryrun(torch, dev, smi)

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
