# Copied from src/repro/compute/roofline.py; imports rebound to repro_torch.
"""Per-(arch, shape, device) roofline step-time estimation, LRU-cached.

Three estimation modes (``SatelliteComputeProfile.mode``):

  analytic   FLOPs = (6 train / 2 inference) x N_active x tokens and an
             HBM-byte model from the arch config's param counts — no
             jax needed, the default.
  compiled   exact XLA ``cost_analysis`` FLOPs/bytes of the lowered
             smoke-config train step (``launch/dryrun``'s
             ``cost_analysis_dict``) at a reduced compile shape, scaled
             linearly in tokens to the profile's shape (the same
             linear-in-tokens assumption the analytic model makes).
  measured   wall-clock of one real jitted smoke step on this host
             (``repro.launch.calibrate`` — the sanctioned wall-clock
             home; this module stays inside the lint's simulation-path
             clock ban), same token scaling.

``step_time_s`` turns a ``StepCost`` into roofline time
max(flops / (peak x MFU), bytes / BW); ``seconds_per_sample`` divides
by the shape's global batch — the c_k/f_k replacement that
``FleetComputeModel`` feeds into eq. (11).  ``arch_payload_bits``
derives the comm payload z|N| from the arch's real param count.

Everything is cached with ``functools.lru_cache`` on hashable keys
(arch id, shape name, frozen ``DeviceProfile``), so pricing a
40-plane round costs one dict lookup per plane.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.compute.profiles import DeviceProfile
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.configs.registry import get_config, get_smoke_config

# training streams each parameter ~3x per step (read weights, write
# grads, read+write optimizer moments amortized); inference reads once
_TRAIN_PARAM_PASSES = 3
_BF16_BYTES = 2
# per-token-per-layer activation traffic, in units of d_model elements
# (residual stream in + out, plus the block's two projections)
_ACTIVATION_FACTOR = 4

# compiled/measured modes run the smoke config at this reduced shape
# (CPU-tractable: a few seconds to lower + compile) and scale linearly
# in tokens to the profile's shape
_COMPILE_SEQ_LEN = 128
_COMPILE_BATCH = 4


@dataclasses.dataclass(frozen=True)
class StepCost:
    """One training/inference step's resource footprint."""

    flops: float
    hbm_bytes: float
    tokens: float                # tokens processed by the step


def _tokens(shape: InputShape) -> float:
    """Tokens per step: decode advances one position per sequence."""
    if shape.kind == "decode":
        return float(shape.global_batch)
    return float(shape.global_batch) * float(shape.seq_len)


def _resolve_config(arch_id: str, smoke: bool) -> ArchConfig:
    return get_smoke_config(arch_id) if smoke else get_config(arch_id)


@functools.lru_cache(maxsize=None)
def analytic_step_cost(
    arch_id: str, shape_name: str, smoke: bool = True
) -> StepCost:
    """FLOPs/bytes from the config's param counts (no jax import)."""
    cfg = _resolve_config(arch_id, smoke)
    shape = INPUT_SHAPES[shape_name]
    tokens = _tokens(shape)
    n_active = float(cfg.active_param_count_estimate())
    n_total = float(cfg.param_count_estimate())
    flops_per_token = (6.0 if shape.kind == "train" else 2.0) * n_active
    param_passes = _TRAIN_PARAM_PASSES if shape.kind == "train" else 1
    act_bytes = (
        tokens * cfg.d_model * cfg.num_layers
        * _ACTIVATION_FACTOR * _BF16_BYTES
    )
    return StepCost(
        flops=flops_per_token * tokens,
        hbm_bytes=n_total * _BF16_BYTES * param_passes + act_bytes,
        tokens=tokens,
    )


@functools.lru_cache(maxsize=None)
def compiled_step_cost(arch_id: str, shape_name: str) -> StepCost:
    """XLA cost_analysis of the lowered smoke train step, token-scaled.

    Lowers + compiles the smoke config at the reduced compile shape on
    a single-device mesh (jax is imported lazily — analytic-mode users
    never pay it), reads ``cost_analysis_dict`` and scales FLOPs and
    bytes linearly from compile-shape tokens to the profile shape's."""
    import repro_torch.configs.base as base
    from repro_torch.launch.dryrun import cost_analysis_dict, lower_pair
    from repro_torch.launch.mesh import make_mesh_compat

    shape = INPUT_SHAPES[shape_name]
    small = dataclasses.replace(
        shape,
        name=f"_roofline_{shape_name}",
        seq_len=min(shape.seq_len, _COMPILE_SEQ_LEN),
        global_batch=min(shape.global_batch, _COMPILE_BATCH),
    )
    base.INPUT_SHAPES[small.name] = small
    try:
        mesh = make_mesh_compat((1, 1), ("data", "model"))
        lowered, _ = lower_pair(
            arch_id, small.name, mesh, cfg=get_smoke_config(arch_id)
        )
        cost = cost_analysis_dict(lowered.compile())
    finally:
        base.INPUT_SHAPES.pop(small.name, None)
    scale = _tokens(shape) / _tokens(small)
    analytic = analytic_step_cost(arch_id, shape_name, True)
    flops = float(cost.get("flops", 0.0)) or analytic.flops / scale
    hbm = float(cost.get("bytes accessed", 0.0)) or (
        analytic.hbm_bytes / scale
    )
    return StepCost(
        flops=flops * scale, hbm_bytes=hbm * scale, tokens=_tokens(shape)
    )


def step_cost(
    arch_id: str, shape_name: str, *, mode: str = "analytic",
    smoke: bool = True,
) -> StepCost:
    """The (arch, shape) step cost under the given estimation mode
    ("measured" prices like "compiled": its calibration replaces the
    roofline *time*, not the cost, in ``step_time_s``)."""
    if mode in ("compiled", "measured"):
        return compiled_step_cost(arch_id, shape_name)
    return analytic_step_cost(arch_id, shape_name, smoke)


@functools.lru_cache(maxsize=None)
def _measured_step_time_s(arch_id: str, shape_name: str) -> float:
    """Wall-clock of one real smoke step, token-scaled to the shape.

    The measurement itself lives in ``repro.launch.calibrate`` — the
    simulation packages (this one included) are wall-clock-banned."""
    from repro_torch.launch.calibrate import measure_smoke_step_s

    shape = INPUT_SHAPES[shape_name]
    small_tokens = (
        float(min(shape.global_batch, _COMPILE_BATCH))
        * min(shape.seq_len, _COMPILE_SEQ_LEN)
    )
    t = measure_smoke_step_s(
        arch_id,
        seq_len=min(shape.seq_len, _COMPILE_SEQ_LEN),
        global_batch=min(shape.global_batch, _COMPILE_BATCH),
    )
    return t * _tokens(shape) / small_tokens


@functools.lru_cache(maxsize=None)
def step_time_s(
    arch_id: str,
    shape_name: str,
    device: DeviceProfile,
    *,
    mode: str = "analytic",
    smoke: bool = True,
) -> float:
    """Roofline step time on ``device``:
    max(flops / (peak x MFU), bytes / BW).  "measured" mode instead
    returns this host's calibrated wall-clock per step (the device
    argument is ignored — the host IS the device)."""
    if mode == "measured":
        return _measured_step_time_s(arch_id, shape_name)
    c = step_cost(arch_id, shape_name, mode=mode, smoke=smoke)
    t_compute = c.flops / (device.peak_flops * device.mfu_fraction)
    t_memory = c.hbm_bytes / device.hbm_bytes_per_s
    return max(t_compute, t_memory)


def seconds_per_sample(
    arch_id: str,
    shape_name: str,
    device: DeviceProfile,
    *,
    mode: str = "analytic",
    smoke: bool = True,
) -> float:
    """Per-sample training cost — the heterogeneous replacement for the
    paper's uniform c_k / f_k in eq. (11)."""
    shape = INPUT_SHAPES[shape_name]
    t = step_time_s(arch_id, shape_name, device, mode=mode, smoke=smoke)
    return t / float(shape.global_batch)


@functools.lru_cache(maxsize=None)
def arch_payload_bits(
    arch_id: str, *, bits_per_param: int = 32, smoke: bool = True
) -> float:
    """Comm payload z|N| from the arch's real param count (the same
    sizing rule as ``multitenant.registry_payload_bits``)."""
    cfg = _resolve_config(arch_id, smoke)
    return float(cfg.param_count_estimate()) * bits_per_param
