"""Abstract stand-ins for every model input (no allocation).

The counterpart of ``src/repro/launch/specs.py``.  Where the reference
builds ``jax.ShapeDtypeStruct``s, these build ``ShapeDtypeStruct``s of
``launch.sharding``: a fake tensor of the global shape, made under
``FakeTensorMode`` (it allocates nothing), with its sharding.
``jax.eval_shape(model.init, ...)`` becomes ``model.init`` run under
that mode.  Each function runs under the fake mode already active (the
dry run enters one for a whole pair, so every input shares it), or
under a new one.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch import sharding as shardlib
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import P, NamedSharding, ShapeDtypeStruct
from repro_torch.optim import get_optimizer
from repro_torch.train.steps import TrainState
from repro_torch.tree import tree_flatten_with_path, tree_map, tree_unflatten

PyTree = Any


@contextlib.contextmanager
def fake_mode() -> Iterator[Any]:
    """The active ``FakeTensorMode``, or a new one entered for the block."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = detect_fake_mode()
    if mode is not None:
        yield mode
        return
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        yield mode


def values(tree: PyTree) -> PyTree:
    """The fake tensors of a tree of ShapeDtypeStructs."""
    return tree_map(lambda s: s.value if isinstance(s, ShapeDtypeStruct) else s, tree)


def sds(shape, dtype, mesh: Optional[Mesh] = None, spec=None) -> ShapeDtypeStruct:
    with fake_mode():
        value = torch.empty(tuple(shape), dtype=dtype)
    if mesh is None:
        return ShapeDtypeStruct(value)
    return ShapeDtypeStruct(value, NamedSharding(mesh, spec or P()))


def sliding_window_for(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    """Window policy: long_500k uses the sub-quadratic variant for
    attention-bearing archs (DESIGN.md §4); other shapes use full attn."""
    if shape.name != "long_500k":
        return None
    if cfg.family == "ssm":
        return None                      # attention-free
    return cfg.sliding_window


def batch_specs(
    cfg: ArchConfig, shape: InputShape, mesh: Optional[Mesh] = None
) -> Dict[str, ShapeDtypeStruct]:
    """Train/prefill batch pytree (decode uses token_specs/cache_specs)."""
    b, s = shape.global_batch, shape.seq_len
    dp = shardlib.batch_sharding(mesh, b) if mesh is not None else ()
    dp_spec = dp if len(dp) != 1 else dp[0]
    batch = {
        "tokens": sds((b, s), torch.int32, mesh,
                      P(dp_spec, None) if mesh else None)
    }
    if cfg.family == "vlm":
        batch["extra"] = sds(
            (b, cfg.vision.num_patches, cfg.d_model), torch.bfloat16, mesh,
            P(dp_spec, None, None) if mesh else None,
        )
    if cfg.family == "audio":
        batch["source"] = sds(
            (b, cfg.encoder.max_source_len, cfg.d_model), torch.bfloat16,
            mesh, P(dp_spec, None, None) if mesh else None,
        )
    return batch


def params_specs(model, mesh: Mesh, fsdp_axes=("data",),
                 rng_seed: int = 0) -> PyTree:
    with fake_mode():
        shapes = model.init(torch.Generator().manual_seed(rng_seed))
    shardings = shardlib.tree_shardings(shapes, mesh, fsdp_axes=fsdp_axes)
    return shardlib.with_shardings(shapes, shardings)


def state_specs(model, cfg: ArchConfig, mesh: Mesh,
                fsdp_axes=("data",),
                opt_fsdp_axes=None) -> TrainState:
    """Sharding modes:
      * FSDP-2D (baseline): fsdp_axes=("data",) — params 2-D sharded
        (data x model).
      * ZeRO-1: fsdp_axes=(), opt_fsdp_axes=("data",) — params TP-only
        (replicated over data), optimizer state sharded over data.
    """
    opt_fsdp_axes = fsdp_axes if opt_fsdp_axes is None else opt_fsdp_axes
    p_specs = params_specs(model, mesh, fsdp_axes)
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    with fake_mode():
        opt_shapes = opt.init(values(p_specs))
    opt_shardings = shardlib.tree_shardings(opt_shapes, mesh,
                                            fsdp_axes=opt_fsdp_axes)
    opt_sds = shardlib.with_shardings(opt_shapes, opt_shardings)
    step_sds = sds((), torch.int32, mesh, P())
    return TrainState(params=p_specs, opt_state=opt_sds, step=step_sds)


def cache_specs(
    model, cfg: ArchConfig, shape: InputShape, mesh: Mesh,
    fsdp_axes=("data",),
) -> PyTree:
    """Decode-cache ShapeDtypeStructs with batch/head sharding."""
    b = shape.global_batch
    with fake_mode(), torch.no_grad():
        if cfg.family == "audio":
            p_specs = params_specs(model, mesh, fsdp_axes)
            src = batch_specs(cfg, shape, mesh)["source"]
            shapes = model.init_cache(values(p_specs), src.value, max_len=shape.seq_len)
        else:
            shapes = model.init_cache(b, shape.seq_len)
    dp = shardlib.batch_sharding(mesh, b)
    dp_spec = dp if len(dp) != 1 else (dp[0] if dp else None)

    def one(path, leaf):
        # find the batch dim: caches are (B, ...) or stacked (L, B, ...)
        shp = tuple(leaf.shape)
        spec = [None] * len(shp)
        for i, d in enumerate(shp[:3]):
            if d == b and dp:
                spec[i] = dp_spec
                break
        # shard a kv-head / ssm-head dim over model when divisible
        path_s = shardlib._path_str(path)
        for i in range(len(shp) - 1, 0, -1):
            if spec[i] is None and shp[i] > 1 and \
                    shp[i] % mesh.shape["model"] == 0 and i >= 2:
                if ("ssm" in path_s or "k" == path_s.split("/")[-1]
                        or "v" == path_s.split("/")[-1]
                        or "conv" in path_s):
                    spec[i] = "model"
                    break
        return ShapeDtypeStruct(leaf, NamedSharding(mesh, P(*spec)))

    pairs, treedef = tree_flatten_with_path(shapes)
    return tree_unflatten(treedef, [one(path, leaf) for path, leaf in pairs])


def token_specs(cfg: ArchConfig, shape: InputShape, mesh: Mesh) -> ShapeDtypeStruct:
    b = shape.global_batch
    dp = shardlib.batch_sharding(mesh, b)
    dp_spec = dp if len(dp) != 1 else (dp[0] if dp else None)
    return sds((b, 1), torch.int32, mesh, P(dp_spec, None))
