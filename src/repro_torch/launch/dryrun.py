"""Dry run: every (architecture x input shape) on a production mesh,
with no device allocation.

The counterpart of ``src/repro/launch/dryrun.py``.  ``lower_pair``
builds the step for a pair and its abstract inputs (``launch/specs``);
``lowered.compile()`` runs the step once on fake tensors — as DTensors
on the mesh's ``DeviceMesh`` (the ``fake`` process-group backend, this
process as rank 0) when the mesh has more than one device — and counts:

  * FLOPs, with ``torch.utils.flop_counter``'s formulas;
  * bytes accessed: each aten operation's tensor inputs and outputs,
    views excluded.  This is an unfused upper bound: XLA's
    ``cost_analysis`` counts after fusion, so its bytes read lower;
  * memory: the arguments' bytes, the outputs', and the peak of the
    bytes the step itself holds live (from the fake storages);
  * collectives: each one's output bytes, by kind (``CommDebugMode``
    counts them too).

FLOPs and bytes are **per device**, as XLA's are for a partitioned
program: what rank 0 executes on its shards, redundant work on
replicated dims included (DTensor's sharding propagation, which runs
operations at the global shape, is not counted).  The port also counts
every iteration of a Python loop (chunked attention's chunk pairs, the
layer stack), where XLA's cost model counts a loop's body once: the
port's FLOPs read 1.4-1.7x XLA's at the smoke shape.

On a sharded mesh the step runs the plan a sharded program runs, not
DTensor's replicated defaults (``_FsdpModel``, ``_substituted``):

  * train: parameters all-gathered over the FSDP axes layer by layer;
    attention on each device's query heads and the kv heads they read;
    the head and the cross-entropy on each device's vocabulary shard; MoE
    experts where they are held, each device filling buffers for its
    experts from its data shard's tokens;
  * prefill: the same gathers, in the model's dtype, and every product
    on the model-axis shard a device holds (``_SplitWeight``): column
    then row parallel, a Mamba block on each device's heads;
  * decode: no parameter moves.  Each product contracts on the shards a
    device holds and sums its partial activations over the axes that
    split the contraction (``_split_product``), the embedding is a
    masked local lookup, the logits stay split over the vocabulary, the
    experts run with their d_model slices, the caches are written on
    their shards, and at a batch of one the idle data axis splits the
    key positions.

The record names each route.

For each pair this prints and records what the reference does
(``compiled.memory_analysis()``, ``compiled.cost_analysis()`` and the
collective bytes parsed from ``compiled.as_text()``, which writes one
HLO-like line per collective), and the three collectives (kind, dtype,
per-device shape) that move the most bytes.  The port's steps run out
of place, so nothing aliases: ``donate`` is accepted, never modelled.
The fake process group has no all-to-all: DTensor sends one as an
all-gather and a chunk, which is counted as the all-to-all it stands for.
XLA's HLO text lists a scanned layer stack's loop body once, so the
reference's collective bytes count one layer of each stack; each record
also gives the port's with each stack's unit counted once.

Usage:
  python -m repro_torch.launch.dryrun --arch mistral-large-123b --shape train_4k
  python -m repro_torch.launch.dryrun --multi-pod --out results.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, build_model, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import specs as speclib
from repro_torch.launch.mesh import Mesh, make_production_mesh, use_mesh_compat
from repro_torch.launch.sharding import P, NamedSharding, ShapeDtypeStruct
from repro_torch.optim import get_optimizer
from repro_torch.train.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.tree import tree_flatten_with_path, tree_map, tree_unflatten

# --- HLO collective-bytes accounting -------------------------------------------------
_COLLECTIVE_RE = re.compile(
    r"(\w[\w.\-]*)\s*=\s*(\(?[^=]*?\)?)\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(", re.M,
)
_SHAPE_RE = re.compile(r"(bf16|f32|f16|f64|s32|u32|s8|u8|pred|s64|u64)"
                       r"\[([\d,]*)\]")
_DTYPE_BYTES = {
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8, "s32": 4, "u32": 4,
    "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8,
}
# torch dtypes and collectives under their HLO names
_HLO_DTYPES = {
    torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
    torch.float64: "f64", torch.int32: "s32", torch.uint32: "u32", torch.int8: "s8",
    torch.uint8: "u8", torch.bool: "pred", torch.int64: "s64", torch.uint64: "u64",
}
_HLO_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-broadcast",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def cost_analysis_dict(compiled) -> Dict[str, Any]:
    """compiled.cost_analysis() as a flat dict (a one-element list of
    dicts is unwrapped, as some JAX versions return)."""
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    return cost or {}


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Sum output-shape bytes of every collective op in the HLO."""
    out: Dict[str, float] = {}
    for m in _COLLECTIVE_RE.finditer(hlo_text):
        shapes_str, kind, suffix = m.group(2), m.group(3), m.group(4)
        if suffix == "-done":
            continue  # counted at -start
        total = 0
        for sm in _SHAPE_RE.finditer(shapes_str):
            dt, dims = sm.group(1), sm.group(2)
            n = 1
            if dims:
                for d in dims.split(","):
                    if d:
                        n *= int(d)
            total += n * _DTYPE_BYTES[dt]
        out[kind] = out.get(kind, 0) + total
    return out


# --- counting -------------------------------------------------------------------------
def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    from torch.utils._pytree import tree_leaves as leaves

    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


class _Counter(TorchDispatchMode):
    """Counts the aten operations that reach it on plain (fake) tensors:
    FLOPs, bytes, collectives, and the live bytes of storages the step
    allocates.  Operations on DTensors pass through (DTensor then
    dispatches their local operations here)."""

    def __init__(self, fake_mode, argument_storages: set):
        super().__init__()
        self.fake_mode = fake_mode
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[Tuple[str, torch.dtype, Tuple[int, ...]], int] = {}
        self.paused = 0
        self.times = 1
        self.args = argument_storages
        self.refs: Dict[int, int] = {}
        self.sizes: Dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self.largest = 0

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count what runs in the block ``n`` times (a loop whose
        iterations are identical in shape, run once)."""
        self.times *= n
        try:
            yield
        finally:
            self.times //= n

    def count_collective(self, kind: str, out) -> None:
        """A collective of ``kind`` whose per-device output is ``out``."""
        for t in _tensors(out):
            key = (kind, t.dtype, tuple(t.shape))
            self.collectives[key] = self.collectives.get(key, 0) + self.times

    def _release(self, key: int) -> None:
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= self.sizes.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.args:
            return
        if key not in self.refs:
            self.refs[key] = 0
            self.sizes[key] = storage.nbytes()
            self.live += self.sizes[key]
            self.peak = max(self.peak, self.live)
            self.largest = max(self.largest, self.sizes[key])
        self.refs[key] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused or not any(getattr(t, "fake_mode", None) is self.fake_mode
                                  for t in _tensors((args, kwargs, out))):
            return out
        namespace = func.namespace
        if namespace in _COLLECTIVE_NAMESPACES:
            kind = _HLO_COLLECTIVES.get(func.overloadpacket.__name__)
            if kind is not None:
                self.count_collective(kind, out)
        elif not _is_view(func):
            ins, outs = _tensors((args, kwargs)), _tensors(out)
            self.bytes += self.times * (sum(_nbytes(t) for t in ins)
                                        + sum(_nbytes(t) for t in outs))
            count = self.flop_registry.get(func.overloadpacket)
            if count is not None:
                self.flops += self.times * count(*args, **kwargs, out_val=out)
        for t in _tensors(out):
            self._track(t)
        return out


_ALLOCATIONS = ("empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided")


def _is_view(func) -> bool:
    """An operation that moves no bytes: a view (every output aliases an
    input, none written) or a bare allocation."""
    if func.namespace == "prim" or func.overloadpacket.__name__ in _ALLOCATIONS:
        return True
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write for r in returns)


def _patched(owner, name: str, wrap):
    """``owner.name`` replaced by ``wrap(original)``, or None where this
    torch has no such attribute."""
    original = getattr(owner, name, None)
    if original is None:
        return None
    setattr(owner, name, wrap(original))
    return original


@contextlib.contextmanager
def _dtensor_bookkeeping_uncounted(counter: "_Counter"):
    """Keep DTensor's own bookkeeping out of the count and out of the
    fake mode: its sharding propagation runs each new operation once at
    the global shape to learn the output's metadata, or its
    decomposition, to learn a strategy (both paused), and a
    strided shard's size and offsets come from small index tensors
    (paused, and computed outside the fake mode, where ``.tolist()``
    works).  A CPU mesh has no all-to-all: DTensor moves a shard from one
    dim to another as an all-gather of the whole and a chunk, which is
    counted as the all-to-all it stands for (its output, the new shard)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import _decompositions, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def paused(fn, unfake=False):
        def run(*args, **kwargs):
            counter.paused += 1
            try:
                with unset_fake_temporarily() if unfake else contextlib.nullcontext():
                    return fn(*args, **kwargs)
            finally:
                counter.paused -= 1
        return run

    if not hasattr(ShardingPropagator, "_propagate_tensor_meta_non_cached"):
        raise RuntimeError("this torch's DTensor has no ShardingPropagator."
                           "_propagate_tensor_meta_non_cached: the dry run cannot tell "
                           "its metadata runs from the step's")

    def all_to_all(fn):
        def run(input, gather_dim, shard_dim, mesh, mesh_dim):
            out = paused(fn)(input, gather_dim, shard_dim, mesh, mesh_dim)
            if not counter.paused:
                counter.count_collective("all-to-all", out)
                for t in _tensors(out):
                    counter._track(t)
            return out
        return run

    targets = [(ShardingPropagator, "_propagate_tensor_meta_non_cached", paused),
               (getattr(_decompositions, "DecompShardingStrategy", None),
                "propagate_strategy", paused),
               (getattr(placement_types, "_StridedShard", None), "local_shard_size_and_offset",
                lambda fn: paused(fn, unfake=True)),
               (placement_types, "shard_dim_alltoall", all_to_all)]
    originals = [(owner, name, _patched(owner, name, wrap)) for owner, name, wrap in targets]
    try:
        yield
    finally:
        for owner, name, original in originals:
            if original is not None:
                setattr(owner, name, original)


def _runs(counter: _Counter, n: int):
    """Two iterations of an n-long loop, the first counted n - 1 times:
    the second then meets the first's leftovers live, as every later
    iteration of the loop does."""
    for i in range(min(n, 2)):
        with counter.repeat(n - 1 if i == 0 and n > 1 else 1):
            yield i


def _counted_chunked_attention(counter: _Counter):
    """``models.layers.chunked_attention`` for a step without autograd,
    each chunk loop run twice and counted as its nq (nk) iterations:
    every iteration has the same shapes, only the mask's values differ.
    The q chunks' outputs stay live together, as the loop keeps them.
    (With autograd, the backward pass would run two iterations'
    gradients; train steps run the loops whole.)"""

    def chunked_attention(q, k, v, q_per_kv, causal=True, window=None,
                          logit_soft_cap=None, q_chunk=512, k_chunk=512):
        b, s, h, hd = q.shape
        g = k.shape[2]
        q_chunk = math.gcd(s, min(q_chunk, s))
        k_chunk = math.gcd(s, min(k_chunk, s))
        nq, nk = s // q_chunk, s // k_chunk
        scale = 1.0 / math.sqrt(hd)
        qh = q.reshape(b, s, g, q_per_kv, hd).permute(0, 2, 3, 1, 4).float()
        kh = k.permute(0, 2, 1, 3).float()
        vh = v.permute(0, 2, 1, 3).float()
        outs = []
        for qi in _runs(counter, nq):
            if qi == 1:     # the chunks between the first and the last
                outs += [torch.empty_like(outs[0]) for _ in range(nq - 2)]
            qblk = qh[:, :, :, qi * q_chunk:(qi + 1) * q_chunk]
            q_pos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
            m = torch.full((b, g, q_per_kv, q_chunk, 1), -math.inf, device=q.device)
            l = torch.zeros((b, g, q_per_kv, q_chunk, 1), device=q.device)
            acc = torch.zeros((b, g, q_per_kv, q_chunk, hd), device=q.device)
            for ki in _runs(counter, nk):
                kblk = kh[:, :, ki * k_chunk:(ki + 1) * k_chunk]
                vblk = vh[:, :, ki * k_chunk:(ki + 1) * k_chunk]
                s_ = torch.einsum("bgpqh,bgkh->bgpqk", qblk, kblk) * scale
                if logit_soft_cap is not None:
                    s_ = logit_soft_cap * torch.tanh(s_ / logit_soft_cap)
                k_pos = ki * k_chunk + torch.arange(k_chunk, device=q.device)
                diff = q_pos[:, None] - k_pos[None, :]
                mask = torch.ones((q_chunk, k_chunk), dtype=torch.bool, device=q.device)
                if causal:
                    mask &= diff >= 0
                if window is not None:
                    mask &= diff < window
                s_ = s_.masked_fill(~mask, -math.inf)
                m_cur = torch.amax(s_, dim=-1, keepdim=True)
                m_new = torch.maximum(m, m_cur)
                m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
                p = torch.exp(s_ - m_safe)
                p = torch.where(torch.isfinite(s_), p, torch.zeros_like(p))
                corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                   torch.zeros_like(m))
                l = corr * l + torch.sum(p, dim=-1, keepdim=True)
                acc = acc * corr + torch.einsum("bgpqk,bgkh->bgpqh", p, vblk)
                m = m_new
            outs.append(acc / torch.clamp(l, min=1e-30))
        out = torch.cat(outs, dim=3)
        out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)
        return out.to(q.dtype)

    return chunked_attention


# --- per-device regions -----------------------------------------------------------------
# Where DTensor's own plan for an operation replicates work or memory that a
# sharded program keeps on its shards, the dry run runs that operation on each
# device's local shards instead (``to_local``, plain operations, ``from_local``)
# and writes the collectives it needs itself: attention on the device's query
# heads and the kv heads they read, the cross-entropy on the logits' vocab
# shard, and the MoE experts on the devices that hold them.  The local regions
# never ask DTensor to flatten a batch and a head dim both sharded, which some
# torch versions refuse.  The values are never computed (fake tensors), so the
# regions are held to the plain functions by their shapes and placements.
def _mesh_dims(t) -> Tuple[List[str], Optional[int]]:
    """The mesh's dim names and the index of its "model" dim (or None)."""
    names = list(t.device_mesh.mesh_dim_names)
    return names, (names.index("model") if "model" in names else None)


def _model_size_and_rank(t) -> Tuple[int, int]:
    _, mi = _mesh_dims(t)
    if mi is None:
        return 1, 0
    return t.device_mesh.size(mi), t.device_mesh.get_local_rank(mi)


def _batch_placements(t, model) -> list:
    """``t``'s placements with a Shard of dim 0 kept on every mesh dim but
    "model", Replicate elsewhere, and ``model`` on the model dim."""
    from torch.distributed.tensor import Replicate, Shard

    names, mi = _mesh_dims(t)
    out = [p if isinstance(p, Shard) and p.dim == 0 and i != mi else Replicate()
           for i, p in enumerate(t.placements)]
    if mi is not None:
        out[mi] = model
    return out


def _to_local(t, placements, grad_placements=None) -> torch.Tensor:
    """``t`` laid out as ``placements`` (a redistribution where it is not),
    as its local shard; its gradient comes back as ``grad_placements``."""
    if list(t.placements) != list(placements):
        t = t.redistribute(t.device_mesh, placements)
    return t.to_local(grad_placements=grad_placements or placements)


def _from_local(local: torch.Tensor, mesh, placements, shape):
    """A DTensor of global ``shape`` from even local shards (their
    strides kept)."""
    from torch.distributed.tensor import DTensor

    out = DTensor.from_local(local, mesh, placements, run_check=False)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"local {tuple(local.shape)} as {placements} is "
                         f"{tuple(out.shape)}, not {tuple(shape)}")
    return out


def _local_rows(x, like, placements) -> torch.Tensor:
    """The local shard of ``x`` laid out as ``placements`` on ``like``'s
    mesh: a DTensor redistributed, a plain (replicated) tensor split
    without moving a byte."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return _to_local(x, placements)
    whole = _from_local(x, like.device_mesh, [Replicate()] * len(placements), x.shape)
    return whole.redistribute(like.device_mesh, placements).to_local()


def _reduce_over_model(local: torch.Tensor, like, op: str = "sum") -> torch.Tensor:
    """``local``'s sum (or max) over the model dim of ``like``'s mesh,
    an all-reduce; ``local`` is laid out as ``like``'s batch."""
    from torch.distributed.tensor import Partial, Replicate

    names, mi = _mesh_dims(like)
    if mi is None or like.device_mesh.size(mi) == 1:
        return local
    partial = _batch_placements(like, Partial(op))
    whole = _from_local(local, like.device_mesh, partial, _global_shape(local, like, partial))
    return _to_local(whole, _batch_placements(like, Replicate()))


def _reduce_over(local: torch.Tensor, mesh, dims: List[int], op: str = "sum") -> torch.Tensor:
    """``local``'s sum (or max) over the mesh dims ``dims``, an
    all-reduce on each (``local`` is whole over them)."""
    from torch.distributed.tensor import Partial, Replicate

    pl = [Partial(op) if i in dims else Replicate() for i in range(mesh.ndim)]
    return _to_local(_from_local(local, mesh, pl, local.shape), [Replicate()] * mesh.ndim)


def _global_shape(local: torch.Tensor, like, placements) -> Tuple[int, ...]:
    from torch.distributed.tensor import Shard

    shape = list(local.shape)
    for p, n in zip(placements, like.device_mesh.shape):
        if isinstance(p, Shard):
            shape[p.dim] *= n
    return tuple(shape)


def regroups(num_heads: int, num_kv: int, model: int) -> bool:
    """Whether attention runs on each device's query heads on a model
    axis of ``model`` devices: the heads split evenly over it, and each
    device's heads fill whole kv groups or lie inside one."""
    if num_heads % model:
        return False
    local, per = num_heads // model, num_heads // num_kv
    return local % per == 0 or per % local == 0


def _regrouped_locals(q, k, v):
    """q, k, v as each device's local query heads and the kv heads they
    read, where ``regroups`` (else whole over the model dim): (q, k, v,
    query heads per kv head, q's placements).  The kv heads split over
    the model dim too where they divide by it, else each device slices
    its groups from them whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    m, rank = _model_size_and_rank(q)
    _, mi = _mesh_dims(q)
    h, g = q.shape[2], k.shape[2]
    split = regroups(h, g, m)
    q_pl = _batch_placements(q, Shard(2) if split else Replicate())
    kv_pl = _batch_placements(q, Shard(2) if split and g % m == 0 else Replicate())
    # a kv head read by several devices' queries takes their gradients' sum
    kv_grad = list(kv_pl)
    if mi is not None and not isinstance(kv_pl[mi], Shard):
        kv_grad[mi] = Partial()
    ql = _to_local(q, q_pl)
    kl, vl = (_to_local(t, kv_pl, kv_grad) if isinstance(t, DTensor) else _local_rows(t, q, kv_pl)
              for t in (k, v))
    per = h // g
    if split and g % m:
        local = h // m
        lo, n = rank * local // per, max(1, local // per)
        kl, vl, per = kl[:, :, lo:lo + n], vl[:, :, lo:lo + n], local // n
    return ql, kl, vl, per, q_pl


def _regrouped_chunked(fn):
    """``chunked_attention`` on each device's query heads (``fn`` on
    plain tensors)."""
    from torch.distributed.tensor import DTensor

    def chunked_attention(q, k, v, q_per_kv, *args, **kwargs):
        if not isinstance(q, DTensor):
            return fn(q, k, v, q_per_kv, *args, **kwargs)
        ql, kl, vl, per, q_pl = _regrouped_locals(q, k, v)
        out = fn(ql, kl, vl, per, *args, **kwargs)
        return _from_local(out, q.device_mesh, q_pl, q.shape)

    return chunked_attention


def _regrouped_scores(fn):
    """``attention_scores`` on each device's shards: on its query heads
    and the kv heads they read, or, where the kv cache splits its head
    dim over the model dim (``cache_specs``), on its slice of every head
    dim, the logits summed over the model dim before the softmax."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def attention_scores(q, k, v, mask, q_per_kv, logit_soft_cap=None):
        if not isinstance(q, DTensor):
            return fn(q, k, v, mask, q_per_kv, logit_soft_cap)
        _, mi = _mesh_dims(q)
        hd_split = (mi is not None and isinstance(k, DTensor)
                    and isinstance(k.placements[mi], Shard) and k.placements[mi].dim == 3)
        if not hd_split:
            ql, kl, vl, per, q_pl = _regrouped_locals(q, k, v)
            ml = _local_rows(mask, q, _batch_placements(q, Replicate()))
            out = fn(ql, kl, vl, ml, per, logit_soft_cap)
            return _from_local(out, q.device_mesh, q_pl, q.shape)
        pl = _batch_placements(q, Shard(3))
        # mesh dims that split neither the batch nor the cache (a batch of
        # one): each device there takes a slice of the key positions
        mesh = q.device_mesh
        idle = [i for i, (pq, pk) in enumerate(zip(q.placements, k.placements))
                if i != mi and pq == Replicate() and pk == Replicate()]
        if k.shape[1] % math.prod(mesh.size(i) for i in idle):
            idle = []
        kv_pl = [Shard(1) if i in idle else p for i, p in enumerate(pl)]
        mask_pl = [Shard(2) if i in idle else p
                   for i, p in enumerate(_batch_placements(q, Replicate()))]
        ql, kl, vl = _to_local(q, pl), _to_local(k, kv_pl), _to_local(v, kv_pl)
        ml = _local_rows(mask, q, mask_pl)
        b, sq, h, hd = ql.shape
        g = kl.shape[2]
        partial = torch.einsum("bqgph,bkgh->bgpqk", ql.reshape(b, sq, g, h // g, hd), kl)
        logits = _reduce_over_model(partial, q) / math.sqrt(q.shape[-1])
        if logit_soft_cap is not None:
            logits = logit_soft_cap * torch.tanh(logits / logit_soft_cap)
        logits = logits.masked_fill(~ml[:, None, None], torch.finfo(logits.dtype).min)
        if idle:        # the softmax over key positions split over the idle dims
            x = logits.float()
            top = _reduce_over(x.amax(dim=-1, keepdim=True), mesh, idle, "max")
            e = torch.exp(x - top)
            probs = (e / _reduce_over(e.sum(dim=-1, keepdim=True), mesh, idle)).to(q.dtype)
            out = _reduce_over(torch.einsum("bgpqk,bkgh->bqgph", probs, vl), mesh, idle)
        else:
            probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
            out = torch.einsum("bgpqk,bkgh->bqgph", probs, vl)
        # left split on the head dim: the output projection contracts heads
        # and head dim together, on whichever split it takes
        return _from_local(out.reshape(b, sq, h, hd), q.device_mesh, pl, q.shape)

    return attention_scores


def _loss_parallel(fn):
    """``lm_loss`` on the logits' local shards (batch over the data dims,
    vocabulary over the model dim): each device's max and sum of
    exponentials over its vocabulary slice, and its targets' logits where
    its slice holds them, summed over the model dim; the mean over the
    batch dims.  No device holds more than its shard or its gradient."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def lm_loss(logits, tokens, num_prefix: int = 0):
        if not isinstance(logits, DTensor):
            return fn(logits, tokens, num_prefix)
        if num_prefix:
            logits = logits[:, num_prefix:]
        m, rank = _model_size_and_rank(logits)
        vocab = logits.shape[-1]
        split = vocab % m == 0
        pl = _batch_placements(logits, Shard(2) if split else Replicate())
        x = _to_local(logits[:, :-1], pl).float()
        tgt = _local_rows(tokens, logits, _batch_placements(logits, Replicate()))
        tgt = tgt[:, 1:].long()
        with torch.no_grad():
            top = x.amax(dim=-1, keepdim=True)
            if split:
                top = _reduce_over_model(top, logits, "max")
        sumexp = torch.exp(x - top).sum(dim=-1)
        lo, width = (rank * (vocab // m), vocab // m) if split else (0, vocab)
        held = (tgt >= lo) & (tgt < lo + width)
        picked = torch.gather(x, -1, torch.clamp(tgt - lo, 0, width - 1)[..., None])[..., 0]
        picked = torch.where(held, picked, torch.zeros_like(picked))
        if split:
            sumexp = _reduce_over_model(sumexp, logits)
            picked = _reduce_over_model(picked, logits)
        nll = (torch.log(sumexp) + top[..., 0] - picked).sum() / (logits.shape[0] * x.shape[1])
        over_batch = [Partial() if isinstance(p, Shard) else Replicate()
                      for p in _batch_placements(logits, Replicate())]
        loss = _from_local(nll, logits.device_mesh, over_batch, ())
        return loss.redistribute(logits.device_mesh, [Replicate()] * len(over_batch))

    return lm_loss


def _expert_parallel(fn):
    """``apply_moe`` with each device's experts on that device: every
    device routes its data shard's tokens (the capacity is the shard's,
    as GShard's groups take it), fills buffers (E / model, cap, d) for the
    experts it holds, runs them and combines their outputs, and runs its
    slice of the shared expert's hidden units; the output is the sum over
    the model dim.  Where the experts do not split over the model dim,
    every device runs them all."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models import moe

    def apply_moe(params, x, cfg, activation: str = "silu"):
        if not isinstance(x, DTensor):
            return fn(params, x, cfg, activation)
        act = torch.nn.functional.silu if activation == "silu" else moe._gelu_tanh
        m, rank = _model_size_and_rank(x)
        names, mi = _mesh_dims(x)
        if any(isinstance(p, Shard) for i, p in enumerate(_unwrapped(params["w_gate"]).placements)
               if i != mi):
            return _expert_parallel_decode(params, x, cfg, act)    # d_model still split
        n = len(names)
        E = cfg.num_experts
        split = E % m == 0 and m > 1          # the output is a sum over the model dim
        held, lo = (E // m, rank * (E // m)) if split else (E, 0)
        x_pl = _batch_placements(x, Replicate())
        batch = [i for i, p in enumerate(x_pl) if isinstance(p, Shard)]

        def weights(t, model, model_grad=None):
            """``t`` whole over the data dims, ``model`` on the model dim; its
            gradient the data shards' sum."""
            pl = [Replicate()] * n
            grad = [Partial() if i in batch else Replicate() for i in range(n)]
            if mi is not None:
                pl[mi], grad[mi] = model, model_grad or model
            return _to_local(_unwrapped(t), pl, grad)

        x_grad = list(x_pl)
        if split:
            x_grad[mi] = Partial()
        xl = _to_local(x, x_pl, x_grad)
        b, s, d = xl.shape
        xt = xl.reshape(b * s, d)
        router = weights(params["router"], Replicate(), Partial())
        gate_vals, flats, valids, aux, cap = moe.route({"router": router}, xt, cfg)
        if split:
            valids = [valid & (flat >= lo * cap) & (flat < (lo + held) * cap)
                      for flat, valid in zip(flats, valids)]
            flats = [torch.clamp(flat - lo * cap, 0, held * cap - 1) for flat in flats]
        wg, wu, wd = (weights(params[k], Shard(0) if split else Replicate())
                      for k in ("w_gate", "w_up", "w_down"))
        ex_in = moe.dispatch(xt, flats, valids, held, cap)
        gate = act(torch.bmm(ex_in, wg.to(xt.dtype)))
        up = torch.bmm(ex_in, wu.to(xt.dtype))
        ex_out = torch.bmm(gate * up, wd.to(xt.dtype)).reshape(held * cap, d)
        out = moe.combine(ex_out, gate_vals, flats, valids)
        if "shared" in params:
            sh = params["shared"]
            # the shared expert's hidden units split over the model dim with
            # the experts; where they cannot, the whole of it on model rank 0
            hidden = split and sh["w_gate"].shape[1] % m == 0
            col, row = (Shard(1), Shard(0)) if hidden else (Replicate(), Replicate())
            g = act(xt @ weights(sh["w_gate"], col).to(xt.dtype))
            u = xt @ weights(sh["w_up"], col).to(xt.dtype)
            y = (g * u) @ weights(sh["w_down"], row, Partial() if split else None).to(xt.dtype)
            out = out + (y if hidden or not split or rank == 0 else torch.zeros_like(y))
        out_pl = list(x_pl)
        if split:
            out_pl[mi] = Partial()
        out = _from_local(out.reshape(b, s, d), x.device_mesh, out_pl, x.shape)
        if not torch.is_grad_enabled():     # summed once here, not once per reader
            out = out.redistribute(x.device_mesh, x_pl)
        shards = math.prod(x.device_mesh.size(i) for i in batch)
        aux_pl = [Partial() if i in batch else Replicate() for i in range(n)]
        aux = _from_local(aux / shards, x.device_mesh, aux_pl, ())
        return out, aux.redistribute(x.device_mesh, [Replicate()] * n)

    return apply_moe


def _vocab_parallel_head(fn):
    """``Transformer._lm_head`` taking the residual stream whole over
    the model dim (its batch split as it comes), so that the product
    with the head's vocabulary shard leaves each device its logits'
    vocabulary shard, as the loss-parallel cross-entropy reads them."""
    from torch.distributed.tensor import DTensor, Replicate

    def _lm_head(self, params, x):
        if isinstance(x, DTensor):
            x = x.redistribute(x.device_mesh, _batch_placements(x, Replicate()))
        return fn(self, params, x)

    return _lm_head


def _per_head_mamba(fn, ssd_chunked):
    """``apply_mamba_block``'s full-sequence pass on each device's heads
    (they divide over the model dim, as ``in_proj``'s ``("F", "T")``
    splits them): the device takes ``in_proj``'s columns of its heads' z,
    x and dt and every column of B and C (the weight gathered whole over
    the model dim, in the activations' dtype), runs the conv on its
    channels and ``ssd_chunked`` on its heads, so the (P, N) state stays
    on it, as attention runs on its query heads; the output norm's mean
    square and ``out_proj``'s partial sums (its rows are the heads') are
    summed over the model dim.  ``fn`` runs a decode step."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models import mamba2, nn

    def apply_mamba_block(params, x, cfg, cache=None, ssd_impl="xla"):
        d_inner, heads, g, n, _ = mamba2._dims(cfg)
        if cache is not None or not isinstance(x, DTensor):
            return fn(params, x, cfg, cache, ssd_impl)
        m, _ = _model_size_and_rank(x)
        _, mi = _mesh_dims(x)
        if mi is None or heads % m:
            return fn(params, x, cfg, cache, ssd_impl)
        mesh = x.device_mesh

        def whole(t):
            return _to_local(t, [Replicate()] * mesh.ndim) if isinstance(t, DTensor) else t

        def mine(t, dim):
            """The device's part of ``t`` (whole on it) along ``dim``: its heads'."""
            pl = [Replicate()] * mesh.ndim
            pl[mi] = Shard(dim)
            return _local_rows(t, x, pl)

        p_ = cfg.ssm.head_dim
        e = heads // m * p_                        # the device's inner channels
        xl = _to_local(x, _batch_placements(x, Replicate()))
        b, s, _ = xl.shape
        h = nn.apply_rmsnorm({"scale": whole(params["norm"]["scale"])}, xl)
        w_in = whole(_unwrapped(params["in_proj"]).to(xl.dtype))
        dt_at = 2 * d_inner + 2 * g * n
        z, xin, bc, dt = torch.split(h @ torch.cat(
            [mine(w_in[:, :d_inner], 1), mine(w_in[:, d_inner:2 * d_inner], 1),
             w_in[:, 2 * d_inner:dt_at], mine(w_in[:, dt_at:], 1)], dim=1),
            [e, e, 2 * g * n, heads // m], dim=-1)
        conv_w, conv_b = whole(params["conv_w"]), whole(params["conv_b"])
        conv_out, _ = mamba2._causal_conv(
            torch.cat([xin, bc], dim=-1),
            torch.cat([mine(conv_w[:, :d_inner], 1), conv_w[:, d_inner:]], dim=1),
            torch.cat([mine(conv_b[:d_inner], 0), conv_b[d_inner:]]))
        conv_out = torch.nn.functional.silu(conv_out)
        xh = conv_out[..., :e].reshape(b, s, heads // m, p_)
        bm = conv_out[..., e:e + g * n].reshape(b, s, g, n)
        cm = conv_out[..., e + g * n:].reshape(b, s, g, n)
        dt = torch.nn.functional.softplus(dt.float() + mine(whole(params["dt_bias"]), 0))
        a = -torch.exp(mine(whole(params["A_log"]), 0))
        y, _ = ssd_chunked(xh, dt, a, bm, cm, chunk=min(cfg.ssm.chunk_size, s))
        y = y + mine(whole(params["D"]), 0)[None, None, :, None].to(y.dtype) * xh
        y = y.reshape(b, s, e) * torch.nn.functional.silu(z)
        y32 = y.float()
        square = _reduce_over_model(torch.sum(torch.square(y32), dim=-1, keepdim=True), x)
        scale = mine(whole(params["out_norm"]["scale"]), 0)
        y = (y32 * torch.rsqrt(square / d_inner + 1e-6) * scale).to(y.dtype)
        rows = [Replicate()] * mesh.ndim
        rows[mi] = Shard(0)
        out = xl + _reduce_over_model(
            y @ _to_local(_unwrapped(params["out_proj"]), rows).to(y.dtype), x)
        return _from_local(out, mesh, _batch_placements(x, Replicate()), x.shape), None

    return apply_mamba_block


def _per_head_ssd(fn):
    """``ssd_chunked`` on each device's heads, for a train step (under
    autograd; a prefill runs the whole block per head, ``_per_head_mamba``):
    x, dt and A on the device's heads, B and C whole over the model dim
    (their gradients the heads' partial sums), the (P, N) state of each
    head on the device that holds it.  No collective runs inside the scan,
    and DTensor never flattens the batch and the heads both sharded (which
    torch 2.11 refuses)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def ssd_chunked(x, dt, A, Bm, Cm, chunk=128, initial_state=None):
        if not isinstance(x, DTensor):
            return fn(x, dt, A, Bm, Cm, chunk, initial_state)
        m, _ = _model_size_and_rank(x)
        _, mi = _mesh_dims(x)
        if mi is None or x.shape[2] % m:
            return fn(x, dt, A, Bm, Cm, chunk, initial_state)
        heads = _batch_placements(x, Shard(2))
        whole = _batch_placements(x, Replicate())
        whole_grad = _batch_placements(x, Partial())
        a_pl = [Shard(0) if i == mi else Replicate() for i in range(len(heads))]
        a_grad = [Shard(0) if i == mi else Partial() if isinstance(p, Shard) else Replicate()
                  for i, p in enumerate(whole)]

        def local(t, pl, grad):
            return _to_local(t, pl, grad) if isinstance(t, DTensor) else _local_rows(t, x, pl)

        state_pl = _batch_placements(x, Shard(1))
        init = None if initial_state is None else local(initial_state, state_pl, state_pl)
        y, state = fn(local(x, heads, heads), local(dt, heads, heads), local(A, a_pl, a_grad),
                      local(Bm, whole, whole_grad), local(Cm, whole, whole_grad), chunk, init)
        b, _, h, p_ = x.shape
        return (_from_local(y, x.device_mesh, heads, x.shape),
                _from_local(state, x.device_mesh, state_pl, (b, h, p_, Bm.shape[3])))

    return ssd_chunked


# --- decode with the weights where params_specs puts them -----------------------------
# A decode step reads every weight once for a few tokens, so no weight moves:
# each product contracts on the shards a device holds and sums its partial
# activations over the mesh dims that split the contraction (``_split_product``),
# the embedding looks up the rows a device holds and sums them, and the head's
# logits stay split over the vocabulary.  A step without autograd hands the
# layers ``_SplitWeight``s in place of the FSDP-sharded parameters (a prefill's
# gathered over the data axes first); the model's own products (``x @ w``,
# ``torch.einsum``) reach ``_split_product`` through ``__torch_function__``.
def _split_product(equation: str, x, w):
    """``torch.einsum(equation, x, w)`` with ``w`` (a DTensor) where it
    lies.  On each mesh dim: where ``w`` splits a contracted dim, ``x``
    takes the same slice and the product is partial there; where ``w``
    splits one of its output dims, ``x`` is whole there; elsewhere a split
    of ``x`` (its batch) carries through.  The result is laid out as the
    residual stream: ``x``'s batch split kept (a partial sum reduced onto
    it, a reduce-scatter), the model dim's split of an output dim kept
    (column parallel), every other partial sum all-reduced."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    xs, rest = equation.replace(" ", "").split(",")
    ws, out = rest.split("->")
    mesh = w.device_mesh
    if not isinstance(x, DTensor):
        x = _from_local(x, mesh, [Replicate()] * mesh.ndim, x.shape)
    _, mi = _mesh_dims(w)
    x_pl, w_pl, out_pl, target = [], list(w.placements), [], []
    for m, (pw, px) in enumerate(zip(w.placements, x.placements)):
        carried = isinstance(px, Shard) and xs[px.dim] in out and xs[px.dim] not in ws
        if isinstance(pw, Shard) and ws[pw.dim] in out:      # an output dim of w
            x_pl.append(Replicate())
            out_pl.append(Shard(out.index(ws[pw.dim])))
        elif isinstance(pw, Shard):                          # a contracted dim of w
            x_pl.append(Shard(xs.index(ws[pw.dim])))
            out_pl.append(Partial())
        elif carried:
            x_pl.append(px)
            out_pl.append(Shard(out.index(xs[px.dim])))
        elif isinstance(px, Shard) and xs[px.dim] in ws:     # x splits a contracted dim:
            x_pl.append(px)                                  # w, whole there, takes its slice
            w_pl[m] = Shard(ws.index(xs[px.dim]))
            out_pl.append(Partial())
        else:
            x_pl.append(Replicate())
            out_pl.append(Replicate())
        if carried:
            target.append(Shard(out.index(xs[px.dim])))
        elif m == mi and isinstance(out_pl[-1], Shard):
            target.append(out_pl[-1])
        else:
            target.append(Replicate())
    xl = _to_local(x, x_pl)
    local = torch.einsum(equation, xl, _to_local(w, w_pl).to(xl.dtype))
    y = _from_local(local, mesh, out_pl, _global_shape(local, w, out_pl))
    return y if out_pl == target else y.redistribute(mesh, target)


def _split_lookup(table, tokens, dtype=None):
    """``table[tokens]`` with the table where it lies (rows over the model
    dim where they split, features over the FSDP dims): each device looks
    every token up in the rows it holds, zeros where it holds none, and the
    rows are summed over the model dim, laid out as the tokens are.  With
    ``dtype``, the rows of ``table.to(dtype)`` (the same values as the rows
    cast after the lookup)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    # every token over the mesh dims that split the table, the tokens'
    # own split elsewhere
    tok_pl = [Replicate() if isinstance(p, Shard) else q
              for p, q in zip(table.placements, tokens.placements)] \
        if isinstance(tokens, DTensor) else [Replicate()] * mesh.ndim
    ids = _to_local(tokens, tok_pl) if isinstance(tokens, DTensor) else tokens
    tl = table.to_local() if dtype is None else table.to_local().to(dtype)
    rows = tl.shape[0]
    pl = [Partial() if p == Shard(0) else Shard(ids.ndim) if isinstance(p, Shard) else q
          for p, q in zip(table.placements, tok_pl)]
    # the first row the device holds, as a tensor
    lo = _local_rows(torch.arange(table.shape[0]), table,
                     [Shard(0) if p == Shard(0) else Replicate() for p in table.placements])[0]
    held = (ids >= lo) & (ids < lo + rows)
    looked = tl[torch.clamp(ids - lo, 0, rows - 1).long()]
    looked = torch.where(held[..., None], looked, torch.zeros((), dtype=tl.dtype))
    y = _from_local(looked, mesh, pl, tuple(tokens.shape) + tuple(table.shape[1:]))
    target = ([p if isinstance(p, Shard) else Replicate() for p in tokens.placements]
              if isinstance(tokens, DTensor) else [Replicate()] * mesh.ndim)
    return y.redistribute(mesh, target)


def _unwrapped(t):
    return t.t if isinstance(t, _SplitWeight) else t


class _SplitWeight:
    """A parameter left as ``params_specs`` shards it, for a step without
    autograd: its products run as ``_split_product`` (``x @ w``, ``x @
    w.T``, ``torch.einsum(eq, x, w)``), a row lookup (``w[tokens]``) as
    ``_split_lookup``, and ``w[i]`` takes layer i of a stack.  ``.to``
    records the dtype the local shard is cast to inside the product."""

    def __init__(self, t, transposed: bool = False, dtype=None):
        self.t, self.transposed, self._dtype = t, transposed, dtype

    @property
    def shape(self):
        return tuple(self.t.shape)[::-1] if self.transposed else tuple(self.t.shape)

    @property
    def T(self):
        return _SplitWeight(self.t, not self.transposed, self._dtype)

    def to(self, dtype):
        return _SplitWeight(self.t, self.transposed, dtype)

    def __getitem__(self, index):
        if isinstance(index, int):
            return _SplitWeight(self.t[index], self.transposed, self._dtype)
        return _split_lookup(self.t, index, self._dtype)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name == "einsum" and len(args) == 3 and isinstance(args[2], cls):
            equation, x, w = args
        elif name in ("matmul", "__matmul__") and isinstance(args[1], cls):
            x, w = args
            lead = "abcdefgh"[:x.ndim - 1]
            equation = f"{lead}k,{'nk' if w.transposed else 'kn'}->{lead}n"
        else:
            raise TypeError(f"a split weight takes part in products and lookups only, not {name}")
        if w.transposed and name == "einsum":
            raise TypeError("a transposed split weight takes part in x @ w only")
        t = w.t if w._dtype is None else w.t.to(w._dtype)
        return _split_product(equation, x, t)


def _expert_parallel_decode(params, x, cfg, act):
    """``apply_moe`` with each expert's weights where they lie: experts
    split over the model dim, their d_model rows (``w_gate``, ``w_up``) and
    columns (``w_down``) over the FSDP dims.  Every device routes every
    token, as the model does (one capacity for the whole batch), and fills
    buffers for its experts with its d_model slice of the tokens; the gate
    and up products are summed over the FSDP dims, the down product gives
    the device its slice of the output, and the outputs are summed over the
    model dim.  The router and the shared expert are split products."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.models import moe

    mesh = x.device_mesh
    n_dims = mesh.ndim
    _, mi = _mesh_dims(x)
    wg, wu, wd = (params[k].t for k in ("w_gate", "w_up", "w_down"))
    split = mi is not None and wg.placements[mi] == Shard(0)
    held = wg.to_local().shape[0]
    lo = mesh.get_local_rank(mi) * held if split else 0
    b, s, d = x.shape
    n = b * s
    # the router's logits of every token (a split product), then routing as
    # the model routes them: ``route`` takes the logits through an identity
    logits = _to_local(_split_product("bsd,de->bse", x, params["router"].t),
                       [Replicate()] * n_dims).reshape(n, -1)
    eye = torch.eye(cfg.num_experts, dtype=logits.dtype)
    gate_vals, flats, valids, aux, cap = moe.route({"router": eye}, logits, cfg)
    if split:
        valids = [valid & (flat >= lo * cap) & (flat < (lo + held) * cap)
                  for flat, valid in zip(flats, valids)]
        flats = [torch.clamp(flat - lo * cap, 0, held * cap - 1) for flat in flats]
    rows = [Shard(2) if p == Shard(1) else Replicate() for p in wg.placements]   # d_model
    if split:
        rows[mi] = Replicate()
    xl = _to_local(x, rows).reshape(n, -1).to(x.dtype)
    ex_in = moe.dispatch(xl, flats, valids, held, cap)
    # (held, cap, F) partial over the FSDP dims that split d_model
    experts = [Shard(0) if split and i == mi else Replicate() for i in range(n_dims)]
    partial = [Partial() if p == Shard(1) else e for p, e in zip(wg.placements, experts)]

    def summed(local):
        shape = (held * (mesh.size(mi) if split else 1),) + tuple(local.shape[1:])
        return _to_local(_from_local(local, mesh, partial, shape), experts)

    gate = summed(torch.bmm(ex_in, wg.to_local().to(x.dtype)))
    up = summed(torch.bmm(ex_in, wu.to_local().to(x.dtype)))
    ex_out = torch.bmm(act(gate) * up, wd.to_local().to(x.dtype))
    out = moe.combine(ex_out.reshape(held * cap, -1), gate_vals, flats, valids)
    out_pl = [Shard(2) if p == Shard(2) else Replicate() for p in wd.placements]
    if split:
        out_pl[mi] = Partial()
    y = _from_local(out.reshape(b, s, -1), mesh, out_pl, x.shape)
    y = y.redistribute(mesh, _batch_placements(x, Replicate()))
    if "shared" in params:
        sh = params["shared"]
        hidden = act(_split_product("bsd,df->bsf", x, sh["w_gate"].t).to(x.dtype)) * \
            _split_product("bsd,df->bsf", x, sh["w_up"].t).to(x.dtype)
        y = y + _split_product("bsf,fd->bsd", hidden, sh["w_down"].t).to(x.dtype)
    return y, aux


class _LocalCacheWrites(torch.overrides.TorchFunctionMode):
    """A decode cache's write (``cache.index_copy_(dim, rows, new)``) on
    each device's shard of the cache, the new rows laid out as the cache.
    DTensor's own in-place ``index_copy_`` may pick a layout for the cache
    other than the one it has (torch 2.13 then re-labels the cache without
    moving it, as with a replicated batch of one)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        kwargs = kwargs or {}
        if func is torch.Tensor.index_copy_ and isinstance(args[0], DTensor) and not kwargs:
            cache, dim, index, new = args
            if Shard(dim % cache.ndim) not in cache.placements:
                idx = (_to_local(index, [Replicate()] * index.device_mesh.ndim)
                       if isinstance(index, DTensor) else index)
                nl = _local_rows(new, cache, list(cache.placements))
                cache.to_local().index_copy_(dim, idx, nl.to(cache.dtype))
                return cache
        return func(*args, **kwargs)


@contextlib.contextmanager
def _substituted(counter: _Counter, count_loops: bool, sharded: bool, grad: bool):
    """The step's functions that the dry run replaces for the duration of
    one run: chunked attention with its loops counted, not run (without
    autograd), and, on a sharded mesh, the per-device regions above and
    the ``Transformer``'s vocabulary-parallel head.  Without autograd a
    Mamba block's full-sequence pass runs on each device's heads; under
    autograd the SSD scan alone does, the rest of the block on DTensor's
    plan, and a decode cache is written on its shards
    (``_LocalCacheWrites``)."""
    from repro_torch.models import hybrid, layers, mamba2, transformer
    from repro_torch.train import steps

    chunked = _counted_chunked_attention(counter) if count_loops else layers.chunked_attention
    targets = [(layers, "chunked_attention", _regrouped_chunked(chunked) if sharded else chunked)]
    if sharded:
        targets += [(layers, "attention_scores", _regrouped_scores(layers.attention_scores)),
                    (steps, "lm_loss", _loss_parallel(steps.lm_loss)),
                    (transformer, "apply_moe", _expert_parallel(transformer.apply_moe))]
        targets.append((transformer.Transformer, "_lm_head",
                        _vocab_parallel_head(transformer.Transformer._lm_head)))
        if grad:
            targets.append((mamba2, "ssd_chunked", _per_head_ssd(mamba2.ssd_chunked)))
        else:
            mamba = _per_head_mamba(mamba2.apply_mamba_block, mamba2.ssd_chunked)
            targets += [(module, "apply_mamba_block", mamba) for module in (mamba2, hybrid)]
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    for owner, name, new in targets:
        setattr(owner, name, new)
    try:
        with _LocalCacheWrites() if sharded and not grad else contextlib.nullcontext():
            yield
    finally:
        for owner, name, original in originals:
            setattr(owner, name, original)


# --- lowered / compiled ---------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MemoryAnalysis:
    """Per-device bytes, named as XLA's ``memory_analysis()`` names them."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int = 0
    generated_code_size_in_bytes: int = 0


@dataclasses.dataclass
class Compiled:
    """What one run of the step on fake tensors counted (per device)."""

    flops: float
    bytes_accessed: float
    memory: MemoryAnalysis
    collectives: Dict[Tuple[str, torch.dtype, Tuple[int, ...]], int]
    collective_counts: Dict[str, int]
    largest_buffer_bytes: int = 0     # the largest storage the step allocated

    def cost_analysis(self) -> Dict[str, float]:
        return {"flops": float(self.flops), "bytes accessed": float(self.bytes_accessed)}

    def memory_analysis(self) -> MemoryAnalysis:
        return self.memory

    def as_text(self) -> str:
        """One HLO-like line per collective, in the grammar
        ``collective_bytes`` parses: ``%all-gather.3 = bf16[8,128] all-gather(...)``."""
        lines = []
        for (kind, dtype, shape), n in self.collectives.items():
            dims = ",".join(str(d) for d in shape)
            for _ in range(n):
                lines.append(f"  %{kind}.{len(lines)} = {_HLO_DTYPES[dtype]}[{dims}] {kind}(...)")
        return "\n".join(lines)


class Lowered:
    """A step and its abstract inputs on a mesh; ``compile()`` runs it."""

    def __init__(self, fn, args: tuple, mesh: Mesh, fake_mode, grad: bool):
        self.fn, self.args, self.mesh, self.fake_mode = fn, args, mesh, fake_mode
        self.grad = grad
        # without autograd, chunked attention's loops are counted, not run
        self.count_loops = not grad

    def _concrete(self, spec):
        """A plain fake tensor (one device), or a DTensor of local fake
        shards on the mesh.  Without autograd, a replicated input stays a
        plain tensor, which joins DTensor operations as replicated: an
        in-place update of a tensor the model made (a decode mask) with
        one derived from a DTensor input (the cache's index) is one that
        DTensor refuses."""
        if not isinstance(spec, ShapeDtypeStruct):
            return spec
        if self.mesh.size == 1 or spec.sharding is None:
            return spec.value
        from torch.distributed.tensor import Shard

        placements = spec.sharding.placements
        if not self.grad and not any(isinstance(p, Shard) for p in placements):
            return spec.value
        return _sharded_dtensor(self.mesh, self.fake_mode, spec.shape, placements, spec.dtype)

    def compile(self) -> Compiled:
        from torch.distributed.tensor.debug import CommDebugMode

        args = tree_map(self._concrete, self.args)
        arg_locals = [getattr(t, "_local_tensor", t) for t in _tensors(args)]
        counter = _Counter(self.fake_mode, {t.untyped_storage()._cdata for t in arg_locals})
        propagation = (_dtensor_bookkeeping_uncounted(counter) if self.mesh.size > 1
                       else contextlib.nullcontext())
        regions = _substituted(counter, self.count_loops, self.mesh.size > 1, self.grad)
        with propagation, regions, self.fake_mode, CommDebugMode() as comm, counter, \
                use_mesh_compat(self.mesh):
            out = self.fn(*args)
        out_locals = [getattr(t, "_local_tensor", t) for t in _tensors(out)]
        out_bytes = sum(_nbytes(t) for t in out_locals)
        memory = MemoryAnalysis(
            argument_size_in_bytes=sum(_nbytes(t) for t in arg_locals),
            output_size_in_bytes=out_bytes,
            temp_size_in_bytes=max(counter.peak - out_bytes, 0),
        )
        counts = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
        return Compiled(counter.flops, counter.bytes, memory, counter.collectives, counts,
                        counter.largest)


# --- what this torch's DTensor can run -----------------------------------------------
def _sharded_dtensor(mesh: Mesh, fake, shape: Tuple[int, ...], placements,
                     dtype: torch.dtype = torch.float32):
    """A DTensor of ``shape`` whose local shard is a fake tensor of
    ``fake``, placed on ``mesh`` (every sharded dim splits evenly)."""
    from torch.distributed.tensor import DTensor, Shard

    local = list(shape)
    for p, n in zip(placements, mesh.devices.shape):
        if isinstance(p, Shard):
            if local[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not split {n} ways")
            local[p.dim] //= n
    with fake:
        shard = torch.empty(local, dtype=dtype)
    return DTensor.from_local(shard, mesh.device_mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _flip_sharding(x, dims):
    from torch.distributed.tensor import Replicate, Shard

    flipped = {d % x.ndim for d in dims}
    return [([Replicate()], [Replicate(), None])] + [
        ([Shard(d)], [Shard(d), None]) for d in range(x.ndim) if d not in flipped]


def _index_copy_sharding(x, dim, index, source):
    from torch.distributed.tensor import Replicate, Shard

    dim %= x.ndim
    return [([Replicate()], [Replicate(), None, Replicate(), Replicate()])] + [
        ([Shard(d)], [Shard(d), None, Replicate(), Shard(d)])
        for d in range(x.ndim) if d != dim]


def _missing_strategy(error: Exception) -> bool:
    return "sharding strategy" in str(error)


@dataclasses.dataclass(frozen=True)
class _DTensorSupport:
    """What this torch's DTensor runs of the models (see ``_adapt_dtensor``)."""

    flattens_sharded_dims: bool
    embedding_backward: bool


@functools.lru_cache(maxsize=None)
def _adapt_dtensor(mesh: Mesh) -> _DTensorSupport:
    """Fit this process's DTensor to the models, on tiny fake DTensors of
    the mesh, before any step runs (a step that fails half-way leaves
    DTensor unfit for the next).

    * Registers a sharding strategy for ``flip`` (the backward of
      ``cumsum``) and ``index_copy_`` (the decode caches' writes) where
      this torch has none (torch 2.11 has neither; 2.13 has both).
      ``flip``'s ``dims`` go into DTensor's strategy cache key, or a flip
      of other dims of a tensor placed alike would reuse the strategy.
    * Whether it flattens a batch dim and a head dim that are both
      sharded, as tensor-parallel attention's products do (2.13 does; 2.11
      refuses).
    * Whether it runs an embedding's backward, an accumulating
      ``index_put`` of gradients sharded over the batch and partial over
      the model axis (2.11's strategy returns an unnormalised ``Shard(-1)``).
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor.experimental import register_sharding

    mesh_shape = tuple(mesh.devices.shape)
    n0 = mesh_shape[0]
    rest = [Replicate()] * (len(mesh_shape) - 1)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    try:
        x = _sharded_dtensor(mesh, fake, (2 * n0, 4), [Shard(0), *rest])
        with fake:
            torch.flip(x, [1])
    except NotImplementedError as e:
        if not _missing_strategy(e):
            raise
        register_sharding(torch.ops.aten.flip.default)(_flip_sharding)
        DTensor._op_dispatcher.sharding_propagator.op_to_schema_info[
            torch.ops.aten.flip.default] = RuntimeSchemaInfo(1, needs_pytree=True)
    try:
        c = _sharded_dtensor(mesh, fake, (2 * n0, 4, 4), [Shard(0), *rest])
        src = _sharded_dtensor(mesh, fake, (2 * n0, 1, 4), [Shard(0), *rest])
        with fake, use_mesh_compat(mesh):
            c.index_copy_(1, torch.zeros(1, dtype=torch.int64), src)
    except NotImplementedError as e:
        if not _missing_strategy(e):
            raise
        register_sharding(torch.ops.aten.index_copy_.default)(_index_copy_sharding)
    if len(mesh_shape) < 2:
        return _DTensorSupport(True, True)
    n1 = mesh_shape[1]
    flattens = embedding = True
    y = _sharded_dtensor(mesh, fake, (n0, n1, 4), [Shard(0), Shard(1), *rest[1:]])
    try:
        with fake:
            y.reshape(n0 * n1, 4)
    except RuntimeError as e:
        if "flatten" not in str(e):
            raise
        flattens = False
    table = _sharded_dtensor(mesh, fake, (8, 4), [Replicate(), *rest])
    tokens = _sharded_dtensor(mesh, fake, (n0, 3), [Shard(0), *rest], torch.int64)
    grads = _sharded_dtensor(mesh, fake, (n0, 3, 4), [Shard(0), Partial(), *rest[1:]])
    try:
        with fake:
            torch.ops.aten.index_put.default(table, [tokens], grads, True)
    except RuntimeError as e:
        if "normalized" not in str(e):
            raise
        embedding = False
    return _DTensorSupport(flattens, embedding)


# --- FSDP -------------------------------------------------------------------------------
# the params' top-level keys whose leaves stack layers on a leading axis
_STACKS = ("layers", "enc_layers", "dec_layers", "mamba_full", "mamba_rem")


def _gather(t, axes: Tuple[str, ...]):
    """All-gather a DTensor over the FSDP ``axes`` (their mesh dims become
    Replicate; the tensor-parallel ones stay).  Autograd turns it into a
    reduce-scatter of the gradient."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    names = t.device_mesh.mesh_dim_names
    target = [Replicate() if n in axes else p for n, p in zip(names, t.placements)]
    return t if list(t.placements) == target else t.redistribute(t.device_mesh, target)


class _StackGather:
    """A stacked leaf whose layers are all-gathered one index at a time,
    when the model takes them (``leaf[i]``), as FSDP gathers a layer;
    with ``wrap``, each gathered layer is a ``_SplitWeight``."""

    def __init__(self, t, axes: Tuple[str, ...], wrap_as=None):
        self.t, self.axes, self.wrap_as = t, axes, wrap_as

    @property
    def shape(self):
        return self.t.shape

    def __getitem__(self, i):
        if self.wrap_as is None:
            return _gather(self.t[i], self.axes)
        return _SplitWeight(_gather(self.t[i].to(self.wrap_as), self.axes), dtype=self.wrap_as)


class _LocalLookup:
    """The embedding table, for a torch whose DTensor cannot shard the
    lookup's backward: gathered whole, then each device looks its own
    tokens up in its copy, and the rows form a DTensor placed as the
    tokens are.  The table's gradient is the devices' partial sums over
    the batch axes; the tied lm head reads the table as FSDP leaves it."""

    def __init__(self, t, axes: Tuple[str, ...]):
        self.t, self.axes = t, axes

    def to(self, *args, **kwargs):
        return _gather(self.t, self.axes).to(*args, **kwargs)

    def __getitem__(self, tokens):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        if not isinstance(tokens, DTensor):
            return _gather(self.t, self.axes)[tokens]
        whole = self.t.redistribute(self.t.device_mesh, [Replicate()] * len(self.t.placements))
        grad = [Partial() if isinstance(p, Shard) else Replicate() for p in tokens.placements]
        rows = whole.to_local(grad_placements=grad)[tokens.to_local()]
        shape = tuple(tokens.shape) + tuple(self.t.shape[1:])
        return DTensor.from_local(rows, tokens.device_mesh, tokens.placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())


class _FsdpModel:
    """``model`` with FSDP's parameter handling: each parameter stays
    sharded over the FSDP axes until a layer uses it, then is
    all-gathered over them (the tensor-parallel axis stays sharded).
    Without it DTensor keeps the contraction dims sharded and gathers
    the activations instead, replicating the batch on every device.

    With ``local_lookup``, the embedding table is a ``_LocalLookup``.
    A step without autograd (``kind`` "prefill" or "decode") runs each
    product on the device's shards (``_SplitWeight``, tensor parallel
    over the model axis), a prefill's parameters gathered in the model's
    dtype, in which the model uses every such parameter (the cast of a
    shard is the shard of the cast); a decode step gathers nothing: each
    parameter sharded over the FSDP axes is a ``_SplitWeight`` where it
    lies."""

    def __init__(self, model, axes: Tuple[str, ...], local_lookup: bool, kind: str = "train"):
        self._model = model
        self._axes = tuple(axes)
        self._local_lookup = local_lookup
        self._split = kind == "decode"
        self._local_products = kind != "train"

    def __getattr__(self, name):
        return getattr(self._model, name)

    def _fsdp_sharded(self, t) -> bool:
        from torch.distributed.tensor import DTensor, Shard

        return isinstance(t, DTensor) and any(
            isinstance(p, Shard) and n in self._axes
            for n, p in zip(t.device_mesh.mesh_dim_names, t.placements))

    def _params(self, params):
        pairs, treedef = tree_flatten_with_path(params)
        leaves = []
        for path, t in pairs:
            name = str(getattr(path[-1], "key", ""))
            top = str(getattr(path[0], "key", ""))
            dtype = self._model.dtype
            wrap = self._local_products and self._fsdp_sharded(t)
            if self._split:
                leaves.append(_SplitWeight(t, dtype=dtype) if wrap else t)
            elif top in _STACKS:
                leaves.append(_StackGather(t, self._axes, dtype if wrap else None))
            elif wrap:
                leaves.append(_SplitWeight(_gather(t.to(dtype), self._axes), dtype=dtype))
            elif name == "table" and self._local_lookup:
                leaves.append(_LocalLookup(t, self._axes))
            else:
                leaves.append(_gather(t, self._axes))
        return tree_unflatten(treedef, leaves)

    def forward(self, params, *args, **kwargs):
        return self._model.forward(self._params(params), *args, **kwargs)

    def decode_step(self, params, *args, **kwargs):
        return self._model.decode_step(self._params(params), *args, **kwargs)


# --- per-pair dry run ------------------------------------------------------------------
_REGROUPED = ("regrouped: each device's query heads and the kv heads they read, "
              "KV caches as cache_specs shard them")
_GATHERED_WEIGHTS = "FSDP: each layer's parameters all-gathered over the data axes when it runs"
_SPLIT_WEIGHTS = ("split: no parameter moves; each product on the shards a device holds, its "
                  "partial activations summed over the axes that split the contraction")
_SPLIT_LOOKUP = "split: a masked lookup in the rows a device holds, summed over the model axis"
_SPLIT_HEAD = ("vocabulary-parallel: the logits left split over the model axis (a greedy "
               "pick is a max over the shards)")
_SPLIT_EXPERTS = ("expert-parallel with d_model slices: every token routed (the batch's "
                  "capacity), each device its experts' d_model slice, partial products summed "
                  "over the data axes")
_PER_HEAD_SSD = ("per-head Mamba block: in_proj's columns of each device's heads, the scan on "
                 "its heads (the (P, N) state stays on it), out_proj summed over the model axis")
_TP_PRODUCTS = ("tensor-parallel: each product on the gathered layer's model-axis shard "
                "(column then row parallel: the FFN's hidden units and the heads stay on their "
                "device, the row-parallel outputs summed over the model axis)")


def lower_pair(
    arch: str,
    shape_name: str,
    mesh: Mesh,
    *,
    cfg: Optional[ArchConfig] = None,
    fsdp_axes=None,
    sharding_mode: str = "fsdp2d",   # or "zero1"
    donate: bool = True,
):
    """Build the right step for (arch, shape) on a mesh and its abstract
    inputs.  Returns (lowered, meta) where meta records what was lowered.
    On a sharded mesh attention runs on each device's query heads,
    the loss on its vocabulary shard and the MoE experts where they are
    held (``_substituted``); ``meta`` names each route.  ``donate`` is
    accepted, never modelled (the port's steps run out of place)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    window = speclib.sliding_window_for(cfg, shape)
    # chunked = flash-style online-softmax attention in plain PyTorch: the
    # production path for full-sequence shapes (never materializes SxS)
    attn_impl = "chunked" if shape.kind in ("train", "prefill") else "xla"
    model = build_model(cfg, sliding_window=window, attn_impl=attn_impl, device="cpu")
    fsdp_axes = fsdp_axes or tuple(
        a for a in ("data",) if a in mesh.axis_names
    )

    meta = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.devices.shape),
        "kind": shape.kind, "window": window,
    }

    if sharding_mode == "zero1":
        param_axes, opt_axes = (), ("data",)
    else:
        param_axes, opt_axes = fsdp_axes, fsdp_axes
    meta["sharding"] = sharding_mode

    # train and prefill gather FSDP-sharded parameters layer by layer; a
    # decode step leaves them where they lie and moves activations
    model_size = mesh.shape.get("model", 1)
    support = _adapt_dtensor(mesh) if mesh.size > 1 else _DTensorSupport(True, True)
    step_model = model
    split = mesh.size > 1 and bool(param_axes) and shape.kind == "decode"
    if mesh.size > 1 and param_axes:
        step_model = _FsdpModel(model, param_axes,
                                local_lookup=not support.embedding_backward, kind=shape.kind)
        meta["weights"] = _SPLIT_WEIGHTS if split else _GATHERED_WEIGHTS
        meta["embedding"] = (_SPLIT_LOOKUP if shape.kind != "train"
                             else "DTensor lookup" if support.embedding_backward
                             else "gathered whole, looked up per device")
    if mesh.size > 1:
        meta["dtensor_flattens_sharded_dims"] = support.flattens_sharded_dims
        if cfg.family != "ssm":
            meta["attention"] = (_REGROUPED if regroups(cfg.num_heads, cfg.num_kv_heads,
                                                        model_size)
                                 else "whole over the model axis, run per device")
        if shape.kind == "train":
            meta["loss"] = "loss-parallel: the head and the cross-entropy on each device's vocabulary shard"
        if split:
            meta["head"] = _SPLIT_HEAD
            meta["cache_writes"] = "on each device's shard of the cache"
        if cfg.moe is not None:
            meta["experts"] = (_SPLIT_EXPERTS if split
                               else "expert-parallel: buffers (E / model, capacity of the data "
                               "shard, d)" if cfg.moe.num_experts % model_size == 0
                               else "every expert on every device")
        if cfg.ssm is not None and shape.kind != "decode":
            meta["ssd"] = (_PER_HEAD_SSD if shape.kind == "prefill" else
                           "per-head scan: each device scans its heads; the (P, N) state "
                           "stays on it (the rest of the block on DTensor's plan)")
        if shape.kind == "prefill":
            meta["products"] = _TP_PRODUCTS
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        if shape.kind == "train":
            state_sds = speclib.state_specs(model, cfg, mesh, param_axes,
                                            opt_fsdp_axes=opt_axes)
            batch_sds = speclib.batch_specs(cfg, shape, mesh)
            opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
            lowered = Lowered(make_train_step(step_model, opt), (state_sds, batch_sds), mesh, fake,
                              grad=True)
        elif shape.kind == "prefill":
            p_sds = speclib.params_specs(model, mesh, param_axes)
            batch_sds = speclib.batch_specs(cfg, shape, mesh)
            lowered = Lowered(make_prefill_step(step_model), (p_sds, batch_sds), mesh, fake,
                              grad=False)
        else:  # decode
            p_sds = speclib.params_specs(model, mesh, param_axes)
            cache_sds = speclib.cache_specs(model, cfg, shape, mesh, param_axes)
            tok_sds = speclib.token_specs(cfg, shape, mesh)
            pos_sds = speclib.sds((), torch.int32, mesh)
            lowered = Lowered(make_serve_step(step_model), (p_sds, tok_sds, cache_sds, pos_sds),
                              mesh, fake, grad=False)
    return lowered, meta


def depth_knobs(cfg: ArchConfig) -> Dict[str, Tuple[int, int]]:
    """The config's independent layer stacks: knob -> (units, layers per
    unit).  Every unit of a stack runs the same operations on the same
    shapes, so each count is affine in each stack's units."""
    if cfg.family == "hybrid":
        every = cfg.hybrid_attn_every
        return {"groups": (cfg.num_layers // every, every)}
    knobs = {"units": (cfg.num_layers // (cfg.moe_every if cfg.moe else 1),
                       cfg.moe_every if cfg.moe else 1)}
    if cfg.encoder is not None:
        knobs["encoder"] = (cfg.encoder.num_layers, 1)
    return knobs


def _at_depth(cfg: ArchConfig, units: Dict[str, int]) -> ArchConfig:
    """``cfg`` with each stack cut to ``units[knob]`` units (a hybrid
    keeps its remainder layers)."""
    knobs = depth_knobs(cfg)
    if cfg.family == "hybrid":
        every = knobs["groups"][1]
        return dataclasses.replace(
            cfg, num_layers=units["groups"] * every + cfg.num_layers % every)
    out = dataclasses.replace(cfg, num_layers=units["units"] * knobs["units"][1])
    if "encoder" in units:
        out = dataclasses.replace(
            out, encoder=dataclasses.replace(cfg.encoder, num_layers=units["encoder"]))
    return out


def _compile_at(arch, shape_name, mesh, cfg) -> Dict[str, Any]:
    lowered, meta = lower_pair(arch, shape_name, mesh, cfg=cfg)
    compiled = lowered.compile()
    mem = compiled.memory_analysis()
    by_shape = {(kind, _HLO_DTYPES[dtype], shape): n
                for (kind, dtype, shape), n in compiled.collectives.items()}
    return {"meta": meta, "flops": compiled.flops, "bytes": compiled.bytes_accessed,
            "coll": collective_bytes(compiled.as_text()), "by_shape": by_shape,
            "memory": {k: getattr(mem, k) for k in _MEM_ATTRS}}


def extrapolated_analysis(arch: str, shape_name: str, mesh: Mesh,
                          cfg: Optional[ArchConfig] = None) -> Dict[str, Any]:
    """Counts of the full-depth step from steps of 2, 3 (and, with
    autograd, 4) units of each layer stack, by Newton's forward
    differences: ``c(n) = c(2) + m D1 + m (m - 1) / 2 D2`` with m = n - 2.
    Every unit is identical, so a step without autograd is affine in the
    units; a train step adds a square term: the backward of each
    ``stack[i]`` writes a gradient the size of the whole stack.  Exact
    where that holds (tested against full traces); a stack of at most 4
    units is traced whole.  One full-width layer of a 32k prefill is tens
    of thousands of operations, so tracing 61 of them is what this
    avoids.  (Not from one unit: under DTensor a stack of one lays its
    cache out otherwise, off the line.)

    Collectives move each unit's weights and activations once, so they
    are affine in the units: a train step takes their slope from its two
    deepest traces, where DTensor's plan has settled (its plan for 2
    units may differ, and the square term would scale that by
    m (m - 1) / 2).  ``coll_body_once`` is the collective count with
    each stack's unit counted once, c(n) - (n - 1) slope, as the
    reference's HLO text lists a scanned stack's loop body once (None
    where a stack was traced whole)."""
    cfg = cfg or get_config(arch)
    knobs = depth_knobs(cfg)
    order = 2 if INPUT_SHAPES[shape_name].kind == "train" else 1
    base_units = {k: 2 if n > 2 + order else n for k, (n, _) in knobs.items()}
    base = _compile_at(arch, shape_name, mesh, _at_depth(cfg, base_units))
    out = {"meta": base["meta"], "flops": base["flops"], "bytes": base["bytes"],
           "coll": dict(base["coll"]), "by_shape": dict(base["by_shape"]),
           "memory": dict(base["memory"])}
    slopes: Optional[List[Tuple[int, Dict[str, float]]]] = []

    for knob, (n, _) in knobs.items():
        if n == base_units[knob]:
            slopes = None
            continue
        points = [base] + [
            _compile_at(arch, shape_name, mesh,
                        _at_depth(cfg, {**base_units, knob: base_units[knob] + i}))
            for i in range(1, order + 1)]
        m = n - base_units[knob]
        weights = [-m, m] if order == 1 else [-m + m * (m - 1) // 2, m - m * (m - 1),
                                              m * (m - 1) // 2]
        # c(n) - c(2) as a weighted sum over the traced points
        nums = [[c["flops"], c["bytes"]] + [c["memory"][a] for a in _MEM_ATTRS]
                for c in points]
        delta = [sum(w * v[i] for w, v in zip(weights, nums)) for i in range(len(nums[0]))]
        out["flops"] += delta[0]
        out["bytes"] += delta[1]
        for attr, d in zip(_MEM_ATTRS, delta[2:]):
            out["memory"][attr] += d
        # collectives: affine through the two deepest traces
        affine = [-m, m] if order == 1 else [-1, 2 - m, m - 1]
        for field in ("coll", "by_shape"):
            for key in set().union(*(c[field] for c in points)):
                d = sum(w * c[field].get(key, 0) for w, c in zip(affine, points))
                out[field][key] = out[field].get(key, 0) + d
        if slopes is not None:
            slopes.append((n, {kind: points[-1]["coll"].get(kind, 0)
                               - points[-2]["coll"].get(kind, 0)
                               for kind in set(points[-1]["coll"]) | set(points[-2]["coll"])}))
    out["memory"]["temp_size_in_bytes"] = max(out["memory"]["temp_size_in_bytes"], 0)
    out["depth"] = {k: n for k, (n, _) in knobs.items()}
    out["traced_depth"] = base_units
    out["coll_body_once"] = None
    if slopes is not None:
        body = dict(out["coll"])
        for n, slope in slopes:
            for kind, d in slope.items():
                body[kind] = body.get(kind, 0) - (n - 1) * d
        out["coll_body_once"] = body
    return out


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, cfg: Optional[ArchConfig] = None
             ) -> Dict[str, Any]:
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    counts = extrapolated_analysis(arch, shape_name, mesh, cfg=cfg)
    t_compile = time.time() - t0
    coll = counts["coll"]

    result = dict(counts["meta"])
    result.update(
        {
            "ok": True,
            "lower_s": 0.0,                 # building the inputs is in compile_s
            "compile_s": round(t_compile, 2),
            "depth": counts["depth"],
            "traced_depth": counts["traced_depth"],
            "flops": float(counts["flops"]),
            "bytes_accessed": float(counts["bytes"]),
            "collective_bytes": coll,
            "collective_bytes_body_once": counts["coll_body_once"],
            "top_collectives": _top_collectives(counts["by_shape"]),
            "memory": _mem_dict(MemoryAnalysis(**counts["memory"])),
        }
    )
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} mesh={result['mesh']}  "
              f"compile={t_compile:.1f}s (depth {counts['depth']} from {counts['traced_depth']} + 1)")
        print(f"  memory_analysis: {result['memory']}")
        print(f"  cost_analysis: flops={result['flops']:.3e} "
              f"bytes={result['bytes_accessed']:.3e}")
        print(f"  collectives: { {k: f'{v:.3e}' for k, v in coll.items()} }")
    return result


def _top_collectives(by_shape: Dict[Tuple[str, str, Tuple[int, ...]], int],
                     n: int = 3) -> List[Dict[str, Any]]:
    """The ``n`` collectives of one kind, dtype and per-device shape that
    move the most bytes in the step, with their count."""
    rows = []
    for (kind, dtype, shape), count in by_shape.items():
        size = math.prod(shape) * _DTYPE_BYTES[dtype]
        rows.append({"kind": kind, "dtype": dtype, "shape": list(shape),
                     "count": int(count), "bytes": float(count * size)})
    return sorted(rows, key=lambda r: -r["bytes"])[:n]


_MEM_ATTRS = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "alias_size_in_bytes",
              "generated_code_size_in_bytes")


def _mem_dict(mem) -> Optional[Dict[str, float]]:
    if mem is None:
        return None
    out = {}
    for attr in _MEM_ATTRS:
        v = getattr(mem, attr, None)
        if v is not None:
            out[attr] = float(v)
    return out or {"repr": str(mem)[:500]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS) + ["all"],
                    default="all")
    ap.add_argument("--shape", choices=list(INPUT_SHAPES) + ["all"],
                    default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None, help="append-JSONL output path")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]

    done = set()
    if args.out and args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("ok"):
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except (ValueError, KeyError):
                    pass

    n_ok = n_fail = 0
    for arch in archs:
        for shape in shapes:
            mesh_tag = "2x16x16" if args.multi_pod else "16x16"
            if (arch, shape, mesh_tag) in done:
                print(f"[dryrun] skip {arch} x {shape} (cached)")
                continue
            try:
                res = run_pair(arch, shape, multi_pod=args.multi_pod)
                n_ok += 1
            except Exception as e:
                traceback.print_exc()
                res = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                       "ok": False, "error": f"{type(e).__name__}: {e}"}
                n_fail += 1
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(res) + "\n")
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
