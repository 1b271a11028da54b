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

  * train and prefill: parameters all-gathered over the FSDP axes layer
    by layer, in the model's dtype, when a product takes them (under
    ``remat`` again in the backward pass); every product on the
    model-axis shard a device holds (``_SplitWeight``): column then row
    parallel; the embedding a masked lookup in the rows a device holds;
    attention on each device's query heads and the kv heads they read; a
    Mamba block on each device's heads; MoE experts where they are held,
    each device filling buffers for its experts from its data shard's
    tokens (a prefill's gate and up products on the experts' d_model
    slices, a train step's experts gathered: ``_expert_parallel``);
  * train: the head and the cross-entropy on each device's vocabulary
    shard, the norms on each device's rows, and the backward pass as the
    regions specify it (each gradient's placements named where it is
    made, each sum written as a collective of the region's), down to the
    parameters' reduce-scatters; the gradient clip's and the optimizer's
    sums and means on each device's shards.  What DTensor's sharding
    propagation moves by itself is counted apart
    (``collectives_outside_regions``): in a train step nothing but
    scalars;
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
import array
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
        # the collectives issued while no region is active: DTensor's own plan
        self.outside: Dict[Tuple[str, torch.dtype, Tuple[int, ...]], int] = {}
        self.routes: Dict[str, str] = {}     # the route a region took, by meta key
        self.paused = 0
        self.times = 1
        self.args = argument_storages
        self.refs: Dict[int, int] = {}
        self.sizes: Dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self.largest = 0
        self.timeline = array.array("q")    # the live bytes after each allocation
        # where each unit of a layer stack starts running: (its function,
        # in the backward pass, the allocations before it)
        self.marks: List[Tuple[str, bool, int]] = []

    def mark(self, unit: str, backward: bool) -> None:
        self.marks.append((unit, backward, len(self.timeline)))

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
            if not _REGION_DEPTH[0]:
                self.outside[key] = self.outside.get(key, 0) + self.times

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
            self.timeline.append(self.live)
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
#
# Under autograd a region specifies its backward too: its entries (``_to_local``)
# name the placements of each local gradient, its exits (``_from_local``) and
# moves (``_moved``) bring a gradient back to the placements their input had,
# each through an autograd function of its own, so that no gradient reaches
# DTensor's sharding propagation in placements it would have to move.  A
# gradient that an entry leaves partial where its input was replicated (a
# column-parallel product's input, a weight's data shards) is summed where it
# was made: at the exit of the region that made it, or by the parameter's
# reduce-scatter (``_gather``).  A collective issued while no region is active
# is DTensor's own plan, counted apart (``collectives_outside_regions``).
_REGION_DEPTH = [0]


@contextlib.contextmanager
def _in_region():
    _REGION_DEPTH[0] += 1
    try:
        yield
    finally:
        _REGION_DEPTH[0] -= 1


@contextlib.contextmanager
def _dtensor_plan():
    """A region's fallback to the plain function on DTensors: what it
    issues is DTensor's own plan."""
    depth = _REGION_DEPTH[0]
    _REGION_DEPTH[0] = 0
    try:
        yield
    finally:
        _REGION_DEPTH[0] = depth


def _region(fn):
    """``fn`` counted as a region: the collectives it issues are its own."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _in_region():
            return fn(*args, **kwargs)
    return run


def _replicated_for_grad(placements) -> list:
    """``placements`` with each Partial read as Replicate (a gradient's)."""
    from torch.distributed.tensor import Replicate

    return [Replicate() if p.is_partial() else p for p in placements]


class _Moved(torch.autograd.Function):
    """A DTensor redistributed to ``placements``; its gradient is brought
    back to the input's placements (a Partial there read as Replicate).
    With ``defer``, a gradient partial where the input was replicated stays
    partial, to be summed where the input was made."""

    @staticmethod
    def forward(ctx, t, placements, defer):
        ctx.back, ctx.defer = tuple(t.placements), defer
        if tuple(t.placements) == tuple(placements):
            return t.view_as(t)
        return t.redistribute(t.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate

        target = [g if ctx.defer and g.is_partial() and isinstance(b, Replicate) else
                  Replicate() if b.is_partial() else b
                  for g, b in zip(grad.placements, ctx.back)]
        if list(grad.placements) != target:
            with _in_region():
                grad = grad.redistribute(grad.device_mesh, target)
        return grad, None, None


def _moved(t, placements, defer: bool = True):
    return _Moved.apply(t, tuple(placements), defer)


class _Whole:
    """The mesh dims on which every device computes the whole of a
    product (neither factor split there), and whether its output's
    gradient arrived partial on each: set by the output's ``_Exit`` in
    the backward pass, read by the factors' ``_Entry``s after it, so that
    the factors' gradients keep the form the output's came in (a partial
    one summed once, where the factor was made, a whole one not at all)."""

    def __init__(self, dims):
        self.dims, self.partial = tuple(dims), {}


class _Entry(torch.autograd.Function):
    """A DTensor's local shard, its gradient read as ``placements`` but on
    the dims of ``whole``, where it is partial as the product's output's
    gradient arrived."""

    @staticmethod
    def forward(ctx, t, placements, whole):
        ctx.mesh, ctx.placements, ctx.whole = t.device_mesh, placements, whole
        ctx.shape, ctx.stride = t.shape, t.stride()
        return t.to_local()

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        pl = [(Partial() if ctx.whole.partial.get(i) else Replicate()) if i in ctx.whole.dims
              else p for i, p in enumerate(ctx.placements)]
        return DTensor.from_local(grad, ctx.mesh, pl, run_check=False, shape=ctx.shape,
                                  stride=ctx.stride), None, None


class _Exit(torch.autograd.Function):
    """A DTensor of even local shards; its gradient is brought to its
    placements (a Partial read as Replicate: the sum of a partial
    gradient) before its local shard is taken, but on the dims of
    ``whole`` (``_Whole``), where it stays as it came."""

    @staticmethod
    def forward(ctx, local, mesh, placements, whole):
        from torch.distributed.tensor import DTensor

        ctx.placements, ctx.whole = _replicated_for_grad(placements), whole
        return DTensor.from_local(local, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        dims = ctx.whole.dims if ctx.whole is not None else ()
        target = [g if i in dims and (g.is_partial() or g.is_replicate()) else p
                  for i, (g, p) in enumerate(zip(grad.placements, ctx.placements))]
        if list(grad.placements) != target:
            with _in_region():
                grad = grad.redistribute(grad.device_mesh, target)
        if dims:
            ctx.whole.partial = {i: grad.placements[i].is_partial() for i in dims}
        return grad.to_local(), None, None, None


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


def _to_local(t, placements, grad_placements=None, whole: Optional[_Whole] = None
              ) -> torch.Tensor:
    """``t`` laid out as ``placements`` (a redistribution where it is not),
    as its local shard; its local gradient is read as ``grad_placements``
    (default ``placements``), on the dims of ``whole`` as ``_Entry``
    reads it."""
    if list(t.placements) != list(placements):
        t = _moved(t, placements)
    grad_placements = tuple(grad_placements or placements)
    if whole is not None and whole.dims:
        return _Entry.apply(t, grad_placements, whole)
    return t.to_local(grad_placements=grad_placements)


def _from_local(local: torch.Tensor, mesh, placements, shape, whole: Optional[_Whole] = None):
    """A DTensor of global ``shape`` from even local shards (their
    strides kept); its gradient kept as it comes on the dims of ``whole``
    (``_Exit``)."""
    out = _Exit.apply(local, mesh, tuple(placements), whole)
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


def _reduce_over_model(local: torch.Tensor, like, op: str = "sum",
                       partial_grad: bool = False) -> torch.Tensor:
    """``local``'s sum (or max) over the model dim of ``like``'s mesh,
    an all-reduce; ``local`` is laid out as ``like``'s batch.  With
    ``partial_grad`` the sum's gradient is each device's share (it feeds
    the device's own channels), summed over the model dim in the
    backward pass."""
    from torch.distributed.tensor import Partial, Replicate

    names, mi = _mesh_dims(like)
    if mi is None or like.device_mesh.size(mi) == 1:
        return local
    partial = _batch_placements(like, Partial(op))
    whole = _from_local(local, like.device_mesh, partial, _global_shape(local, like, partial))
    return _to_local(whole, _batch_placements(like, Replicate()),
                     _batch_placements(like, Partial()) if partial_grad else None)


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
    if mi is not None and split and not isinstance(kv_pl[mi], Shard):
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
        return _moved(loss, [Replicate()] * len(over_batch))

    return lm_loss


def _expert_parallel(fn, routes: Dict[str, str], sliced: bool):
    """``apply_moe`` with each device's experts on that device: every
    device routes its data shard's tokens (the capacity is the shard's,
    as GShard's groups take it), fills buffers (E / model, cap, d) for the
    experts it holds, runs them and combines their outputs, and runs its
    slice of the shared expert's hidden units; the output is the sum over
    the model dim.  Where the experts do not split over the model dim,
    every device runs them all.  The experts' weights:

      * gathered: all-gathered over the data axes (FSDP), their gradients
        reduce-scattered;
      * sliced (with ``sliced``, where ``_d_model_slices`` finds the
        slices; no autograd): ``w_gate`` and ``w_up`` stay on their
        d_model slices: every data shard's buffers move to the devices
        that hold those slices (an all-to-all over the data axes, each
        device its slice of every shard's slots), and the partial
        products are reduce-scattered back onto the shard whose tokens
        they are; ``w_down`` is gathered.

    A prefill takes the sliced route and a train step the gathered one:
    each the route that moved the fewer bytes there by the dry run's count
    on kimi-k2's and llama4's full-width pairs.  A decode step (its
    weights not gathered) keeps every expert where it lies
    (``_expert_parallel_decode``).  The route taken goes into ``routes``
    under "experts"."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models import moe

    def apply_moe(params, x, cfg, activation: str = "silu"):
        if not isinstance(x, DTensor):
            return fn(params, x, cfg, activation)
        act = torch.nn.functional.silu if activation == "silu" else moe._gelu_tanh
        m, rank = _model_size_and_rank(x)
        names, mi = _mesh_dims(x)
        if isinstance(params["w_gate"], _SplitWeight) and not params["w_gate"].axes:
            routes["experts"] = _SPLIT_EXPERTS
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
        # every model rank routes every token; its experts' share of the
        # gradient is its own (and the aux loss is counted 1 / m on each)
        router = weights(params["router"], Replicate(), Partial() if split else None)
        gate_vals, flats, valids, aux, cap = moe.route({"router": router}, xt, cfg)
        if split:
            valids = [valid & (flat >= lo * cap) & (flat < (lo + held) * cap)
                      for flat, valid in zip(flats, valids)]
            flats = [torch.clamp(flat - lo * cap, 0, held * cap - 1) for flat in flats]
        ex_in = moe.dispatch(xt, flats, valids, held, cap)
        slices = _d_model_slices(params["w_gate"], batch, mi) if sliced and split else None
        routes["experts"] = (_EXPERT_ROUTES["sliced" if slices is not None else "gathered"]
                             if split else "every expert on every device")
        if slices is not None:
            gate, up = _sliced_products(ex_in, [params[k] for k in ("w_gate", "w_up")],
                                        batch, mi, slices)
            gate = act(gate)
        else:
            wg, wu = (weights(params[k], Shard(0) if split else Replicate())
                      for k in ("w_gate", "w_up"))
            gate = act(torch.bmm(ex_in, wg.to(xt.dtype)))
            up = torch.bmm(ex_in, wu.to(xt.dtype))
        wd = weights(params["w_down"], Shard(0) if split else Replicate())
        ex_out = torch.bmm(gate * up, wd.to(xt.dtype)).reshape(held * cap, d)
        out = moe.combine(ex_out, gate_vals, flats, valids)
        if "shared" in params:
            sh = params["shared"]
            # the shared expert's hidden units split over the model dim with
            # the experts; where they cannot, the whole of it on model rank 0
            hidden = split and sh["w_gate"].shape[1] % m == 0
            col, row = (Shard(1), Shard(0)) if hidden else (Replicate(), Replicate())
            on_rank0 = Partial() if split and not hidden else None
            g = act(xt @ weights(sh["w_gate"], col, on_rank0).to(xt.dtype))
            u = xt @ weights(sh["w_up"], col, on_rank0).to(xt.dtype)
            y = (g * u) @ weights(sh["w_down"], row, on_rank0).to(xt.dtype)
            out = out + (y if hidden or not split or rank == 0 else torch.zeros_like(y))
        out_pl = list(x_pl)
        if split:
            out_pl[mi] = Partial()
        out = _moved(_from_local(out.reshape(b, s, d), x.device_mesh, out_pl, x.shape), x_pl)
        shards = math.prod(x.device_mesh.size(i) for i in batch + ([mi] if split else []))
        aux_pl = [Partial() if i in batch or split and i == mi else Replicate() for i in range(n)]
        aux = _from_local(aux / shards, x.device_mesh, aux_pl, ())
        return out, _moved(aux, [Replicate()] * n)

    return apply_moe


def _d_model_slices(w, batch: List[int], mi: int) -> Optional[List[int]]:
    """The mesh dims over which expert weight ``w`` (a ``_SplitWeight`` of
    (E, d, F)) splits d_model, where they are the dims that split the
    batch and ``w`` splits its experts over the model dim; else None."""
    from torch.distributed.tensor import Shard

    if not isinstance(w, _SplitWeight):
        return None
    pl = w.t.placements
    dims = [i for i, p in enumerate(pl) if p == Shard(1)]
    if not dims or sorted(dims) != sorted(batch) or pl[mi] != Shard(0):
        return None
    return dims


def _sliced_products(ex_in, ws, batch: List[int], mi: int, slices: List[int]):
    """``bmm(ex_in, w)`` for each expert weight ``w`` of ``ws`` on its
    d_model slices: the data shards' buffers (held, cap, d) move to the
    devices holding each d_model slice (an all-to-all), each device
    multiplies every shard's slots by its slice, and the partial sums are
    reduce-scattered back onto the slots' own shard (a step without
    autograd)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = ws[0].t.device_mesh
    shards = math.prod(mesh.size(i) for i in batch)
    held, cap, d = ex_in.shape
    slots = [Shard(1) if i in batch else Replicate() for i in range(mesh.ndim)]
    slots[mi] = Shard(0)
    buf = _from_local(ex_in, mesh, slots, (held * mesh.size(mi), cap * shards, d))
    cols = [Shard(2) if i in slices else p for i, p in enumerate(slots)]
    bl = _to_local(buf, cols)
    partial = [Partial() if i in slices else p for i, p in enumerate(cols)]
    outs = []
    for w in ws:
        wl = _to_local(w.t.to(ex_in.dtype), w.t.placements)
        part = torch.bmm(bl, wl)
        y = _from_local(part, mesh, partial, (held * mesh.size(mi), cap * shards, part.shape[2]))
        outs.append(_to_local(y, slots))
    return outs


def _vocab_parallel_head(fn):
    """``Transformer._lm_head`` taking the residual stream whole over
    the model dim (its batch split as it comes), so that the product
    with the head's vocabulary shard leaves each device its logits'
    vocabulary shard, as the loss-parallel cross-entropy reads them."""
    from torch.distributed.tensor import DTensor, Replicate

    def _lm_head(self, params, x):
        if isinstance(x, DTensor):
            x = _moved(x, _batch_placements(x, Replicate()))
        return fn(self, params, x)

    return _lm_head


def _per_head_mamba(fn, ssd_chunked, routes: Dict[str, str]):
    """``apply_mamba_block`` on each device's heads (they divide over the
    model dim, as ``in_proj``'s ``("F", "T")`` splits them).  The
    full-sequence pass: after the input norm, the device takes
    ``in_proj``'s columns of its heads' z, x and dt and every column of B
    and C (the weight gathered whole over the model dim, in the
    activations' dtype), runs the conv on its channels and ``ssd_chunked``
    on its heads, so the (P, N) state stays on it, as attention runs on
    its query heads; the output norm's mean square and ``out_proj``'s
    partial sums (its rows are the heads') are summed over the model dim.
    Under autograd the norm's output takes each device's share of its
    gradient, summed over the model dim where the norm ran, and a weight
    read whole takes its partial gradient (the device's heads' columns,
    B's and C's from its heads).  A decode step runs ``_mamba_decode``
    where its caches lie as ``cache_specs`` lays them out; elsewhere
    ``fn`` runs on DTensor's own plan.  The route taken goes into
    ``routes`` under "ssd"."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models import mamba2, nn

    def apply_mamba_block(params, x, cfg, cache=None, ssd_impl="xla"):
        d_inner, heads, g, n, _ = mamba2._dims(cfg)
        m, _ = _model_size_and_rank(x) if isinstance(x, DTensor) else (1, 0)
        _, mi = _mesh_dims(x) if isinstance(x, DTensor) else (None, None)
        per_head = mi is not None and not heads % m
        if per_head and cache is not None and _decode_caches_placed(x, cache):
            routes["ssd"] = _PER_HEAD_DECODE
            return _mamba_decode(params, x, cfg, cache)
        if cache is not None or not per_head:
            routes["ssd"] = _DTENSOR_SSD
            with _dtensor_plan():
                return fn(params, x, cfg, cache, ssd_impl)
        routes["ssd"] = _PER_HEAD_SSD
        mesh = x.device_mesh
        grad = torch.is_grad_enabled()
        whole_pl = [Replicate()] * mesh.ndim
        # a gradient read whole: partial over the data shards and the heads
        partial_pl = [Partial() if isinstance(p, Shard) or i == mi else Replicate()
                      for i, p in enumerate(_batch_placements(x, Replicate()))]

        def whole(t):
            return _to_local(t, whole_pl, partial_pl) if isinstance(t, DTensor) else t

        def mine(t, dim):
            """The device's part of ``t`` (whole on it) along ``dim``: its heads'
            (under autograd by their indices, so that the gradient of ``t`` is
            the device's part, zeros elsewhere)."""
            pl = [Replicate()] * mesh.ndim
            pl[mi] = Shard(dim)
            if not grad:
                return _local_rows(t, x, pl)
            pl[mi] = Shard(0)
            return t.index_select(dim, _local_rows(torch.arange(t.shape[dim]), x, pl))

        p_ = cfg.ssm.head_dim
        e = heads // m * p_                        # the device's inner channels
        batch_pl = _batch_placements(x, Replicate())
        h = _to_local(nn.apply_rmsnorm(params["norm"], x), batch_pl,
                      _batch_placements(x, Partial()))
        b, s, _ = h.shape
        w_in = whole(_unwrapped(params["in_proj"]).to(h.dtype))
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
        square = _reduce_over_model(torch.sum(torch.square(y32), dim=-1, keepdim=True), x,
                                    partial_grad=grad)
        scale = mine(whole(params["out_norm"]["scale"]), 0)
        y = (y32 * torch.rsqrt(square / d_inner + 1e-6) * scale).to(y.dtype)
        rows = [Replicate()] * mesh.ndim
        rows[mi] = Shard(0)
        w_out = _unwrapped(params["out_proj"])
        rows_grad = [Partial() if isinstance(p, Shard) else q for p, q in zip(batch_pl, rows)]
        part = y @ _to_local(w_out, rows, rows_grad).to(y.dtype)
        out = _from_local(part, mesh, _batch_placements(x, Partial()), x.shape)
        return x + _moved(out, batch_pl), None

    return apply_mamba_block


def _decode_caches_placed(x, cache) -> bool:
    """Whether a Mamba block's decode caches lie as ``cache_specs`` lays
    them out for ``x`` (a DTensor): their batch split as x's, the conv
    tail's channels split over the model dim or whole there, the SSM
    state's heads, head dim or state dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    _, mi = _mesh_dims(x)
    batch = _batch_placements(x, Replicate())
    for t, dims in ((cache.conv, (2,)), (cache.ssm, (1, 2, 3))):
        if not isinstance(t, DTensor) or t.device_mesh != x.device_mesh:
            return False
        pl = list(t.placements)
        model = pl[mi]
        pl[mi] = Replicate()
        if pl != batch or not (model == Replicate() or model in [Shard(d) for d in dims]):
            return False
    return True


def _mamba_decode(params, x, cfg, cache):
    """One token through a Mamba block with every weight and cache where
    it lies (no weight moves, no state moves): the input norm on each
    device's rows; ``in_proj`` a split product, its output (one token's
    projection) gathered over the model dim; the conv on the device's
    channels of the conv tail, its output gathered; the SSM step on the
    device's shard of the state, whichever of its dims the model dim
    splits, its output brought onto the device's heads (summed over the
    model dim where the state dim is split); the gate, the output norm
    (its mean square summed over the model dim) on those heads, and
    ``out_proj`` (its rows are the heads') a split product.  The new conv
    tail and state are laid out as the caches."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.models import mamba2, nn

    d_inner, heads, g, n, _ = mamba2._dims(cfg)
    mesh = x.device_mesh
    _, mi = _mesh_dims(x)
    e = heads // mesh.size(mi) * cfg.ssm.head_dim      # the device's heads' channels
    batch_pl = _batch_placements(x, Replicate())

    def on_model(p) -> list:
        pl = [Replicate()] * mesh.ndim
        pl[mi] = p
        return pl

    def part(t, p=Replicate()):
        """The device's part of ``t`` (a parameter, or its rows of an
        activation) laid out as ``p`` on the model dim, whole elsewhere."""
        return _to_local(t, on_model(p)) if isinstance(t, DTensor) else \
            _local_rows(t, x, on_model(p))

    def mine(t, dim):
        return part(t, Shard(dim))

    xl = _to_local(x, batch_pl)
    b = xl.shape[0]
    h = nn.apply_rmsnorm({"scale": part(params["norm"]["scale"])}, xl)
    w_in = _unwrapped(params["in_proj"].to(h.dtype))
    proj = _split_product("bsk,kn->bsn", _from_local(h, mesh, batch_pl, x.shape), w_in)
    z, xin, bm, cm, dt = mamba2._split_proj(cfg, _to_local(proj, batch_pl))
    tail = cache.conv
    channels = tail.placements[mi] != Replicate()     # the tail's, over the model dim
    conv_out, new_tail = mamba2._causal_conv(
        part(torch.cat([xin, bm, cm], dim=-1), tail.placements[mi]),
        part(params["conv_w"], Shard(1) if channels else Replicate()),
        part(params["conv_b"], Shard(0) if channels else Replicate()), tail.to_local())
    conv = _from_local(torch.nn.functional.silu(conv_out), mesh, tail.placements,
                       (x.shape[0], 1, tail.shape[-1]))
    conv_out = _to_local(conv, batch_pl)
    xh = conv_out[:, 0, :d_inner].reshape(b, heads, cfg.ssm.head_dim)
    bh, ch = (torch.repeat_interleave(t.reshape(b, g, n), heads // g, dim=1).float()
              for t in (conv_out[:, 0, d_inner:d_inner + g * n], conv_out[:, 0, d_inner + g * n:]))
    dt = torch.nn.functional.softplus(dt[:, 0].float() + part(params["dt_bias"]))
    decay = torch.exp(dt * -torch.exp(part(params["A_log"])))
    xdt = (xh * dt[..., None]).float()
    # the step on the device's shard of the state (B, H, P, N)
    state = cache.ssm
    split = state.placements[mi]
    if split == Shard(1):
        xdt, decay, bh, ch = mine(xdt, 1), mine(decay, 1), mine(bh, 1), mine(ch, 1)
    elif split == Shard(2):
        xdt = mine(xdt, 2)
    elif split == Shard(3):
        bh, ch = mine(bh, 2), mine(ch, 2)
    new = state.to_local() * decay[:, :, None, None] + torch.einsum("bhn,bhp->bhpn", bh, xdt)
    y = torch.einsum("bhn,bhpn->bhp", ch, new)
    y_pl = _batch_placements(x, Partial() if split == Shard(3) else split)
    y = _to_local(_from_local(y, mesh, y_pl, (x.shape[0], heads, cfg.ssm.head_dim)),
                  _batch_placements(x, Shard(1))).to(xh.dtype)
    y = y + mine(params["D"], 0)[None, :, None].to(y.dtype) * mine(xh, 1)
    y = y.reshape(b, 1, e) * torch.nn.functional.silu(mine(z, 2))
    y32 = y.float()
    square = _reduce_over_model(torch.sum(torch.square(y32), dim=-1, keepdim=True), x)
    scale = mine(params["out_norm"]["scale"], 0)
    y = (y32 * torch.rsqrt(square / d_inner + 1e-6) * scale).to(y.dtype)
    y = _from_local(y, mesh, _batch_placements(x, Shard(2)), (x.shape[0], 1, d_inner))
    out = _split_product("bsk,kn->bsn", y, _unwrapped(params["out_proj"].to(y.dtype)))
    out = _from_local(xl + _to_local(out, batch_pl), mesh, batch_pl, x.shape)
    return out, mamba2.MambaCache(
        conv=_from_local(new_tail, mesh, tail.placements, tail.shape),
        ssm=_from_local(new, mesh, state.placements, state.shape))


class _RmsNorm(torch.autograd.Function):
    """``nn.apply_rmsnorm`` that keeps its input and each row's reciprocal
    RMS for the backward pass (as a fused norm does), not its float32
    copies."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        x32 = x.float()
        r = torch.rsqrt(torch.mean(torch.square(x32), dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, scale, r)
        return (x32 * r * scale).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, scale, r = ctx.saved_tensors
        x32, dy32 = x.float(), dy.float()
        g = dy32 * scale
        dx = r * g - x32 * r ** 3 * torch.mean(g * x32, dim=-1, keepdim=True)
        dscale = torch.sum((dy32 * x32 * r).reshape(-1, x.shape[-1]), dim=0)
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def _local_rmsnorm(fn):
    """``apply_rmsnorm`` on each device's rows (the normalised dim whole on
    it), as ``_RmsNorm``: the scale's gradient is the data shards' partial
    sum, and the output's gradient is summed over the model dim here, once
    for all the column-parallel products that read it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def apply_rmsnorm(p, x, eps=1e-6):
        if not isinstance(x, DTensor) or Shard(x.ndim - 1) in x.placements:
            with _dtensor_plan():
                return fn(p, x, eps)
        pl = list(x.placements)
        scale = p["scale"]
        if isinstance(scale, DTensor):
            scale = _to_local(scale, [Replicate()] * len(pl),
                              [Partial() if isinstance(q, Shard) else Replicate() for q in pl])
        y = _RmsNorm.apply(_to_local(x, pl), scale, eps)
        return _from_local(y, x.device_mesh, pl, x.shape)

    return apply_rmsnorm


def _contiguous_stride(shape) -> Tuple[int, ...]:
    """A contiguous tensor's strides for ``shape``, worked out, not
    allocated (a meta tensor made while a step runs may be counted as the
    step's memory)."""
    return tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))


def _reduced(func, t, dim=None, keepdim=False, **kwargs):
    """``func`` (a sum or a mean) of DTensor ``t``: each device's over its
    shard, summed over the mesh dims that split a reduced dim (an
    all-reduce), left split as ``t`` over the rest."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    dims = list(range(t.ndim)) if dim is None else [
        d % t.ndim for d in (dim if isinstance(dim, (list, tuple)) else [dim])]
    local = torch.sum(t.to_local(), dim=dims, keepdim=keepdim, **kwargs)
    if getattr(func, "__name__", "") == "mean":
        local = local / math.prod(t.shape[d] for d in dims)
    split = [i for i, p in enumerate(t.placements) if isinstance(p, Shard) and p.dim in dims]
    pl = [Partial() if i in split else
          Shard(p.dim if keepdim else p.dim - sum(d < p.dim for d in dims))
          if isinstance(p, Shard) else p for i, p in enumerate(t.placements)]
    shape = [1 if d in dims else n for d, n in enumerate(t.shape) if keepdim or d not in dims]
    out = DTensor.from_local(local, t.device_mesh, pl, run_check=False, shape=torch.Size(shape),
                             stride=_contiguous_stride(shape))
    if not split:
        return out
    with _in_region():
        return out.redistribute(t.device_mesh, _replicated_for_grad(pl))


def _elementwise(func, a, b):
    """``func(a, b)`` (an elementwise operation of two DTensors that
    broadcast) on each device's shards: each mesh dim keeps the split that
    one of them has (on a dim the other broadcasts or holds whole, which
    then takes its slice, moving no byte); None where they split
    different dims or one is partial."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    ndim = max(a.ndim, b.ndim)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    out = []
    for pa, pb in zip(a.placements, b.placements):
        if pa.is_partial() or pb.is_partial():
            return None
        dims = {p.dim + ndim - t.ndim for p, t in ((pa, a), (pb, b)) if isinstance(p, Shard)}
        if len(dims) > 1:
            return None
        out.append(Shard(dims.pop()) if dims else Replicate())

    def local(t):
        pl = [Shard(p.dim - (ndim - t.ndim)) if isinstance(p, Shard)
              and p.dim >= ndim - t.ndim and t.shape[p.dim - (ndim - t.ndim)] != 1
              else Replicate() for p in out]
        if any(isinstance(q, Shard) and q != p for q, p in zip(t.placements, pl)):
            return None
        return t.redistribute(t.device_mesh, pl).to_local()

    la, lb = local(a), local(b)
    if la is None or lb is None:
        return None
    y = func(la, lb)
    return DTensor.from_local(y, a.device_mesh, out, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def _with_new_axes(t, index):
    """``t[index]`` for an index of ``...``, ``:`` and ``None`` alone (new
    axes, every element kept) on each device's shard, its splits kept on
    the dims they move to (a torch whose DTensor slices a split dim, even
    whole, gathers it first); None for any other index."""
    from torch.distributed.tensor import DTensor, Shard

    index = index if isinstance(index, tuple) else (index,)
    if not all(i is Ellipsis or i is None or i == slice(None) for i in index):
        return None
    taken = sum(1 for i in index if i is not None and i is not Ellipsis)
    moved, out_dim, in_dim = {}, 0, 0
    for i in index:
        if i is None:
            out_dim += 1
            continue
        for _ in range(t.ndim - taken if i is Ellipsis else 1):
            moved[in_dim], in_dim, out_dim = out_dim, in_dim + 1, out_dim + 1
    for d in range(in_dim, t.ndim):
        moved[d], out_dim = out_dim, out_dim + 1
    local = t.to_local()[index]
    source = {o: d for d, o in moved.items()}
    shape = tuple(t.shape[source[j]] if j in source else 1 for j in range(local.ndim))
    pl = [Shard(moved[p.dim]) if isinstance(p, Shard) else p for p in t.placements]
    return DTensor.from_local(local, t.device_mesh, pl, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


class _LocalReductions(torch.overrides.TorchFunctionMode):
    """Without autograd (the gradient clip and the optimizer): sums and
    means of DTensors as ``_reduced`` (a factored second moment's row and
    column means, an update's RMS, the global norm), new axes as
    ``_with_new_axes`` and elementwise operations of two DTensors laid out
    apart (a replicated factored moment and a gradient's row means, their
    outer product) as ``_elementwise``, so that DTensor plans none of
    them."""

    _REDUCTIONS = (torch.sum, torch.mean, torch.Tensor.sum, torch.Tensor.mean)
    _BINARY = (torch.Tensor.add, torch.Tensor.sub, torch.Tensor.mul, torch.Tensor.div,
               torch.Tensor.__add__, torch.Tensor.__radd__, torch.Tensor.__sub__,
               torch.Tensor.__rsub__, torch.Tensor.__mul__, torch.Tensor.__rmul__,
               torch.Tensor.__truediv__, torch.Tensor.__rtruediv__, torch.add, torch.sub,
               torch.mul, torch.div, torch.maximum, torch.minimum)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if not torch.is_grad_enabled() and args and isinstance(args[0], DTensor):
            if func in self._REDUCTIONS:
                return _reduced(func, *args, **kwargs)
            if func is torch.Tensor.__getitem__:
                out = _with_new_axes(*args)
                if out is not None:
                    return out
            if (func in self._BINARY and len(args) == 2 and not kwargs
                    and isinstance(args[1], DTensor) and args[0].placements != args[1].placements
                    and args[0].ndim and args[1].ndim):
                out = _elementwise(func, *args)
                if out is not None:
                    return out
        return func(*args, **kwargs)


# --- decode with the weights where params_specs puts them -----------------------------
# A decode step reads every weight once for a few tokens, so no weight moves:
# each product contracts on the shards a device holds and sums its partial
# activations over the mesh dims that split the contraction (``_split_product``),
# the embedding looks up the rows a device holds and sums them, and the head's
# logits stay split over the vocabulary.  A step without autograd hands the
# layers ``_SplitWeight``s in place of the FSDP-sharded parameters (a prefill's
# gathered over the data axes first); the model's own products (``x @ w``,
# ``torch.einsum``) reach ``_split_product`` through ``__torch_function__``.
@_region
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
    x_grad, w_grad = [], []
    # the mesh dims where every device computes the whole product: there
    # x's and w's gradients take the form the output's comes in (``_Whole``)
    whole = _Whole(m for m, (pw, px) in enumerate(zip(w.placements, x.placements))
                   if not isinstance(pw, Shard) and not isinstance(px, Shard))
    for m, (pw, px) in enumerate(zip(w.placements, x.placements)):
        carried = isinstance(px, Shard) and xs[px.dim] in out and xs[px.dim] not in ws
        # x's gradient partial where w splits an output dim (each device has
        # its columns' share), w's where x's batch splits
        x_grad.append(Partial() if isinstance(pw, Shard) and ws[pw.dim] in out else None)
        w_grad.append(Partial() if carried and not isinstance(pw, Shard) else None)
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
    xl = _to_local(x, x_pl, [g or p for g, p in zip(x_grad, x_pl)], whole)
    wl = _to_local(w, w_pl, [g or p for g, p in zip(w_grad, w_pl)], whole)
    local = torch.einsum(equation, xl, wl.to(xl.dtype))
    y = _from_local(local, mesh, out_pl, _global_shape(local, w, out_pl), whole)
    return y if out_pl == target else _moved(y, target)


@_region
def _split_lookup(table, tokens):
    """``table[tokens]`` with the table where it lies (rows over the model
    dim where they split, features over the FSDP dims): each device looks
    every token up in the rows it holds, zeros where it holds none, and the
    rows are summed over the model dim, laid out as the tokens are.  The
    table's gradient is each device's rows' partial sum over the mesh dims
    that split the tokens but not the table."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    # every token over the mesh dims that split the table, the tokens'
    # own split elsewhere
    tok_pl = [Replicate() if isinstance(p, Shard) else q
              for p, q in zip(table.placements, tokens.placements)] \
        if isinstance(tokens, DTensor) else [Replicate()] * mesh.ndim
    ids = _to_local(tokens, tok_pl) if isinstance(tokens, DTensor) else tokens
    tl = table.to_local(grad_placements=tuple(
        Partial() if isinstance(p, Replicate) and isinstance(q, Shard) else p
        for p, q in zip(table.placements, tok_pl)))
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
    return _moved(y, target)


def _unwrapped(t):
    return t.gathered() if isinstance(t, _SplitWeight) else t


class _SplitWeight:
    """A parameter left as ``params_specs`` shards it: its products run
    as ``_split_product`` (``x @ w``, ``x @ w.T``, ``torch.einsum(eq, x,
    w)``), a row lookup (``w[tokens]``) as ``_split_lookup``, and ``w[i]``
    takes layer i of a stack.  ``.to`` records the dtype the shard is cast
    to; ``axes`` are the FSDP axes it is all-gathered over (after the
    cast) when a product takes it (``gathered``), none in a decode step."""

    def __init__(self, t, transposed: bool = False, dtype=None, axes: Tuple[str, ...] = ()):
        self.t, self.transposed, self._dtype, self.axes = t, transposed, dtype, axes

    @property
    def shape(self):
        return tuple(self.t.shape)[::-1] if self.transposed else tuple(self.t.shape)

    @property
    def T(self):
        return _SplitWeight(self.t, not self.transposed, self._dtype, self.axes)

    def to(self, dtype):
        return _SplitWeight(self.t, self.transposed, dtype, self.axes)

    def gathered(self):
        """The weight in its dtype, all-gathered over ``axes``."""
        t = self.t if self._dtype is None else self.t.to(self._dtype)
        return _gather(t, self.axes) if self.axes else t

    def __getitem__(self, index):
        if isinstance(index, int):
            return _SplitWeight(self.t[index], self.transposed, self._dtype, self.axes)
        return _split_lookup(self.gathered(), index)

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
        return _split_product(equation, x, w.gathered())


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
    y = _moved(y, _batch_placements(x, Replicate()))
    if "shared" in params:
        sh = params["shared"]
        hidden = act(_split_product("bsd,df->bsf", x, sh["w_gate"].t).to(x.dtype)) * \
            _split_product("bsd,df->bsf", x, sh["w_up"].t).to(x.dtype)
        y = y + _split_product("bsf,fd->bsd", hidden, sh["w_down"].t).to(x.dtype)
    return y, aux


class _LocalCacheWrites(torch.overrides.TorchFunctionMode):
    """A decode cache's writes (``cache.index_copy_(dim, rows, new)``, a
    Mamba state's ``cache.ssm[i].copy_(new)``) on each device's shard of
    the cache, the new values laid out as the cache.  DTensor's own
    in-place ``index_copy_`` may pick a layout for the cache other than
    the one it has (torch 2.13 then re-labels the cache without moving
    it, as with a replicated batch of one)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        kwargs = kwargs or {}
        if func is torch.Tensor.copy_ and isinstance(args[0], DTensor) and len(args) == 2 \
                and not kwargs:
            cache, new = args
            with _in_region():
                cache.to_local().copy_(_local_rows(new, cache, list(cache.placements)))
            return cache
        if func is torch.Tensor.index_copy_ and isinstance(args[0], DTensor) and not kwargs:
            cache, dim, index, new = args
            if Shard(dim % cache.ndim) not in cache.placements:
                with _in_region():
                    idx = (_to_local(index, [Replicate()] * index.device_mesh.ndim)
                           if isinstance(index, DTensor) else index)
                    nl = _local_rows(new, cache, list(cache.placements))
                    cache.to_local().index_copy_(dim, idx, nl.to(cache.dtype))
                return cache
        return func(*args, **kwargs)


def _marked_remat(fn, counter: _Counter):
    """``nn.remat`` marking in ``counter`` where each unit of a layer stack
    starts: as it is called, and in the backward pass where its output's
    gradient arrives (the depth extrapolation's unit boundaries)."""
    def remat(enabled, unit, *args):
        name = getattr(unit, "__qualname__", type(unit).__name__)
        counter.mark(name, False)
        out = fn(enabled, unit, *args)
        first = _tensors(out)[0]
        if first.requires_grad:
            first.register_hook(lambda grad: counter.mark(name, True))
        return out
    return remat


@contextlib.contextmanager
def _substituted(counter: _Counter, count_loops: bool, sharded: bool, grad: bool):
    """The step's functions that the dry run replaces for the duration of
    one run: chunked attention with its loops counted, not run (without
    autograd), and, on a sharded mesh, the per-device regions above and
    the ``Transformer``'s vocabulary-parallel head; a Mamba block runs on
    each device's heads.  Under autograd the
    norms run on each device's rows (``_local_rmsnorm``) and the sums and
    means of DTensors that no gradient flows through (the gradient clip's,
    the optimizer's) as ``_reduced``; without it a decode cache is written
    on its shards (``_LocalCacheWrites``).  The regions that choose a route
    write it into ``counter.routes``; under autograd each unit of a layer
    stack marks where it starts (``_marked_remat``)."""
    from repro_torch.models import hybrid, layers, mamba2, nn, transformer
    from repro_torch.train import steps

    chunked = _counted_chunked_attention(counter) if count_loops else layers.chunked_attention
    targets = [(layers, "chunked_attention", _regrouped_chunked(chunked) if sharded else chunked)]
    if sharded:
        targets += [(layers, "attention_scores", _regrouped_scores(layers.attention_scores)),
                    (steps, "lm_loss", _loss_parallel(steps.lm_loss)),
                    (transformer, "apply_moe",
                     _expert_parallel(transformer.apply_moe, counter.routes, sliced=not grad))]
        targets.append((transformer.Transformer, "_lm_head",
                        _vocab_parallel_head(transformer.Transformer._lm_head)))
        mamba = _per_head_mamba(mamba2.apply_mamba_block, mamba2.ssd_chunked, counter.routes)
        targets += [(module, "apply_mamba_block", mamba) for module in (mamba2, hybrid)]
        if grad:
            targets.append((nn, "apply_rmsnorm", _local_rmsnorm(nn.apply_rmsnorm)))
    targets = [(owner, name, _region(new) if sharded else new) for owner, name, new in targets]
    if grad:
        targets.append((nn, "remat", _marked_remat(nn.remat, counter)))
    originals = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    for owner, name, new in targets:
        setattr(owner, name, new)
    modes = contextlib.ExitStack()
    if sharded:
        modes.enter_context(_LocalReductions() if grad else _LocalCacheWrites())
    try:
        with modes:
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
    # the collectives issued while no region was active (DTensor's own plan)
    outside_regions: Dict[Tuple[str, torch.dtype, Tuple[int, ...]], int] = \
        dataclasses.field(default_factory=dict)
    # the live bytes after each allocation, and where each unit of a layer
    # stack started (``_Counter.marks``)
    timeline: array.array = dataclasses.field(default_factory=lambda: array.array("q"))
    marks: List[Tuple[str, bool, int]] = dataclasses.field(default_factory=list)

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
    """A step and its abstract inputs on a mesh; ``compile()`` runs it and
    adds to ``meta`` the routes its regions took."""

    def __init__(self, fn, args: tuple, mesh: Mesh, fake_mode, grad: bool,
                 meta: Optional[Dict[str, Any]] = None):
        self.fn, self.args, self.mesh, self.fake_mode = fn, args, mesh, fake_mode
        self.grad, self.meta = grad, meta if meta is not None else {}
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
        self.meta.update(counter.routes)
        out_locals = [getattr(t, "_local_tensor", t) for t in _tensors(out)]
        out_bytes = sum(_nbytes(t) for t in out_locals)
        memory = MemoryAnalysis(
            argument_size_in_bytes=sum(_nbytes(t) for t in arg_locals),
            output_size_in_bytes=out_bytes,
            temp_size_in_bytes=max(counter.peak - out_bytes, 0),
        )
        counts = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
        return Compiled(counter.flops, counter.bytes, memory, counter.collectives, counts,
                        counter.largest, counter.outside, counter.timeline, counter.marks)


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
      sharded (2.13 does; 2.11 refuses): no region asks it to, and the
      record says which torch ran.
    """
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
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
        return _DTensorSupport(True)
    n1 = mesh_shape[1]
    flattens = True
    y = _sharded_dtensor(mesh, fake, (n0, n1, 4), [Shard(0), Shard(1), *rest[1:]])
    try:
        with fake:
            y.reshape(n0 * n1, 4)
    except RuntimeError as e:
        if "flatten" not in str(e):
            raise
        flattens = False
    return _DTensorSupport(flattens)


# --- FSDP -------------------------------------------------------------------------------
# the params' top-level keys whose leaves stack layers on a leading axis
_STACKS = ("layers", "enc_layers", "dec_layers", "mamba_full", "mamba_rem")


@_region
def _gather(t, axes: Tuple[str, ...]):
    """All-gather a DTensor over the FSDP ``axes`` (their mesh dims become
    Replicate; the tensor-parallel ones stay).  Its gradient is brought
    back to ``t``'s placements: reduce-scattered over the FSDP axes, and
    summed where it is partial over a mesh dim that replicates ``t`` (a
    replicated parameter read by every data shard)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return t
    names = t.device_mesh.mesh_dim_names
    target = [Replicate() if n in axes else p for n, p in zip(names, t.placements)]
    if list(t.placements) == target and not torch.is_grad_enabled():
        return t
    return _moved(t, target, defer=False)


class _StackGather:
    """A stacked leaf that no product takes (a norm's scale, a scan's
    A_log): layer ``i`` all-gathered over the FSDP axes when the model
    takes it (``leaf[i]``), as FSDP gathers a layer."""

    def __init__(self, t, axes: Tuple[str, ...]):
        self.t, self.axes = t, axes

    @property
    def shape(self):
        return self.t.shape

    def __getitem__(self, i):
        return _gather(self.t[i], self.axes)


class _FsdpModel:
    """``model`` with FSDP's parameter handling: each parameter stays
    sharded over the FSDP axes until a layer uses it, then is
    all-gathered over them (the tensor-parallel axis stays sharded), and
    its gradient reduce-scattered back onto its shards.  Without it
    DTensor keeps the contraction dims sharded and gathers the
    activations instead, replicating the batch on every device.

    Each parameter sharded over the FSDP axes is a ``_SplitWeight``: every
    product runs on the device's shards (tensor parallel over the model
    axis) and the embedding is a masked lookup in the rows a device holds.
    A train or prefill step gathers each such parameter in the model's
    dtype (the cast of a shard is the shard of the cast, and the model
    casts every such parameter before it uses it): a layer's when a
    product takes it, so that under ``remat`` the gathered layer is
    dropped after the forward pass and gathered again in the backward
    pass, as FSDP reshards; the rest (the embedding, a tied or separate
    head) once for all their uses.  A decode step gathers nothing."""

    def __init__(self, model, axes: Tuple[str, ...], kind: str = "train"):
        self._model = model
        self._axes = tuple(axes)
        self._gathers = () if kind == "decode" else self._axes

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
            top = str(getattr(path[0], "key", ""))
            if self._fsdp_sharded(t) and top not in _STACKS and self._gathers:
                # outside the layers: gathered once for every use
                dtype = self._model.dtype
                leaves.append(_SplitWeight(_gather(t.to(dtype), self._gathers), dtype=dtype))
            elif self._fsdp_sharded(t):
                leaves.append(_SplitWeight(t, dtype=self._model.dtype, axes=self._gathers))
            elif top in _STACKS:
                leaves.append(_StackGather(t, self._axes))
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
_EXPERT_ROUTES = {
    "gathered": ("expert-parallel, gathered: buffers (E / model, capacity of the data shard, "
                 "d), the experts' weights all-gathered over the data axes"),
    "sliced": ("expert-parallel, sliced: buffers (E / model, capacity of the data shard, d); "
               "w_gate and w_up on their d_model slices (every shard's buffers moved to each "
               "slice, an all-to-all, the partial products reduce-scattered back), w_down "
               "all-gathered over the data axes"),
}
_PER_HEAD_SSD = ("per-head Mamba block: in_proj's columns of each device's heads, the scan on "
                 "its heads (the (P, N) state stays on it), out_proj summed over the model axis")
_PER_HEAD_DECODE = ("per-head Mamba decode: no weight or state moves; in_proj and out_proj split "
                    "products, the conv on the device's channels of the conv tail, the SSM step on "
                    "its shard of the state, the gate and output norm on its heads")
_DTENSOR_SSD = "DTensor's own plan: the Mamba block on DTensors"
_TP_PRODUCTS = ("tensor-parallel: each product on the gathered layer's model-axis shard "
                "(column then row parallel: the FFN's hidden units and the heads stay on their "
                "device, the row-parallel outputs summed over the model axis; under autograd "
                "a column-parallel input's gradient summed over the model axis, a weight's "
                "reduce-scattered over the data axes)")
_LOCAL_NORMS = ("per device: each device's rows, the scale's gradient summed over the data "
                "axes, the output's gradient over the model axis")
_LOCAL_REDUCTIONS = ("per device: the gradient clip's and the optimizer's sums and means on "
                     "each device's shards, summed over the mesh axes that split them")


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
    held (``_substituted``); ``meta`` names each route (``compile()``
    adds those that a region chooses as it runs: the MoE experts', the
    Mamba blocks').
    ``donate`` is accepted, never modelled (the port's steps run out of
    place)."""
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
    support = _adapt_dtensor(mesh) if mesh.size > 1 else _DTensorSupport(True)
    step_model = model
    split = mesh.size > 1 and bool(param_axes) and shape.kind == "decode"
    if mesh.size > 1 and param_axes:
        step_model = _FsdpModel(model, param_axes, kind=shape.kind)
        meta["weights"] = _SPLIT_WEIGHTS if split else _GATHERED_WEIGHTS
        meta["embedding"] = _SPLIT_LOOKUP
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
        if shape.kind != "decode":
            meta["products"] = _TP_PRODUCTS
        if shape.kind == "train":
            meta["norms"] = _LOCAL_NORMS
            meta["optimizer"] = _LOCAL_REDUCTIONS
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        if shape.kind == "train":
            state_sds = speclib.state_specs(model, cfg, mesh, param_axes,
                                            opt_fsdp_axes=opt_axes)
            batch_sds = speclib.batch_specs(cfg, shape, mesh)
            opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
            lowered = Lowered(make_train_step(step_model, opt), (state_sds, batch_sds), mesh, fake,
                              grad=True, meta=meta)
        elif shape.kind == "prefill":
            p_sds = speclib.params_specs(model, mesh, param_axes)
            batch_sds = speclib.batch_specs(cfg, shape, mesh)
            lowered = Lowered(make_prefill_step(step_model), (p_sds, batch_sds), mesh, fake,
                              grad=False, meta=meta)
        else:  # decode
            p_sds = speclib.params_specs(model, mesh, param_axes)
            cache_sds = speclib.cache_specs(model, cfg, shape, mesh, param_axes)
            tok_sds = speclib.token_specs(cfg, shape, mesh)
            pos_sds = speclib.sds((), torch.int32, mesh)
            lowered = Lowered(make_serve_step(step_model), (p_sds, tok_sds, cache_sds, pos_sds),
                              mesh, fake, grad=False, meta=meta)
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
    outside = {(kind, _HLO_DTYPES[dtype], shape): n
               for (kind, dtype, shape), n in compiled.outside_regions.items()}
    return {"meta": meta, "flops": compiled.flops, "bytes": compiled.bytes_accessed,
            "coll": collective_bytes(compiled.as_text()), "by_shape": by_shape,
            "outside": _bytes_by_kind(outside), "outside_by_shape": outside,
            "memory": {k: getattr(mem, k) for k in _MEM_ATTRS},
            "timeline": compiled.timeline, "marks": compiled.marks}


def _bytes_by_kind(by_shape: Dict[Tuple[str, str, Tuple[int, ...]], int]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for (kind, dtype, shape), n in by_shape.items():
        out[kind] = out.get(kind, 0) + n * math.prod(shape) * _DTYPE_BYTES[dtype]
    return out


def extrapolated_analysis(arch: str, shape_name: str, mesh: Mesh,
                          cfg: Optional[ArchConfig] = None) -> Dict[str, Any]:
    """Counts of the full-depth step from steps of 2 and 3 units of each
    layer stack (a train step: 3, 4 and 5), by Newton's forward
    differences: ``c(n) = c(b) + m D1 + m (m - 1) / 2 D2`` with m = n - b.
    Every unit is identical, so a step without autograd is affine in the
    units; a train step's FLOPs and bytes add a square term: the backward
    of each ``stack[i]`` writes a gradient the size of the whole stack.
    Exact where that holds (tested against full traces); a shorter stack
    is traced whole.  One full-width layer of a 32k prefill is tens of
    thousands of operations, so tracing 61 of them is what this avoids.
    (Not from one unit: under DTensor a stack of one lays its cache out
    otherwise, off the line.)

    Collectives and a serving step's memory are affine in the units: a
    step moves each unit's weights and activations once.  A train step
    takes the collectives' slope from its two deepest traces (a square
    term through three would scale any plan change between them by
    m (m - 1) / 2), and its peak memory from every point of them
    (``_unit_peak``).  With several stacks, each one's change adds.
    ``coll_body_once`` is the collective count with each stack's unit
    counted once, c(n) - (n - 1) slope, as the reference's HLO text lists
    a scanned stack's loop body once (None where a stack was traced
    whole)."""
    cfg = cfg or get_config(arch)
    knobs = depth_knobs(cfg)
    order = 2 if INPUT_SHAPES[shape_name].kind == "train" else 1
    first = _FIRST_TRACED[order]
    base_units = {k: first if n > first + order else n for k, (n, _) in knobs.items()}
    base = _compile_at(arch, shape_name, mesh, _at_depth(cfg, base_units))
    out = {"meta": base["meta"], "flops": base["flops"], "bytes": base["bytes"],
           "coll": dict(base["coll"]), "by_shape": dict(base["by_shape"]),
           "outside": dict(base["outside"]), "outside_by_shape": dict(base["outside_by_shape"]),
           "memory": dict(base["memory"])}
    traced = [base]
    slopes: Optional[List[Tuple[int, str, Dict[str, float]]]] = []

    for knob, (n, _) in knobs.items():
        if n == base_units[knob]:
            slopes = None
            continue
        points = [base] + [
            _compile_at(arch, shape_name, mesh,
                        _at_depth(cfg, {**base_units, knob: base_units[knob] + i}))
            for i in range(1, order + 1)]
        traced += points[1:]
        m = n - base_units[knob]
        weights = [-m, m] if order == 1 else [-m + m * (m - 1) // 2, m - m * (m - 1),
                                              m * (m - 1) // 2]
        # c(n) - c(2) as a weighted sum over the traced points
        out["flops"] += sum(w * c["flops"] for w, c in zip(weights, points))
        out["bytes"] += sum(w * c["bytes"] for w, c in zip(weights, points))
        # memory and collectives: affine through the two deepest traces
        affine = [-m, m] if order == 1 else [-1, 2 - m, m - 1]
        for attr in _MEM_ATTRS:
            out["memory"][attr] += sum(w * c["memory"][attr] for w, c in zip(affine, points))
        if order == 2:
            # a train step's peak: each position in a unit extrapolated on its own
            output = base["memory"]["output_size_in_bytes"] + sum(
                w * c["memory"]["output_size_in_bytes"] for w, c in zip(affine, points))
            temp = _unit_peak(points[-2], points[-1], first + 1, n) - output
            out["memory"]["temp_size_in_bytes"] += temp - (
                base["memory"]["temp_size_in_bytes"]
                + sum(w * c["memory"]["temp_size_in_bytes"] for w, c in zip(affine, points)))
        for field in ("coll", "by_shape", "outside", "outside_by_shape"):
            for key in set().union(*(c[field] for c in points)):
                d = sum(w * c[field].get(key, 0) for w, c in zip(affine, points))
                out[field][key] = out[field].get(key, 0) + d
        if slopes is not None:
            for field in ("coll", "outside"):
                slopes.append((n, field, {
                    kind: points[-1][field].get(kind, 0) - points[-2][field].get(kind, 0)
                    for kind in set(points[-1][field]) | set(points[-2][field])}))
    out["memory"]["temp_size_in_bytes"] = max(out["memory"]["temp_size_in_bytes"], 0)
    out["depth"] = {k: n for k, (n, _) in knobs.items()}
    out["traced_depth"] = base_units
    out["coll_body_once"] = out["outside_body_once"] = None
    if slopes is not None:
        body = {"coll": dict(out["coll"]), "outside": dict(out["outside"])}
        for n, field, slope in slopes:
            for kind, d in slope.items():
                body[field][kind] = body[field].get(kind, 0) - (n - 1) * d
        out["coll_body_once"], out["outside_body_once"] = body["coll"], body["outside"]
    # the largest single collective outside the regions in any trace
    out["outside_largest"] = max(
        [math.prod(shape) * _DTYPE_BYTES[dtype] for c in traced
         for (kind, dtype, shape), k in c["outside_by_shape"].items() if k > 0], default=0)
    return out


# the fewest units of a stack traced: a step without autograd at 2 and 3,
# a train step at 3, 4 and 5 (``_unit_peak`` reads 2 units at each end of
# the two deepest)
_FIRST_TRACED = {1: 2, 2: 3}
_END_UNITS = 2


def _unit_peak(a: Dict[str, Any], b: Dict[str, Any], d: int, n: int) -> int:
    """The peak of a train step's live bytes at ``n`` units of one layer
    stack, from its traces ``a`` at ``d`` units and ``b`` at d + 1
    (d >= 2 ``_END_UNITS``).

    Past its first and last few units, the bytes live at a given point of
    unit u's forward or backward pass are affine in u and in n (each unit
    saves its input, each adds its share of the gradients), so their
    largest is in the first or the last ``_END_UNITS`` units of each pass;
    the peak is the largest over every point of those units and of the
    code before the first unit (that after the last is the last unit's),
    each point extrapolated to n on its own.  The peak's own trace is not
    affine: at a few units it falls in one pass, at many in the other.
    Nor are a pass's first units like the rest: there the backward pass
    holds more whole-stack gradient buffers while autograd sums a stack's
    gradients (smoke zamba2: three of ``in_proj``'s at its peak), so two
    units are read at each end (held to traces of every unit for each
    family's smoke config, ``tests/test_torch_launch.py``).  The units
    are found by their marks (``_marked_remat``): the stack's is the
    function whose marks grow by r a unit."""
    import numpy as np

    def count(trace, name, backward):
        return sum(1 for unit, back, _ in trace["marks"] if unit == name and back == backward)

    grown = {name: count(b, name, False) - count(a, name, False)
             for name, _, _ in b["marks"]}
    names = [name for name, r in grown.items() if r > 0]
    if len(names) != 1:
        raise ValueError(f"no one layer stack grows with the units: {grown}")
    name, r = names[0], grown[names[0]]

    def windows(trace):
        fwd = [i for unit, back, i in trace["marks"] if unit == name and not back]
        bwd = [i for unit, back, i in trace["marks"] if unit == name and back]
        w = _END_UNITS * r
        if len(bwd) != len(fwd) or len(fwd) < 2 * w:
            raise ValueError(f"{name}: {len(fwd)} units marked forward, {len(bwd)} backward")
        t = np.frombuffer(trace["timeline"], dtype=np.int64)
        return [t[:fwd[0]], t[fwd[0]:fwd[w]], t[fwd[-w]:bwd[0]], t[bwd[0]:bwd[w]], t[bwd[-w]:]]

    peak = 0
    for wa, wb in zip(windows(a), windows(b)):
        if len(wa) != len(wb):
            raise ValueError(f"{name}: a unit allocates {len(wa)} times at {d} units, "
                             f"{len(wb)} at {d + 1}")
        if len(wb):
            peak = max(peak, int((wb + (n - d - 1) * (wb - wa)).max()))
    return peak


def run_pair(arch: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True, cfg: Optional[ArchConfig] = None) -> Dict[str, Any]:
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
            "collectives_outside_regions": counts["outside"],
            "collectives_outside_regions_body_once": counts["outside_body_once"],
            "largest_collective_outside_regions": counts["outside_largest"],
            "top_collectives": _top_collectives(counts["by_shape"]),
            "top_collectives_outside_regions": _top_collectives(counts["outside_by_shape"]),
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
        if count <= 0:
            continue
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
