"""The port's launch layer (mesh, sharding, specs, dry run) against the
JAX package, on the CPU.

  * Twins of ``tests/test_sharding_fedleo.py``'s rule tests on the port,
    with the same ``_FakeMesh``.
  * ``spec_for_leaf`` equal to the reference's on every leaf path of
    every smoke architecture's parameters and Adam, adafactor and SGD
    state, on the 16x16, 2x16x16 and FedLEO meshes, in both sharding
    modes.
  * The block each mesh coordinate holds under the port's DTensor
    placements equals JAX's ``NamedSharding.devices_indices_map`` on a
    (2, 2, 2) mesh (tuple axes included), in a subprocess with 8 fake
    JAX devices and the fake process-group backend.
  * ``batch_specs``, ``params_specs``, ``state_specs``, ``cache_specs``
    and ``token_specs`` equal the reference's ``jax.eval_shape`` shapes
    and dtypes leaf for leaf, every smoke architecture, every input
    shape, and allocate nothing (fake tensors).
  * A twin of ``tests/test_dryrun_launch.py`` in a subprocess (8 ranks on
    the fake backend, the same three pairs at seq 256, batch 8), with its
    parser test on the same HLO string; FLOPs per device on one sharded
    matmul counted by hand; a repeated compile counts the same.
  * FLOPs: exact on a hand-counted MLP train step; each smoke
    architecture's compiled FLOPs against the analytic 6 N D within
    [0.95, 1.30] (seamless [1.5, 1.8]: its 1024 source frames are not in
    the analytic token count); the depth extrapolation and the counted
    chunk loops equal full traces.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import pytest
import torch

from repro.configs import build_model as ref_build_model
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import INPUT_SHAPES as REF_SHAPES
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.launch.mesh import make_mesh_compat as ref_mesh
from repro.optim import get_optimizer as ref_optimizer
from repro_torch.compute import roofline
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, build_model, get_smoke_config
from repro_torch.configs import base as tbase
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import (
    make_fedleo_mesh,
    make_mesh_compat,
    make_production_mesh,
)
from repro_torch.launch.sharding import P, _path_str, batch_sharding, spec_for_leaf
from repro_torch.optim import get_optimizer
from repro_torch.tree import tree_flatten_with_path, tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _FakeMesh:
    axis_names = ("pod", "data", "model")
    shape = {"pod": 2, "data": 16, "model": 16}


# --- rules: twins of tests/test_sharding_fedleo.py ---------------------------------
def test_spec_rules():
    mesh = _FakeMesh()
    s = spec_for_leaf("layers/block0/attn/wq", (12288, 96, 128), mesh)
    assert s == P("data", "model", None)
    s = spec_for_leaf("layers/block0/attn/wk", (12288, 8, 128), mesh)
    assert s == P("data", None, None)
    s = spec_for_leaf("layers/block0/ffn/w_gate", (88, 12288, 28672), mesh)
    assert s == P(None, "data", "model")
    s = spec_for_leaf("layers/block0/moe/w_gate", (61, 384, 7168, 2048), mesh)
    assert s == P(None, "model", "data", None)
    s = spec_for_leaf("layers/block0/moe/shared/w_gate", (7168, 4096), mesh)
    assert s == P("data", "model")
    s = spec_for_leaf("layers/block0/ln_attn/scale", (88, 12288), mesh)
    assert s == P(None, None)
    s = spec_for_leaf("embed/table", (32768, 12288), mesh)
    assert s == P("model", "data")
    s = spec_for_leaf("opt_state/factored/w_gate", (12288,), mesh)
    assert s == P(None)


def test_batch_sharding_policy():
    mesh = _FakeMesh()
    assert batch_sharding(mesh, 256) == ("pod", "data")
    assert batch_sharding(mesh, 32) == ("pod", "data")
    assert batch_sharding(mesh, 2) == ("pod",)
    assert batch_sharding(mesh, 1) == ()


def test_meshes_expose_what_the_rules_read():
    mesh = make_production_mesh(multi_pod=True)
    assert mesh.axis_names == ("pod", "data", "model")
    assert (mesh.shape["pod"], mesh.shape["data"], mesh.shape["model"]) == (2, 16, 16)
    assert mesh.devices.shape == (2, 16, 16) and mesh.size == 512
    fed = make_fedleo_mesh(num_orbits=4)
    assert fed.devices.shape == (4, 4, 16) and fed.axis_names == ("orbit", "data", "model")
    assert make_mesh_compat((1, 1), ("data", "model")).device_mesh is None
    with pytest.raises(ValueError):
        make_fedleo_mesh(num_orbits=3)


# --- spec_for_leaf against the reference, leaf by leaf ----------------------------
def _ref_paths(tree):
    pairs, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jsharding._path_str(p), tuple(x.shape)) for p, x in pairs]


def _port_paths(tree):
    pairs, _ = tree_flatten_with_path(tree)
    return [(_path_str(p), tuple(x.shape)) for p, x in pairs]


class _Mesh:
    """The mesh attributes ``spec_for_leaf`` reads, for the reference."""

    def __init__(self, mesh):
        self.axis_names, self.shape = mesh.axis_names, dict(mesh.shape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_leaf_equals_reference_on_every_leaf(arch):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    rmodel, model = ref_build_model(rcfg), build_model(cfg, device="cpu")
    rparams = jax.eval_shape(rmodel.init, jax.random.PRNGKey(0))
    with specs.fake_mode():
        params = model.init(torch.Generator().manual_seed(0))
    trees = [(_ref_paths(rparams), _port_paths(params))]
    for name in ("adam", "adafactor", "sgd"):
        rstate = jax.eval_shape(ref_optimizer(name, 1e-3).init, rparams)
        with specs.fake_mode():
            state = get_optimizer(name, 1e-3).init(params)
        trees.append((_ref_paths(rstate), _port_paths(state)))
    meshes = [(make_production_mesh(), None), (make_production_mesh(multi_pod=True), None),
              (make_fedleo_mesh(num_orbits=4), "orbit")]
    checked = 0
    for ref_leaves, port_leaves in trees:
        assert ref_leaves == port_leaves
        for mesh, replica in meshes:
            for fsdp in (("data",), ()):            # FSDP-2D and ZeRO-1's params
                for path, shape in port_leaves:
                    if replica is not None:
                        shape = (4,) + shape
                    ours = spec_for_leaf(path, shape, mesh, fsdp, leading_replica_axis=replica)
                    ref = jsharding.spec_for_leaf(path, shape, _Mesh(mesh), fsdp,
                                                  leading_replica_axis=replica)
                    assert tuple(ours) == tuple(ref), (path, shape, mesh, fsdp)
                    checked += 1
    assert checked > 100


# --- abstract inputs against jax.eval_shape -----------------------------------------
def _ref_sds_leaves(tree):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree_util.tree_leaves(tree)]


def _port_sds_leaves(tree):
    out = []
    for s in tree_leaves(tree):
        assert isinstance(s.value, torch._subclasses.fake_tensor.FakeTensor)   # allocates nothing
        out.append((s.shape, str(s.dtype).replace("torch.", "")))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference_eval_shape(arch):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    rmesh, mesh = ref_mesh((1, 1), ("data", "model")), make_mesh_compat((1, 1), ("data", "model"))
    rmodel, model = ref_build_model(rcfg), build_model(cfg, device="cpu")
    assert _port_sds_leaves(specs.params_specs(model, mesh)) == \
        _ref_sds_leaves(jspecs.params_specs(rmodel, rmesh))
    assert _port_sds_leaves(specs.state_specs(model, cfg, mesh)) == \
        _ref_sds_leaves(jspecs.state_specs(rmodel, rcfg, rmesh))
    assert _port_sds_leaves(specs.state_specs(model, cfg, mesh, (), opt_fsdp_axes=("data",))) \
        == _ref_sds_leaves(jspecs.state_specs(rmodel, rcfg, rmesh, (), opt_fsdp_axes=("data",)))
    for name, shape in INPUT_SHAPES.items():
        ref_shape = REF_SHAPES[name]
        assert specs.sliding_window_for(cfg, shape) == jspecs.sliding_window_for(rcfg, ref_shape)
        if shape.kind == "decode":
            ours = [specs.token_specs(cfg, shape, mesh)]
            ref = [jspecs.token_specs(rcfg, ref_shape, rmesh)]
            if name == "decode_32k":     # the caches, at one decode shape
                ours.append(specs.cache_specs(model, cfg, shape, mesh))
                ref.append(jspecs.cache_specs(rmodel, rcfg, ref_shape, rmesh))
        else:
            ours = [specs.batch_specs(cfg, shape, mesh)]
            ref = [jspecs.batch_specs(rcfg, ref_shape, rmesh)]
        for o, r in zip(ours, ref):
            assert _port_sds_leaves(o) == _ref_sds_leaves(r), (arch, name)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.sharding import placements

    mesh = make_production_mesh(multi_pod=True)
    assert placements(P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        placements(P(("data", "pod"), None), mesh)       # not pod-major
    with pytest.raises(ValueError):
        placements(P("model", "model"), mesh)


# --- the dry run on 8 fake ranks (subprocess) ---------------------------------------
_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import numpy as np
import torch
import torch.distributed as dist

out = {}
# the block layout of the port's placements against JAX's, per coordinate
import jax
from jax.sharding import NamedSharding, PartitionSpec as JP
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro.launch.mesh import make_mesh_compat as ref_mesh
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.launch.sharding import P, placements

AXES = ("pod", "data", "model")
LEAVES = [((8, 4), (("pod", "data"), None)), ((8, 4), (("pod", "data"), "model")),
          ((4, 6, 8), (None, "model", ("pod", "data"))), ((16,), (("pod", "data", "model"),)),
          ((6, 8), ("data", None)), ((6, 8), (None, "pod")), ((2, 4, 8), ("pod", "data", "model")),
          ((4, 12), ("model", ("pod", "data"))), ((8, 2, 6), (("data", "model"), None, None)),
          ((3, 5), (None, None)), ((4, 4, 4, 2), (None, ("pod", "model"), "data", None)),
          ((2, 8), (None, ("pod", "data", "model")))]
jmesh = ref_mesh((2, 2, 2), AXES)
pmesh = make_mesh_compat((2, 2, 2), AXES)
mismatch = []
for rank in range(8):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
    dm = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=AXES)
    coord = np.unravel_index(rank, (2, 2, 2))
    device = jmesh.devices[coord]
    for shape, spec in LEAVES:
        jmap = NamedSharding(jmesh, JP(*spec)).devices_indices_map(shape)
        want = [(s.start or 0, s.stop if s.stop is not None else n)
                for s, n in zip(jmap[device], shape)]
        local, offset = compute_local_shape_and_global_offset(
            shape, dm, placements(P(*spec), pmesh))
        got = [(o, o + l) for o, l in zip(offset, local)]
        if got != want:
            mismatch.append([rank, list(shape), str(spec), got, want])
    dist.destroy_process_group()
out["layout_mismatch"] = mismatch
out["layout_checked"] = 8 * len(LEAVES)

# the twin of tests/test_dryrun_launch.py
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch.dryrun import Lowered, collective_bytes, cost_analysis_dict, lower_pair
mesh = make_mesh_compat((2, 2, 2), AXES)
for arch, shape in [("gemma-7b", "train_4k"),
                    ("kimi-k2-1t-a32b", "train_4k"),
                    ("mamba2-780m", "decode_32k")]:
    cfg = get_smoke_config(arch)
    sh = INPUT_SHAPES[shape]
    INPUT_SHAPES[shape] = dataclasses.replace(sh, seq_len=256, global_batch=8)
    try:
        lowered, meta = lower_pair(arch, shape, mesh, cfg=cfg)
        compiled = lowered.compile()
        cost = cost_analysis_dict(compiled)
        coll = collective_bytes(compiled.as_text())
        out[f"{arch}|{shape}"] = {
            "ok": True,
            "flops": float(cost.get("flops", -1)),
            "collectives": {k: float(v) for k, v in coll.items()},
            "counts": compiled.collective_counts,
            "mesh": meta["mesh"],
        }
        if arch == "mamba2-780m":     # a second compile counts the same
            again = lower_pair(arch, shape, mesh, cfg=cfg)[0].compile()
            out["repeat_equal"] = (again.cost_analysis() == compiled.cost_analysis()
                                   and again.memory == compiled.memory)
    finally:
        INPUT_SHAPES[shape] = sh

# FLOPs per device: one sharded matmul, (64, 32) @ (32, 48), rows over pod and
# data (4), columns over model (2): each device multiplies 16 rows by 24 columns
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.launch.sharding import NamedSharding as PNS, ShapeDtypeStruct
fake = FakeTensorMode(allow_non_fake_inputs=True)
with fake:
    x = ShapeDtypeStruct(torch.empty(64, 32), PNS(mesh, P(("pod", "data"), None)))
    w = ShapeDtypeStruct(torch.empty(32, 48), PNS(mesh, P(None, "model")))
mm = Lowered(lambda a, b: a @ b, (x, w), mesh, fake, grad=False).compile()
out["matmul_flops"] = mm.flops
out["matmul_memory"] = [mm.memory.argument_size_in_bytes, mm.memory.output_size_in_bytes]

# what the dry run fits to an older DTensor, held on this one: the strategies
# it registers for flip and index_copy_ where a torch has none, and the
# per-device embedding lookup where a torch cannot shard the lookup's backward
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
from torch.distributed.tensor.experimental import register_sharding
from repro_torch.launch import dryrun
support = dryrun._adapt_dtensor(mesh)
out["support"] = [support.flattens_sharded_dims, support.embedding_backward]
register_sharding(torch.ops.aten.flip.default)(dryrun._flip_sharding)
DTensor._op_dispatcher.sharding_propagator.op_to_schema_info[
    torch.ops.aten.flip.default] = RuntimeSchemaInfo(1, needs_pytree=True)
register_sharding(torch.ops.aten.index_copy_.default)(dryrun._index_copy_sharding)
x = dryrun._sharded_dtensor(mesh, fake, (4, 8, 4), [Shard(0), Shard(1), Replicate()])
with fake:
    out["flip1"] = [str(p) for p in torch.flip(x, [1]).placements]
    out["flip0"] = [str(p) for p in torch.flip(x, [0]).placements]
c = dryrun._sharded_dtensor(mesh, fake, (4, 8, 4), [Shard(0), Replicate(), Shard(2)])
src = dryrun._sharded_dtensor(mesh, fake, (4, 1, 4), [Shard(0), Replicate(), Replicate()])
with fake, dryrun.use_mesh_compat(mesh):
    c.index_copy_(1, torch.zeros(1, dtype=torch.int64), src)
out["index_copy"] = [str(p) for p in c.placements] + [list(c.to_local().shape)]
table = dryrun._sharded_dtensor(mesh, fake, (16, 8), [Replicate(), Shard(1), Shard(0)])
tok = dryrun._sharded_dtensor(mesh, fake, (8, 5), [Shard(0), Shard(0), Replicate()],
                             torch.int64)
with fake:
    with torch.enable_grad():
        leaf = table.detach().requires_grad_(True)
        rows = dryrun._LocalLookup(leaf, ("pod", "data"))[tok]
        (grad,) = torch.autograd.grad(rows.sum(), leaf)
out["lookup"] = [list(rows.shape), [str(p) for p in rows.placements],
                 list(rows.to_local().shape), [str(p) for p in grad.placements],
                 list(grad.shape)]
print("RESULT:" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def dryrun_result():
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        capture_output=True, text=True, timeout=600, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT:")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[0][len("RESULT:"):])


def test_placement_blocks_equal_jax(dryrun_result):
    assert dryrun_result["layout_checked"] == 96
    assert dryrun_result["layout_mismatch"] == []


def test_lower_compile_on_multipod_mesh(dryrun_result):
    pairs = [k for k in dryrun_result if "|" in k]
    assert len(pairs) == 3
    for key in pairs:
        rec = dryrun_result[key]
        assert rec["ok"] and rec["mesh"] == "2x2x2", key
        assert rec["flops"] > 0, key


def test_train_step_has_gradient_collectives(dryrun_result):
    rec = dryrun_result["gemma-7b|train_4k"]
    assert sum(rec["collectives"].values()) > 0
    # CommDebugMode saw collectives of the same kinds
    assert sum(rec["counts"].values()) > 0


def test_moe_dispatch_lowered(dryrun_result):
    assert dryrun_result["kimi-k2-1t-a32b|train_4k"]["ok"]


def test_dtensor_fitting(dryrun_result):
    """This torch's DTensor needs no fitting; the fitting an older one
    gets holds here: flip keeps a shard only off the flipped dims,
    index_copy_ keeps self's placement, the per-device lookup's rows are
    placed as the tokens and the table's gradient as the table."""
    assert dryrun_result["support"] == [True, True]
    # no mesh dim shards a flipped dim (which other dims stay sharded is
    # DTensor's cost-based choice)
    assert "S(1)" not in dryrun_result["flip1"] and "S(0)" in dryrun_result["flip1"]
    assert "S(0)" not in dryrun_result["flip0"] and "S(1)" in dryrun_result["flip0"]
    assert dryrun_result["index_copy"] == ["S(0)", "R", "S(2)", [2, 8, 2]]
    shape, placements, local, grad_placements, grad_shape = dryrun_result["lookup"]
    assert (shape, placements, local) == ([8, 5, 8], ["S(0)", "S(0)", "R"], [2, 5, 8])
    assert grad_shape == [16, 8] and grad_placements == ["R", "S(1)", "S(0)"]


def test_repeated_compile_counts_the_same(dryrun_result):
    assert dryrun_result["repeat_equal"] is True


def test_flops_are_per_device(dryrun_result):
    # 2 * 16 rows * 32 * 24 columns on each of the 8 devices (global: 2 * 64 * 32 * 48)
    assert dryrun_result["matmul_flops"] == 2 * 16 * 32 * 24
    # x's (16, 32) and w's (32, 24) float32 shards in, out's (16, 24) shard
    assert dryrun_result["matmul_memory"] == [(16 * 32 + 32 * 24) * 4, 16 * 24 * 4]


def test_collective_bytes_parser():
    from repro_torch.launch.dryrun import collective_bytes

    hlo = """
      %ag = bf16[8,128]{1,0} all-gather(%x), dimensions={0}
      %ar.1 = f32[64]{0} all-reduce(%y), to_apply=%add
      %a2a = (f32[4,4]{1,0}, f32[4,4]{1,0}) all-to-all(%p, %q)
      %done = f32[64]{0} all-reduce-done(%ar.1)
    """
    out = collective_bytes(hlo)
    assert out["all-gather"] == 8 * 128 * 2
    assert out["all-reduce"] == 64 * 4
    assert out["all-to-all"] == 2 * 16 * 4


def test_as_text_round_trips_through_the_parser():
    compiled = dryrun.Compiled(
        flops=0, bytes_accessed=0, memory=dryrun.MemoryAnalysis(0, 0, 0),
        collectives={("all-gather", torch.bfloat16, (8, 128)): 2,
                     ("reduce-scatter", torch.float32, (64,)): 1},
        collective_counts={})
    assert dryrun.collective_bytes(compiled.as_text()) == {
        "all-gather": 2 * 8 * 128 * 2, "reduce-scatter": 64 * 4}


# --- FLOP counts ------------------------------------------------------------------------
def test_flops_exact_on_a_hand_counted_train_step():
    """relu(x @ w1) @ w2, summed: forward 2Bdh + 2Bho; backward 2Bho
    (grad w2) + 2Bho (grad h) + 2Bdh (grad w1); x takes no gradient."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.sharding import ShapeDtypeStruct

    B, d, h, o = 8, 16, 32, 4

    def step(x, w1, w2):
        with torch.enable_grad():
            w1, w2 = w1.requires_grad_(True), w2.requires_grad_(True)
            loss = (torch.relu(x @ w1) @ w2).sum()
            return torch.autograd.grad(loss, (w1, w2))

    mesh = make_mesh_compat((1, 1), ("data", "model"))
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        args = tuple(ShapeDtypeStruct(torch.empty(s)) for s in ((B, d), (d, h), (h, o)))
    compiled = dryrun.Lowered(step, args, mesh, fake, grad=True).compile()
    assert compiled.cost_analysis()["flops"] == 2 * (2 * B * d * h) + 3 * (2 * B * h * o)
    assert compiled.memory.argument_size_in_bytes == 4 * (B * d + d * h + h * o)
    assert compiled.memory.output_size_in_bytes == 4 * (d * h + h * o)


_BANDS = {"seamless-m4t-large-v2": (1.5, 1.8)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_compiled_flops_within_band_of_analytic(arch):
    ours = roofline.compiled_step_cost(arch, "train_4k")
    analytic = roofline.analytic_step_cost(arch, "train_4k", True)
    lo, hi = _BANDS.get(arch, (0.95, 1.30))
    assert lo <= ours.flops / analytic.flops <= hi
    assert ours.hbm_bytes > 0 and ours.tokens == analytic.tokens


def _with_shape(name, **kw):
    small = dataclasses.replace(INPUT_SHAPES[name], name=f"_test_{name}", **kw)
    tbase.INPUT_SHAPES[small.name] = small
    return small.name


def test_depth_extrapolation_equals_full_trace():
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    name = _with_shape("train_4k", seq_len=64, global_batch=2)
    try:
        for arch, layers in (("gemma-7b", 5), ("zamba2-1.2b", 26)):
            cfg = dataclasses.replace(get_smoke_config(arch), num_layers=layers)
            full = dryrun.lower_pair(arch, name, mesh, cfg=cfg)[0].compile()
            ext = dryrun.extrapolated_analysis(arch, name, mesh, cfg=cfg)
            assert ext["traced_depth"] != ext["depth"]
            assert ext["flops"] == full.flops
            assert ext["bytes"] == full.bytes_accessed
            assert ext["memory"]["argument_size_in_bytes"] == full.memory.argument_size_in_bytes
    finally:
        tbase.INPUT_SHAPES.pop(name)


def test_counted_chunk_loops_equal_running_them():
    mesh = make_mesh_compat((1, 1), ("data", "model"))
    name = _with_shape("prefill_32k", seq_len=1536, global_batch=2)
    try:
        runs = []
        for counted in (True, False):
            lowered, _ = dryrun.lower_pair("phi3-medium-14b", name, mesh,
                                           cfg=get_smoke_config("phi3-medium-14b"))
            assert lowered.count_loops
            lowered.count_loops = counted
            runs.append(lowered.compile())
        assert runs[0].cost_analysis() == runs[1].cost_analysis()
        assert runs[0].memory == runs[1].memory
    finally:
        tbase.INPUT_SHAPES.pop(name)
