"""The dry run's per-device regions compute what they replace.

Each region runs on real tensors on a (2, 2) data x model mesh under
torch's ``LocalTensorMode`` (one process holds every rank's shard and
computes the collectives), smoke configs in float32, and its output
equals the plain unsharded function's within 1e-5 of the largest value:

  * whole decode steps with the weights where ``params_specs`` puts them
    (``_SplitWeight``: the products, the lookup, the vocabulary-parallel
    head, the caches written on their shards, the MoE experts with their
    d_model slices, the key positions split over an idle data axis at a
    batch of one) -- the logits and every leaf of the new cache;
  * whole prefill steps (tensor-parallel products on the gathered
    layers, the per-head Mamba block, regrouped chunked attention);
  * the loss-parallel cross-entropy, and the expert-parallel MoE of a
    prefill against the plain MoE on each data shard's tokens (its
    capacity is the shard's, so a MoE model's whole prefill step is not
    the plain one's wherever a token is dropped);
  * a train step's per-head SSD scan, its outputs and the gradients of
    its inputs under autograd.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TOLERANCE = 1e-5
# (kind, arch, global batch); decode batches avoid the smoke stacks' 2 layers,
# which cache_specs would take for a batch dim
STEPS = [("decode", "gemma-7b", 4), ("decode", "gemma-7b", 1),
         ("decode", "mamba2-780m", 4), ("decode", "mamba2-780m", 1),
         ("decode", "zamba2-1.2b", 4), ("decode", "kimi-k2-1t-a32b", 4),
         ("decode", "llama4-maverick-400b-a17b", 4), ("decode", "seamless-m4t-large-v2", 1),
         ("decode", "internvl2-26b", 4),
         ("prefill", "gemma-7b", 4), ("prefill", "mistral-large-123b", 4),
         ("prefill", "mamba2-780m", 4), ("prefill", "zamba2-1.2b", 4),
         ("prefill", "seamless-m4t-large-v2", 2)]
REGIONS = ["loss_parallel", "expert_parallel", "per_head_ssd"]
CASES = [f"{k}|{a}|{b}" for k, a, b in STEPS] + REGIONS

_RUN = r'''
import dataclasses, json, sys
import torch
from torch.distributed._local_tensor import LocalTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import dryrun, specs as speclib
from repro_torch.launch.mesh import Mesh, use_mesh_compat
from repro_torch.models import mamba2, moe
from repro_torch.train.steps import lm_loss, make_prefill_step, make_serve_step
from repro_torch.tree import tree_leaves, tree_map

SEQ, POS = 64, 5
mesh = Mesh((2, 2), ("data", "model"))
steps = json.loads(sys.argv[1])
out = {}


def place(real, spec):
    """``real`` laid out as its spec (a replicated input stays plain, as
    the dry run's ``Lowered`` leaves it)."""
    pl = spec.sharding.placements
    if not any(isinstance(p, Shard) for p in pl):
        return real
    return distribute_tensor(real, mesh.device_mesh, list(pl))


def error(got, want):
    """Largest difference over every rank's copy of ``got``, relative to
    ``want``'s largest value."""
    full = got.full_tensor() if isinstance(got, DTensor) else got
    ranks = getattr(full, "_local_tensors", {0: full})
    scale = want.abs().max().clamp(min=1e-30)
    return max(float((t - want).abs().max() / scale) for t in ranks.values())


for kind, arch, batch in steps:
    torch.manual_seed(0)
    cfg = get_smoke_config(arch)
    base = "decode_32k" if kind == "decode" else "prefill_32k"
    shape = dataclasses.replace(INPUT_SHAPES[base], global_batch=batch, seq_len=SEQ)
    model = build_model(cfg, dtype=torch.float32, device="cpu",
                        attn_impl="xla" if kind == "decode" else "chunked")
    params = model.init(torch.Generator().manual_seed(0))
    with speclib.fake_mode():
        p_specs = speclib.params_specs(model, mesh, ("data",))
        b_specs = speclib.batch_specs(cfg, shape, mesh)
    extra = {}
    if "source" in b_specs:
        extra["source"] = torch.randn(b_specs["source"].shape)
    if "extra" in b_specs:
        extra["extra"] = torch.randn(b_specs["extra"].shape)
    if kind == "decode":
        tokens = torch.randint(0, cfg.vocab_size, (batch, 1), dtype=torch.int32)
        if cfg.family == "audio":
            cache = model.init_cache(params, extra["source"], max_len=SEQ, dtype=torch.float32)
        else:
            cache = model.init_cache(batch, SEQ, dtype=torch.float32)
        cache = tree_map(lambda t: torch.full_like(t, POS) if t.dtype == torch.int32
                         else torch.randn(t.shape, dtype=t.dtype), cache)
        with speclib.fake_mode():
            c_specs = speclib.cache_specs(model, cfg, shape, mesh, ("data",))
            t_specs = speclib.token_specs(cfg, shape, mesh)
        plain_cache = tree_map(torch.clone, cache)
        want = [make_serve_step(model)(params, tokens, plain_cache, POS)[0]]
        want += tree_leaves(plain_cache)
    else:
        tokens = torch.randint(0, cfg.vocab_size, (batch, SEQ), dtype=torch.int32)
        want = [make_prefill_step(model)(params, {"tokens": tokens, **extra})]
    with LocalTensorMode(4):
        sparams = tree_map(place, params, p_specs)
        if kind == "decode":
            scache = tree_map(place, cache, c_specs)
            step = make_serve_step(dryrun._FsdpModel(model, ("data",), False, kind))
            args = (sparams, place(tokens, t_specs), scache, POS)
        else:
            step = make_prefill_step(dryrun._FsdpModel(model, ("data",), False, kind))
            sbatch = {k: place(v, b_specs[k]) for k, v in {"tokens": tokens, **extra}.items()}
            args = (sparams, sbatch)
        with dryrun._substituted(None, False, True, False), use_mesh_compat(mesh):
            got = step(*args)
        got = [got[0]] + tree_leaves(scache) if kind == "decode" else [got]
        out[f"{kind}|{arch}|{batch}"] = max(error(g, w) for g, w in zip(got, want))

torch.manual_seed(1)
logits, tokens = torch.randn(4, 16, 64), torch.randint(0, 64, (4, 16), dtype=torch.int32)
with LocalTensorMode(4):
    dm = mesh.device_mesh
    got = dryrun._loss_parallel(lm_loss)(distribute_tensor(logits, dm, [Shard(0), Shard(2)]),
                                         distribute_tensor(tokens, dm, [Shard(0), Replicate()]))
    out["loss_parallel"] = error(got, lm_loss(logits, tokens))

cfg = get_smoke_config("kimi-k2-1t-a32b")
model = build_model(cfg, dtype=torch.float32, device="cpu")
block = model.init(torch.Generator().manual_seed(2))["layers"]["block0"]["moe"]
params = tree_map(lambda t: t[0], block)
x = torch.randn(4, 8, cfg.d_model)
want = torch.cat([moe.apply_moe(params, half, cfg.moe, cfg.activation)[0]
                  for half in x.chunk(2)])
with LocalTensorMode(4):
    dm = mesh.device_mesh
    sharded = {"router": distribute_tensor(params["router"], dm, [Replicate(), Replicate()]),
               "shared": {k: distribute_tensor(v, dm, [Replicate(), Shard(1 if k != "w_down" else 0)])
                          for k, v in params["shared"].items()}}
    sharded.update({k: distribute_tensor(params[k], dm, [Replicate(), Shard(0)])
                    for k in ("w_gate", "w_up", "w_down")})
    got, _ = dryrun._expert_parallel(moe.apply_moe)(
        sharded, distribute_tensor(x, dm, [Shard(0), Replicate()]), cfg.moe, cfg.activation)
    out["expert_parallel"] = error(got, want)

# the train step's per-head scan: its outputs and every input's gradient
torch.manual_seed(3)
b, s, h, p, g, n = 4, 32, 4, 8, 1, 16
inputs = (torch.randn(b, s, h, p), torch.rand(b, s, h) + 0.1, -torch.rand(h) - 0.5,
          torch.randn(b, s, g, n), torch.randn(b, s, g, n))
plain = [t.clone().requires_grad_(True) for t in inputs]
y, state = mamba2.ssd_chunked(*plain, chunk=8)
(y.square().sum() + state.square().sum()).backward()
want = [y.detach(), state.detach()] + [t.grad for t in plain]
with LocalTensorMode(4):
    dm = mesh.device_mesh
    batch = [Shard(0), Replicate()]
    sharded = [distribute_tensor(t, dm, batch if t.ndim > 1 else [Replicate(), Replicate()])
               .requires_grad_(True) for t in inputs]
    with torch.enable_grad():
        y, state = dryrun._per_head_ssd(mamba2.ssd_chunked)(*sharded, chunk=8)
        (y.square().sum() + state.square().sum()).backward()
    got = [y, state] + [t.grad for t in sharded]
    out["per_head_ssd"] = max(error(gt, w) for gt, w in zip(got, want))
print("RESULT:" + json.dumps(out))
'''


@pytest.fixture(scope="module")
def errors():
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run([sys.executable, "-c", _RUN, json.dumps(STEPS)], capture_output=True,
                          text=True, timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT:")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[0][len("RESULT:"):])


@pytest.mark.parametrize("case", CASES)
def test_region_matches_plain(errors, case):
    assert errors[case] <= TOLERANCE, (case, errors[case])
