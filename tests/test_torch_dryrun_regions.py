"""The dry run's per-device regions compute what they replace.

Each region runs on real tensors on a (2, 2) data x model mesh under
torch's ``LocalTensorMode`` (one process holds every rank's shard and
computes the collectives), smoke configs in float32, and its output
equals the plain unsharded function's within 1e-5 of the largest value:

  * whole decode steps with the weights where ``params_specs`` puts them
    (``_SplitWeight``: the products, the lookup, the vocabulary-parallel
    head, the caches written on their shards, the MoE experts with their
    d_model slices, the key positions split over an idle data axis at a
    batch of one, the Mamba block per head on the shards of its conv tail
    and SSM state, whichever dim of the state the model axis splits) --
    the logits, every leaf of the cache written in place and every leaf
    of the new cache the step returns;
  * whole prefill steps (tensor-parallel products on the gathered
    layers, the per-head Mamba block, regrouped chunked attention);
  * whole train steps (the same regions under autograd, the norms on
    each device's rows): the loss and every gradient leaf, and the
    optimizer's update of the same gradients (the gradient clip's and the
    optimizer's sums and means on each device's shards);
  * the loss-parallel cross-entropy, and the expert-parallel MoE against
    the plain MoE on each data shard's tokens (its capacity is the
    shard's, so a MoE model's whole step is not the plain one's wherever
    a token is dropped: a MoE train step is held to the plain step's
    mean over the data shards), with its weights gathered (forward and
    gradients: a train step's route) and with ``w_gate`` and ``w_up`` on
    their d_model slices (forward: a prefill's route), each case the
    route the region reports it took.

The train steps run in a second process beside the rest.
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
         ("decode", "zamba2-1.2b", 4), ("decode", "zamba2-1.2b", 1),
         ("decode", "kimi-k2-1t-a32b", 4),
         ("decode", "llama4-maverick-400b-a17b", 4), ("decode", "seamless-m4t-large-v2", 1),
         ("decode", "internvl2-26b", 4),
         ("prefill", "gemma-7b", 4), ("prefill", "mistral-large-123b", 4),
         ("prefill", "mamba2-780m", 4), ("prefill", "zamba2-1.2b", 4),
         ("prefill", "seamless-m4t-large-v2", 2)]
# the SSM decode step with its state split over the model axis on another dim
# than the state dim (cache_specs takes the last dim that splits): an odd state
# dim leaves the head dim; an odd head dim as well, the heads
STATE_SPLITS = [("decode", "mamba2-780m", 4, {"state_dim": 9}),
                ("decode", "mamba2-780m", 4, {"d_model": 288, "head_dim": 9, "state_dim": 9})]
TRAIN_STEPS = [("train", "gemma-7b", 4), ("train", "mistral-large-123b", 4),
               ("train", "mamba2-780m", 4), ("train", "zamba2-1.2b", 4),
               ("train", "kimi-k2-1t-a32b", 4)]
REGIONS = ["loss_parallel", "expert_parallel|gathered", "expert_parallel|sliced"]


def _case(kind, arch, batch, ssm=None) -> str:
    return "|".join([kind, arch, str(batch)] + [f"{k}={v}" for k, v in (ssm or {}).items()])


CASES = [_case(*step) for step in STEPS + STATE_SPLITS + TRAIN_STEPS] + REGIONS

_RUN = r'''
import dataclasses, json, sys
import torch
from torch.distributed._local_tensor import LocalTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import dryrun, specs as speclib
from repro_torch.launch.mesh import Mesh, use_mesh_compat
from repro_torch.models import moe
from repro_torch.optim import clip_by_global_norm, get_optimizer
from repro_torch.train import steps as stepslib
from repro_torch.train.steps import lm_loss, make_prefill_step, make_serve_step
from repro_torch.tree import tree_leaves, tree_map

SEQ, POS = 64, 5
mesh = Mesh((2, 2), ("data", "model"))
steps, regions = json.loads(sys.argv[1])
out = {}


def place(real, spec, keep_replicated=True):
    """``real`` laid out as its spec (a replicated input stays plain, as
    the dry run's ``Lowered`` leaves it without autograd)."""
    pl = spec.sharding.placements
    if keep_replicated and not any(isinstance(p, Shard) for p in pl):
        return real
    return distribute_tensor(real, mesh.device_mesh, list(pl))


def error(got, want):
    """Largest difference over every rank's copy of ``got``, relative to
    ``want``'s largest value."""
    full = got.full_tensor() if isinstance(got, DTensor) else got
    ranks = getattr(full, "_local_tensors", {0: full})
    scale = want.abs().max().clamp(min=1e-30)
    return max(float((t - want).abs().max() / scale) for t in ranks.values())


def train_step(arch, batch):
    """The loss, every gradient leaf and the optimizer's update of the
    same gradients, sharded against plain (a MoE model against the mean
    of the plain step over each data shard's tokens)."""
    torch.manual_seed(0)
    cfg = get_smoke_config(arch)
    shape = dataclasses.replace(INPUT_SHAPES["train_4k"], global_batch=batch, seq_len=SEQ)
    model = build_model(cfg, dtype=torch.float32, device="cpu", attn_impl="chunked")
    params = model.init(torch.Generator().manual_seed(0))
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    with speclib.fake_mode():
        s_specs = speclib.state_specs(model, cfg, mesh, ("data",))
        b_specs = speclib.batch_specs(cfg, shape, mesh)
    data = {"tokens": torch.randint(0, cfg.vocab_size, (batch, SEQ), dtype=torch.int32)}
    loss_fn = stepslib._loss_fn(model)
    if cfg.moe is not None:
        shards = [stepslib._value_and_grad(loss_fn, params, {k: v.chunk(2)[i]
                                                             for k, v in data.items()})
                  for i in range(2)]
        total = (shards[0][0][0] + shards[1][0][0]) / 2
        grads = tree_map(lambda a, b: (a + b) / 2, shards[0][1], shards[1][1])
    else:
        (total, _), grads = stepslib._value_and_grad(loss_fn, params, data)
    opt_state = opt.init(params)
    updates, _ = opt.update(clip_by_global_norm(grads, 1.0), opt_state, params)
    with LocalTensorMode(4):
        sparams = tree_map(lambda t, sp: place(t, sp, False), params, s_specs.params)
        sbatch = {k: place(v, b_specs[k], False) for k, v in data.items()}
        sloss = stepslib._loss_fn(dryrun._FsdpModel(model, ("data",), "train"))
        with dryrun._substituted(dryrun._Counter(None, set()), False, True, True), use_mesh_compat(mesh):
            (stotal, _), sgrads = stepslib._value_and_grad(sloss, sparams, sbatch)
            with torch.no_grad():
                sgrads_in = tree_map(lambda t, sp: place(t, sp, False), grads, s_specs.params)
                sstate = tree_map(lambda t, sp: place(t, sp, False), opt_state, s_specs.opt_state)
                supdates, _ = opt.update(stepslib.clip_by_global_norm(sgrads_in, 1.0), sstate,
                                         sparams)
        got = [stotal] + tree_leaves(sgrads) + tree_leaves(supdates)
        want = [total] + tree_leaves(grads) + tree_leaves(updates)
        return max(error(g, w) for g, w in zip(got, want))


for kind, arch, batch, *ssm in steps:
    key = "|".join([kind, arch, str(batch)] + [f"{k}={v}" for k, v in (ssm or [{}])[0].items()])
    if kind == "train":
        out[key] = train_step(arch, batch)
        continue
    torch.manual_seed(0)
    cfg = get_smoke_config(arch)
    if ssm:
        over = dict(ssm[0])
        cfg = dataclasses.replace(cfg, d_model=over.pop("d_model", cfg.d_model),
                                  ssm=dataclasses.replace(cfg.ssm, **over))
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
        logits, plain_new = make_serve_step(model)(params, tokens, plain_cache, POS)
        want = [logits] + tree_leaves(plain_cache) + tree_leaves(plain_new)
    else:
        tokens = torch.randint(0, cfg.vocab_size, (batch, SEQ), dtype=torch.int32)
        want = [make_prefill_step(model)(params, {"tokens": tokens, **extra})]
    with LocalTensorMode(4):
        sparams = tree_map(place, params, p_specs)
        if kind == "decode":
            scache = tree_map(place, cache, c_specs)
            step = make_serve_step(dryrun._FsdpModel(model, ("data",), kind))
            args = (sparams, place(tokens, t_specs), scache, POS)
        else:
            step = make_prefill_step(dryrun._FsdpModel(model, ("data",), kind))
            sbatch = {k: place(v, b_specs[k]) for k, v in {"tokens": tokens, **extra}.items()}
            args = (sparams, sbatch)
        counter = dryrun._Counter(None, set())
        with dryrun._substituted(counter, False, True, False), use_mesh_compat(mesh):
            got = step(*args)
        got = [got[0]] + tree_leaves(scache) + tree_leaves(got[1]) if kind == "decode" else [got]
        # a Mamba block took its per-head route
        took = cfg.ssm is None or counter.routes.get("ssd", "").startswith("per-head Mamba")
        out[key] = max(error(g, w) for g, w in zip(got, want)) if took else float("inf")

if "loss_parallel" in regions:
    torch.manual_seed(1)
    logits, tokens = torch.randn(4, 16, 64), torch.randint(0, 64, (4, 16), dtype=torch.int32)
    with LocalTensorMode(4):
        dm = mesh.device_mesh
        got = dryrun._loss_parallel(lm_loss)(distribute_tensor(logits, dm, [Shard(0), Shard(2)]),
                                             distribute_tensor(tokens, dm, [Shard(0), Replicate()]))
        out["loss_parallel"] = error(got, lm_loss(logits, tokens))

# the expert-parallel MoE, forward and gradients, against the plain MoE on each
# data shard's tokens, with the weights as the dry run hands them over (FSDP
# over data, experts over model) and each route
cfg = get_smoke_config("kimi-k2-1t-a32b")
model = build_model(cfg, dtype=torch.float32, device="cpu")
block = model.init(torch.Generator().manual_seed(2))["layers"]["block0"]["moe"]
params = tree_map(lambda t: t[0].clone(), block)
x, w = torch.randn(4, 8, cfg.d_model), torch.randn(4, 8, cfg.d_model)
plain = []
for xh, wh in zip(x.chunk(2), w.chunk(2)):
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), params)
    xs = xh.clone().requires_grad_(True)
    y, aux = moe.apply_moe(leaves, xs, cfg.moe, cfg.activation)
    ((y * wh).sum() + aux).backward()
    plain.append([y.detach(), xs.grad] + [t.grad for t in tree_leaves(leaves)])
want = [torch.cat([plain[0][0], plain[1][0]]), torch.cat([plain[0][1], plain[1][1]])] + [
    a + b for a, b in zip(plain[0][2:], plain[1][2:])]
specs = {"router": (Shard(0), Replicate()), "w_gate": (Shard(1), Shard(0)),
         "w_up": (Shard(1), Shard(0)), "w_down": (Shard(2), Shard(0)),
         "shared/w_gate": (Shard(0), Shard(1)), "shared/w_up": (Shard(0), Shard(1)),
         "shared/w_down": (Shard(1), Shard(0))}
for route in ("gathered", "sliced"):
    if f"expert_parallel|{route}" not in regions:
        continue
    with LocalTensorMode(4):
        dm = mesh.device_mesh
        sp = {k: distribute_tensor(v, dm, list(specs[k])).requires_grad_(True)
              for k, v in params.items() if k != "shared"}
        sp["shared"] = {k: distribute_tensor(v, dm, list(specs["shared/" + k])).requires_grad_(True)
                        for k, v in params["shared"].items()}
        sx = distribute_tensor(x, dm, [Shard(0), Replicate()]).requires_grad_(True)
        # the sliced route is a prefill's: no autograd, the output alone
        sliced, routes = route == "sliced", {}
        with torch.set_grad_enabled(not sliced), use_mesh_compat(mesh):
            split = tree_map(lambda t: dryrun._SplitWeight(t, dtype=torch.float32,
                                                          axes=("data",)), sp)
            y, aux = dryrun._expert_parallel(moe.apply_moe, routes, sliced)(split, sx, cfg.moe,
                                                                          cfg.activation)
            if not sliced:
                # the aux loss is the mean over the data shards' (each shard's counted once)
                ((y * distribute_tensor(w, dm, [Shard(0), Replicate()])).sum()
                 + 2 * aux).backward()
        got = [y] if sliced else [y, sx.grad] + [t.grad for t in tree_leaves(sp)]
        took = routes.get("experts", "").startswith(f"expert-parallel, {route}")
        out[f"expert_parallel|{route}"] = (max(error(g, v) for g, v in zip(got, want))
                                           if took else float("inf"))
print("RESULT:" + json.dumps(out))
'''


@pytest.fixture(scope="module")
def errors():
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="2")
    groups = [(STEPS + STATE_SPLITS, ["loss_parallel"]),
              (TRAIN_STEPS, [r for r in REGIONS if "|" in r])]
    procs = [subprocess.Popen([sys.executable, "-c", _RUN, json.dumps(group)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for group in groups]
    out = {}
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        line = [l for l in stdout.splitlines() if l.startswith("RESULT:")]
        assert line, stdout[-2000:]
        out.update(json.loads(line[0][len("RESULT:"):]))
    return out


@pytest.mark.parametrize("case", CASES)
def test_region_matches_plain(errors, case):
    assert errors[case] <= TOLERANCE, (case, errors[case])
