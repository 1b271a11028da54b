"""The port's MoE layer and MoE transformers against the JAX package, on
the CPU.

Weights come from the reference's own ``init_moe`` / ``init`` and carry
across with ``convert.params_from_numpy``; inputs are numpy arrays from a
seed.  Tolerances:

  * slot assignment (which token sits in which expert slot, which are
    dropped): exact, against a loop over the tokens in order and against
    the reference's expert input buffers, bit for bit in float32;
  * ``apply_moe`` in float32: 1e-5 of the largest output; the aux loss:
    1e-6 (float32 summation order only);
  * whole models in float32: 1e-4 of the largest logit; in bfloat16:
    3e-2 of it (the rule of ``tests/test_torch_transformer.py``);
  * loss: rtol 1e-5, gradients: 1e-5 of the largest gradient.
"""
import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as ref_build_model
from repro.configs import get_smoke_config as ref_smoke_config
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import moe as ref_moe
from repro.train import steps as jsteps
from repro_torch.configs import build_model, get_config, get_smoke_config
from repro_torch.configs.base import MoEConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe
from repro_torch.train import steps as tsteps

MOE_ARCHS = ["llama4-maverick-400b-a17b", "kimi-k2-1t-a32b"]
# (experts, top_k, d_ff_expert, capacity_factor, shared, batch, seq):
# llama4's top-1 with a shared expert, kimi's top-2 smoke routing, a
# capacity factor small enough that tokens are dropped, and a decode step
# of 4 tokens (capacity 2: some drop)
CASES = {
    "top1-shared": (4, 1, 256, 2.0, 1, 2, 32),
    "top2": (4, 2, 128, 1.25, 1, 2, 32),
    "dropping": (4, 2, 128, 0.5, 0, 2, 32),
    "decode": (4, 2, 128, 1.25, 1, 4, 1),
}
D_MODEL = 256


def _port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _case(name):
    e, k, f, cf, shared, b, s = CASES[name]
    kw = dict(num_experts=e, top_k=k, d_ff_expert=f, capacity_factor=cf,
              num_shared_experts=shared)
    rp = ref_moe.init_moe(jax.random.PRNGKey(len(name)), D_MODEL, RefMoEConfig(**kw))
    x = np.random.default_rng(len(name)).standard_normal((b, s, D_MODEL)).astype(np.float32)
    return RefMoEConfig(**kw), MoEConfig(**kw), rp, _port(rp), x


def _loop_slots(expert_idx: np.ndarray, num_experts: int, cap: int):
    """Slots by the definition: the k choices in turn, each over the
    tokens in order, an expert's next free slot or a drop."""
    n, k = expert_idx.shape
    count = np.zeros(num_experts, np.int64)
    flats, valids = np.zeros((k, n), np.int64), np.zeros((k, n), bool)
    for j in range(k):
        for t in range(n):
            e = expert_idx[t, j]
            pos = count[e]
            count[e] += 1
            valids[j, t] = pos < cap
            flats[j, t] = e * cap + min(pos, cap - 1)
    return flats, valids


def _reference_expert_inputs(monkeypatch, rcfg, rp, x):
    """The reference's expert input buffer (E, cap, d), read off its first
    expert product (a wrapper around its module's ``jnp``)."""
    seen = []

    def einsum(spec, a, *rest, **kw):
        if spec == "ecd,edf->ecf" and not seen:
            seen.append(np.asarray(a))
        return jnp.einsum(spec, a, *rest, **kw)

    names = {n: getattr(jnp, n) for n in dir(jnp) if not n.startswith("__")}
    monkeypatch.setattr(ref_moe, "jnp", types.SimpleNamespace(**{**names, "einsum": einsum}))
    out, aux = ref_moe.apply_moe(rp, jnp.asarray(x), rcfg)
    return seen[0], np.asarray(out), float(aux)


@pytest.mark.parametrize("case", list(CASES))
def test_slots_match_the_definition(case):
    _, cfg, _, pp, x = _case(case)
    xt = torch.from_numpy(x).reshape(-1, D_MODEL)
    gate_vals, flats, valids, _, cap = moe.route(pp, xt, cfg)
    probs = torch.softmax(xt @ pp["router"], dim=-1)
    expert_idx = torch.topk(probs, cfg.top_k, dim=-1).indices.numpy()
    want_flat, want_valid = _loop_slots(expert_idx, cfg.num_experts, cap)
    np.testing.assert_array_equal(torch.stack(flats).numpy(), want_flat)
    np.testing.assert_array_equal(torch.stack(valids).numpy(), want_valid)
    np.testing.assert_allclose(gate_vals.sum(-1).numpy(), 1.0, rtol=1e-6)
    dropped = (~want_valid).sum()
    assert (dropped > 0) == (case in ("dropping", "decode")), dropped


@pytest.mark.parametrize("case", list(CASES))
def test_dispatch_equals_reference_buffers(case, monkeypatch):
    """Every expert slot holds the reference's row, dropped tokens
    included: the expert input buffers are equal bit for bit."""
    rcfg, cfg, rp, pp, x = _case(case)
    want, _, _ = _reference_expert_inputs(monkeypatch, rcfg, rp, x)
    xt = torch.from_numpy(x).reshape(-1, D_MODEL)
    _, flats, valids, _, cap = moe.route(pp, xt, cfg)
    got = moe.dispatch(xt, flats, valids, cfg.num_experts, cap)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_reference(case, monkeypatch):
    rcfg, cfg, rp, pp, x = _case(case)
    _, want, want_aux = _reference_expert_inputs(monkeypatch, rcfg, rp, x)
    got, aux = moe.apply_moe(pp, torch.from_numpy(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert abs(float(aux) - want_aux) <= 1e-6


def test_capacity_is_the_reference_expression():
    """Truncated as ``int()`` truncates: full-width prefill of 4 x 2048
    tokens, and a decode step of 4 tokens (one slot per expert)."""
    llama4, kimi = (get_config(a).moe for a in MOE_ARCHS)
    assert moe.capacity(llama4, 4 * 2048) == 128
    assert moe.capacity(kimi, 4 * 2048) == 213
    assert moe.capacity(llama4, 4) == moe.capacity(kimi, 4) == 1
    for cf, n, k, e in ((1.25, 7, 3, 5), (0.1, 3, 1, 8), (2.0, 100, 2, 6)):
        cfg = MoEConfig(num_experts=e, top_k=k, d_ff_expert=8, capacity_factor=cf)
        assert moe.capacity(cfg, n) == max(1, int(cf * n * k / e))


def test_init_moe_layout_matches_reference():
    rcfg, cfg, rp, _, _ = _case("top1-shared")
    got = moe.init_moe(torch.Generator().manual_seed(0), D_MODEL, cfg, torch.bfloat16)
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), rp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), got) == shapes
    assert all(t.dtype == torch.bfloat16 for t in jax.tree_util.tree_leaves(got))


# --- MoE transformers ------------------------------------------------------------------
def _models(arch, jdt=jnp.float32, tdt=torch.float32, attn_impl="pallas"):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    ref = ref_build_model(rcfg, attn_impl=attn_impl, dtype=jdt)
    port = build_model(cfg, attn_impl=attn_impl, dtype=tdt, device="cpu")
    rp = ref.init(jax.random.PRNGKey(0))
    return ref, port, rp, _port(rp)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_transformer_forward_matches_reference(arch):
    """float32 logits and aux loss; the routing is the reference's (the
    logits would move by far more than 1e-4 on one token routed apart)."""
    ref, port, rp, pp = _models(arch)
    assert port.unit_size == ref.unit_size and port.num_units == ref.num_units
    tokens = np.random.default_rng(6).integers(0, port.cfg.vocab_size, (2, 64))
    want, want_aux = ref.forward(rp, jnp.asarray(tokens, jnp.int32))
    got, aux = port.forward(pp, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    last = tsteps.make_prefill_step(port)(pp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(last.numpy(), np.asarray(want[:, -1]), rtol=0, atol=1e-4)


def _replay_routing(monkeypatch, ref, rp, tokens):
    """Run the reference (unrolled, eager) in bfloat16, recording the
    experts its ``top_k`` picks at each MoE layer; then make the port's
    ``top_k`` pick the same experts, in the same order, with its own
    probabilities as gate values.  Returns the reference's logits and aux
    loss, and the list of (port's own choices, replayed choices, port's
    margin between its k-th and (k+1)-th probability) per layer."""
    picks = []

    def ref_top_k(probs, k):
        vals, idx = jax.lax.top_k(probs, k)
        picks.append(np.asarray(idx))
        return vals, idx

    monkeypatch.setattr(ref_moe, "jax", types.SimpleNamespace(
        nn=jax.nn, lax=types.SimpleNamespace(top_k=ref_top_k)))
    want, want_aux = ref.forward(rp, jnp.asarray(tokens, jnp.int32))
    replay, seen = iter(picks), []

    def port_topk(probs, k, dim=-1):
        own = torch.topk(probs, k + 1, dim=dim)
        idx = torch.from_numpy(np.array(next(replay))).long()
        seen.append((own.indices[:, :k], idx, own.values[:, k - 1] - own.values[:, k]))
        return torch.gather(probs, -1, idx), idx

    names = {n: getattr(torch, n) for n in dir(torch) if not n.startswith("__")}
    monkeypatch.setattr(moe, "torch", types.SimpleNamespace(**{**names, "topk": port_topk}))
    return np.asarray(want, np.float32), float(want_aux), seen


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_transformer_bf16_matches_reference_on_its_routing(arch, monkeypatch):
    """bfloat16 logits within 3e-2 of the largest, with the routing
    replayed from the reference: in bfloat16 a token whose top-k
    probabilities nearly tie may go to another expert in either package
    (and through the capacity, move other tokens' slots), which no
    tolerance on the logits survives.  Where the port's own choice
    differs from the reference's, its margin is below 1e-2, the
    probabilities' bfloat16 noise."""
    rcfg = dataclasses.replace(ref_smoke_config(arch), scan_layers=False)
    ref = ref_build_model(rcfg, attn_impl="pallas", dtype=jnp.bfloat16)
    port = build_model(get_smoke_config(arch), attn_impl="pallas", dtype=torch.bfloat16,
                       device="cpu")
    rp = ref.init(jax.random.PRNGKey(0))
    pp = _port(rp)
    tokens = np.random.default_rng(6).integers(0, port.cfg.vocab_size, (2, 64))
    want, want_aux, seen = _replay_routing(monkeypatch, ref, rp, tokens)
    got, aux = port.forward(pp, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    assert len(seen) == port.num_units           # one MoE block a unit
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=3e-2 * np.abs(want).max())
    assert abs(float(aux) - want_aux) <= 1e-3
    for own, replayed, margin in seen:
        apart = (own.sort(-1).values != replayed.sort(-1).values).any(-1)
        assert bool((margin[apart] < 1e-2).all()), margin[apart]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_reference(arch):
    """Teacher-forced decode steps against the reference's, step by step
    (capacity max(1, int(cf * B * k / E)) in both), and the caches: one
    per block of a unit."""
    ref, port, rp, pp = _models(arch, attn_impl="xla")
    b, steps = 2, 6
    tokens = np.random.default_rng(7).integers(0, port.cfg.vocab_size, (b, steps))
    rc = ref.init_cache(b, steps, jnp.float32)
    pc = port.init_cache(b, steps, torch.float32)
    assert sorted(pc) == [f"block{i}" for i in range(port.unit_size)]
    step = jax.jit(ref.decode_step)
    for t in range(steps):
        want, rc = step(rp, jnp.asarray(tokens[:, t:t + 1], jnp.int32), rc,
                        jnp.asarray(t, jnp.int32))
        got, pc = port.decode_step(pp, torch.from_numpy(tokens[:, t:t + 1]), pc, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    for name in pc:
        np.testing.assert_allclose(pc[name].k.numpy(), np.asarray(rc[name].k), atol=1e-5)
        assert pc[name].index.tolist() == [steps] * port.num_units


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_gradients_match_reference(arch):
    """lm_loss + the summed aux loss, and the gradients of every leaf
    (the router's through the gates and the aux loss)."""
    ref, port, rp, pp = _models(arch, attn_impl="xla")
    tokens = np.random.default_rng(1).integers(0, port.cfg.vocab_size, (2, 16)).astype(np.int32)

    def ref_loss(p):
        logits, aux = ref.forward(p, jnp.asarray(tokens))
        loss = jsteps.lm_loss(logits, jnp.asarray(tokens))
        return loss + aux, loss

    (r_total, r_ce), r_grads = jax.value_and_grad(ref_loss, has_aux=True)(rp)
    (t_total, t_ce), t_grads = tsteps._value_and_grad(
        tsteps._loss_fn(port), pp, {"tokens": torch.from_numpy(tokens)})
    assert float(t_ce) == pytest.approx(float(r_ce), rel=1e-5)
    assert float(t_total) == pytest.approx(float(r_total), rel=1e-5)
    assert float(t_total) > float(t_ce)              # the aux loss is in the total
    g_leaves, w_leaves = jax.tree_util.tree_leaves(t_grads), jax.tree_util.tree_leaves(r_grads)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5 * scale)
    router = t_grads["layers"][f"block{port.unit_size - 1}"]["moe"]["router"]
    assert float(router.abs().max()) > 0


def test_moe_units_and_storage_dtype():
    """llama4's unit is a dense block and a MoE block; init in bfloat16
    draws the same values as float32 init cast afterwards."""
    cfg = get_smoke_config(MOE_ARCHS[0])
    model = build_model(cfg, device="cpu")
    p32 = model.init(torch.Generator().manual_seed(3))
    p16 = model.init(torch.Generator().manual_seed(3), dtype=torch.bfloat16)
    assert "ffn" in p32["layers"]["block0"] and "moe" in p32["layers"]["block1"]
    assert p32["layers"]["block1"]["moe"]["w_gate"].shape == (
        model.num_units, cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert)
    for a, b in zip(jax.tree_util.tree_leaves(p32), jax.tree_util.tree_leaves(p16)):
        assert b.dtype == torch.bfloat16 and torch.equal(a.bfloat16(), b)


def test_moe_train_step_moves_parameters():
    """As ``tests/test_archs.py::test_train_step`` holds the reference: a
    fresh MoE model's loss near ln V, every expert leaf moved."""
    from repro_torch.optim import get_optimizer

    cfg = get_smoke_config(MOE_ARCHS[1])
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    state = tsteps.TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32)))
    new, metrics = tsteps.make_train_step(model, opt)(state, {"tokens": tokens})
    assert abs(float(metrics["loss"]) - math.log(cfg.vocab_size)) < 1.5
    assert float(metrics["total_loss"]) > float(metrics["loss"])
    moe_old, moe_new = params["layers"]["block0"]["moe"], new.params["layers"]["block0"]["moe"]
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert not torch.equal(moe_old[name], moe_new[name]), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expert_counts_equal_bincount(seed):
    """The fixed-shape count is ``bincount``'s, experts that get no token
    included (E above the tokens' range, and a skewed draw)."""
    rng = np.random.default_rng(seed)
    for n, num_experts in ((1, 8), (37, 16), (200, 384)):
        idx = torch.from_numpy(rng.integers(0, max(1, num_experts // 3), n))
        counts = moe.expert_counts(idx, num_experts)
        assert counts.dtype == torch.int64 and counts.shape == (num_experts,)
        assert torch.equal(counts, torch.bincount(idx, minlength=num_experts))
        assert int((counts == 0).sum()) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_traces_under_fake_tensors(arch):
    """Routing has no data-dependent shape: the smoke forward and a train
    step run under ``FakeTensorMode`` (the dry run's abstract tensors)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.optim import get_optimizer

    cfg = get_smoke_config(arch)
    model = build_model(cfg, dtype=torch.float32, device="cpu")
    with FakeTensorMode():
        params = model.init(torch.Generator().manual_seed(0))
        tokens = torch.zeros((2, 32), dtype=torch.int32)
        logits, aux = model.forward(params, tokens)
        opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
        state = tsteps.TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32))
        new, metrics = tsteps.make_train_step(model, opt)(state, {"tokens": tokens})
    assert isinstance(logits, FakeTensor) and logits.shape == (2, 32, cfg.vocab_size)
    assert isinstance(metrics["loss"], FakeTensor)
