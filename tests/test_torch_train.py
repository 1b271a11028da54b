"""The port's training path against the JAX package, on the CPU.

``lm_loss``, ``make_train_step`` (loss, gradients, parameters after SGD
steps), every optimizer's update, the FedLEO orbit-replica local step and
aggregate (with and without the aggregation kernel's route, with
staleness, the int32 step counter), remat, and the refusal of the
forward-only kernels under autograd.  Weights come from the reference's
own ``init``; tokens, gradients and perturbations are numpy arrays from
a seed.  Models run in float32.  Tolerances:

  * ``lm_loss``: 1e-6; a train step's loss: rtol 1e-5; gradients: 1e-5
    of the largest gradient; parameters after 2 SGD steps: 1e-5 —
    float32 summation order only.
  * optimizer updates from identical gradients: 1e-6.
  * FedLEO aggregate: 1e-5 in float32, 1 ulp in bfloat16 (or float32
    rounding of the products where the sum cancels), the int32
    step counter exact at R = 3 (weights 1/6, 1/3, 1/2 are not exact
    in binary, so the float32 sums truncate as the reference's do).
  * R stacked replicas against R separate calls, and remat on against
    off: equal, bit for bit.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import build_model as ref_build_model
from repro.configs import get_smoke_config as ref_smoke_config
from repro.optim import optimizers as jopt
from repro.train import fedleo_step as jfl
from repro.train import steps as jsteps
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_ops, ssd_ops
from repro_torch.kernels.aggregate_ref import bf16_ulp_distance
from repro_torch.optim import optimizers as topt
from repro_torch.train import fedleo_step as tfl
from repro_torch.train import steps as tsteps
from repro_torch.tree import flatten_up_to, tree_flatten, tree_leaves, tree_map

FAMILIES = {"dense": "gemma-7b", "ssm": "mamba2-780m", "hybrid": "zamba2-1.2b",
            "moe": "kimi-k2-1t-a32b"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x, np.float32) if jnp.issubdtype(x.dtype, jnp.floating) else np.asarray(x)


def _assert_trees_close(got, want, tol, rel=False):
    g_leaves, w_leaves = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g_leaves) == len(w_leaves)
    scale = max(float(np.abs(_np(w)).max(initial=0.0)) for w in w_leaves) if rel else 1.0
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=tol * scale)


def _models(arch, **cfg_kw):
    rcfg = dataclasses.replace(ref_smoke_config(arch), **cfg_kw)
    cfg = dataclasses.replace(get_smoke_config(arch), **cfg_kw)
    ref = ref_build_model(rcfg, dtype=jnp.float32)
    port = build_model(cfg, dtype=torch.float32, device="cpu")
    rp = ref.init(jax.random.PRNGKey(0))
    return ref, port, rp, params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), "cpu")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def _ref_state(params, opt, step=0):
    return jsteps.TrainState(params=params, opt_state=opt.init(params),
                             step=jnp.asarray(step, jnp.int32))


def _port_state(params, opt):
    return tsteps.TrainState(params=params, opt_state=opt.init(params),
                             step=torch.zeros((), dtype=torch.int32))


# --- lm_loss and the train step ----------------------------------------------------------
@pytest.mark.parametrize("num_prefix", [0, 3])
def test_lm_loss_matches_reference(num_prefix):
    rng = np.random.default_rng(num_prefix)
    logits = (rng.standard_normal((2, 11, 37)) * 3).astype(np.float32)
    tokens = rng.integers(0, 37, size=(2, 11 - num_prefix)).astype(np.int32)
    ref = float(jsteps.lm_loss(jnp.asarray(logits), jnp.asarray(tokens), num_prefix))
    ours = float(tsteps.lm_loss(torch.from_numpy(logits), torch.from_numpy(tokens), num_prefix))
    assert abs(ours - ref) <= 1e-6 * max(1.0, abs(ref))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_gradients_match_reference(family):
    ref, port, rp, tp = _models(FAMILIES[family])
    tokens = _tokens(port.cfg.vocab_size, (2, 16), 1)

    def ref_loss(p):
        logits, aux = ref.forward(p, jnp.asarray(tokens))
        loss = jsteps.lm_loss(logits, jnp.asarray(tokens))
        return loss + aux, loss

    (r_total, r_ce), r_grads = jax.value_and_grad(ref_loss, has_aux=True)(rp)
    (t_total, t_ce), t_grads = tsteps._value_and_grad(
        tsteps._loss_fn(port), tp, {"tokens": torch.from_numpy(tokens)})
    assert float(t_ce) == pytest.approx(float(r_ce), rel=1e-5)
    assert float(t_total) == pytest.approx(float(r_total), rel=1e-5)
    assert abs(float(t_ce) - math.log(port.cfg.vocab_size)) < 1.5
    _assert_trees_close(t_grads, r_grads, 1e-5, rel=True)
    if family == "hybrid":   # the shared block's gradient sums over its uses
        assert float(t_grads["shared_attn"]["attn"]["wq"].abs().max()) > 0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_sgd_matches_reference(family):
    ref, port, rp, tp = _models(FAMILIES[family])
    jopt_, topt_ = jopt.sgd(0.5), topt.sgd(0.5)
    jstep = jax.jit(jsteps.make_train_step(ref, jopt_))
    tstep = tsteps.make_train_step(port, topt_)
    js, ts = _ref_state(rp, jopt_), _port_state(tp, topt_)
    for i in range(2):
        tokens = _tokens(port.cfg.vocab_size, (2, 16), 10 + i)
        js, jm = jstep(js, {"tokens": jnp.asarray(tokens)})
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(tokens)})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(tm["total_loss"]) == pytest.approx(float(jm["total_loss"]), rel=1e-5)
    assert int(ts.step) == int(js.step) == 2
    _assert_trees_close(ts.params, js.params, 1e-5)
    # the input state is left as it was
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tp), tree_leaves(
        params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), "cpu"))))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_step_with_config_optimizer(family):
    """As ``tests/test_archs.py::test_train_step`` holds the reference:
    the config's optimizer, a fresh model's loss near ln V, parameters
    moved, one step counted; and the optimizer state after one step from
    the same weights and tokens within 1e-5 of its largest value, as the
    gradients are.  (The parameters are held after SGD steps: Adam's
    first step is lr * g / (|g| + eps), which turns the gradients'
    rounding on elements near zero into moves of up to lr.)"""
    ref, port, rp, tp = _models(FAMILIES[family])
    cfg = port.cfg
    jo = jopt.get_optimizer(cfg.optimizer, cfg.learning_rate)
    to = topt.get_optimizer(cfg.optimizer, cfg.learning_rate)
    tokens = _tokens(cfg.vocab_size, (2, 16), 3)
    js, _ = jax.jit(jsteps.make_train_step(ref, jo))(_ref_state(rp, jo), {"tokens": jnp.asarray(tokens)})
    ts, tm = tsteps.make_train_step(port, to)(_port_state(tp, to), {"tokens": torch.from_numpy(tokens)})
    loss = float(tm["loss"])
    assert math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 1.5
    assert sum(float((a - b).abs().sum()) for a, b in zip(tree_leaves(ts.params), tree_leaves(tp))) > 0
    assert int(ts.step) == 1
    for got, want in zip(ts.opt_state[1:], js.opt_state[1:]):     # Adam's mu, nu
        _assert_trees_close(got, want, 1e-5, rel=True)
    assert int(ts.opt_state.step) == int(js.opt_state.step) == 1


@pytest.mark.parametrize("arch", ["internvl2-26b", "seamless-m4t-large-v2"])
def test_train_step_takes_the_multimodal_batch(arch):
    """The vlm (``extra``, its patches left out of the loss) and audio
    (``source``) batches through 2 SGD steps, against the reference's."""
    ref, port, rp, tp = _models(arch)
    rng = np.random.default_rng(5)
    key = "extra" if port.cfg.family == "vlm" else "source"
    n = port.cfg.vision.num_patches if key == "extra" else 24
    embeds = rng.standard_normal((2, n, port.cfg.d_model)).astype(np.float32)
    jopt_, topt_ = jopt.sgd(0.5), topt.sgd(0.5)
    jstep = jax.jit(jsteps.make_train_step(ref, jopt_))
    tstep = tsteps.make_train_step(port, topt_)
    js, ts = _ref_state(rp, jopt_), _port_state(tp, topt_)
    for i in range(2):
        tokens = _tokens(port.cfg.vocab_size, (2, 16), 20 + i)
        js, jm = jstep(js, {"tokens": jnp.asarray(tokens), key: jnp.asarray(embeds)})
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(tokens), key: torch.from_numpy(embeds)})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _assert_trees_close(ts.params, js.params, 1e-5)


# --- optimizers ------------------------------------------------------------------------
_OPT_SHAPES = {"w": (5, 4), "b": (4,), "t": (3, 2, 6), "row": (1, 5), "z": ()}


def _opt_grads(step):
    rng = np.random.default_rng(200 + step)
    return {k: (rng.standard_normal(s) * (0.1 + step)).astype(np.float32)
            for k, s in _OPT_SHAPES.items()}


@pytest.mark.parametrize(
    "name,kwargs",
    [("sgd", {}), ("momentum", {}), ("momentum", {"nesterov": True}), ("adam", {}),
     ("adam", {"weight_decay": 0.01}), ("adafactor", {}),
     ("adafactor", {"clip_threshold": 0.05, "decay": 0.5})],
)
def test_optimizer_update_from_same_gradients(name, kwargs):
    """Every optimizer on leaves of rank 0-3, factorable or not, with
    gradients of growing scale (adafactor's RMS clip engages)."""
    rng = np.random.default_rng(7)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in _OPT_SHAPES.items()}
    jo = jopt.get_optimizer(name, 0.05, **kwargs)
    to = topt.get_optimizer(name, 0.05, **kwargs)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p0), params_from_numpy(p0, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = _opt_grads(step)
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = to.update(params_from_numpy(g, "cpu"), ts, tp)
        _assert_trees_close(tu, ju, 1e-6)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    _assert_trees_close(tp, jp, 1e-6)
    for got, want in zip(tree_leaves(ts), jax.tree_util.tree_leaves(js)):   # moments: relative
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)


def test_adafactor_state_is_factored_as_the_reference():
    p = {k: torch.zeros(s) for k, s in _OPT_SHAPES.items()}
    st = topt.adafactor().init(p)
    jst = jopt.adafactor().init(jax.tree_util.tree_map(jnp.zeros, _OPT_SHAPES,
                                                       is_leaf=lambda s: isinstance(s, tuple)))
    for k in _OPT_SHAPES:
        assert topt._is_factorable(p[k]) == jopt._is_factorable(jnp.zeros(_OPT_SHAPES[k]))
        assert isinstance(st.factored[k], tuple) == isinstance(jst.factored[k], tuple)
    assert [tuple(t.shape) for t in st.factored["w"]] == [(5,), (4,)]
    assert [tuple(t.shape) for t in st.factored["t"]] == [(3, 2), (3, 6)]
    assert st.factored["row"].shape == (1, 5) and st.step.dtype == torch.int32
    # flatten_up_to keeps each (row, col) pair whole, as the update needs
    pairs = flatten_up_to(tree_flatten(p)[1], st.factored)
    assert [isinstance(f, tuple) for f in pairs] == [False, False, True, True, False]


# --- FedLEO orbit replicas -----------------------------------------------------------
def _perturbed(tp, r, seed, scale=0.01):
    rng = np.random.default_rng(seed)
    return tree_map(lambda p: torch.stack([
        p + scale * torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
        for _ in range(r)]), tp)


def _separately(step, state, batches, r, tau):
    outs = []
    for i in range(r):
        st = tree_map(lambda x: x[i], state)
        for t in range(tau):
            st, m = step(st, tree_map(lambda b: b[i, t], batches))
        outs.append((st, m))
    return outs


@pytest.mark.parametrize("opt_name,grad_clip", [("adam", 1.0), ("adafactor", 1.0),
                                                ("adafactor", None), ("sgd", 1e-3)])
def test_stacked_replicas_equal_separate_calls(opt_name, grad_clip):
    """The local step maps the clip and the optimizer over the replicas:
    R stacked replicas equal R separate calls bit for bit, where one call
    on the stack would take one norm, call a stacked bias factorable and
    average adafactor's RMS over the replicas."""
    _, port, _, tp = _models("mamba2-780m")
    r, tau = 3, 2
    opt = topt.get_optimizer(opt_name, 0.05)
    stacked = _perturbed(tp, r, seed=5)
    state = tsteps.TrainState(params=stacked,
                              opt_state=tfl.replicate_for_orbits(opt.init(tp), r),
                              step=torch.zeros((r,), dtype=torch.int32))
    batches = {"tokens": torch.from_numpy(_tokens(port.cfg.vocab_size, (r, tau, 2, 16), 9))}
    local = tfl.make_fedleo_local_step(port, opt, grad_clip, num_local_steps=tau)
    got, metrics = local(state, batches)
    want = _separately(tsteps.make_train_step(port, opt, grad_clip), state, batches, r, tau)
    for i, (st, m) in enumerate(want):
        assert all(torch.equal(a[i], b) for a, b in zip(tree_leaves(got), tree_leaves(st)))
        assert torch.equal(metrics["loss"][i], m["loss"])
    assert torch.equal(got.step, torch.full((r,), tau, dtype=torch.int32))
    if opt_name == "adafactor":     # one update on the stack is a different update
        g = _perturbed(tree_map(torch.zeros_like, tp), r, seed=8, scale=1.0)
        whole, _ = opt.update(g, opt.init(stacked), stacked)
        per = opt.update(tree_map(lambda x: x[0], g), opt.init(tp), tp)[0]
        assert isinstance(opt.init(stacked).factored["ln_final"]["scale"], tuple)
        assert not isinstance(opt.init(tp).factored["ln_final"]["scale"], tuple)
        assert not torch.allclose(whole["ln_final"]["scale"][0], per["ln_final"]["scale"])


@pytest.mark.parametrize("tau", [1, 3])
@pytest.mark.parametrize("opt_name,lr", [("sgd", 0.01), ("adam", 1e-4)])
def test_fedleo_local_step_matches_reference(tau, opt_name, lr):
    """Adam runs at lr 1e-4: each of its steps turns the gradients'
    rounding on elements near zero into moves of up to lr, which feed the
    next step's gradients; at 1e-4 they stay under the limits for 3 steps."""
    ref, port, rp, tp = _models("mamba2-780m")
    r = 2
    jo, to = jopt.get_optimizer(opt_name, lr), topt.get_optimizer(opt_name, lr)
    tstacked = _perturbed(tp, r, seed=11)
    jstacked = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tstacked)
    js = jsteps.TrainState(params=jstacked,
                           opt_state=jfl.replicate_for_orbits(jo.init(rp), r),
                           step=jnp.zeros((r,), jnp.int32))
    ts = tsteps.TrainState(params=tstacked,
                           opt_state=tfl.replicate_for_orbits(to.init(tp), r),
                           step=torch.zeros((r,), dtype=torch.int32))
    tokens = _tokens(port.cfg.vocab_size, (r, tau, 2, 16), 4)
    js, jm = jax.jit(jfl.make_fedleo_local_step(ref, jo, num_local_steps=tau))(
        js, {"tokens": jnp.asarray(tokens)})
    ts, tm = tfl.make_fedleo_local_step(port, to, num_local_steps=tau)(
        ts, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(ts.step.numpy(), np.asarray(js.step))
    if opt_name == "sgd":
        _assert_trees_close(ts.params, js.params, 1e-5)
    else:   # the moments; the parameters as test_train_step_with_config_optimizer says
        for got, want in zip(ts.opt_state[1:], js.opt_state[1:]):
            _assert_trees_close(got, want, 1e-5, rel=True)
        np.testing.assert_array_equal(ts.opt_state.step.numpy(), np.asarray(js.opt_state.step))


def _adam_states(r, seed, dtype=torch.float32, steps=(7, 7, 7)):
    """A stacked smoke-mamba2 ``TrainState`` with Adam moments, replicas
    apart, the int32 step counter replicated; in both packages."""
    ref, port, rp, tp = _models("mamba2-780m")
    params = _perturbed(tp, r, seed)
    rng = np.random.default_rng(seed + 1)
    mom = lambda p, s: torch.from_numpy((rng.standard_normal(tuple(p.shape)) * s).astype(np.float32))
    opt_state = topt.AdamState(step=torch.tensor(steps, dtype=torch.int32),
                               mu=tree_map(lambda p: mom(p, 0.01), params),
                               nu=tree_map(lambda p: mom(p, 1e-4).abs(), params))
    params = tree_map(lambda p: p.to(dtype), params)
    ts = tsteps.TrainState(params=params, opt_state=opt_state,
                           step=torch.tensor(steps[0], dtype=torch.int32))
    jnp_tree = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) if x.dtype == torch.bfloat16
        else jnp.asarray(x.numpy()), t, is_leaf=lambda x: isinstance(x, torch.Tensor))
    jo_state = jopt.AdamState(step=jnp.asarray(np.array(steps, np.int32)),
                              mu=jnp_tree(opt_state.mu), nu=jnp_tree(opt_state.nu))
    js = jsteps.TrainState(params=jnp_tree(params), opt_state=jo_state,
                           step=jnp.asarray(steps[0], jnp.int32))
    return js, ts


def _assert_bf16_mean_close(got, want, x, w, st):
    """At most 1 bfloat16 ulp apart, except where the weighted sum of the
    replicas cancels: there the two float32 sums (rounded products here,
    an fmaf chain in the reference's jitted kernel) may differ by their
    float32 rounding, 2^-22 of the sum of |w_k x_k|, which is many ulps
    of a result near zero (0 against 4.7e-10 at exact cancellation)."""
    wt = torch.from_numpy(w)
    if st is not None:
        wt = tfl.staleness_weights(wt, torch.from_numpy(st))
    wt = wt / wt.sum()
    mag = torch.sum(wt.reshape((-1,) + (1,) * (x.ndim - 1)).abs() * x.float().abs(), dim=0)
    want_t = torch.from_numpy(np.asarray(want, np.float32)).to(torch.bfloat16)
    ulps = bf16_ulp_distance(got, want_t)
    err = (got.float() - want_t.float()).abs()
    assert bool(((ulps <= 1) | (err <= 2.0 ** -22 * mag)).all())
    assert float((ulps <= 1).float().mean()) > 0.999


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedleo_aggregate_matches_reference(use_kernel, stale, dtype):
    r = 3
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    js, ts = _adam_states(r, seed=21, dtype=tdt, steps=(3, 5, 8))
    w = np.array([1.0, 2.0, 3.0], np.float32)
    st = np.array([0.0, 1800.0, 7200.0], np.float32) if stale else None
    jout = jfl.make_fedleo_aggregate(use_kernel)(
        js, jnp.asarray(w), None if st is None else jnp.asarray(st))
    tout = tfl.make_fedleo_aggregate(use_kernel)(
        ts, torch.from_numpy(w), None if st is None else torch.from_numpy(st))
    for got, want, x in zip(tree_leaves(tout.params), jax.tree_util.tree_leaves(jout.params),
                            tree_leaves(ts.params)):
        assert got.dtype == tdt and tuple(got.shape) == want.shape
        assert all(torch.equal(got[0], got[i]) for i in range(r))    # every replica the mean
        if tdt == torch.bfloat16:
            _assert_bf16_mean_close(got[0], want[0], x, w, st)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    _assert_trees_close(tout.opt_state.mu, jout.opt_state.mu, 1e-5)
    _assert_trees_close(tout.opt_state.nu, jout.opt_state.nu, 1e-5)
    np.testing.assert_array_equal(tout.opt_state.step.numpy(), np.asarray(jout.opt_state.step))
    assert int(tout.step) == int(jout.step)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("steps,weights", [((7, 7, 7), (1.0, 2.0, 3.0)), ((5, 5, 5), (1.0, 1.0, 1.0)),
                                           ((3, 11, 20), (1.0, 2.0, 3.0)), ((6, 6, 6), (0.7, 0.2, 0.1))])
def test_int32_step_counter_truncates_as_the_reference(use_kernel, steps, weights):
    """Adam's replicated step counter goes through the float32 mean and
    back to int32 by truncation: exactly the reference's integer, also
    where equal counters come back one lower (7 at weights 1:2:3)."""
    js, ts = _adam_states(3, seed=2, steps=steps)
    w = np.array(weights, np.float32)
    jout = jfl.make_fedleo_aggregate(use_kernel)(js, jnp.asarray(w))
    tout = tfl.make_fedleo_aggregate(use_kernel)(ts, torch.from_numpy(w))
    assert tout.opt_state.step.dtype == torch.int32
    np.testing.assert_array_equal(tout.opt_state.step.numpy(), np.asarray(jout.opt_state.step))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_aggregate_passes_sgd_state_and_writes_every_replica(use_kernel, monkeypatch):
    """SGD's state ``()`` has no replicated leaf: the kernel route sends
    only the parameters.  The mean lands in every replica as a view, and
    the next local step leaves the aggregated state as it was."""
    from repro_torch.kernels import aggregate_ops

    calls = []
    real = aggregate_ops.aggregate_pytree
    monkeypatch.setattr(aggregate_ops, "aggregate_pytree",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    _, port, _, tp = _models("mamba2-780m")
    r, opt = 2, topt.sgd(0.1)
    state = tsteps.TrainState(params=_perturbed(tp, r, seed=3), opt_state=opt.init(tp),
                              step=torch.zeros((r,), dtype=torch.int32))
    agg = tfl.make_fedleo_aggregate(use_kernel)(state, torch.ones(r))
    assert agg.opt_state == ()
    assert calls == ([len(tree_leaves(tp))] if use_kernel else [])
    before = [x.clone() for x in tree_leaves(agg)]
    tokens = torch.from_numpy(_tokens(port.cfg.vocab_size, (r, 1, 2, 16), 5))
    new, _ = tfl.make_fedleo_local_step(port, opt)(agg, {"tokens": tokens})
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(agg), before))
    assert not torch.equal(new.params["embed"]["table"][0], new.params["embed"]["table"][1])


def test_staleness_weights_and_replication_match_reference():
    w = np.array([1.0, 2.0, 0.5], np.float32)
    st = np.array([-5.0, 0.0, 5400.0], np.float32)
    np.testing.assert_allclose(
        tfl.staleness_weights(torch.from_numpy(w), torch.from_numpy(st), power=0.7).numpy(),
        np.asarray(jfl.staleness_weights(jnp.asarray(w), jnp.asarray(st), power=0.7)), rtol=1e-6)
    tree = {"a": torch.arange(6.0).reshape(2, 3), "s": torch.tensor(4)}
    rep = tfl.replicate_for_orbits(tree, 3)
    ref = jfl.replicate_for_orbits({"a": jnp.arange(6.0).reshape(2, 3), "s": jnp.asarray(4)}, 3)
    for k in tree:
        np.testing.assert_array_equal(rep[k].numpy(), np.asarray(ref[k]))


# --- remat and the forward-only kernels ------------------------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_changes_memory_not_values(family, monkeypatch):
    """``cfg.remat`` recomputes each unit (Mamba block) in the backward
    pass: the same loss and gradients bit for bit, each unit run twice;
    under ``no_grad`` once, as without remat."""
    from repro_torch.models import hybrid, mamba2, transformer

    calls = []
    if family in ("dense", "moe"):
        real = transformer.Transformer._apply_block
        monkeypatch.setattr(transformer.Transformer, "_apply_block",
                            lambda self, *a, **k: calls.append(1) or real(self, *a, **k))
    else:
        real = mamba2.apply_mamba_block
        monkeypatch.setattr(mamba2, "apply_mamba_block",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    if family == "hybrid":
        monkeypatch.setattr(hybrid, "apply_mamba_block", mamba2.apply_mamba_block)
    tokens = {"tokens": torch.from_numpy(_tokens(512, (2, 16), 6))}
    out, counts = {}, {}
    for remat in (False, True):
        _, port, _, tp = _models(FAMILIES[family], remat=remat)
        calls.clear()
        out[remat] = tsteps._value_and_grad(tsteps._loss_fn(port), tp, tokens)
        counts[remat] = len(calls)
        calls.clear()
        with torch.no_grad():
            port.forward(tp, tokens["tokens"])
        assert len(calls) == counts[False]
    assert counts[True] == 2 * counts[False] > 0
    (l0, _), g0 = out[False]
    (l1, _), g1 = out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


def test_forward_only_kernels_refuse_autograd():
    """flash and SSD have no backward: under grad mode with an input that
    requires grad the dispatch raises (on the CPU as on the card); under
    ``no_grad``, or with no input requiring grad, it runs."""
    rng = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 2, 16), generator=rng) for _ in range(3))
    x = torch.randn((1, 8, 2, 4), generator=rng)
    dt = torch.rand((1, 8, 2), generator=rng) + 0.1
    A = -torch.rand((2,), generator=rng)
    Bm, Cm = (torch.randn((1, 8, 1, 4), generator=rng) for _ in range(2))
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            flash_ops.flash_attention(*args)
        with torch.no_grad():
            flash_ops.flash_attention(*args)
    for i in range(5):
        args = [x, dt, A, Bm, Cm]
        args[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            ssd_ops.ssd(*args, chunk=4)
        with torch.no_grad():
            ssd_ops.ssd(*args, chunk=4)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_ops.ssd(x, dt, A, Bm, Cm, chunk=4,
                    initial_state=torch.zeros((1, 2, 4, 4), requires_grad=True))
    assert flash_ops.flash_attention(q, k, v).shape == q.shape


@pytest.mark.parametrize("arch,impl", [("gemma-7b", {"attn_impl": "pallas"}),
                                       ("mamba2-780m", {"ssd_impl": "pallas"}),
                                       ("zamba2-1.2b", {"attn_impl": "pallas"})])
def test_train_step_through_a_kernel_path_raises(arch, impl):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, dtype=torch.float32, device="cpu", **impl)
    params = model.init(torch.Generator().manual_seed(0))
    opt = topt.sgd(0.1)
    tokens = torch.from_numpy(_tokens(cfg.vocab_size, (1, 8), 0))
    with pytest.raises(RuntimeError, match="no backward"):
        tsteps.make_train_step(model, opt)(_port_state(params, opt), {"tokens": tokens})


def test_federated_task_refuses_adafactor():
    from repro_torch.core import FederatedTask

    with pytest.raises(ValueError, match="elementwise"):
        FederatedTask(init_fn=None, apply_fn=None, clients=[], test_set=None,
                      optimizer=topt.adafactor(), device="cpu")
