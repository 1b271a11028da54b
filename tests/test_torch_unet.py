"""The paper's Fig. 5 segmentation model: the port's U-Net and its new
layers against the JAX package.

  * ``apply_conv_transpose`` (XLA's SAME transposed convolution) for
    kernel sizes 2, 3, 4 at stride 2 on even and odd sizes: within
    1e-5 of the output's largest value (float32 rounding; k = 2, the
    U-Net's, is exact).
  * ``init_layernorm`` equal, ``apply_layernorm`` within 1e-6.
  * ``init_unet``: the same tree, leaf shapes and parameter count
    (285,970 at the defaults); ``apply_unet`` on carried parameters
    (biases made non-zero) at fig. 5's base 4 / depth 2 and at the
    default width: float32 logits within 2e-5 of the largest logit.
  * A 2-round FedLEO run on the DeepGlobe-like data at fig. 5's setup
    (base 4, depth 2, 32x32 images, Adam 1e-3, the aggregation kernel
    path on): round times and events exactly equal, parameters within
    1e-4, pixel accuracy within 2 test pixels per thousand.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import data as jdata
from repro.models import cnn as jcnn
from repro.models import nn as jnn
from repro.optim import get_optimizer as jget_optimizer
from repro_torch import data as tdata
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import cnn as tcnn
from repro_torch.models import nn as tnn
from repro_torch.optim import get_optimizer as tget_optimizer
from repro_torch.tree import tree_flatten, tree_leaves

UNET_DEFAULT_PARAMS = 285_970
UNET_DEFAULT_LEAVES = 28


def _ref_unet(seed=0, **kw):
    """Parameters in the reference U-Net's tree, as numpy: its structure
    and shapes from ``jax.eval_shape`` (eager JAX initialisation takes
    tens of seconds on the CPU), kernels drawn from numpy at the
    reference's scale, biases made non-zero."""
    shapes = jax.eval_shape(lambda k: jcnn.init_unet(k, **kw), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(leaf):
        if len(leaf.shape) == 1:
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        scale = np.sqrt(1.0 / np.prod(leaf.shape[:-1]))
        return rng.uniform(-scale, scale, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("h", [7, 8])
def test_conv_transpose_matches_reference(k, h):
    rng = np.random.default_rng(10 * k + h)
    x = rng.standard_normal((2, h, h + 1, 5)).astype(np.float32)
    p = {"w": rng.standard_normal((k, k, 5, 3)).astype(np.float32),
         "b": rng.standard_normal(3).astype(np.float32)}
    ref = np.asarray(jnn.apply_conv_transpose(jax.tree_util.tree_map(jnp.asarray, p),
                                              jnp.asarray(x), stride=2))
    ours = tnn.apply_conv_transpose(params_from_numpy(p, "cpu"), torch.from_numpy(x), stride=2)
    assert ours.shape == ref.shape == (2, 2 * h, 2 * (h + 1), 3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_layernorm_matches_reference():
    ref_p = jax.tree_util.tree_map(np.asarray, jnn.init_layernorm(24))
    ours_p = tnn.init_layernorm(24)
    for key in ("scale", "bias"):
        np.testing.assert_array_equal(ours_p[key].numpy(), ref_p[key])
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((4, 7, 24))).astype(np.float32)
    p = {"scale": rng.standard_normal(24).astype(np.float32),
         "bias": rng.standard_normal(24).astype(np.float32)}
    ref = np.asarray(jnn.apply_layernorm(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x)))
    ours = tnn.apply_layernorm(params_from_numpy(p, "cpu"), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6 * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("kw", [dict(base=4, depth=2), dict()], ids=["fig5", "default"])
def test_init_unet_tree_matches_reference(kw):
    ref = jax.eval_shape(lambda k: jcnn.init_unet(k, **kw), jax.random.PRNGKey(0))
    ours = tcnn.init_unet(torch.Generator().manual_seed(0), **kw)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    leaves, treedef = tree_flatten(ours)
    assert [tuple(l.shape) for l in leaves] == [l.shape for l in ref_leaves]
    assert [l.dtype for l in leaves] == [torch.float32] * len(ref_leaves)
    assert all(l.dtype == np.float32 for l in ref_leaves)
    assert treedef == tree_flatten(params_from_numpy(_ref_unet(**kw), "cpu"))[1]
    assert ours["skipconv"] == [] and set(ours) == set(ref)
    assert tnn.count_params(ours) == sum(int(np.prod(l.shape)) for l in ref_leaves)
    if not kw:
        assert tnn.count_params(ours) == UNET_DEFAULT_PARAMS
        assert len(leaves) == UNET_DEFAULT_LEAVES


@pytest.mark.parametrize("kw,size", [(dict(base=4, depth=2), 32), (dict(), 64)],
                         ids=["fig5", "default"])
def test_apply_unet_matches_reference(kw, size):
    params = _ref_unet(**kw)
    x = np.random.default_rng(2).standard_normal((2, size, size, 3)).astype(np.float32)
    ref = np.asarray(jcnn.apply_unet(params, jnp.asarray(x)))
    ours = tcnn.apply_unet(params_from_numpy(params, "cpu"), torch.from_numpy(x)).numpy()
    assert ours.shape == ref.shape == (2, size, size, 2)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5 * np.abs(ref).max())


# --- a FedLEO run on the DeepGlobe-like data ---------------------------------------
HP = dict(local_epochs=20, learning_rate=0.01, batch_size=4)


def _seg_data(pkg):
    train = pkg.make_segmentation_dataset(num_samples=80, size=32, seed=0)
    test = pkg.make_segmentation_dataset(num_samples=16, size=32, seed=9)
    return pkg.partition_iid(train, 5, 8), test


@pytest.fixture(scope="module")
def unet_runs():
    init = _ref_unet(in_ch=3, base=4, depth=2)
    clients, test = _seg_data(jdata)
    jtask = J.FederatedTask(
        init_fn=lambda r: jax.tree_util.tree_map(jnp.asarray, init),
        apply_fn=jcnn.apply_unet, clients=clients, test_set=test,
        optimizer=jget_optimizer("adam", 1e-3), hp=J.TrainHyperparams(**HP),
        sim_epochs=2,
    )
    clients, test = _seg_data(tdata)
    ttask = T.FederatedTask(
        init_fn=lambda r: params_from_numpy(init, "cpu"),
        apply_fn=tcnn.apply_unet, clients=clients, test_set=test,
        optimizer=tget_optimizer("adam", 1e-3), hp=T.TrainHyperparams(**HP),
        sim_epochs=2, device="cpu",
    )
    # one full batch per epoch: the gradient does not depend on the order
    assert max(ttask.num_samples(c) for c in range(40)) <= HP["batch_size"]
    runs = []
    for pkg, task in ((J, jtask), (T, ttask)):
        strat = pkg.FedLEO(task, pkg.SimConfig(horizon_hours=72.0, use_kernel=True))
        runs.append((strat, strat.run(max_rounds=2)))
    return runs


def test_unet_fedleo_schedule_equal_exactly(unet_runs):
    (_, jres), (_, tres) = unet_runs
    assert len(tres.history) == len(jres.history) == 2
    assert [h.t_hours for h in tres.history] == [h.t_hours for h in jres.history]
    assert [h.events for h in tres.history] == [h.events for h in jres.history]


def test_unet_fedleo_params_close(unet_runs):
    (jstrat, jres), (tstrat, tres) = unet_runs
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jstrat.global_params))
    ours = tree_leaves(params_to_numpy(tstrat.global_params))
    assert len(ours) == len(ref) == 20
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    init = tree_leaves(params_to_numpy(tstrat.task.global_params))
    assert max(float(np.abs(a - b).max()) for a, b in zip(ours, init)) > 1e-4
    for jh, th in zip(jres.history, tres.history):
        assert abs(th.metrics["accuracy"] - jh.metrics["accuracy"]) <= 2e-3
        assert th.metrics["loss"] == pytest.approx(jh.metrics["loss"], abs=1e-4)
