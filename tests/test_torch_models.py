"""The port's CNN building blocks and optimizers against the JAX reference.

Weights and inputs are made with numpy (or by the reference's init,
carried across as numpy arrays) and fed to both packages.  Tolerances:

  * logits and conv/pool outputs: 1e-5 in float32 — the two frameworks'
    CPU convolutions and matmuls sum in different orders.
  * optimizers: 1e-6 after several updates on identical gradients —
    elementwise float32 arithmetic on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as jcnn
from repro.models import nn as jnn
from repro.optim import optimizers as jopt
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models import cnn as tcnn
from repro_torch.models import nn as tnn
from repro_torch.optim import optimizers as topt
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


# --- CNN ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "input_shape,widths,hidden",
    [((28, 28, 1), (4, 8), 16), ((32, 32, 3), (4, 8), 16), ((28, 28, 1), (6,), 10)],
)
def test_apply_cnn_matches_reference(input_shape, widths, hidden):
    ref_params = jcnn.init_cnn(jax.random.PRNGKey(0), input_shape, 10,
                               widths=widths, hidden=hidden)
    x = np.random.default_rng(1).standard_normal((5,) + input_shape).astype(np.float32)
    ref = np.asarray(jcnn.apply_cnn(ref_params, jnp.asarray(x)))
    ours = tcnn.apply_cnn(params_from_numpy(_np_params(ref_params), "cpu"),
                          torch.from_numpy(x))
    assert ours.shape == ref.shape == (5, 10)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("widths,hidden", [((4, 8), 16), ((32, 64), 128)])
def test_init_cnn_matches_reference_structure(widths, hidden):
    ref = jcnn.init_cnn(jax.random.PRNGKey(0), (28, 28, 1), 10, widths=widths,
                        hidden=hidden)
    ours = tcnn.init_cnn(torch.Generator().manual_seed(0), (28, 28, 1), 10,
                         widths=widths, hidden=hidden)
    ref_leaves, ref_def = jax.tree_util.tree_flatten(ref)
    our_leaves, our_def = tree_flatten(ours)
    assert [l.shape for l in ref_leaves] == [tuple(l.shape) for l in our_leaves]
    assert tnn.count_params(ours) == jnn.count_params(ref)
    assert tnn.param_bits(ours) == jnn.param_bits(ref)
    for a, b in zip(ref_leaves, our_leaves):
        if a.ndim == 1:                                 # biases start at zero
            assert not np.asarray(a).any() and not b.any()
        else:                                           # U(-s, s), s = fan_in^-1/2
            scale = float(np.sqrt(1.0 / np.prod(a.shape[:-1])))
            assert float(b.abs().max()) <= scale
            assert float(np.abs(np.asarray(a)).max()) <= scale
    if widths == (32, 64):
        assert tnn.count_params(ours) == 421_642       # the paper's full width


def test_init_is_seeded():
    a = tcnn.init_cnn(torch.Generator().manual_seed(3), widths=(4,), hidden=8)
    b = tcnn.init_cnn(torch.Generator().manual_seed(3), widths=(4,), hidden=8)
    c = tcnn.init_cnn(torch.Generator().manual_seed(4), widths=(4,), hidden=8)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert not torch.equal(a["fc1"]["w"], c["fc1"]["w"])


@pytest.mark.parametrize(
    "hw,ksize,stride,padding",
    [(7, 3, 1, "SAME"), (8, 2, 2, "SAME"), (7, 2, 2, "SAME"), (9, 4, 3, "SAME"),
     (7, 3, 2, "VALID"), (6, 1, 1, "SAME")],
)
def test_apply_conv_matches_reference(hw, ksize, stride, padding):
    rng = np.random.default_rng(hw * ksize + stride)
    p = {"w": rng.standard_normal((ksize, ksize, 3, 5)).astype(np.float32),
         "b": rng.standard_normal(5).astype(np.float32)}
    x = rng.standard_normal((2, hw, hw + 1, 3)).astype(np.float32)
    ref = np.asarray(jnn.apply_conv(jax.tree_util.tree_map(jnp.asarray, p),
                                    jnp.asarray(x), stride=stride, padding=padding))
    ours = tnn.apply_conv(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                          stride=stride, padding=padding)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(4, 4), (7, 5), (2, 3)])
def test_max_pool_matches_reference(hw):
    x = np.random.default_rng(0).standard_normal((2,) + hw + (3,)).astype(np.float32)
    ref = np.asarray(jnn.max_pool(jnp.asarray(x), 2))
    ours = tnn.max_pool(torch.from_numpy(x), 2)
    assert tuple(ours.shape) == ref.shape
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_dense_and_tree_cast_match_reference():
    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((6, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    x = rng.standard_normal((3, 6)).astype(np.float32)
    ref = np.asarray(jnn.apply_dense(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x)))
    ours = tnn.apply_dense(params_from_numpy(p, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)
    cast = tnn.tree_cast(params_from_numpy(p, "cpu"), torch.bfloat16)
    assert all(l.dtype == torch.bfloat16 for l in tree_leaves(cast))


# --- optimizers --------------------------------------------------------------------
def _grads(step, shapes):
    rng = np.random.default_rng(100 + step)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize(
    "name,kwargs",
    [("sgd", {}), ("momentum", {}), ("momentum", {"nesterov": True}),
     ("adam", {}), ("adam", {"weight_decay": 0.01})],
)
def test_optimizer_updates_match_reference(name, kwargs):
    shapes = {"w": (4, 3), "b": (3,), "z": ()}
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jo = jopt.get_optimizer(name, 0.01, **kwargs)
    to = topt.get_optimizer(name, 0.01, **kwargs)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p0), params_from_numpy(p0, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for step in range(6):
        g = _grads(step, shapes)
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = to.update(params_from_numpy(g, "cpu"), ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
    for key in shapes:
        np.testing.assert_allclose(params_to_numpy(tp)[key], np.asarray(jp[key]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _grads(0, {"a": (5, 2), "b": (7,)})
    ref = jopt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    ours = topt.clip_by_global_norm(params_from_numpy(g, "cpu"), max_norm)
    for key in g:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-6, atol=1e-6)


def test_get_optimizer_raises_on_names_not_ported():
    """Every optimizer of the reference is ported, adafactor included;
    a name neither package has still raises."""
    opt = topt.get_optimizer("adafactor", 0.01)
    assert opt.name == "adafactor" and isinstance(opt.init({"w": torch.zeros(3, 2)}),
                                                  topt.AdafactorState)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get_optimizer("lion", 0.01)


# --- pytrees and conversion ------------------------------------------------------------
_TREES = [
    {"b": 1, "a": [2, {"z": 3, "y": 4}], "c": (5, 6)},
    [{"k2": 1, "k1": 2}, [3, [4, 5]]],
    {"conv": [{"w": 1, "b": 2}, {"w": 3, "b": 4}], "fc1": {"w": 5, "b": 6}, "fc2": {"w": 7}},
]


@pytest.mark.parametrize("tree", _TREES)
def test_tree_flatten_order_matches_jax(tree):
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    back = tree_unflatten(treedef, leaves)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    doubled = tree_map(lambda a, b: a + b, tree, tree)
    assert jax.tree_util.tree_leaves(doubled) == [2 * l for l in leaves]


@pytest.mark.parametrize("build", ["tree_map", "flatten_up_to"])
def test_tree_helpers_leave_no_reference_cycle(build):
    """A tree built by ``tree_map`` (``tree_unflatten``) or read by
    ``flatten_up_to`` lets its leaves go with the last reference, with
    the cyclic collector off: a recursive closure would hold them in a
    cycle until it runs."""
    import gc
    import weakref

    from repro_torch.tree import flatten_up_to

    tree = {"a": [torch.ones(4), (torch.ones(2), torch.ones(3))], "b": torch.ones(5)}
    enabled = gc.isenabled()
    gc.disable()
    try:
        if build == "tree_map":
            out = tree_map(lambda t: t * 2, tree)
        else:
            out = flatten_up_to(tree_flatten(tree)[1], tree_map(lambda t: t * 2, tree))
        refs = [weakref.ref(t) for t in tree_leaves(out)]
        del out
        assert all(r() is None for r in refs)
    finally:
        if enabled:
            gc.enable()


def test_tree_map_rejects_mismatched_structures():
    with pytest.raises(ValueError, match="structures differ"):
        tree_map(lambda a, b: a, {"a": 1}, {"b": 1})
    with pytest.raises(ValueError, match="leaves"):
        tree_unflatten(tree_flatten([1, 2])[1], [1])


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.int32])
def test_params_round_trip_through_numpy(dtype):
    ref = {"w": jnp.asarray(np.random.default_rng(0).standard_normal((3, 4)) * 100, dtype),
           "l": [jnp.arange(5, dtype=dtype)]}
    ours = params_from_numpy(_np_params(ref), "cpu")
    assert ours["w"].dtype == {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
                               jnp.int32: torch.int32}[dtype]
    back = params_to_numpy(ours)
    np.testing.assert_array_equal(back["w"], np.asarray(ref["w"], back["w"].dtype))
    np.testing.assert_array_equal(back["l"][0], np.asarray(ref["l"][0], back["l"][0].dtype))
