"""The port's checkpoints against the JAX package's, on the CPU.

Both packages write ``ckpt_{step:08d}.npz`` with one array per leaf under
``{i:05d}__{keypath}``.  The tests hold the port's keys and arrays equal
to the reference's for the same ``TrainState`` (SGD, Adam, adafactor with
its ``(row, col)`` pairs), restore each package's file in the other, and
check the bfloat16 route: the reference writes a bfloat16 leaf as raw
2-byte words (``|V2``) and cannot read them back; the port writes the
same bytes and reads them back bit for bit.  Values are exact: no
tolerance.  The driver's checkpoints (``launch/train.py``) restore in
both packages and resume a run.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.configs import build_model as ref_build_model
from repro.configs import get_smoke_config as ref_smoke_config
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch import ckpt as tckpt
from repro_torch.ckpt.checkpoint import _key_str
from repro_torch.convert import params_from_numpy
from repro_torch.launch import train as tdriver
from repro_torch.optim import optimizers as topt
from repro_torch.train import steps as tsteps
from repro_torch.tree import (tree_flatten, tree_flatten_with_path, tree_leaves, tree_map,
                              tree_unflatten)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _small_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32),
            "layers": [{"k": rng.standard_normal((2, 5, 2)).astype(np.float32)},
                       {"k": rng.standard_normal((2, 5, 2)).astype(np.float32)}]}


def _states(opt_name, seed=0, step=7):
    """The same TrainState in both packages: the reference's, one
    optimizer update in (so the moments are not zero), and its leaves
    carried into the port's structure and classes."""
    p = _small_params(seed)
    g = _small_params(seed + 1)
    jo, to = jopt.get_optimizer(opt_name, 0.1), topt.get_optimizer(opt_name, 0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    _, jo_state = jo.update(jax.tree_util.tree_map(jnp.asarray, g), jo.init(jp), jp)
    js = jsteps.TrainState(params=jp, opt_state=jo_state, step=jnp.asarray(step, jnp.int32))
    tp = params_from_numpy(p, "cpu")
    template = tsteps.TrainState(params=tp, opt_state=to.init(tp),
                                 step=torch.tensor(0, dtype=torch.int32))
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(js)]
    ts = tree_unflatten(tree_flatten(template)[1], params_from_numpy(leaves, "cpu"))
    return js, ts


def _npz(directory, step):
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as data:
        return {k: data[k] for k in data.files}


def _assert_equal_trees(got, want):
    g, w = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == torch.from_numpy(np.zeros(0, np.asarray(b).dtype)).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("opt_name", ["sgd", "adam", "adafactor"])
def test_keys_and_arrays_match_reference(opt_name, tmp_path):
    js, ts = _states(opt_name)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, js)
    tckpt.save_checkpoint(str(tmp_path / "port"), 3, ts)
    ref, ours = _npz(tmp_path / "ref", 3), _npz(tmp_path / "port", 3)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
    # the key paths themselves, leaf by leaf
    jpaths = [jckpt.checkpoint._key_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(js)[0]]
    assert [_key_str(p) for p, _ in tree_flatten_with_path(ts)[0]] == jpaths


def test_adam_keys_name_fields_in_order(tmp_path):
    p = {"w": torch.ones(2, 2), "b": torch.zeros(2)}
    opt = topt.adam(0.1)
    state = tsteps.TrainState(params=p, opt_state=opt.init(p), step=torch.tensor(0, dtype=torch.int32))
    tckpt.save_checkpoint(str(tmp_path), 0, state)
    assert list(_npz(tmp_path, 0)) == [
        "00000__params_b", "00001__params_w", "00002__opt_state_step",
        "00003__opt_state_mu_b", "00004__opt_state_mu_w",
        "00005__opt_state_nu_b", "00006__opt_state_nu_w", "00007__step"]


@pytest.mark.parametrize("opt_name", ["adam", "adafactor"])
def test_checkpoints_restore_across_packages(opt_name, tmp_path):
    js, ts = _states(opt_name, seed=3)
    js_other, ts_other = _states(opt_name, seed=8, step=0)     # templates
    tckpt.save_checkpoint(str(tmp_path / "port"), 5, ts)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 5, js)
    # port -> reference
    _assert_equal_trees(ts, jckpt.restore_checkpoint(str(tmp_path / "port"), 5, js_other))
    # reference -> port, into the port's own classes
    back = tckpt.restore_checkpoint(str(tmp_path / "ref"), 5, ts_other)
    assert type(back) is tsteps.TrainState and type(back.opt_state) is type(ts.opt_state)
    _assert_equal_trees(back, js)
    assert tckpt.latest_step(str(tmp_path / "ref")) == 5
    assert tckpt.latest_step(str(tmp_path / "none")) is None


def test_bfloat16_leaves(tmp_path):
    """The reference writes a bfloat16 leaf as raw words and raises on
    restoring it; the port writes the same bytes and reads them back."""
    x = np.random.default_rng(0).standard_normal(7).astype(np.float32)
    jtree = {"h": jnp.asarray(x).astype(jnp.bfloat16), "f": jnp.asarray(x)}
    ttree = {"h": torch.from_numpy(x).to(torch.bfloat16), "f": torch.from_numpy(x)}
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, jtree)
    tckpt.save_checkpoint(str(tmp_path / "port"), 1, ttree)
    ref, ours = _npz(tmp_path / "ref", 1), _npz(tmp_path / "port", 1)
    assert ref["00001__h"].dtype == ours["00001__h"].dtype == np.dtype("V2")
    assert ref["00001__h"].tobytes() == ours["00001__h"].tobytes()
    with pytest.raises(ValueError):
        jckpt.restore_checkpoint(str(tmp_path / "ref"), 1, jtree)
    template = {"h": torch.zeros(7, dtype=torch.bfloat16), "f": torch.zeros(7)}
    for d in ("ref", "port"):
        back = tckpt.restore_checkpoint(str(tmp_path / d), 1, template)
        assert back["h"].dtype == torch.bfloat16
        assert torch.equal(back["h"].view(torch.int16), ttree["h"].view(torch.int16))
        assert torch.equal(back["f"], ttree["f"])


def test_restore_takes_the_templates_dtypes(tmp_path):
    tree = {"a": torch.tensor([1.5, -2.75]), "n": torch.tensor([3, 4], dtype=torch.int32)}
    tckpt.save_checkpoint(str(tmp_path), 2, tree)
    template = {"a": torch.zeros(2, dtype=torch.bfloat16), "n": torch.zeros(2, dtype=torch.int64)}
    back = tckpt.restore_checkpoint(str(tmp_path), 2, template)
    assert back["a"].dtype == torch.bfloat16 and back["n"].dtype == torch.int64
    assert back["a"].tolist() == [1.5, -2.75] and back["n"].tolist() == [3, 4]
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore_checkpoint(str(tmp_path), 2, {"a": template["a"]})


def test_reference_train_state_carries_across_from_numpy():
    """A whole reference TrainState with adafactor's state, as numpy,
    loads with ``params_from_numpy``: the same leaves under the same key
    paths, and the port's adafactor takes it up where the reference's
    left it."""
    js, ts = _states("adafactor", seed=5)
    carried = params_from_numpy(_np_tree(js), "cpu")
    jpaths = [jckpt.checkpoint._key_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(js)[0]]
    assert [_key_str(p) for p, _ in tree_flatten_with_path(carried)[0]] == jpaths
    _assert_equal_trees(carried, js)
    assert isinstance(carried.opt_state.factored["w"], tuple)
    g = _small_params(9)
    ju, _ = jopt.adafactor(0.1).update(jax.tree_util.tree_map(jnp.asarray, g), js.opt_state, js.params)
    tu, _ = topt.adafactor(0.1).update(params_from_numpy(g, "cpu"), carried.opt_state, carried.params)
    for a, b in zip(tree_leaves(tu), jax.tree_util.tree_leaves(ju)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def test_driver_checkpoints_restore_in_both_packages(tmp_path, capsys):
    """``launch/train.py`` on the CPU: a plain run's checkpoint restores
    in the reference against its own state's structure; a FedLEO run
    checkpoints the aggregated model (replica 0) and a new run resumes
    from it."""
    d = str(tmp_path / "plain")
    state = tdriver.train(tdriver.parse_args(
        ["--arch", "gemma-7b", "--smoke", "--steps", "2", "--batch", "2", "--seq", "16",
         "--ckpt-dir", d, "--ckpt-every", "2", "--device", "cpu"]))
    assert tckpt.latest_step(d) == 2 and int(state.step) == 2
    ref_model = ref_build_model(ref_smoke_config("gemma-7b"))
    rp = ref_model.init(jax.random.PRNGKey(0))
    jo = jopt.get_optimizer("adam", 1e-3)
    restored = jckpt.restore_checkpoint(d, 2, jsteps.TrainState(rp, jo.init(rp), jnp.zeros((), jnp.int32)))
    _assert_equal_trees(state, restored)

    d = str(tmp_path / "fedleo")
    args = ["--arch", "mamba2-780m", "--smoke", "--fedleo", "--steps", "4", "--tau", "2",
            "--batch", "2", "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "4", "--device", "cpu"]
    state = tdriver.train(tdriver.parse_args(args))
    assert tckpt.latest_step(d) == 4 and state.step.tolist() == [4, 4]
    template = tree_map(lambda x: x[0], state)
    back = tckpt.restore_checkpoint(d, 4, template)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(template)))
    capsys.readouterr()
    tdriver.main(args[:5] + ["0"] + args[6:])
    assert "[train] restored step 4" in capsys.readouterr().out
