"""The port's aggregation (repro_torch) against the JAX reference (repro).

Inputs are made from a seed with numpy and handed to both packages.
The reference's Pallas kernel runs in interpret mode, as its own tests
run it.  Tolerances:

  * float32: 1e-5 (the reference kernel tests' tolerance; the two sides
    sum the K products in different orders).
  * bfloat16: at most 1 ulp.  Both sides accumulate in float32 and round
    once, so they differ only where the float32 sums straddle a rounding
    boundary — the reference's own kernel and jnp paths differ by 1 ulp
    in the same way.

The CUDA kernel itself runs only on the card: tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.kernels.aggregate import aggregate_flat as jaggregate_flat
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.kernels import aggregate_ops, build
from repro_torch.kernels.aggregate import aggregate_flat
from repro_torch.kernels.aggregate_ref import aggregate_flat_ref, bf16_ulp_distance
from repro_torch.tree import tree_leaves


def _ragged_tree(rng, k, dtype=np.float32):
    """A pytree of ragged leaves stacked over K: conv kernel, biases,
    dense matrices, a scalar-per-client leaf, a nested list."""
    shapes = {
        "conv": [(3, 3, 1, 4), (4,)],
        "fc": {"w": (37, 5), "b": (5,)},
        "scale": (),
        "deep": [[(7, 3)], {"z": (11,)}],
    }

    def make(s):
        if isinstance(s, dict):
            return {key: make(v) for key, v in s.items()}
        if isinstance(s, list):
            return [make(v) for v in s]
        return rng.standard_normal((k,) + s).astype(dtype)

    return make(shapes)


def _jax_tree(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _assert_tree_close(ours, ref, *, dtype):
    ours_l = [np.asarray(a, np.float32) for a in tree_leaves(params_to_numpy(ours))]
    ref_l = [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(ref)]
    assert len(ours_l) == len(ref_l)
    for a, b in zip(ours_l, ref_l):
        assert a.shape == b.shape
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        else:
            ulps = bf16_ulp_distance(
                torch.from_numpy(a).to(torch.bfloat16),
                torch.from_numpy(b).to(torch.bfloat16),
            )
            assert int(ulps.max()) <= 1


@pytest.mark.parametrize("k,n", [(1, 17), (3, 1000), (5, 40_003), (8, 4096)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_ref_matches_pallas_kernel(k, n, dtype):
    rng = np.random.default_rng(k * n)
    x = rng.standard_normal((k, n)).astype(np.float32)
    w = rng.random(k).astype(np.float32) + 0.05
    w /= w.sum()
    ref = jaggregate_flat(jnp.asarray(x, dtype), jnp.asarray(w), block_n=4096,
                          interpret=True)
    xt = params_from_numpy(np.asarray(jnp.asarray(x, dtype)), "cpu")
    ours = aggregate_flat_ref(xt, torch.from_numpy(w))
    assert ours.dtype == xt.dtype and ours.shape == (n,)
    _assert_tree_close([ours], [ref], dtype=dtype)


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_average_kernel_path_matches_reference(k, dtype):
    rng = np.random.default_rng(100 + k)
    tree = _ragged_tree(rng, k)
    weights = rng.random(k).astype(np.float32) + 0.1
    ref = jagg.weighted_average(_jax_tree(tree, dtype), jnp.asarray(weights),
                                use_kernel=True)
    ours = tagg.weighted_average(
        params_from_numpy(_jax_tree(tree, dtype), "cpu"),
        torch.from_numpy(weights), use_kernel=True,
    )
    _assert_tree_close(ours, ref, dtype=dtype)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_partial_and_global_aggregate_match_reference(use_kernel):
    rng = np.random.default_rng(7)
    tree = _ragged_tree(rng, 5)
    counts = [40, 41, 39, 40, 12]
    hists = rng.integers(0, 9, size=(5, 10)).astype(np.float64)
    j, t = _jax_tree(tree, "float32"), params_from_numpy(tree, "cpu")
    _assert_tree_close(
        tagg.partial_aggregate(t, counts, use_kernel=use_kernel),
        jagg.partial_aggregate(j, counts, use_kernel=use_kernel), dtype="float32",
    )
    _assert_tree_close(
        tagg.global_aggregate(t, counts, histograms=hists, noniid_alpha=0.5,
                              use_kernel=use_kernel),
        jagg.global_aggregate(j, counts, histograms=hists, noniid_alpha=0.5,
                              use_kernel=use_kernel), dtype="float32",
    )


def test_mixed_dtype_leaves_promote_and_cast_back():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 6, 3)).astype(np.float32),
            "b": rng.standard_normal((4, 9)).astype(np.float32)}
    jt = {"a": jnp.asarray(tree["a"]), "b": jnp.asarray(tree["b"], jnp.bfloat16)}
    w = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    ref = jagg.weighted_average(jt, jnp.asarray(w), use_kernel=True)
    ours = aggregate_ops.aggregate_pytree(params_from_numpy(jt, "cpu"),
                                          torch.from_numpy(w))
    assert ours["a"].dtype == torch.float32 and ours["b"].dtype == torch.bfloat16
    np.testing.assert_allclose(ours["a"].numpy(), np.asarray(ref["a"]), rtol=1e-5, atol=1e-5)
    assert int(bf16_ulp_distance(ours["b"], params_from_numpy(ref["b"], "cpu")).max()) <= 1


def test_noniid_weights_copy_matches_reference():
    h = np.random.default_rng(0).integers(0, 5, size=(6, 10))
    h[:, 3] = 0
    np.testing.assert_array_equal(tagg.noniid_weights(h), jagg.noniid_weights(h))
    np.testing.assert_array_equal(
        tagg.noniid_weights(np.zeros((3, 4))), jagg.noniid_weights(np.zeros((3, 4)))
    )


def test_stack_and_index_pytrees_match_reference():
    rng = np.random.default_rng(1)
    trees = [{"w": rng.standard_normal((3, 2)).astype(np.float32),
              "l": [rng.standard_normal(4).astype(np.float32)]} for _ in range(3)]
    ref = jagg.stack_pytrees([_jax_tree(t, "float32") for t in trees])
    ours = tagg.stack_pytrees([params_from_numpy(t, "cpu") for t in trees])
    _assert_tree_close(ours, ref, dtype="float32")
    _assert_tree_close(tagg.index_pytree(ours, 2), jagg.index_pytree(ref, 2),
                       dtype="float32")


def test_bf16_ulp_distance():
    a = torch.tensor([1.0, 1.0, -1.0, 0.0, -0.0, 2.0], dtype=torch.bfloat16)
    b = torch.tensor([1.0, 1.0078125, -1.0078125, -0.0, 0.0, 1.9921875],
                     dtype=torch.bfloat16)
    assert bf16_ulp_distance(a, b).tolist() == [0, 1, 1, 0, 0, 1]
    tiny = torch.tensor([0.0], dtype=torch.bfloat16)
    step = torch.tensor([1], dtype=torch.int16).view(torch.bfloat16)
    assert bf16_ulp_distance(tiny, step).item() == 1
    assert bf16_ulp_distance(-step, step).item() == 2


# --- dispatch: a CUDA stream goes to the kernel and nowhere else ---------------------
def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((2, 5))
    w = torch.full((2,), 0.5)
    before = aggregate_flat.launches
    with pytest.raises(ValueError, match="CUDA"):
        aggregate_flat(x, w)
    assert aggregate_flat.launches == before


def test_ops_raise_on_a_device_with_no_path(monkeypatch):
    """Only CUDA (kernel) and CPU (plain version) streams are aggregated;
    the plain version is never reached for any other device."""
    called = []
    monkeypatch.setattr(aggregate_ops, "aggregate_flat_ref",
                        lambda *a: called.append(a))
    tree = {"w": torch.zeros((2, 3), device="meta")}
    with pytest.raises(ValueError, match="no aggregation path"):
        aggregate_ops.aggregate_pytree(tree, torch.full((2,), 0.5))
    assert not called


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "CUDA_ROOTS", ())
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("aggregate")
    assert not (tmp_path / "out").exists()


def test_build_lists_and_keys_the_kernel_sources(monkeypatch, tmp_path):
    assert (build.CSRC / "aggregate.cu").is_file()
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    path = build.library_path("aggregate")
    assert path.parent.parent == tmp_path and path.name == "libaggregate.so"
    assert build.library_path("aggregate") == path      # stable key
    # the key covers the flags: a library built otherwise is not reused
    monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-lineinfo"))
    assert build.library_path("aggregate") != path
