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

The kernel's planner (tiles over the leaves, the table, the split into
launches) is pure Python and is tested here; the CUDA kernel itself runs
only on the card: tests/test_torch_kernels_cuda.py.
"""
import bisect
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import aggregation as jagg
from repro.kernels.aggregate import aggregate_flat as jaggregate_flat
from repro.kernels.aggregate_ops import aggregate_pytree as jaggregate_pytree
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.kernels import aggregate as kagg
from repro_torch.kernels import aggregate_ref as kagg_ref
from repro_torch.kernels import aggregate_ops, build
from repro_torch.kernels.aggregate import LeafSpec, aggregate_flat, aggregate_leaves, plan
from repro_torch.kernels.aggregate_ref import (aggregate_flat_ref, aggregate_leaves_ref,
                                               bf16_ulp_distance, weighted_sum_leaves)
from repro_torch.models.cnn import init_cnn
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten


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
    monkeypatch.setattr(aggregate_ops, "weighted_sum_leaves",
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


# --- the kernel's planner: tiles over the leaves, the table, the launches ------------
CNN_SHAPES = [tuple(l.shape) for l in tree_leaves(init_cnn(torch.Generator().manual_seed(0)))]


def _spec(n, itemsize=4, x=1 << 20, out=1 << 30, stride=None):
    return LeafSpec(x=x, out=out, n=n, stride=n if stride is None else stride,
                    itemsize=itemsize, bf16=itemsize == 2)


def _specs_of(sizes, itemsizes):
    """Contiguous leaves laid out one after another from 16-byte aligned
    bases, as separate allocations are."""
    specs, x, out = [], 1 << 20, 1 << 32
    for n, size in zip(sizes, itemsizes):
        specs.append(_spec(n, size, x=x, out=out))
        x += -(-max(n, 1) * size * 3 // 512) * 512
        out += -(-max(n, 1) * size // 512) * 512
    return specs


def _tile_range(launch, specs, tile):
    """(leaf index, first element, end element) of one tile of a launch,
    found as the kernel finds it: the last leaf whose first tile is at or
    before ``tile``."""
    j = bisect.bisect_right(launch.tile0, tile) - 1
    s = specs[launch.leaves[j]]
    start = (tile - launch.tile0[j]) * s.tile_elems
    return launch.leaves[j], start, min(start + s.tile_elems, s.n)


def _coverage(specs, launches):
    """How many times the kernel's threads write each element of each
    leaf, following the kernel's tiles (``_tile_range``) and its threads'
    accesses within a tile: thread t's q-th access of ``vec_bytes`` at
    element start + (q * THREADS + t) * (vec_bytes / itemsize)."""
    seen = [np.zeros(s.n, np.int64) for s in specs]
    for launch in launches:
        assert launch.tile0[0] == 0 and list(launch.tile0) == sorted(launch.tile0)
        for tile in range(launch.tiles):
            i, start, stop = _tile_range(launch, specs, tile)
            s = specs[i]
            assert 0 <= start < stop <= s.n and stop - start <= s.tile_elems
            ev = s.vec_bytes // s.itemsize
            accesses = kagg.TILE_BYTES // kagg.THREADS // s.vec_bytes
            firsts = start + (np.arange(accesses)[:, None] * kagg.THREADS
                              + np.arange(kagg.THREADS)[None, :]).ravel() * ev
            firsts = firsts[firsts < s.n]
            assert (firsts + ev <= s.n).all()     # no access crosses the leaf's end
            elems = (firsts[:, None] + np.arange(ev)[None, :]).ravel()
            assert elems.min() >= start and elems.max() < stop
            np.add.at(seen[i], elems, 1)
    return seen


RAGGED_LEAVES = {
    "cnn_f32": ([math.prod(s) for s in CNN_SHAPES], [4] * len(CNN_SHAPES)),
    "cnn_bf16": ([math.prod(s) for s in CNN_SHAPES], [2] * len(CNN_SHAPES)),
    "mixed": ([1, 7, 2048, 2049, 4096, 4100, 0, 12_345, 8, 3], [4, 2, 4, 2, 2, 4, 4, 2, 2, 4]),
    "one_big": ([1_000_003], [2]),
    "tiny": ([1, 2, 3, 4, 5, 6, 7, 8, 9], [4] * 9),
}


@pytest.mark.parametrize("case", sorted(RAGGED_LEAVES))
@pytest.mark.parametrize("max_leaves", [kagg.MAX_LEAVES, 3])
def test_planner_covers_every_element_once(case, max_leaves):
    sizes, itemsizes = RAGGED_LEAVES[case]
    specs = _specs_of(sizes, itemsizes)
    launches = plan(specs, max_leaves=max_leaves)
    assert all(len(l.leaves) <= max_leaves for l in launches)
    planned = [i for l in launches for i in l.leaves]
    assert planned == [i for i, s in enumerate(specs) if s.n > 0]
    for s, count in zip(specs, _coverage(specs, launches)):
        assert (count == 1).all()
    nonempty = sum(s.n > 0 for s in specs)
    assert len(launches) == -(-nonempty // max_leaves)


@settings(max_examples=60, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 20_000), st.sampled_from([2, 4]),
                          st.sampled_from([0, 1, 2, 4])), min_size=1, max_size=12),
       st.integers(1, 5))
def test_planner_covers_every_element_once_property(leaves, max_leaves):
    """Ragged leaves of both element sizes, some on bases a few elements
    off 16 bytes, planned into tables of 1-5 leaves."""
    specs = [_spec(n, size, x=(1 << 20) * (i + 1) + shift * size,
                   out=(1 << 40) + (1 << 20) * i)
             for i, (n, size, shift) in enumerate(leaves)]
    launches = plan(specs, max_leaves=max_leaves)
    for s, count in zip(specs, _coverage(specs, launches)):
        assert (count == 1).all()
    assert sum(l.tiles for l in launches) == sum(-(-s.n // s.tile_elems) for s in specs)


@pytest.mark.parametrize("spec,vec_bytes", [
    (_spec(4096), 16),
    (_spec(4096, 2), 16),
    (_spec(10), 8),                              # fc2.b: 40 bytes a row
    (_spec(8, 2), 16),
    (_spec(12, 2), 8),                           # 24 bytes a row
    (_spec(421_642), 8),                         # one (K, N) stream of the CNN
    (_spec(421_642, 2), 4),
    (_spec(7, 2), 2),
    (_spec(7), 4),
    (_spec(4096, x=(1 << 20) + 4), 4),           # a view one element in
    (_spec(4096, 2, x=(1 << 20) + 2), 2),
    (_spec(4096, out=(1 << 30) + 8), 8),
    (_spec(4096, stride=4100), 16),              # rows 16,400 bytes apart
    (_spec(4096, stride=4097), 4),
    (_spec(4096, 2, stride=4100), 8),            # 8,200 bytes apart
])
def test_planner_classifies_aligned_and_unaligned_leaves(spec, vec_bytes):
    assert spec.vec_bytes == vec_bytes
    flags = int(np.frombuffer(kagg.pack(plan([spec])[0], [spec], 0, 3)[16:56], "<i4")[-1])
    assert flags == (vec_bytes.bit_length() - 1) << 1 | (1 if spec.itemsize == 2 else 0)


def test_planner_skips_zero_size_leaves():
    specs = _specs_of([0, 5000, 0, 17, 0], [4, 4, 2, 2, 4])
    (launch,) = plan(specs)
    assert launch.leaves == (1, 3)
    assert launch.tile0 == (0, 3) and launch.tiles == 4
    assert plan(_specs_of([0, 0], [4, 2])) == []


def test_planner_plans_one_launch_for_the_cnn_tree():
    assert len(CNN_SHAPES) == 8
    assert sum(math.prod(s) for s in CNN_SHAPES) == 421_642
    specs = _specs_of([math.prod(s) for s in CNN_SHAPES], [4] * 8)
    (launch,) = plan(specs)
    assert launch.leaves == tuple(range(8))
    # every leaf but the 10-element fc2 bias takes 16-byte accesses
    assert [s.vec_bytes for s in specs] == [16] * 6 + [8, 16]
    assert specs[6].n == 10


def test_planner_splits_a_tree_larger_than_one_table():
    specs = _specs_of([100] * (2 * kagg.MAX_LEAVES + 368), [4] * (2 * kagg.MAX_LEAVES + 368))
    launches = plan(specs)
    assert [len(l.leaves) for l in launches] == [kagg.MAX_LEAVES, kagg.MAX_LEAVES, 368]
    assert [l.tiles for l in launches] == [kagg.MAX_LEAVES, kagg.MAX_LEAVES, 368]


def test_pack_writes_the_kernel_table():
    specs = _specs_of([300, 9], [2, 4])
    (launch,) = plan(specs)
    table = kagg.pack(launch, specs, 0xABC0, 5)
    assert len(table) == 16 + 40 * 2
    assert np.frombuffer(table[:8], "<u8")[0] == 0xABC0
    assert list(np.frombuffer(table[8:16], "<i4")) == [5, 2]
    for j, s in enumerate(specs):
        entry = table[16 + 40 * j:16 + 40 * (j + 1)]
        x, out, n, stride = np.frombuffer(entry[:32], "<i8")
        tile0, flags = np.frombuffer(entry[32:], "<i4")
        assert (x, out, n, stride, tile0) == (s.x, s.out, s.n, s.stride, launch.tile0[j])
        assert flags == (1 if s.bf16 else 0) | (s.vec_bytes.bit_length() - 1) << 1


# --- the plain versions and the pytree route ------------------------------------------
def _fmaf_exact(a, b, c):
    """float32 a * b + c rounded once to nearest even, in exact rational
    arithmetic: the nearer of the two float32 neighbours, the even one on a
    tie."""
    from fractions import Fraction

    out = []
    for x, y, z in zip(a.tolist(), b.tolist(), c.tolist()):
        v = Fraction(x) * Fraction(y) + Fraction(z)
        f = np.float32(float(v))
        near = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
        out.append(min(near, key=lambda q: (abs(Fraction(float(q)) - v),
                                            int(np.float32(q).view(np.int32)) & 1)))
    return torch.tensor(np.array(out, np.float32))


def test_fmaf_ref_rounds_once():
    gen = torch.Generator().manual_seed(5)
    n = 4000
    a, b = torch.randn(n, generator=gen), torch.randn(n, generator=gen)
    c = torch.randn(n, generator=gen) * torch.exp2(torch.randint(-40, 40, (n,), generator=gen).float())
    # exact sums on and next to a midpoint between two float32 values, which
    # the float64 sum rounds onto: (1 +- 2^-15)(1 -+ 2^-15) = 1 - 2^-30
    e = 2.0 ** -15
    a = torch.cat([a, torch.tensor([1 + e, 1 + e, 1 - e, 3.0], dtype=torch.float32)])
    b = torch.cat([b, torch.tensor([1 - e, 1 - e, 1 + e, 0.5], dtype=torch.float32)])
    c = torch.cat([c, torch.tensor([2.0 ** 24 + 2, 2.0 ** 24, -(2.0 ** 24) - 2, 2.0 ** 24],
                                   dtype=torch.float32)])
    got = kagg_ref.fmaf_ref(a, b, c)
    assert torch.equal(got, _fmaf_exact(a, b, c))
    assert got[-4] == 2.0 ** 24 + 2                       # not the even 2^24 + 4
    assert not torch.equal(got, (a.double() * b.double() + c.double()).float())
    assert not torch.equal(got, a * b + c)


@pytest.mark.parametrize("k", [1, 3, 5, 8, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_leaves_ref_equals_flat_ref_on_the_concatenation(k, dtype):
    gen = torch.Generator().manual_seed(k)
    sizes = [math.prod(s) for s in CNN_SHAPES] + [0, 1, 7, 33]
    xs = [torch.randn((k, n), generator=gen).to(dtype) for n in sizes]
    w = torch.rand((k,), generator=gen) + 0.05
    w = w / w.sum()
    ours = aggregate_leaves_ref(xs, w)
    whole = aggregate_flat_ref(torch.cat(xs, dim=1), w)
    assert [o.dtype for o in ours] == [dtype] * len(xs)
    assert torch.equal(torch.cat(ours), whole)


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_sum_is_per_element_and_near_the_fmaf_chain(k, dtype):
    """The CPU route's float32 sum: the same on a leaf as on the
    concatenation (bit for bit), and within float32 rounding of the
    kernel's plain version."""
    gen = torch.Generator().manual_seed(10 + k)
    sizes = [math.prod(s) for s in CNN_SHAPES] + [0, 1, 7, 33]
    xs = [torch.randn((k, n), generator=gen).to(dtype) for n in sizes]
    w = torch.rand((k,), generator=gen) + 0.05
    w = w / w.sum()
    ours = weighted_sum_leaves(xs, w)
    (whole,) = weighted_sum_leaves([torch.cat(xs, dim=1)], w)
    assert [o.dtype for o in ours] == [dtype] * len(xs)
    assert torch.equal(torch.cat(ours), whole)
    if dtype == torch.float32:
        fmaf = torch.cat(aggregate_leaves_ref(xs, w))
        assert float((whole - fmaf).abs().max()) <= 1e-6 * float(fmaf.abs().max())


def _concatenated_route(stacked, weights):
    """The route the reference takes (and the port took before its kernel
    read leaves in place): cast every leaf to the promoted dtype, concatenate,
    aggregate the (K, N) stream with the CPU route's arithmetic, split and
    cast back."""
    leaves, treedef = tree_flatten(stacked)
    k = leaves[0].shape[0]
    common = functools.reduce(torch.promote_types, [l.dtype for l in leaves])
    flat = torch.cat([l.reshape(k, -1).to(common) for l in leaves], dim=1)
    (agg,) = weighted_sum_leaves([flat], weights.float())
    sizes = [math.prod(l.shape[1:]) for l in leaves]
    return tree_unflatten(treedef, [part.reshape(l.shape[1:]).to(l.dtype)
                                    for part, l in zip(torch.split(agg, sizes), leaves)])


MIXED_TREES = {
    "float32": {"a": torch.float32, "b": torch.float32, "c": torch.float32},
    "bfloat16": {"a": torch.bfloat16, "b": torch.bfloat16, "c": torch.bfloat16},
    "f32+bf16": {"a": torch.float32, "b": torch.bfloat16, "c": torch.float32},
    "f32+f16": {"a": torch.float16, "b": torch.float32, "c": torch.float32},
    "f64+f32+bf16": {"a": torch.float64, "b": torch.float32, "c": torch.bfloat16},
    "bf16+f16": {"a": torch.bfloat16, "b": torch.float16, "c": torch.bfloat16},
}


@pytest.mark.parametrize("case", sorted(MIXED_TREES))
@pytest.mark.parametrize("k", [1, 5, 8])
def test_pytree_equals_the_concatenated_route(case, k):
    gen = torch.Generator().manual_seed(k)
    shapes = {"a": (6, 3), "b": (), "c": (4, 37)}
    tree = {name: torch.randn((k,) + shapes[name], generator=gen).to(dt)
            for name, dt in MIXED_TREES[case].items()}
    tree["c"] = [tree["c"], {"z": torch.randn((k, 0), generator=gen)}]
    w = torch.rand((k,), generator=gen) + 0.1
    w = w / w.sum()
    ours = aggregate_ops.aggregate_pytree(tree, w)
    want = _concatenated_route(tree, w)
    for a, b in zip(tree_leaves(ours), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_pytree_on_the_full_width_cnn_matches_reference():
    """The paper's CNN at full width (421,642 parameters), K = 8 float32,
    against the reference's concatenated stream through its Pallas kernel
    in interpret mode."""
    rng = np.random.default_rng(16)
    leaves, treedef = tree_flatten(init_cnn(torch.Generator().manual_seed(0)))
    tree = tree_unflatten(treedef, [rng.standard_normal((8,) + tuple(l.shape)).astype(np.float32)
                                    for l in leaves])
    w = rng.random(8).astype(np.float32) + 0.05
    w /= w.sum()
    ref = jaggregate_pytree(_jax_tree(tree, "float32"), jnp.asarray(w))
    ours = aggregate_ops.aggregate_pytree(params_from_numpy(tree, "cpu"), torch.from_numpy(w))
    assert sum(l.numel() for l in tree_leaves(ours)) == 421_642
    _assert_tree_close(ours, ref, dtype="float32")


def test_pytree_never_concatenates(monkeypatch):
    def no_cat(*args, **kwargs):
        raise AssertionError("aggregate_pytree concatenated its leaves")

    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((5, 6, 3), generator=gen),
            "b": [torch.randn((5, 9), generator=gen).bfloat16()]}
    w = torch.full((5,), 0.2)
    monkeypatch.setattr(torch, "cat", no_cat)
    monkeypatch.setattr(torch, "concatenate", no_cat)
    out = aggregate_ops.aggregate_pytree(tree, w)
    assert out["a"].shape == (6, 3) and out["b"][0].dtype == torch.bfloat16


def test_leaves_wrapper_refuses_cpu_tensors():
    xs = [torch.zeros((2, 5)), torch.zeros((2, 3))]
    w = torch.full((2,), 0.5)
    before = aggregate_flat.launches
    with pytest.raises(ValueError, match="CUDA"):
        aggregate_leaves(xs, w)
    assert aggregate_flat.launches == before
