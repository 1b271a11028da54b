"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no NVIDIA GPU is present (the
kernel has no CPU mode).  The file imports neither jax nor the reference
package, so it runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: aggregation in float32 relative to the largest output, 1e-5,
in bfloat16 at most 1 ulp.  The kernel and its plain version run the same
fmaf chain over k in order (the plain version emulates fmaf in float64),
so they should be bit-equal; the limits are those the kernel is held to.
Flash attention and the SSD scan are held to their float32 plain
versions on the same input values, within float32 rounding
(``assert_flash_close``, ``assert_ssd_close``) plus, in bfloat16, half
an ulp of each output.  Flash attention and the SSD scan run bfloat16
on the tensor cores and float32 on the CUDA cores; both meet the same
limit.
"""
import pytest
import torch

from repro_torch.kernels.aggregate import MAX_LEAVES, aggregate_flat, aggregate_leaves
from repro_torch.kernels.aggregate_ref import (aggregate_flat_ref, aggregate_leaves_ref,
                                               bf16_ulp_distance)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1, 1_000_003), (5, 421_642), (8, 421_642)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(cuda_device, k, n, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    x = torch.randn((k, n), generator=gen, device=cuda_device).to(dtype)
    w = torch.rand((k,), generator=gen, device=cuda_device) + 0.05
    w = w / w.sum()
    before = aggregate_flat.launches
    got = aggregate_flat(x, w)
    torch.cuda.synchronize()
    assert aggregate_flat.launches == before + 1
    want = aggregate_flat_ref(x, w)
    if dtype == torch.float32:
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) <= 1e-5
    else:
        assert int(bf16_ulp_distance(got, want).max()) <= 1


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((3, 10), device=cuda_device)
    w = torch.full((3,), 1 / 3, device=cuda_device)
    with pytest.raises(TypeError):
        aggregate_flat(x.half(), w)
    with pytest.raises(ValueError, match="contiguous"):
        aggregate_flat(x.t().contiguous().t(), w)
    with pytest.raises(ValueError, match="float32"):
        aggregate_flat(x, w.double())
    with pytest.raises(ValueError):
        aggregate_flat(x, w.cpu())


@pytest.mark.cuda
def test_pytree_aggregation_is_one_launch_and_matches_cpu(cuda_device):
    from repro_torch.core.aggregation import weighted_average

    gen = torch.Generator().manual_seed(0)
    tree = {"conv": [{"w": torch.randn(5, 3, 3, 1, 4, generator=gen),
                      "b": torch.randn(5, 4, generator=gen)}],
            "fc": {"w": torch.randn(5, 37, 10, generator=gen).bfloat16()}}
    w = torch.rand(5, generator=gen) + 0.1
    before = aggregate_flat.launches
    on_card = weighted_average({"conv": [{k: v.to(cuda_device) for k, v in tree["conv"][0].items()}],
                                "fc": {"w": tree["fc"]["w"].to(cuda_device)}},
                               w, use_kernel=True)
    torch.cuda.synchronize()
    assert aggregate_flat.launches == before + 1
    on_cpu = weighted_average(tree, w, use_kernel=True)
    assert on_card["fc"]["w"].dtype == torch.bfloat16
    for a, b in [(on_card["conv"][0]["w"], on_cpu["conv"][0]["w"]),
                 (on_card["conv"][0]["b"], on_cpu["conv"][0]["b"])]:
        assert float((a.cpu() - b).abs().max()) <= 1e-5
    assert int(bf16_ulp_distance(on_card["fc"]["w"].cpu(), on_cpu["fc"]["w"]).max()) <= 1


@pytest.mark.cuda
def test_fedleo_round_on_the_card_launches_the_kernel(cuda_device):
    from repro_torch.core import FedLEO, FederatedTask, SimConfig, TrainHyperparams
    from repro_torch.data import make_classification_dataset, partition_noniid_by_orbit
    from repro_torch.models.cnn import apply_cnn, init_cnn
    from repro_torch.optim import get_optimizer

    train = make_classification_dataset("mnist-like", num_samples=400, seed=0)
    test = make_classification_dataset("mnist-like", num_samples=100, seed=99)
    task = FederatedTask(
        init_fn=lambda r: init_cnn(r, (28, 28, 1), 10, widths=(4,), hidden=8),
        apply_fn=apply_cnn, clients=partition_noniid_by_orbit(train, 5, 8),
        test_set=test, optimizer=get_optimizer("sgd", 0.05),
        hp=TrainHyperparams(batch_size=16), sim_epochs=1,
    )
    assert task.device.type == "cuda"
    before = aggregate_flat.launches
    res = FedLEO(task, SimConfig(horizon_hours=72.0, use_kernel=True)).run(max_rounds=2)
    assert len(res.history) == 2
    assert aggregate_flat.launches == before + 2 * (5 + 1)


def ragged_leaves(gen, dev, k, dtypes):
    """(K, n) leaves of every alignment, cycling through ``dtypes``: rows of
    4 to 1.6 MB, some not a multiple of 16 bytes, and two views per dtype
    into a wider matrix (rows 5000 elements apart): one a single element
    in (a base off 16 bytes), one 16 bytes in (aligned, stride != n)."""
    sizes = [1, 7, 8, 10, 288, 2049, 4096, 12_345, 401_408, 0]
    xs = [torch.randn((k, n), generator=gen, device=dev).to(dtypes[i % len(dtypes)])
          for i, n in enumerate(sizes)]
    for dt in dtypes:
        big = torch.randn((k, 5000), generator=gen, device=dev).to(dt)
        step = 16 // big.element_size()
        xs += [big[:, 1:4097], big[:, step:step + 4096]]
    return xs


def assert_leaves_close(got, want):
    """float32 within 1e-5 of each leaf's largest output, bfloat16 within
    1 ulp (both sides run the same fmaf chain, so they should be equal)."""
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.dtype == r.dtype
        if r.numel() == 0:
            continue
        if r.dtype == torch.float32:
            assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())
        else:
            assert int(bf16_ulp_distance(g, r).max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 8, 13])
@pytest.mark.parametrize("dtypes", ["float32", "bfloat16", "mixed"])
def test_aggregate_leaves_matches_plain_version(cuda_device, k, dtypes):
    kinds = {"float32": [torch.float32], "bfloat16": [torch.bfloat16],
             "mixed": [torch.float32, torch.bfloat16]}[dtypes]
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    xs = ragged_leaves(gen, cuda_device, k, kinds)
    assert any(x.storage_offset() for x in xs)
    w = torch.rand((k,), generator=gen, device=cuda_device) + 0.05
    w = w / w.sum()
    before = aggregate_flat.launches
    got = aggregate_leaves(xs, w)
    torch.cuda.synchronize()
    assert aggregate_flat.launches == before + 1
    assert_leaves_close(got, aggregate_leaves_ref(xs, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aggregate_pytree_is_one_launch_for_the_cnn_tree(cuda_device, dtype, monkeypatch):
    from repro_torch.kernels.aggregate_ops import aggregate_pytree
    from repro_torch.models.cnn import init_cnn
    from repro_torch.tree import tree_leaves, tree_map

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = init_cnn(torch.Generator().manual_seed(0))
    stacked = tree_map(lambda p: torch.randn((8,) + tuple(p.shape), generator=gen,
                                             device=cuda_device).to(dtype), params)
    w = torch.rand((8,), generator=gen, device=cuda_device) + 0.05
    w = w / w.sum()

    def no_cat(*args, **kwargs):
        raise AssertionError("aggregate_pytree concatenated its leaves")

    monkeypatch.setattr(torch, "cat", no_cat)
    before = aggregate_flat.launches
    got = aggregate_pytree(stacked, w)
    torch.cuda.synchronize()
    assert aggregate_flat.launches == before + 1
    monkeypatch.undo()
    want = [l.reshape(8, -1) for l in tree_leaves(stacked)]
    assert_leaves_close([l.reshape(-1) for l in tree_leaves(got)], aggregate_leaves_ref(want, w))


def _stacked_on_card(params, k, gen, dev):
    from repro_torch.tree import tree_map

    return tree_map(lambda p: torch.randn((k,) + tuple(p.shape), generator=gen, device=dev),
                    params)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 8])
def test_unet_tree_aggregation_is_one_launch_and_bit_equal(cuda_device, k):
    """The full-width U-Net (28 float32 leaves) through weighted_average:
    one launch per call, every leaf equal to the plain version's bits."""
    from repro_torch.core.aggregation import weighted_average
    from repro_torch.models.cnn import init_unet
    from repro_torch.tree import tree_leaves

    gen = torch.Generator(device=cuda_device).manual_seed(k)
    stacked = _stacked_on_card(init_unet(torch.Generator().manual_seed(0)), k, gen, cuda_device)
    assert len(tree_leaves(stacked)) == 28
    w = torch.rand((k,), generator=gen, device=cuda_device) + 0.05
    before = aggregate_flat.launches
    got = weighted_average(stacked, w, use_kernel=True)
    torch.cuda.synchronize()
    assert aggregate_flat.launches == before + 1
    xs = [l.reshape(k, -1) for l in tree_leaves(stacked)]
    wn = w / torch.sum(w)           # as weighted_average normalises, on the card
    for g, r in zip(tree_leaves(got), aggregate_leaves_ref(xs, wn)):
        assert torch.equal(g.reshape(-1), r)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["cnn", "unet"])
def test_async_mix_is_one_launch_and_bit_equal(cuda_device, model):
    """The asynchronous strategies' server mix, (1 - alpha) * global +
    alpha * local over a K = 2 stack, as the baselines call it."""
    import numpy as np

    from repro_torch.core import aggregation
    from repro_torch.models.cnn import init_cnn, init_unet
    from repro_torch.tree import tree_leaves, tree_map

    init = {"cnn": init_cnn, "unet": init_unet}[model]
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    params = init(torch.Generator().manual_seed(0))
    glob, local = (tree_map(lambda p: torch.randn(p.shape, generator=gen, device=cuda_device),
                            params) for _ in range(2))
    alpha = 0.6 / (1.0 + 1.7) ** 0.5
    before = aggregate_flat.launches
    got = aggregation.weighted_average(aggregation.stack_pytrees([glob, local]),
                                       np.asarray([1.0 - alpha, alpha]), use_kernel=True)
    torch.cuda.synchronize()
    assert aggregate_flat.launches == before + 1
    w = torch.as_tensor([1.0 - alpha, alpha], dtype=torch.float32, device=cuda_device)
    w = w / torch.sum(w)
    xs = [torch.stack([a, b]).reshape(2, -1) for a, b in
          zip(tree_leaves(glob), tree_leaves(local))]
    for g, r in zip(tree_leaves(got), aggregate_leaves_ref(xs, w)):
        assert torch.equal(g.reshape(-1), r)


def _tiny_baseline_task():
    from repro_torch.core import FederatedTask, TrainHyperparams
    from repro_torch.data import make_classification_dataset, partition_noniid_by_orbit
    from repro_torch.models.cnn import apply_cnn, init_cnn
    from repro_torch.optim import get_optimizer

    train = make_classification_dataset("mnist-like", num_samples=400, seed=0)
    test = make_classification_dataset("mnist-like", num_samples=100, seed=99)
    return FederatedTask(
        init_fn=lambda r: init_cnn(r, (28, 28, 1), 10, widths=(4,), hidden=8),
        apply_fn=apply_cnn, clients=partition_noniid_by_orbit(train, 5, 8),
        test_set=test, optimizer=get_optimizer("sgd", 0.05),
        hp=TrainHyperparams(batch_size=16), sim_epochs=1,
    )


@pytest.mark.cuda
def test_every_baseline_launches_the_kernel_once_per_aggregation(cuda_device):
    """One round of each Table II baseline on the card: as many K1
    launches as weighted_average calls, so none took the plain path."""
    from repro_torch.core import SimConfig, aggregation
    from repro_torch.core.baselines import ALL_BASELINES

    task = _tiny_baseline_task()
    for name, cls in ALL_BASELINES.items():
        calls, before = aggregation.weighted_average.calls, aggregate_flat.launches
        res = cls(task, SimConfig(horizon_hours=72.0, use_kernel=True)).run(max_rounds=1)
        assert len(res.history) == 1, name
        assert aggregate_flat.launches - before == aggregation.weighted_average.calls - calls, name


@pytest.mark.cuda
def test_fedsat_ideal_buffer_flush_launches_the_kernel(cuda_device):
    """FedSat-ideal folds its buffer in once an orbital period has passed,
    tens of thousands of arrivals in at this width; with its next tick
    moved to 0 its first arrival flushes: eq. (4) over the buffer and the
    K = 2 mix into the global model, one launch each."""
    from repro_torch.core import SimConfig, aggregation
    from repro_torch.core.baselines import FedSat

    strategy = FedSat(_tiny_baseline_task(), SimConfig(horizon_hours=72.0, use_kernel=True))
    strategy._next_agg = 0.0
    calls, before = aggregation.weighted_average.calls, aggregate_flat.launches
    t, info = strategy.step(0.0)
    torch.cuda.synchronize()
    assert t is not None and info == {"aggregated": 1}
    assert aggregation.weighted_average.calls - calls == 2
    assert aggregate_flat.launches - before == 2


@pytest.mark.cuda
def test_unet_fedleo_round_on_the_card_launches_the_kernel(cuda_device):
    from repro_torch.core import FedLEO, FederatedTask, SimConfig, TrainHyperparams
    from repro_torch.data import make_segmentation_dataset, partition_iid
    from repro_torch.models.cnn import apply_unet, init_unet
    from repro_torch.optim import get_optimizer

    task = FederatedTask(
        init_fn=lambda r: init_unet(r, base=4, depth=2), apply_fn=apply_unet,
        clients=partition_iid(make_segmentation_dataset(num_samples=80, size=32, seed=0), 5, 8),
        test_set=make_segmentation_dataset(num_samples=16, size=32, seed=9),
        optimizer=get_optimizer("adam", 1e-3),
        hp=TrainHyperparams(local_epochs=20, learning_rate=0.01, batch_size=4), sim_epochs=1,
    )
    before = aggregate_flat.launches
    res = FedLEO(task, SimConfig(horizon_hours=72.0, use_kernel=True)).run(max_rounds=1)
    assert len(res.history) == 1
    assert aggregate_flat.launches == before + 5 + 1


@pytest.mark.cuda
def test_aggregate_leaves_splits_a_tree_larger_than_one_table(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    n_leaves = 2 * MAX_LEAVES + 100
    xs = [torch.randn((5, 3 + i % 40), generator=gen, device=cuda_device)
          for i in range(n_leaves)]
    xs = [x if i % 3 else x.bfloat16() for i, x in enumerate(xs)]
    w = torch.full((5,), 0.2, device=cuda_device)
    before = aggregate_flat.launches
    got = aggregate_leaves(xs, w)
    torch.cuda.synchronize()
    assert aggregate_flat.launches == before + 3
    assert_leaves_close(got, aggregate_leaves_ref(xs, w))


@pytest.mark.cuda
def test_aggregate_leaves_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((3, 10), device=cuda_device)
    w = torch.full((3,), 1 / 3, device=cuda_device)
    before = aggregate_flat.launches
    with pytest.raises(TypeError):
        aggregate_leaves([x, x.half()], w)
    with pytest.raises(ValueError, match="contiguous"):
        aggregate_leaves([x.t().contiguous().t()], w)
    with pytest.raises(ValueError):
        aggregate_leaves([x, torch.zeros((4, 10), device=cuda_device)], w)
    with pytest.raises(ValueError):
        aggregate_leaves([x.reshape(3, 2, 5)], w)
    with pytest.raises(ValueError, match="float32"):
        aggregate_leaves([x], w.double())
    with pytest.raises(ValueError):
        aggregate_leaves([x], w.cpu())
    with pytest.raises(ValueError):
        aggregate_leaves([x.cpu()], w)
    assert aggregate_flat.launches == before


# --- flash attention ---------------------------------------------------------------
# (b, s, h, g, d): the gemma-7b head, phi3's GQA heads, MQA at head_dim 32,
# ragged S at head_dims 64 and 128 (no block divides S), kimi-k2's head
# (head_dim 112, two 64-wide boxes, the second half past D), the seamless
# encoder's heads (run in every mode, non-causal among them), and the GQA
# ratios 6 and 5 of internvl2-26b and llama4-maverick (the latter at a
# ragged S)
FLASH_SHAPES = [(1, 512, 16, 16, 256), (1, 384, 40, 10, 128), (2, 256, 4, 1, 32),
                (1, 77, 4, 2, 64), (1, 200, 8, 2, 128), (1, 256, 64, 8, 112),
                (2, 1024, 16, 16, 64), (1, 256, 48, 8, 128), (1, 333, 40, 8, 128)]
# (causal, window, soft_cap); window without causal skips tiles on one side only
FLASH_MODES = [(True, None, None), (False, None, None), (True, 96, None),
               (True, None, 20.0), (False, 96, None)]
# input scales: a near-uniform softmax (scores of std 0.25) and a peaked one
# (std 4, where the soft-cap bites)
FLASH_INPUT_SCALES = {"flat": 0.5, "peaked": 2.0}


def assert_flash_close(got, want):
    """``want`` is the float32 plain version on the same input values.
    Both compute in float32, so they may differ by float32 rounding (1e-5
    of the largest output) and, in bfloat16, by the kernel's one rounding
    of its output (half an ulp, 2**-8 of the value)."""
    err = (got.float() - want).abs()
    allowed = 1e-5 * float(want.abs().max())
    if got.dtype == torch.bfloat16:
        allowed = allowed + 2.0 ** -8 * want.abs()
    assert bool((err <= allowed).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", FLASH_MODES, ids=["causal", "full", "window",
                                                   "soft-cap", "full-window"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inputs", list(FLASH_INPUT_SCALES))
def test_flash_kernel_matches_plain_version(cuda_device, shape, mode, dtype, inputs):
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.flash_ref import flash_attention_ref

    b, s, h, g, d = shape
    causal, window, cap = mode
    gen = torch.Generator(device=cuda_device).manual_seed(s + h)
    scale = FLASH_INPUT_SCALES[inputs]
    q, k, v = (torch.randn(shp, generator=gen, device=cuda_device).mul(scale).to(dtype)
               for shp in ((b, s, h, d), (b, s, g, d), (b, s, g, d)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal, window, cap)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal, window, cap)
    assert_flash_close(got, want)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda_device):
    """q, k and v sliced out of one packed projection, read in place."""
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.flash_ref import flash_attention_ref

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((2, 130, 12, 64), generator=gen, device=cuda_device)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = flash_attention(q, k, v, True, None, None)
    want = flash_attention_ref(q, k, v, True, None, None)
    assert_flash_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", list(FLASH_INPUT_SCALES))
def test_flash_kernel_at_zamba2_head(cuda_device, inputs):
    """zamba2-1.2b's shared attention at a full 2048-token prompt: 32 heads
    of 64, causal, bfloat16 on the tensor cores."""
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.flash_ref import flash_attention_ref

    b, s, h, g, d = 1, 2048, 32, 32, 64
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    scale = FLASH_INPUT_SCALES[inputs]
    q, k, v = (torch.randn(shp, generator=gen, device=cuda_device).mul(scale).bfloat16()
               for shp in ((b, s, h, d), (b, s, g, d), (b, s, g, d)))
    got = flash_attention(q, k, v, True, None, None)
    want = flash_attention_ref(q.float(), k.float(), v.float(), True, None, None)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert_flash_close(got, want)


@pytest.mark.cuda
def test_flash_kernel_reads_strided_bf16_views(cuda_device):
    """bf16 q, k and v sliced out of one packed projection on 16-byte
    boundaries, read in place by the tensor-core kernel."""
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.flash_ref import flash_attention_ref

    gen = torch.Generator(device=cuda_device).manual_seed(1)
    qkv = torch.randn((2, 130, 12, 64), generator=gen, device=cuda_device).bfloat16()
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    assert not q.is_contiguous() and k.data_ptr() % 16 == 0
    got = flash_attention(q, k, v, True, None, None)
    want = flash_attention_ref(q.float(), k.float(), v.float(), True, None, None)
    assert_flash_close(got, want)


@pytest.mark.cuda
def test_flash_kernel_rejects_bf16_rows_off_16_bytes(cuda_device):
    """The tensor-core kernel copies 16-byte chunks: bf16 rows must start on
    16-byte boundaries (float32 needs 4)."""
    from repro_torch.kernels.flash import flash_attention

    kv = torch.zeros((1, 16, 2, 64), device=cuda_device)
    wide = torch.zeros((1, 16, 4, 68), device=cuda_device)   # head stride 68 elements
    flash_attention(wide[..., :64], kv, kv)                   # fine in float32
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(wide.bfloat16()[..., :64], kv.bfloat16(), kv.bfloat16())
    flat = torch.zeros(16 * 4 * 64 + 4, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):                 # starts 8 bytes in
        flash_attention(flat[4:].view(1, 16, 4, 64), kv.bfloat16(), kv.bfloat16())


@pytest.mark.cuda
def test_flash_dtype_picks_the_kernel(cuda_device):
    """bf16 runs the tensor-core kernel and float32 the CUDA-core one, by
    the names of the device kernels under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash import KERNELS, flash_attention

    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q = torch.randn((1, 256, 4, 128), generator=gen, device=cuda_device)
    kv = torch.randn((1, 256, 2, 128), generator=gen, device=cuda_device)
    for dtype, other in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        args = (q.to(dtype), kv.to(dtype), kv.to(dtype))
        flash_attention(*args)                              # built and warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention(*args)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()]
        assert sum(f"{KERNELS[dtype]}<" in n for n in names) == 1, names
        assert not any(f"{KERNELS[other]}<" in n for n in names), names


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.flash import flash_attention

    q = torch.zeros((1, 16, 4, 64), device=cuda_device)
    kv = torch.zeros((1, 16, 2, 64), device=cuda_device)
    with pytest.raises(TypeError):
        flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[..., :48], kv[..., :48], kv[..., :48])
    with pytest.raises(ValueError, match="last axis"):
        flash_attention(q.transpose(1, 3).contiguous().transpose(1, 3), kv, kv)
    with pytest.raises(ValueError, match="H % G"):
        flash_attention(q[:, :, :3], kv, kv)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, kv, kv, window=0)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q.cpu(), kv.cpu(), kv.cpu())


@pytest.mark.cuda
def test_prefill_on_the_card_launches_flash_per_layer(cuda_device):
    """A smoke gemma's prefill through attn_impl="pallas": one launch per
    layer at a ragged S, and the logits of the CPU run within 2e-3."""
    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.train.steps import make_prefill_step
    from repro_torch.tree import tree_map

    cfg = get_smoke_config("gemma-7b")
    cpu = build_model(cfg, attn_impl="pallas", dtype=torch.float32, device="cpu")
    card = build_model(cfg, attn_impl="pallas", dtype=torch.float32)
    params = cpu.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 77), generator=torch.Generator().manual_seed(1))
    want = make_prefill_step(cpu)(params, {"tokens": tokens})
    before = flash_attention.launches
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = make_prefill_step(card)(tree_map(lambda p: p.to(cuda_device), params),
                                      {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert flash_attention.launches == before + cfg.num_layers
    assert float((got.cpu() - want).abs().max()) <= 2e-3


# --- SSD scan ----------------------------------------------------------------------
# (b, s, h, p, g, n, chunk): mamba2-780m's and zamba2-1.2b's heads, a grouped
# case, the smoke configs' heads, the four of tests/test_kernels.py, and ragged
# S (no chunk or tile divides it)
SSD_SHAPES = [(1, 512, 48, 64, 1, 128, 128), (1, 512, 64, 64, 1, 64, 128),
              (2, 256, 8, 64, 2, 128, 128), (2, 100, 16, 32, 1, 32, 32),
              (2, 100, 32, 32, 1, 16, 32),
              (1, 64, 2, 8, 1, 8, 16), (2, 128, 4, 16, 2, 8, 32), (1, 256, 4, 32, 4, 16, 64),
              (1, 128, 8, 16, 1, 32, 128), (1, 77, 4, 64, 2, 128, 128)]


def ssd_inputs(gen, dev, b, s, h, p, g, n, dtype, scale):
    """x, dt, A, B, C: at the tests' scale (dt in [0.1, 0.6], A in [-0.6,
    -0.1]) or at the model's (dt = softplus of N(0, 1), A = -linspace(1, 16))."""
    x = (torch.randn((b, s, h, p), generator=gen, device=dev) * 0.5).to(dtype)
    Bm = (torch.randn((b, s, g, n), generator=gen, device=dev) * 0.5).to(dtype)
    Cm = (torch.randn((b, s, g, n), generator=gen, device=dev) * 0.5).to(dtype)
    if scale == "tests":
        dt = torch.rand((b, s, h), generator=gen, device=dev) * 0.5 + 0.1
        A = -(torch.rand((h,), generator=gen, device=dev) * 0.5 + 0.1)
    else:
        dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=dev))
        A = -torch.linspace(1.0, 16.0, h, device=dev)
    return x, dt, A, Bm, Cm


def assert_ssd_close(got, want, limit, dtype):
    """Within the float32 rounding limit of ``ssd_rounding_limit`` and,
    in bfloat16, the kernel's one rounding of y (half an ulp)."""
    if dtype == torch.bfloat16:
        limit = limit + 2.0 ** -8 * want.abs()
    err = (got.float() - want).abs()
    assert bool((err <= limit).all()), float((err - limit).max())


@pytest.mark.cuda
@pytest.mark.parametrize("scale", ["tests", "model"])
@pytest.mark.parametrize("with_init", [False, True], ids=["zeros", "initial-state"])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_version(cuda_device, shape, dtype, with_init, scale):
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.kernels.ssd_ref import ssd_padded, ssd_rounding_limit, ssd_steps

    b, s, h, p, g, n, chunk = shape
    gen = torch.Generator(device=cuda_device).manual_seed(s + h + n)
    x, dt, A, Bm, Cm = ssd_inputs(gen, cuda_device, b, s, h, p, g, n, dtype, scale)
    init = (torch.randn((b, h, p, n), generator=gen, device=cuda_device) * 0.5
            if with_init else None)
    before = ssd_scan.launches
    y, state = ssd_scan(x, dt, A, Bm, Cm, chunk, init)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.shape == x.shape and y.dtype == dtype and state.dtype == torch.float32
    args = (x.float(), dt, A, Bm.float(), Cm.float())
    y_want, s_want = ssd_padded(*args, chunk, init)
    y_lim, s_lim = ssd_rounding_limit(*args, chunk, init)
    assert_ssd_close(y, y_want, y_lim, dtype)
    assert_ssd_close(state, s_want, s_lim, torch.float32)
    y_steps, s_steps = ssd_steps(*args, init)          # the per-step recurrence
    assert_ssd_close(y, y_steps, y_lim, dtype)
    assert_ssd_close(state, s_steps, s_lim, torch.float32)


@pytest.mark.cuda
def test_ssd_kernel_reads_strided_views(cuda_device):
    """x, B and C sliced out of one convolution output, as the Mamba2
    block hands them over, read in place."""
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.kernels.ssd_ref import ssd_padded, ssd_rounding_limit

    b, s, h, p, g, n = 2, 130, 8, 32, 2, 16
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    conv = torch.randn((b, s, h * p + 2 * g * n), generator=gen, device=cuda_device) * 0.5
    x = conv[..., :h * p].reshape(b, s, h, p)
    Bm = conv[..., h * p:h * p + g * n].reshape(b, s, g, n)
    Cm = conv[..., h * p + g * n:].reshape(b, s, g, n)
    assert not x.is_contiguous() and x.stride(1) == conv.shape[-1]
    dt = (torch.rand((b, h, s), generator=gen, device=cuda_device) * 0.5 + 0.1).transpose(1, 2)
    A = -(torch.rand((h,), generator=gen, device=cuda_device) * 0.5 + 0.1)
    y, state = ssd_scan(x, dt, A, Bm, Cm, 32)
    y_want, s_want = ssd_padded(x, dt, A, Bm, Cm, 32)
    y_lim, s_lim = ssd_rounding_limit(x, dt, A, Bm, Cm, 32)
    assert_ssd_close(y, y_want, y_lim, torch.float32)
    assert_ssd_close(state, s_want, s_lim, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", ["tests", "model"])
def test_ssd_kernel_reads_strided_bf16_views(cuda_device, scale):
    """bf16 x, B and C sliced out of one packed (B, S, H P + 2 G N)
    convolution output, as the Mamba2 block slices them, read in place by
    the tensor-core kernel, from an initial state at a ragged S."""
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.kernels.ssd_ref import ssd_padded, ssd_rounding_limit

    b, s, h, p, g, n = 2, 200, 8, 64, 1, 128
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    _, dt, A, _, _ = ssd_inputs(gen, cuda_device, b, s, h, p, g, n, torch.bfloat16, scale)
    conv = (torch.randn((b, s, h * p + 2 * g * n), generator=gen, device=cuda_device)
            * 0.5).bfloat16()
    x = conv[..., :h * p].reshape(b, s, h, p)
    Bm = conv[..., h * p:h * p + g * n].reshape(b, s, g, n)
    Cm = conv[..., h * p + g * n:].reshape(b, s, g, n)
    assert not x.is_contiguous() and Bm.data_ptr() % 16 == 0
    init = torch.randn((b, h, p, n), generator=gen, device=cuda_device) * 0.5
    y, state = ssd_scan(x, dt, A, Bm, Cm, 128, init)
    args = (x.float(), dt, A, Bm.float(), Cm.float())
    y_want, s_want = ssd_padded(*args, 128, init)
    y_lim, s_lim = ssd_rounding_limit(*args, 128, init)
    assert_ssd_close(y, y_want, y_lim, torch.bfloat16)
    assert_ssd_close(state, s_want, s_lim, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", ["tests", "model"])
def test_ssd_kernel_at_zamba2_head_full_length(cuda_device, scale):
    """zamba2-1.2b's SSD head (64 heads, P = 64, N = 64) over a whole
    2048-token prompt in bf16, against the chunked scan."""
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.kernels.ssd_ref import ssd_padded, ssd_rounding_limit

    b, s, h, p, g, n = 1, 2048, 64, 64, 1, 64
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x, dt, A, Bm, Cm = ssd_inputs(gen, cuda_device, b, s, h, p, g, n, torch.bfloat16, scale)
    y, state = ssd_scan(x, dt, A, Bm, Cm, 128)
    args = (x.float(), dt, A, Bm.float(), Cm.float())
    y_want, s_want = ssd_padded(*args, 128)
    y_lim, s_lim = ssd_rounding_limit(*args, 128)
    assert_ssd_close(y, y_want, y_lim, torch.bfloat16)
    assert_ssd_close(state, s_want, s_lim, torch.float32)


@pytest.mark.cuda
def test_ssd_kernel_rejects_bf16_rows_off_16_bytes(cuda_device):
    """The tensor-core kernel copies x, B and C with TMA: bf16 rows must
    start on 16-byte boundaries (float32 needs 4)."""
    from repro_torch.kernels.ssd import ssd_scan

    dt = torch.full((1, 16, 4), 0.3, device=cuda_device)
    A = torch.full((4,), -0.5, device=cuda_device)
    bc = torch.zeros((1, 16, 1, 16), device=cuda_device)
    wide = torch.zeros((1, 16, 4, 36), device=cuda_device)     # head stride 36 elements
    ssd_scan(wide[..., :32], dt, A, bc, bc)                     # fine in float32
    with pytest.raises(ValueError, match="16-byte"):
        ssd_scan(wide.bfloat16()[..., :32], dt, A, bc.bfloat16(), bc.bfloat16())
    flat = torch.zeros(16 * 16 + 4, dtype=torch.bfloat16, device=cuda_device)
    x = torch.zeros((1, 16, 4, 32), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte"):                 # starts 8 bytes in
        ssd_scan(x, dt, A, flat[4:].view(1, 16, 1, 16), bc.bfloat16())


# Run in a process of its own: in a long test process the profiler missed
# the SSD kernels' records (seen on the H100 when their library was loaded
# after an earlier profiling session), so the library is loaded and both
# kernels are launched before the first session, as in chip_smoke.py.
SSD_DTYPE_PROBE = """
import json, torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.ssd import KERNELS, ssd_scan

dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(5)
calls = {}
for dtype in (torch.bfloat16, torch.float32):
    x = (torch.randn((1, 256, 4, 64), generator=gen, device=dev) * 0.5).to(dtype)
    bc = (torch.randn((1, 256, 1, 128), generator=gen, device=dev) * 0.5).to(dtype)
    dt = torch.rand((1, 256, 4), generator=gen, device=dev) * 0.5 + 0.1
    calls[dtype] = (x, dt, -(torch.rand((4,), generator=gen, device=dev) + 0.1), bc, bc)
    ssd_scan(*calls[dtype])
torch.cuda.synchronize()
out = {}
for dtype, args in calls.items():
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ssd_scan(*args)
        torch.cuda.synchronize()
    out[str(dtype)] = [e.key for e in prof.key_averages()]
print(json.dumps({"kernels": {str(d): k for d, k in KERNELS.items()}, "names": out}))
"""


@pytest.mark.cuda
def test_ssd_dtype_picks_the_kernel(cuda_device):
    """bf16 runs the tensor-core kernel and float32 the CUDA-core one, by
    the names of the device kernels under torch.profiler."""
    import json
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.run([sys.executable, "-c", SSD_DTYPE_PROBE], env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    kernels = res["kernels"]
    for dtype, other in (("torch.bfloat16", "torch.float32"), ("torch.float32", "torch.bfloat16")):
        names = res["names"][dtype]
        assert sum(f"{kernels[dtype]}<" in n for n in names) == 1, (dtype, names)
        assert not any(f"{kernels[other]}<" in n for n in names), (dtype, names)


@pytest.mark.cuda
def test_ssd_kernel_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.ssd import ssd_scan

    x = torch.zeros((1, 16, 4, 32), device=cuda_device)
    dt = torch.zeros((1, 16, 4), device=cuda_device)
    A = torch.zeros((4,), device=cuda_device)
    bc = torch.zeros((1, 16, 2, 16), device=cuda_device)
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt, A, bc.half(), bc.half())
    with pytest.raises(TypeError, match="dt"):
        ssd_scan(x, dt.bfloat16(), A, bc, bc)
    with pytest.raises(ValueError, match="head_dim"):
        ssd_scan(x[..., :24], dt, A, bc, bc)
    with pytest.raises(ValueError, match="state_dim"):
        ssd_scan(x, dt, A, torch.zeros((1, 16, 2, 256), device=cuda_device),
                 torch.zeros((1, 16, 2, 256), device=cuda_device))
    with pytest.raises(ValueError, match="last axis"):
        ssd_scan(x.transpose(1, 3).contiguous().transpose(1, 3), dt, A, bc, bc)
    with pytest.raises(ValueError, match="H % G"):
        ssd_scan(x[:, :, :3], dt[:, :, :3], A[:3], bc, bc)
    with pytest.raises(ValueError, match="initial_state"):
        ssd_scan(x, dt, A, bc, bc, initial_state=torch.zeros((1, 4, 32, 8), device=cuda_device))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x.cpu(), dt.cpu(), A.cpu(), bc.cpu(), bc.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_ssm_prefill_on_the_card_launches_ssd_per_layer(cuda_device, arch):
    """A smoke model's prefill through ssd_impl="pallas" at a ragged S:
    one SSD launch per Mamba layer (and one flash launch per use of
    zamba2's shared attention block), and the logits of the CPU run
    within 2e-3."""
    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.ssd import ssd_scan
    from repro_torch.train.steps import make_prefill_step
    from repro_torch.tree import tree_map

    cfg = get_smoke_config(arch)
    kw = dict(attn_impl="pallas", ssd_impl="pallas", dtype=torch.float32)
    cpu = build_model(cfg, device="cpu", **kw)
    card = build_model(cfg, **kw)
    params = cpu.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 77), generator=torch.Generator().manual_seed(1))
    want = make_prefill_step(cpu)(params, {"tokens": tokens})
    ssd_before, flash_before = ssd_scan.launches, flash_attention.launches
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = make_prefill_step(card)(tree_map(lambda p: p.to(cuda_device), params),
                                      {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert ssd_scan.launches == ssd_before + cfg.num_layers
    assert flash_attention.launches == flash_before + getattr(card, "n_attn_uses", 0)
    assert float((got.cpu() - want).abs().max()) <= 2e-3


# --- training: the FedLEO orbit replicas on the card ---------------------------------------
def _smoke_fedleo(device, opt_name, r=2):
    """A smoke mamba2 FedLEO local step (R replicas, tau 1) and its
    aggregate through the kernel route on ``device``, from the same
    weights and tokens: (local step's losses, state after the step,
    aggregated state, K1 launches of the aggregate)."""
    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.optim import get_optimizer
    from repro_torch.train.fedleo_step import (make_fedleo_aggregate, make_fedleo_local_step,
                                               replicate_for_orbits)
    from repro_torch.train.steps import TrainState
    from repro_torch.tree import tree_map

    cfg = get_smoke_config("mamba2-780m")
    model = build_model(cfg, dtype=torch.float32, device=device)
    opt = get_optimizer(opt_name, 0.05 if opt_name == "sgd" else cfg.learning_rate)
    params = tree_map(lambda p: p.to(device), model.init(torch.Generator().manual_seed(0)))
    state = replicate_for_orbits(
        TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32, device=device)), r)
    tokens = torch.randint(0, cfg.vocab_size, (r, 1, 2, 32),
                           generator=torch.Generator().manual_seed(1)).to(device)
    stepped, metrics = make_fedleo_local_step(model, opt)(state, {"tokens": tokens})
    before = aggregate_flat.launches
    agg = make_fedleo_aggregate(use_kernel=True)(stepped, torch.tensor([1.0, 3.0]))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return metrics["loss"].cpu(), stepped, agg, aggregate_flat.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize("opt_name,launches", [("adam", 2), ("adafactor", 2), ("sgd", 1)])
def test_fedleo_step_and_aggregate_on_the_card(cuda_device, opt_name, launches):
    """One K1 launch for each tree with a replicated leaf (SGD's state
    has none); the aggregate equals the plain fmaf chain on the card's
    own state, leaf by leaf (Adam's int32 step through float32 and back);
    the local step's losses and first moments agree with the CPU's within
    1e-4 of their largest value (float32, TF32 off)."""
    from repro_torch.tree import tree_leaves

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        loss, stepped, agg, n = _smoke_fedleo(cuda_device, opt_name)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert n == launches
    w = torch.tensor([0.25, 0.75], device=cuda_device)
    for x, m in zip(tree_leaves(stepped), tree_leaves(agg)):
        if x.ndim == 0 or x.shape[0] != 2:
            continue
        want = aggregate_flat_ref(x.reshape(2, -1).float(), w).to(x.dtype).reshape(x.shape[1:])
        assert torch.equal(m[0], want) and torch.equal(m[1], want)
    loss_cpu, stepped_cpu, _, n_cpu = _smoke_fedleo(torch.device("cpu"), opt_name)
    assert n_cpu == 0
    assert float((loss - loss_cpu).abs().max()) <= 1e-4 * float(loss_cpu.abs().max())
    card, cpu = tree_leaves(stepped.opt_state), tree_leaves(stepped_cpu.opt_state)
    for a, b in zip(card, cpu):
        if b.is_floating_point():
            assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-12
        else:
            assert torch.equal(a.cpu(), b)
    if opt_name == "sgd":
        for a, b in zip(tree_leaves(stepped.params), tree_leaves(stepped_cpu.params)):
            assert float((a.cpu() - b).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_forward_only_kernels_refuse_autograd_on_the_card(cuda_device):
    """Under grad mode, an input that requires grad makes the flash and
    SSD dispatch raise before any launch; under no_grad they launch."""
    from repro_torch.kernels import flash_ops, ssd_ops
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.ssd import ssd_scan

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((1, 64, 2, 64), generator=gen, device=cuda_device) for _ in range(3))
    x = torch.randn((1, 64, 2, 64), generator=gen, device=cuda_device)
    dt = torch.rand((1, 64, 2), generator=gen, device=cuda_device) + 0.1
    A = -torch.rand((2,), generator=gen, device=cuda_device)
    bc = torch.randn((1, 64, 1, 64), generator=gen, device=cuda_device)
    before = (flash_attention.launches, ssd_scan.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_ops.flash_attention(q.requires_grad_(True), k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        ssd_ops.ssd(x, dt.requires_grad_(True), A, bc, bc, chunk=32)
    assert (flash_attention.launches, ssd_scan.launches) == before
    with torch.no_grad():
        flash_ops.flash_attention(q, k, v)
        ssd_ops.ssd(x, dt, A, bc, bc, chunk=32)
    torch.cuda.synchronize()
    assert (flash_attention.launches, ssd_scan.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k,capacity_factor", [(1, 2.0), (2, 1.25), (2, 0.5)])
def test_apply_moe_on_the_card_matches_the_cpu(cuda_device, top_k, capacity_factor):
    """MoE at a smoke width (4 experts, d 256) in float32: the card's slot
    assignment equals the CPU's, dropped tokens included (capacity factor
    0.5 drops), and the outputs agree within 1e-5 of the largest."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe

    cfg = MoEConfig(num_experts=4, top_k=top_k, d_ff_expert=128,
                    capacity_factor=capacity_factor, num_shared_experts=1)
    params = moe.init_moe(torch.Generator().manual_seed(top_k), 256, cfg)
    x = torch.randn((2, 64, 256), generator=torch.Generator().manual_seed(1))
    on_card = {k: (v.to(cuda_device) if torch.is_tensor(v) else
                   {kk: vv.to(cuda_device) for kk, vv in v.items()}) for k, v in params.items()}
    xt = x.reshape(-1, 256)
    _, flats, valids, _, _ = moe.route(params, xt, cfg)
    _, flats_c, valids_c, _, _ = moe.route(on_card, xt.to(cuda_device), cfg)
    for a, b in zip(flats + valids, flats_c + valids_c):
        assert torch.equal(a, b.cpu())
    want, aux = moe.apply_moe(params, x, cfg)
    got, aux_c = moe.apply_moe(on_card, x.to(cuda_device), cfg)
    torch.cuda.synchronize()
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert abs(float(aux_c) - float(aux)) <= 1e-6
