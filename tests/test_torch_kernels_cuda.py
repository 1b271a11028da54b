"""The CUDA aggregation kernel against its plain version, on the card.

Marked ``cuda``: each test skips where no NVIDIA GPU is present (the
kernel has no CPU mode).  The file imports neither jax nor the reference
package, so it runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: float32 relative to the largest output, 1e-5 (the kernel and
cuBLAS sum the K products in their own orders); bfloat16 at most 1 ulp
(both accumulate in float32 and round once).
"""
import pytest
import torch

from repro_torch.kernels.aggregate import aggregate_flat
from repro_torch.kernels.aggregate_ref import aggregate_flat_ref, bf16_ulp_distance


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
