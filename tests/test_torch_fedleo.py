"""The slice end to end: a JAX FedLEO run and a repro_torch FedLEO run.

Both run 2 rounds of the quickstart scenario (5x8 Walker, 1500 km, 80
deg, Rolla GS) with the aggregation kernel path on, 800 samples, a tiny
CNN, sim_epochs=2, and the port starting from the reference's initial
parameters carried across as numpy arrays.  The batch size is at least
the padded client size, so every epoch is one full batch and the
gradient does not depend on the (framework-specific) sample order.

Tolerances:
  * round times, per-plane events and decompositions: exactly equal —
    the schedule is the same numpy code on both sides.
  * global parameters after round 2: 1e-4 — float32 training whose
    convolutions sum in another order on each side, over 2 rounds of
    2 epochs of SGD at lr 0.05.
  * accuracy: within 2 test samples.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro import data as jdata
from repro.models.cnn import apply_cnn as japply_cnn
from repro.models.cnn import init_cnn as jinit_cnn
from repro.optim import get_optimizer as jget_optimizer
from repro_torch import data as tdata
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import fltask as tfltask
from repro.core import fltask as jfltask
from repro_torch.models.cnn import apply_cnn as tapply_cnn
from repro_torch.optim import get_optimizer as tget_optimizer
from repro_torch.tree import tree_leaves

HP = dict(local_epochs=100, learning_rate=0.05, batch_size=32)
ROUNDS = 2
N_TEST = 200


def _datasets(pkg):
    train = pkg.make_classification_dataset("mnist-like", num_samples=800, seed=0)
    test = pkg.make_classification_dataset("mnist-like", num_samples=N_TEST, seed=99)
    return pkg.partition_noniid_by_orbit(train, 5, 8), test


def _jax_task():
    clients, test = _datasets(jdata)
    return J.FederatedTask(
        init_fn=lambda r: jinit_cnn(r, (28, 28, 1), 10, widths=(4, 8), hidden=16),
        apply_fn=japply_cnn, clients=clients, test_set=test,
        optimizer=jget_optimizer("sgd", 0.05), hp=J.TrainHyperparams(**HP),
        sim_epochs=2,
    )


def _torch_task(init_params):
    clients, test = _datasets(tdata)
    return T.FederatedTask(
        init_fn=lambda r: params_from_numpy(init_params, "cpu"),
        apply_fn=tapply_cnn, clients=clients, test_set=test,
        optimizer=tget_optimizer("sgd", 0.05), hp=T.TrainHyperparams(**HP),
        sim_epochs=2, device="cpu",
    )


@pytest.fixture(scope="module")
def runs():
    jtask = _jax_task()
    init = jax.tree_util.tree_map(np.asarray, jtask.global_params)
    jstrat = J.FedLEO(jtask, J.SimConfig(horizon_hours=72.0, use_kernel=True))
    jres = jstrat.run(max_rounds=ROUNDS)
    ttask = _torch_task(init)
    assert max(ttask.num_samples(c) for c in range(40)) <= HP["batch_size"]
    tstrat = T.FedLEO(ttask, T.SimConfig(horizon_hours=72.0, use_kernel=True))
    tres = tstrat.run(max_rounds=ROUNDS)
    return jstrat, jres, tstrat, tres


def test_both_runs_complete(runs):
    _, jres, _, tres = runs
    assert len(jres.history) == len(tres.history) == ROUNDS
    assert tres.name == jres.name == "FedLEO"


def test_round_times_equal_exactly(runs):
    _, jres, _, tres = runs
    assert [h.t_hours for h in tres.history] == [h.t_hours for h in jres.history]


def test_per_plane_events_equal_exactly(runs):
    _, jres, _, tres = runs
    for jh, th in zip(jres.history, tres.history):
        assert th.events == jh.events
        assert len(th.events["planes"]) == 5


def test_round_decompositions_equal(runs):
    _, jres, _, tres = runs
    for jh, th in zip(jres.history, tres.history):
        assert dataclasses.asdict(th.decomposition) == dataclasses.asdict(jh.decomposition)


def test_global_params_after_round_two_close(runs):
    jstrat, _, tstrat, _ = runs
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jstrat.global_params))
    ours = tree_leaves(params_to_numpy(tstrat.global_params))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    moved = max(float(np.abs(a - b).max()) for a, b in
                zip(ours, tree_leaves(params_to_numpy(tstrat.task.global_params))))
    assert moved > 1e-3          # training did change the model


def test_accuracies_within_two_test_samples(runs):
    _, jres, _, tres = runs
    for jh, th in zip(jres.history, tres.history):
        assert abs(th.metrics["accuracy"] - jh.metrics["accuracy"]) <= 2 / N_TEST + 1e-6
        assert th.metrics["loss"] == pytest.approx(jh.metrics["loss"], abs=1e-4)


def test_sanitizer_ran_clean(runs):
    _, _, tstrat, _ = runs
    assert tstrat.env.sanitizer is not None
    assert tstrat.env.sanitizer.report() == []


# --- FederatedTask pieces ----------------------------------------------------------------
def test_clock_and_payload_match_reference(runs):
    jstrat, _, tstrat, _ = runs
    jt, tt = jstrat.task, tstrat.task
    assert tt.payload_bits == jt.payload_bits
    for c in range(len(tt.clients)):
        assert tt.num_samples(c) == jt.num_samples(c)
        assert tt.executed_batches(c) == jt.executed_batches(c)
        assert tt.train_time_s(c) == jt.train_time_s(c)
        assert tstrat.train_time_s(c) == jstrat.train_time_s(c)
    assert tt.clients_on_plane(3) == jt.clients_on_plane(3)
    np.testing.assert_array_equal(tt.client_histograms(), jt.client_histograms())


def test_local_train_matches_reference_for_one_plane():
    jtask = _jax_task()
    init = jax.tree_util.tree_map(np.asarray, jtask.global_params)
    ttask = _torch_task(init)
    clients = jtask.clients_on_plane(2)
    ref = jtask.local_train(jtask.global_params, clients, jax.random.PRNGKey(5))
    ours = ttask.local_train(ttask.global_params, clients, torch.Generator().manual_seed(5))
    for a, b in zip(tree_leaves(params_to_numpy(ours)), jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.shape[0] == len(clients)
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


def test_minibatches_follow_the_generator():
    """With batches smaller than a client, the sample order matters:
    the same generator seed gives the same result, another seed not."""
    clients, test = _datasets(tdata)
    task = T.FederatedTask(
        init_fn=lambda r: params_from_numpy(
            jax.tree_util.tree_map(np.asarray, _jax_task().global_params), "cpu"),
        apply_fn=tapply_cnn, clients=clients, test_set=test,
        optimizer=tget_optimizer("sgd", 0.05),
        hp=T.TrainHyperparams(local_epochs=100, learning_rate=0.05, batch_size=4),
        sim_epochs=1, device="cpu",
    )
    run = lambda seed: tree_leaves(task.local_train(
        task.global_params, [0, 1], torch.Generator().manual_seed(seed)))
    a, b, c = run(1), run(1), run(2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("shape", [(6, 10), (2, 3, 3, 4)])
def test_loss_and_accuracy_match_reference(shape):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal(shape).astype(np.float32)
    labels = rng.integers(0, shape[-1], size=shape[:-1]).astype(np.int32)
    ref_loss = float(jfltask.cross_entropy_loss(logits, labels))
    ref_acc = float(jfltask.accuracy(logits, labels))
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    assert float(tfltask.cross_entropy_loss(lt, yt)) == pytest.approx(ref_loss, abs=1e-6)
    assert float(tfltask.accuracy(lt, yt)) == ref_acc


def test_entry_points_default_to_cuda():
    """device=None means CUDA: it raises without a card, never falls back."""
    clients, test = _datasets(tdata)
    make = lambda: T.FederatedTask(
        init_fn=lambda r: {"w": torch.zeros(2)}, apply_fn=tapply_cnn,
        clients=clients, test_set=test, optimizer=tget_optimizer("sgd", 0.1),
    )
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_compute_model_is_not_ported_yet():
    """The fleet compute model's modes on the port (the name dates from
    before ``repro_torch.launch`` was ported): a task and a strategy take
    ``compute=``, and a strategy prices a round in the compiled mode,
    through the port's dry run, apart from the analytic price."""
    from repro_torch.compute import FleetComputeModel, SatelliteComputeProfile

    clients, test = _datasets(tdata)
    make = lambda compute=None: T.FederatedTask(
        init_fn=lambda r: {"w": torch.zeros(2)}, apply_fn=tapply_cnn,
        clients=clients, test_set=test, optimizer=tget_optimizer("sgd", 0.1),
        compute=compute, device="cpu")
    fleet = FleetComputeModel(SatelliteComputeProfile.per_plane(["mamba2-780m"]), 5)
    assert make(fleet).compute is fleet
    assert T.FedLEO(make(), T.SimConfig(compute=SatelliteComputeProfile())).compute is not None
    compiled = SatelliteComputeProfile.per_plane(["mamba2-780m"], mode="compiled")
    analytic = SatelliteComputeProfile.per_plane(["mamba2-780m"])
    client = make().clients_on_plane(0)[0]
    t = T.FedLEO(make(), T.SimConfig(compute=compiled)).train_time_s(client)
    assert math.isfinite(t) and t > 0
    assert t != T.FedLEO(make(), T.SimConfig(compute=analytic)).train_time_s(client)


def test_sim_config_fields_and_defaults_match_reference():
    ours = {f.name: f for f in dataclasses.fields(T.SimConfig)}
    ref = {f.name: f for f in dataclasses.fields(J.SimConfig)}
    assert list(ours) == list(ref)
    o, r = dataclasses.asdict(T.SimConfig()), dataclasses.asdict(J.SimConfig())
    assert o == r
    assert [f.name for f in dataclasses.fields(T.TrainHyperparams)] == \
        [f.name for f in dataclasses.fields(J.TrainHyperparams)]
    assert dataclasses.asdict(T.TrainHyperparams()) == dataclasses.asdict(J.TrainHyperparams())
