"""The paper's Table II baselines: JAX runs against repro_torch runs.

Every entry of ``ALL_BASELINES`` runs 2 rounds (server events, for the
asynchronous strategies; FedSpace runs 10, the arrival at which its
buffer of a quarter of the 40 clients first folds into the model) on
the scenario of ``test_torch_fedleo.py``:
the quickstart constellation (5x8 Walker, 1500 km, 80 deg, Rolla GS)
with the aggregation kernel path on, 800 non-IID samples, a tiny CNN,
sim_epochs=2, and the port starting from the reference's initial
parameters carried across as numpy arrays.  The batch size is at least
the padded client size, so every epoch is one full batch and the
gradient does not depend on the (framework-specific) sample order.

Tolerances:
  * round times and per-round events: exactly equal — the schedule is
    the same numpy code on both sides.
  * global parameters after the last round: 1e-4 (measured: at most
    7.2e-7, FedSpace) —
    float32 training whose convolutions sum in another order on each
    side.
  * accuracy: within 2 test samples; loss within 1e-4.
"""
import jax
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from repro import data as jdata
from repro.core.baselines import ALL_BASELINES as J_BASELINES
from repro.models.cnn import apply_cnn as japply_cnn
from repro.models.cnn import init_cnn as jinit_cnn
from repro.optim import get_optimizer as jget_optimizer
from repro_torch import data as tdata
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.baselines import ALL_BASELINES as T_BASELINES
from repro_torch.models.cnn import apply_cnn as tapply_cnn
from repro_torch.optim import get_optimizer as tget_optimizer
from repro_torch.tree import tree_leaves

HP = dict(local_epochs=100, learning_rate=0.05, batch_size=32)
ROUNDS = 2
# FedSpace aggregates at its 10th arrival; FedSat-ideal only once an
# orbital period has passed, thousands of arrivals in, so its two rounds
# only buffer
ROUNDS_OF = {"FedSpace": 10}
N_TEST = 200
NAMES = list(J_BASELINES)


def _datasets(pkg):
    train = pkg.make_classification_dataset("mnist-like", num_samples=800, seed=0)
    test = pkg.make_classification_dataset("mnist-like", num_samples=N_TEST, seed=99)
    return pkg.partition_noniid_by_orbit(train, 5, 8), test


def _sim(pkg):
    return pkg.SimConfig(horizon_hours=72.0, use_kernel=True)


@pytest.fixture(scope="module")
def tasks():
    """One task per package, shared by every strategy (a strategy never
    mutates its task), so the reference compiles its training once."""
    clients, test = _datasets(jdata)
    jtask = J.FederatedTask(
        init_fn=lambda r: jinit_cnn(r, (28, 28, 1), 10, widths=(4, 8), hidden=16),
        apply_fn=japply_cnn, clients=clients, test_set=test,
        optimizer=jget_optimizer("sgd", 0.05), hp=J.TrainHyperparams(**HP),
        sim_epochs=2,
    )
    init = jax.tree_util.tree_map(np.asarray, jtask.global_params)
    clients, test = _datasets(tdata)
    ttask = T.FederatedTask(
        init_fn=lambda r: params_from_numpy(init, "cpu"),
        apply_fn=tapply_cnn, clients=clients, test_set=test,
        optimizer=tget_optimizer("sgd", 0.05), hp=T.TrainHyperparams(**HP),
        sim_epochs=2, device="cpu",
    )
    assert max(ttask.num_samples(c) for c in range(40)) <= HP["batch_size"]
    return jtask, ttask


@pytest.fixture(scope="module")
def runs(tasks):
    jtask, ttask = tasks
    out = {}
    for name in NAMES:
        jstrat = J_BASELINES[name](jtask, _sim(J))
        tstrat = T_BASELINES[name](ttask, _sim(T))
        rounds = ROUNDS_OF.get(name, ROUNDS)
        out[name] = (jstrat, jstrat.run(max_rounds=rounds),
                     tstrat, tstrat.run(max_rounds=rounds))
    return out


def test_the_port_has_every_baseline():
    assert list(T_BASELINES) == NAMES
    assert [c.name for c in T_BASELINES.values()] == [c.name for c in J_BASELINES.values()]


@pytest.mark.parametrize("name", NAMES)
def test_round_times_and_events_equal_exactly(runs, name):
    _, jres, _, tres = runs[name]
    assert len(tres.history) == len(jres.history) == ROUNDS_OF.get(name, ROUNDS)
    assert tres.name == jres.name
    assert [h.t_hours for h in tres.history] == [h.t_hours for h in jres.history]
    assert [h.events for h in tres.history] == [h.events for h in jres.history]


@pytest.mark.parametrize("name", NAMES)
def test_global_params_after_round_two_close(runs, name):
    jstrat, _, tstrat, _ = runs[name]
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jstrat.global_params))
    ours = tree_leaves(params_to_numpy(tstrat.global_params))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    # FedSat-ideal has only buffered: the model moves exactly where the
    # reference's does
    init = tree_leaves(params_to_numpy(tstrat.task.global_params))
    moved = lambda leaves: max(float(np.abs(a - b).max()) for a, b in zip(leaves, init))
    assert (moved(ours) > 1e-4) == (moved(ref) > 1e-4) == (name != "FedSat-ideal")


@pytest.mark.parametrize("name", NAMES)
def test_accuracies_within_two_test_samples(runs, name):
    _, jres, _, tres = runs[name]
    for jh, th in zip(jres.history, tres.history):
        assert abs(th.metrics["accuracy"] - jh.metrics["accuracy"]) <= 2 / N_TEST + 1e-6
        assert th.metrics["loss"] == pytest.approx(jh.metrics["loss"], abs=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_sanitizer_ran_clean(runs, name):
    _, _, tstrat, _ = runs[name]
    assert tstrat.env.sanitizer is not None
    assert tstrat.env.sanitizer.report() == []


def test_fedleo_round_time_below_fedavg(tasks):
    """The paper's headline (eq. 12 against eq. 10), on the port: FedLEO's
    2-round time beats the star topology's."""
    _, ttask = tasks
    t_leo = T.FedLEO(ttask, _sim(T)).run(max_rounds=ROUNDS)
    t_avg = T_BASELINES["FedAvg"](ttask, _sim(T)).run(max_rounds=ROUNDS)
    assert t_leo.final_time_hours < t_avg.final_time_hours
