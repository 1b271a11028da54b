"""repro_torch.compute and the fleet-aware engine: the reference's
``tests/test_compute.py`` on the port, and the port against the JAX
package.

  * Twins of the reference's analytic-mode tests (profiles, roofline,
    fleet model, eq. (11)'s executed-work charge, the strategy wiring),
    on CPU tasks.
  * ``analytic_step_cost``, ``seconds_per_sample`` (on every device
    tier, smoke and full size) and ``arch_payload_bits`` for every
    ``ARCH_IDS`` entry: equal to the reference bit for bit.
  * A heterogeneous-fleet FedLEO run (2 rounds): round times, events and
    every client's eq. (11) time equal to the reference exactly.
  * The degenerate case: ``compute=None`` and the all-default profile
    give identical round times, events and metrics.
  * The ``compiled`` mode prices through the port's dry run (finite,
    cached, linear in tokens; the fleet model uses it); ``measured``
    times a smoke step where the caller names the device, and without a
    card raises rather than time the CPU.
"""
import jax
import numpy as np
import pytest

import repro.compute as JC
import repro.core as J
from repro import data as jdata
from repro.models.cnn import apply_cnn as japply_cnn
from repro.models.cnn import init_cnn as jinit_cnn
from repro.optim import get_optimizer as jget_optimizer
from repro_torch.compute import (
    DEVICE_TIERS,
    DeviceProfile,
    FleetComputeModel,
    SatAssignment,
    SatelliteComputeProfile,
    arch_payload_bits,
    seconds_per_sample,
    step_time_s,
)
from repro_torch.compute import roofline
from repro_torch.compute.roofline import analytic_step_cost
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import FedLEO, FederatedTask, SimConfig, TrainHyperparams
from repro_torch.data import make_classification_dataset, partition_noniid_by_orbit
from repro_torch.models.cnn import apply_cnn, init_cnn
from repro_torch.optim import get_optimizer

SLOW, FAST = "gemma-7b", "mamba2-780m"
HETERO = [SLOW, FAST, None, FAST, SLOW]


# --- profiles ---------------------------------------------------------------------
class TestProfiles:
    def test_device_tier_validation(self):
        with pytest.raises(ValueError):
            DeviceProfile("bad", peak_flops=0.0, hbm_bytes_per_s=1e9)
        with pytest.raises(ValueError):
            DeviceProfile("bad", peak_flops=1e12, hbm_bytes_per_s=1e9,
                          mfu_fraction=1.5)

    def test_assignment_validation(self):
        with pytest.raises(ValueError):
            SatAssignment(arch="no-such-arch")
        with pytest.raises(ValueError):
            SatAssignment(arch=FAST, device="no-such-device")
        SatAssignment()

    def test_profile_validation(self):
        with pytest.raises(ValueError):
            SatelliteComputeProfile(shape="no-such-shape")
        with pytest.raises(ValueError):
            SatelliteComputeProfile(mode="no-such-mode")
        with pytest.raises(ValueError):
            SatelliteComputeProfile(mode="compiled", smoke=False)

    def test_assignment_resolution_order(self):
        override = SatAssignment(arch=SLOW, device="cubesat-cpu")
        prof = SatelliteComputeProfile(
            planes=(SatAssignment(arch=FAST),),
            sat_overrides=((0, 3, override),),
        )
        assert prof.assignment(0, 3) == override
        assert prof.assignment(0, 0).arch == FAST
        assert prof.assignment(7, 0).arch is None

    def test_per_plane_constructor(self):
        prof = SatelliteComputeProfile.per_plane([SLOW, None, FAST])
        assert prof.assignment(0).arch == SLOW
        assert prof.assignment(1).arch is None
        assert prof.assignment(2).arch == FAST


# --- roofline ---------------------------------------------------------------------
class TestRoofline:
    def test_analytic_cost_positive_and_cached(self):
        c = analytic_step_cost(FAST, "train_4k", True)
        assert c.flops > 0 and c.hbm_bytes > 0 and c.tokens > 0
        assert analytic_step_cost(FAST, "train_4k", True) is c

    def test_bigger_arch_costs_more(self):
        dev = DEVICE_TIERS["orbital-gpu"]
        slow = seconds_per_sample(SLOW, "train_4k", dev, smoke=False)
        fast = seconds_per_sample(FAST, "train_4k", dev, smoke=False)
        assert slow > fast > 0

    def test_faster_device_is_faster(self):
        t_cube = step_time_s(FAST, "train_4k", DEVICE_TIERS["cubesat-cpu"], smoke=False)
        t_tpu = step_time_s(FAST, "train_4k", DEVICE_TIERS["orbital-tpu-v5e"], smoke=False)
        assert t_cube > t_tpu > 0

    def test_roofline_is_max_of_both_axes(self):
        c = analytic_step_cost(FAST, "train_4k", True)
        dev = DEVICE_TIERS["orbital-gpu"]
        t = step_time_s(FAST, "train_4k", dev)
        assert t == pytest.approx(max(
            c.flops / (dev.peak_flops * dev.mfu_fraction),
            c.hbm_bytes / dev.hbm_bytes_per_s,
        ))

    def test_payload_bits_from_param_count(self):
        bits = arch_payload_bits(FAST, bits_per_param=32)
        assert bits == float(get_smoke_config(FAST).param_count_estimate()) * 32
        assert arch_payload_bits(FAST, bits_per_param=8) * 4 == bits


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_costs_equal_reference_bit_for_bit(arch):
    assert tuple(JC.DEVICE_TIERS) == tuple(DEVICE_TIERS)
    for smoke in (True, False):
        ours = analytic_step_cost(arch, "train_4k", smoke)
        ref = JC.roofline.analytic_step_cost(arch, "train_4k", smoke)
        assert (ours.flops, ours.hbm_bytes, ours.tokens) == (ref.flops, ref.hbm_bytes, ref.tokens)
        for tier in DEVICE_TIERS:
            assert seconds_per_sample(arch, "train_4k", DEVICE_TIERS[tier], smoke=smoke) == \
                JC.seconds_per_sample(arch, "train_4k", JC.DEVICE_TIERS[tier], smoke=smoke)
        for bits in (8, 32):
            assert arch_payload_bits(arch, bits_per_param=bits, smoke=smoke) == \
                JC.arch_payload_bits(arch, bits_per_param=bits, smoke=smoke)


def test_compiled_mode_is_finite_cached_and_linear_in_tokens():
    """``compiled_step_cost`` counts the smoke train step at 4 x 128 on a
    one-device mesh and scales it by tokens: a smaller shape with the
    same compile shape costs exactly its share of tokens."""
    import dataclasses

    from repro_torch.configs import base

    small = dataclasses.replace(base.INPUT_SHAPES["train_4k"], name="_test_train_1k",
                                seq_len=1024, global_batch=64)
    base.INPUT_SHAPES[small.name] = small
    try:
        big = roofline.compiled_step_cost(FAST, "train_4k")
        assert roofline.compiled_step_cost(FAST, "train_4k") is big        # cached
        little = roofline.compiled_step_cost(FAST, small.name)
    finally:
        base.INPUT_SHAPES.pop(small.name)
    assert all(np.isfinite(v) and v > 0 for v in (big.flops, big.hbm_bytes, big.tokens))
    ratio = big.tokens / little.tokens
    assert ratio == 16.0
    assert big.flops == pytest.approx(ratio * little.flops, rel=1e-12)
    assert big.hbm_bytes == pytest.approx(ratio * little.hbm_bytes, rel=1e-12)
    tier = DEVICE_TIERS["orbital-gpu"]
    assert step_time_s(FAST, "train_4k", tier, mode="compiled") == max(
        big.flops / (tier.peak_flops * tier.mfu_fraction), big.hbm_bytes / tier.hbm_bytes_per_s)


def test_fleet_prices_in_compiled_mode():
    fleet = FleetComputeModel(SatelliteComputeProfile.per_plane([FAST, SLOW], mode="compiled"), 2)
    analytic = FleetComputeModel(SatelliteComputeProfile.per_plane([FAST, SLOW]), 2)
    for plane, arch in enumerate((FAST, SLOW)):
        sps = fleet.seconds_per_sample(plane)
        assert np.isfinite(sps) and sps > 0
        assert sps != analytic.seconds_per_sample(plane)
        assert sps == seconds_per_sample(arch, "train_4k", DEVICE_TIERS["orbital-gpu"],
                                         mode="compiled")


def test_calibration_times_a_smoke_step_on_the_named_device():
    from repro_torch.launch.calibrate import measure_smoke_step_s

    t = measure_smoke_step_s(FAST, seq_len=32, global_batch=2, iters=1, device="cpu")
    assert np.isfinite(t) and t > 0


def test_measured_mode_without_a_card_raises(monkeypatch):
    """``measured`` times on the card; without one it raises, naming the
    missing device, and never times the CPU in its place."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    roofline._measured_step_time_s.cache_clear()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        step_time_s(FAST, "train_4k", DEVICE_TIERS["orbital-gpu"], mode="measured")
    fleet = FleetComputeModel(SatelliteComputeProfile.per_plane([FAST], mode="measured"), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.seconds_per_sample(0)
    assert roofline._measured_step_time_s.cache_info().currsize == 0


# --- fleet model ------------------------------------------------------------------
class TestFleetModel:
    def test_degenerate_tier_answers_none(self):
        fleet = FleetComputeModel(SatelliteComputeProfile.uniform(), 5)
        for plane in range(5):
            assert fleet.seconds_per_sample(plane) is None
            assert fleet.payload_bits(plane) is None
            assert fleet.train_time_s(plane, local_epochs=1, n_batches=1, batch_size=1) is None

    def test_train_time_composes_eq11(self):
        fleet = FleetComputeModel(SatelliteComputeProfile.per_plane([FAST]), 1)
        sps = fleet.seconds_per_sample(0)
        assert fleet.train_time_s(0, local_epochs=3, n_batches=2, batch_size=16) == \
            pytest.approx(3 * 2 * 16 * sps)

    def test_payload_gated_on_opt_in(self):
        off = FleetComputeModel(SatelliteComputeProfile.per_plane([FAST]), 1)
        on = FleetComputeModel(
            SatelliteComputeProfile.per_plane([FAST], payload_from_arch=True), 1)
        assert off.payload_bits(0) is None
        assert on.payload_bits(0) == arch_payload_bits(FAST)

    def test_plane_summary(self):
        fleet = FleetComputeModel(SatelliteComputeProfile.per_plane([SLOW, None]), 2)
        rows = fleet.plane_summary()
        assert [r["arch"] for r in rows] == [SLOW, None]
        assert rows[0]["seconds_per_sample"] > 0
        assert rows[1]["seconds_per_sample"] is None


# --- task + strategy wiring -------------------------------------------------------
def _small_task(num_samples=400, sim_epochs=2, compute=None):
    ds = make_classification_dataset("mnist-like", num_samples=num_samples, seed=0)
    test = make_classification_dataset("mnist-like", num_samples=100, seed=99)
    return FederatedTask(
        init_fn=lambda r: init_cnn(r, (28, 28, 1), 10, widths=(8,), hidden=32),
        apply_fn=apply_cnn, clients=partition_noniid_by_orbit(ds, 5, 8),
        test_set=test, optimizer=get_optimizer("sgd", 0.05),
        hp=TrainHyperparams(local_epochs=100, learning_rate=0.05, batch_size=16),
        sim_epochs=sim_epochs, compute=compute, device="cpu",
    )


class TestExecutedWorkFix:
    def test_tiny_client_charges_executed_samples(self):
        task = _small_task(num_samples=400)
        hp = task.hp
        m = task.num_samples(0)
        assert m < hp.batch_size
        assert task.executed_batches(0) == (1, m)
        expected = (hp.local_epochs * 1 * m * hp.cycles_per_sample) / hp.cpu_freq_hz
        assert task.train_time_s(0) == pytest.approx(expected)

    def test_large_client_unchanged(self):
        task = _small_task(num_samples=3200)
        hp = task.hp
        m = task.num_samples(0)
        assert m >= hp.batch_size
        n_batches, bsz = task.executed_batches(0)
        assert bsz == hp.batch_size
        assert n_batches == m // hp.batch_size
        expected = (hp.local_epochs * n_batches * hp.batch_size
                    * hp.cycles_per_sample) / hp.cpu_freq_hz
        assert task.train_time_s(0) == pytest.approx(expected)

    def test_task_level_compute_model_prices_its_clients(self):
        fleet = FleetComputeModel(SatelliteComputeProfile.per_plane(HETERO, smoke=False), 5)
        task, plain = _small_task(compute=fleet), _small_task()
        for cid, c in enumerate(task.clients):
            n_batches, bsz = task.executed_batches(cid)
            t = fleet.train_time_s(c.plane, c.slot, local_epochs=task.hp.local_epochs,
                                   n_batches=n_batches, batch_size=bsz)
            assert task.train_time_s(cid) == (plain.train_time_s(cid) if t is None else t)
        # a strategy falls back to the task's model when SimConfig has none
        assert FedLEO(task, SimConfig()).compute is fleet


class TestStrategyWiring:
    def test_strategy_resolves_compute_without_mutating_task(self):
        task = _small_task()
        strat = FedLEO(task, SimConfig(compute=SatelliteComputeProfile.per_plane(HETERO)))
        assert strat.compute is not None
        assert task.compute is None

    def test_hetero_train_times_ordered(self):
        task = _small_task()
        strat = FedLEO(task, SimConfig(
            compute=SatelliteComputeProfile.per_plane(HETERO, smoke=False)))
        slow_c = task.clients_on_plane(0)[0]
        fast_c = task.clients_on_plane(1)[0]
        deg_c = task.clients_on_plane(2)[0]
        assert strat.train_time_s(slow_c) > strat.train_time_s(fast_c)
        assert strat.train_time_s(deg_c) == task.train_time_s(deg_c)

    def test_sat_and_group_payload_bits(self):
        task = _small_task()
        strat = FedLEO(task, SimConfig(compute=SatelliteComputeProfile.per_plane(
            [SLOW, FAST, None], payload_from_arch=True)))
        assert strat.sat_payload_bits(0) == arch_payload_bits(SLOW)
        assert strat.sat_payload_bits(2) == float(task.payload_bits)
        assert strat.group_payload_bits((0, 1)) == arch_payload_bits(SLOW)
        assert strat.group_payload_bits((2,)) == float(task.payload_bits)
        plain = FedLEO(_small_task(), SimConfig(
            compute=SatelliteComputeProfile.per_plane([SLOW])))
        assert plain.group_payload_bits((0,)) == plain.payload_bits

    def test_uniform_profile_bit_identical_end_to_end(self):
        r0 = FedLEO(_small_task(), SimConfig()).run(max_rounds=1)
        ru = FedLEO(_small_task(), SimConfig(
            compute=SatelliteComputeProfile.uniform())).run(max_rounds=1)
        assert len(r0.history) == len(ru.history) == 1
        a, b = r0.history[0], ru.history[0]
        assert a.t_hours == b.t_hours
        assert a.metrics == b.metrics
        assert a.events == b.events

    def test_hetero_profile_changes_round_time(self):
        r0 = FedLEO(_small_task(), SimConfig()).run(max_rounds=1)
        rh = FedLEO(_small_task(), SimConfig(
            compute=SatelliteComputeProfile.per_plane(HETERO, smoke=False))).run(max_rounds=1)
        assert rh.history[0].t_hours > r0.history[0].t_hours


# --- the heterogeneous fleet against the reference --------------------------------
def test_hetero_fleet_fedleo_equals_reference():
    """Two rounds of FedLEO on a per-plane gemma/mamba2 fleet on the
    orbital GPU tier (full-size analytic pricing), port against
    reference from the same initial parameters: the clock is exact."""
    ds = jdata.make_classification_dataset("mnist-like", num_samples=400, seed=0)
    test = jdata.make_classification_dataset("mnist-like", num_samples=100, seed=99)
    hp = dict(local_epochs=100, learning_rate=0.05, batch_size=16)
    jtask = J.FederatedTask(
        init_fn=lambda r: jinit_cnn(r, (28, 28, 1), 10, widths=(8,), hidden=32),
        apply_fn=japply_cnn, clients=jdata.partition_noniid_by_orbit(ds, 5, 8),
        test_set=test, optimizer=jget_optimizer("sgd", 0.05),
        hp=J.TrainHyperparams(**hp), sim_epochs=1,
    )
    init = jax.tree_util.tree_map(np.asarray, jtask.global_params)
    ttask = _small_task(sim_epochs=1)
    ttask.global_params = params_from_numpy(init, "cpu")
    fleet = dict(device="orbital-gpu", smoke=False)
    archs = ["gemma-7b", "mamba2-780m", "gemma-7b", "mamba2-780m", None]
    jstrat = J.FedLEO(jtask, J.SimConfig(
        compute=JC.SatelliteComputeProfile.per_plane(archs, **fleet), use_kernel=True))
    tstrat = FedLEO(ttask, SimConfig(
        compute=SatelliteComputeProfile.per_plane(archs, **fleet), use_kernel=True))
    for cid in range(len(ttask.clients)):
        assert tstrat.train_time_s(cid) == jstrat.train_time_s(cid)
    jres, tres = jstrat.run(max_rounds=2), tstrat.run(max_rounds=2)
    assert len(tres.history) == len(jres.history) == 2
    assert [h.t_hours for h in tres.history] == [h.t_hours for h in jres.history]
    assert [h.events for h in tres.history] == [h.events for h in jres.history]
    uniform = FedLEO(_small_task(sim_epochs=1), SimConfig(use_kernel=True)).run(max_rounds=2)
    assert [h.t_hours for h in tres.history] != [h.t_hours for h in uniform.history]
