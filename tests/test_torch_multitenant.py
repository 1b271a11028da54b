"""The reference's multi-tenant tests (``tests/test_multitenant.py``)
on the port's copied ``repro_torch.multitenant`` and ``comms``, and a
two-job schedule, port against reference.

  * Twins: ledger booking identity, JobScheduler admission, tiers and
    fairness, the repack floor, lazy routing, the falsy-zero engine
    regressions and single-job transparency, on CPU tasks.  The
    reference's shared-ledger property test is not twinned: its oracle
    merges abutting intervals that the ledger keeps apart, so it fails
    on the reference too (a known reference-side fault).
  * Two concurrent jobs (FedLEO and FedAvgStar over one shared ledger,
    the aggregation kernel path on) through the reference's scheduler
    and the port's, from the same initial parameters: the same job
    records exactly, round times exactly, accuracy within 2 test
    samples and loss within 1e-4 (float32 training that sums in
    another order on each side).
"""
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.comms import LinkConfig
from repro_torch.comms.environment import CommsEnvironment, PendingUpload
from repro_torch.comms.ledger import GSResourceLedger
from repro_torch.multitenant import (
    QUEUED,
    REJECTED,
    RID_STRIDE,
    RUNNING,
    JobScheduler,
    JobSpec,
    projected_demand_rb_s,
)


# ---------------------------------------------------------------------------
# ledger booking identity (the release-identity bugfix)
# ---------------------------------------------------------------------------

class TestBookingIdentity:
    def test_identical_intervals_distinguishable(self):
        led = GSResourceLedger(1, 4)
        b1 = led.reserve(0, 10.0, 20.0)
        b2 = led.reserve(0, 10.0, 20.0)
        assert b1 is not None and b2 is not None and b1 != b2
        assert led.num_reserved() == 2
        led.release_booking(0, b1)
        assert led.num_reserved() == 1
        assert led.occupancy(0, 15.0) == 1
        led.release_booking(0, b2)
        assert led.num_reserved() == 0

    def test_release_booking_unknown_raises(self):
        led = GSResourceLedger(1, 4)
        bid = led.reserve(0, 0.0, 5.0)
        led.release_booking(0, bid)
        with pytest.raises(ValueError, match="no booking id"):
            led.release_booking(0, bid)

    def test_legacy_interval_release_shim(self):
        led = GSResourceLedger(1, 4)
        led.reserve(0, 3.0, 7.0)
        led.release(0, 3.0, 7.0)
        assert led.num_reserved() == 0
        with pytest.raises(ValueError):
            led.release(0, 3.0, 7.0)

    def test_booking_ids_never_reused(self):
        led = GSResourceLedger(1, 4)
        b1 = led.reserve(0, 0.0, 1.0)
        led.release_booking(0, b1)
        b2 = led.reserve(0, 0.0, 1.0)
        assert b2 != b1

    def test_release_before_keeps_ids_aligned(self):
        led = GSResourceLedger(1, 4)
        led.reserve(0, 0.0, 5.0)
        keep = led.reserve(0, 10.0, 15.0)
        led.reserve(0, 2.0, 6.0)
        led.release_before(8.0)
        assert led.num_reserved() == 1
        led.release_booking(0, keep)
        assert led.num_reserved() == 0


# ---------------------------------------------------------------------------
# scheduler harness: bare sessions (no predictor build) + fake runners
# ---------------------------------------------------------------------------

class _StubPredictor:
    """Just enough predictor surface for a planning-free session."""

    def __init__(self, num_stations: int):
        self.ground_stations = tuple(
            SimpleNamespace(name=f"gs{i}") for i in range(num_stations)
        )


class _StubDecision:
    """Books one interval through ``CommsEnvironment.commit`` via the
    single-upload-span fallback of ``_decision_legs``."""

    def __init__(self, gs_index: int, t0: float, t1: float):
        self.window = SimpleNamespace(gs_index=gs_index)
        self.t_upload_start = t0
        self.t_upload_done = t1


def _bare_env(num_stations: int = 1, capacity: float = 1,
              link: "LinkConfig | None" = None) -> CommsEnvironment:
    return CommsEnvironment(
        walker=None, predictor=_StubPredictor(num_stations), link=link,
        ledger=GSResourceLedger(num_stations, capacity),
    )


class FakeRunner:
    """Deterministic RoundRunner: each round advances the clock by the
    next duration; optionally books a fixed interval per round (to
    exercise RB-seconds metering and admission residuals)."""

    def __init__(self, env, name, durations, *, book_interval=None,
                 rb_s_per_round=None, release_on_finish=False, log=None):
        self.env = env
        self.release_floor_fn = None
        self.name = name
        self._durations = list(durations)
        self._book_interval = book_interval      # (gs, t0, t1) absolute
        self._rb_s = rb_s_per_round              # (gs, seconds) from t
        self._release_on_finish = release_on_finish
        self._log = log
        self._reservations = []

    def run_round(self, t, verbose=False):
        if self._log is not None:
            self._log.append(self.name)
        if not self._durations:
            return None
        d = self._durations.pop(0)
        if self._book_interval is not None:
            gs, a, b = self._book_interval
            self._reservations.append(self.env.commit(_StubDecision(gs, a, b)))
        if self._rb_s is not None:
            gs, seconds = self._rb_s
            self._reservations.append(
                self.env.commit(_StubDecision(gs, t, t + seconds))
            )
        return t + d

    def finish(self, t):
        if self._release_on_finish:
            for res in self._reservations:
                self.env.release(res)
        self.env.finish_session(t, check_leaks=False)


def _sim():
    from repro_torch.core.engine import SimConfig

    return SimConfig()


class TestJobScheduler:
    def test_single_fake_job_completes(self):
        sched = JobScheduler(_sim(), base_env=_bare_env())
        sched.submit(
            JobSpec(name="a", rounds=3),
            lambda env: FakeRunner(env, "a", [10.0, 10.0, 10.0]),
        )
        rec = sched.run()[0]
        assert rec.status == "finished"
        assert rec.rounds_done == 3
        assert rec.round_completions_s == [10.0, 20.0, 30.0]

    def test_stalled_round_marks_job_stalled(self):
        sched = JobScheduler(_sim(), base_env=_bare_env())
        sched.submit(
            JobSpec(name="a", rounds=5),
            lambda env: FakeRunner(env, "a", [10.0]),   # dries up early
        )
        rec = sched.run()[0]
        assert rec.status == "stalled"
        assert rec.rounds_done == 1

    def test_tiers_are_strict_priority(self):
        log = []
        sched = JobScheduler(_sim(), base_env=_bare_env())
        sched.submit(
            JobSpec(name="bg", rounds=3, tier=1),
            lambda env: FakeRunner(env, "bg", [10.0] * 3, log=log),
        )
        sched.submit(
            JobSpec(name="fg", rounds=3, tier=0),
            lambda env: FakeRunner(env, "fg", [10.0] * 3, log=log),
        )
        sched.run()
        assert log == ["fg", "fg", "fg", "bg", "bg", "bg"]

    def test_weighted_max_min_fairness_over_rb_seconds(self):
        # equal RB booking per round: a weight-3 job gets three rounds
        # for every one of a weight-1 job
        log = []
        sched = JobScheduler(_sim(), base_env=_bare_env(capacity=10))
        sched.submit(
            JobSpec(name="a", rounds=2, weight=1.0),
            lambda env: FakeRunner(env, "a", [10.0] * 2,
                                   rb_s_per_round=(0, 100.0), log=log),
        )
        sched.submit(
            JobSpec(name="b", rounds=6, weight=3.0),
            lambda env: FakeRunner(env, "b", [10.0] * 6,
                                   rb_s_per_round=(0, 100.0), log=log),
        )
        recs = sched.run()
        assert log == ["a", "b", "b", "b", "a", "b", "b", "b"]
        assert recs[0].served_rb_s == pytest.approx(200.0)
        assert recs[1].served_rb_s == pytest.approx(600.0)

    def test_edf_orders_by_deadline_within_tier(self):
        # under EDF the tighter-deadline job runs ALL its rounds first,
        # regardless of served RB-seconds; deadline-less jobs go last
        log = []
        sched = JobScheduler(_sim(), base_env=_bare_env(capacity=10),
                             fairness="edf")
        sched.submit(
            JobSpec(name="loose", rounds=2, deadline_s=9000.0),
            lambda env: FakeRunner(env, "loose", [10.0] * 2,
                                   rb_s_per_round=(0, 1.0), log=log),
        )
        sched.submit(
            JobSpec(name="none", rounds=2),
            lambda env: FakeRunner(env, "none", [10.0] * 2,
                                   rb_s_per_round=(0, 1.0), log=log),
        )
        sched.submit(
            JobSpec(name="tight", rounds=2, deadline_s=3000.0),
            lambda env: FakeRunner(env, "tight", [10.0] * 2,
                                   rb_s_per_round=(0, 1.0), log=log),
        )
        sched.run()
        assert log == ["tight", "tight", "loose", "loose",
                       "none", "none"]

    def test_edf_respects_tiers(self):
        # strict tier precedence survives the EDF key: a tier-1 job
        # with the earliest deadline still waits for tier 0
        log = []
        sched = JobScheduler(_sim(), base_env=_bare_env(),
                             fairness="edf")
        sched.submit(
            JobSpec(name="bg", rounds=2, tier=1, deadline_s=100.0),
            lambda env: FakeRunner(env, "bg", [10.0] * 2, log=log),
        )
        sched.submit(
            JobSpec(name="fg", rounds=2, tier=0, deadline_s=9000.0),
            lambda env: FakeRunner(env, "fg", [10.0] * 2, log=log),
        )
        sched.run()
        assert log == ["fg", "fg", "bg", "bg"]

    def test_unknown_fairness_rejected(self):
        with pytest.raises(ValueError):
            JobScheduler(_sim(), base_env=_bare_env(), fairness="fifo")

    def test_single_job_identical_under_both_fairness_keys(self):
        # with one job the within-tier key is irrelevant: identical
        # round trace either way
        results = {}
        for fairness in ("maxmin", "edf"):
            sched = JobScheduler(_sim(), base_env=_bare_env(capacity=10),
                                 fairness=fairness)
            sched.submit(
                JobSpec(name="a", rounds=3, deadline_s=5000.0),
                lambda env: FakeRunner(env, "a", [10.0] * 3,
                                       rb_s_per_round=(0, 2.0)),
            )
            recs = sched.run()
            results[fairness] = (recs[0].rounds_done,
                                 tuple(recs[0].round_completions_s),
                                 recs[0].served_rb_s)
        assert results["maxmin"] == results["edf"]

    def test_rid_namespaces_disjoint_across_jobs(self):
        rids = {"a": [], "b": []}
        sched = JobScheduler(_sim(), base_env=_bare_env(capacity=10))

        def factory(name):
            def make(env):
                env.on_commit(lambda res: rids[name].append(res.rid))
                return FakeRunner(env, name, [10.0] * 2,
                                  rb_s_per_round=(0, 5.0))
            return make

        sched.submit(JobSpec(name="a", rounds=2), factory("a"))
        sched.submit(JobSpec(name="b", rounds=2), factory("b"))
        sched.run()
        assert all(r < RID_STRIDE for r in rids["a"])
        assert all(RID_STRIDE <= r < 2 * RID_STRIDE for r in rids["b"])

    def test_shared_ledger_sees_both_jobs(self):
        base = _bare_env(capacity=10)
        sched = JobScheduler(_sim(), base_env=base)
        for name in ("a", "b"):
            sched.submit(
                JobSpec(name=name, rounds=1),
                lambda env, n=name: FakeRunner(
                    env, n, [10.0], book_interval=(0, 50.0, 60.0)
                ),
            )
        sched.run()
        assert base.ledger.occupancy(0, 55.0) == 2


class TestAdmission:
    def _sched(self):
        return JobScheduler(_sim(), base_env=_bare_env(link=LinkConfig()))

    def test_demand_projection(self):
        link = LinkConfig()
        rb_rate = link.data_rate_bps / link.num_resource_blocks
        spec = JobSpec(name="j", rounds=3, uploads_per_round=5,
                       payload_bits=rb_rate * 40.0)
        assert projected_demand_rb_s(spec, link) == pytest.approx(
            3 * 5 * 40.0
        )

    def test_no_deadline_always_admitted(self):
        sched = self._sched()
        assert sched.admission_verdict(
            JobSpec(name="j", rounds=1), 0.0
        ) == RUNNING

    def test_past_deadline_rejected(self):
        sched = self._sched()
        spec = JobSpec(name="j", rounds=1, deadline_s=50.0,
                       payload_bits=1e6)
        assert sched.admission_verdict(spec, 100.0) == REJECTED

    def test_infeasible_demand_rejected_even_on_empty_ledger(self):
        sched = self._sched()
        link = sched.base_env.link
        rb_rate = link.data_rate_bps / link.num_resource_blocks
        # needs 2000 RB-seconds before t=1000 on a 1-RB station
        spec = JobSpec(name="j", rounds=1, deadline_s=1000.0,
                       payload_bits=rb_rate * 2000.0)
        assert sched.admission_verdict(spec, 0.0) == REJECTED

    def test_booked_residual_queues(self):
        sched = self._sched()
        link = sched.base_env.link
        rb_rate = link.data_rate_bps / link.num_resource_blocks
        spec = JobSpec(name="j", rounds=1, deadline_s=1000.0,
                       payload_bits=rb_rate * 600.0)
        assert sched.admission_verdict(spec, 0.0) == RUNNING
        sched.ledger.reserve(0, 0.0, 900.0)     # residual: 100 < 600
        assert sched.admission_verdict(spec, 0.0) == QUEUED

    def test_queued_job_admitted_when_capacity_releases(self):
        sched = self._sched()
        link = sched.base_env.link
        rb_rate = link.data_rate_bps / link.num_resource_blocks
        # job a books [2000, 3500) and releases it on finish (t=100)
        sched.submit(
            JobSpec(name="a", rounds=1),
            lambda env: FakeRunner(env, "a", [100.0],
                                   book_interval=(0, 2000.0, 3500.0),
                                   release_on_finish=True),
        )
        # job b arrives mid-flight needing 2500 RB-s by t=3000: empty
        # supply (2950) is enough, the residual under a's booking
        # (1950) is not -> queued, then admitted at a's finish
        sched.submit(
            JobSpec(name="b", arrival_s=50.0, rounds=1, deadline_s=3000.0,
                    payload_bits=rb_rate * 2500.0),
            lambda env: FakeRunner(env, "b", [10.0]),
        )
        recs = {r.name: r for r in sched.run()}
        assert recs["a"].status == "finished"
        assert recs["b"].status == "finished"
        assert recs["b"].admitted_at_s == pytest.approx(100.0)

    def test_starved_queue_rejected(self):
        sched = self._sched()
        link = sched.base_env.link
        rb_rate = link.data_rate_bps / link.num_resource_blocks
        sched.ledger.reserve(0, 0.0, 900.0)
        sched.submit(
            JobSpec(name="j", rounds=1, deadline_s=1000.0,
                    payload_bits=rb_rate * 600.0),
            lambda env: FakeRunner(env, "j", [10.0]),
        )
        rec = sched.run()[0]
        assert rec.status == REJECTED

    def test_duplicate_job_name_rejected_at_submit(self):
        sched = self._sched()
        sched.submit(JobSpec(name="j", rounds=1),
                     lambda env: FakeRunner(env, "j", [1.0]))
        with pytest.raises(ValueError, match="duplicate job name"):
            sched.submit(JobSpec(name="j", rounds=1),
                         lambda env: FakeRunner(env, "j", [1.0]))


# ---------------------------------------------------------------------------
# repack policy: monotone result is the per-entry floor
# ---------------------------------------------------------------------------

def test_readmit_unknown_policy_raises():
    env = _bare_env()
    with pytest.raises(ValueError, match="policy"):
        env.readmit([], 0.0, policy="bogus")


@pytest.fixture(scope="module")
def contended_async_base():
    from repro_torch.core.engine import SimConfig

    sim = SimConfig(gs_rb_capacity=1, sanitize=False)
    return sim, CommsEnvironment.from_sim(sim)


def _async_scenario(base_env, payload_bits=2e8):
    """price_async_round's release scenario on a fresh session: four
    planes book uploads at schedule time, the earliest-starting one
    aborts and releases."""
    from repro_torch.orbits.constellation import Satellite

    env = base_env.derive()
    pending = []
    for plane in range(4):
        sat = Satellite(plane, 0)
        dec = env.plan_upload(sat, 0.0, payload_bits)
        assert dec is not None
        res = env.commit(dec)
        pending.append(
            PendingUpload(plane, sat, 0.0, payload_bits, dec, res)
        )
    victim = min(
        range(len(pending)),
        key=lambda i: (pending[i].decision.t_start, i),
    )
    env.release(pending[victim].reservation)
    return env, [p for i, p in enumerate(pending) if i != victim]


def test_repack_never_regresses_monotone(contended_async_base):
    _, base_env = contended_async_base
    env_m, pend_m = _async_scenario(base_env)
    env_r, pend_r = _async_scenario(base_env)
    mono, _ = env_m.readmit(pend_m, 0.0, policy="monotone")
    rep, _ = env_r.readmit(pend_r, 0.0, policy="repack")
    t_mono = {p.key: p.decision.t_done for p in mono}
    t_rep = {p.key: p.decision.t_done for p in rep}
    assert set(t_mono) == set(t_rep)
    for key, floor in t_mono.items():
        assert t_rep[key] <= floor + 1e-6, (
            f"plane {key}: repack {t_rep[key]} regressed past its "
            f"monotone floor {floor}"
        )


def test_repack_single_entry_matches_monotone(contended_async_base):
    """Degenerate case: with one queued upload there is nothing to
    swap — repack must equal monotone exactly."""
    from repro_torch.orbits.constellation import Satellite

    _, base_env = contended_async_base
    outs = []
    for policy in ("monotone", "repack"):
        env = base_env.derive()
        sat = Satellite(0, 0)
        blocker = env.commit(env.plan_upload(sat, 0.0, 2e8))
        dec = env.plan_upload(Satellite(1, 0), 0.0, 2e8)
        res = env.commit(dec)
        env.release(blocker)
        pend, _ = env.readmit(
            [PendingUpload(1, Satellite(1, 0), 0.0, 2e8, dec, res)],
            0.0, policy=policy,
        )
        outs.append(pend[0].decision.t_done)
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# lazy routing resolution + planner equivalence
# ---------------------------------------------------------------------------

def test_resolve_lazy_routing_explicit_wins_and_auto_scales():
    from repro_torch.comms.routing import (
        LAZY_AUTO_NODE_THRESHOLD,
        resolve_lazy_routing,
    )
    from repro_torch.orbits import ConstellationConfig

    small = ConstellationConfig()                       # 5x8 = 40
    big = ConstellationConfig(num_planes=64, sats_per_plane=16)
    assert big.num_satellites >= LAZY_AUTO_NODE_THRESHOLD
    assert resolve_lazy_routing(small) is False
    assert resolve_lazy_routing(big) is True
    assert resolve_lazy_routing(big, lazy=False) is False
    assert resolve_lazy_routing(small, lazy=True) is True


def test_planner_schedule_equivalent_eager_vs_lazy():
    """The wiring assert: a FedLEOGrid cluster plan priced
    through a lazy routing table is identical to the eager one."""
    import dataclasses

    from repro_torch.comms.routing import ISLPlan, get_routing_table
    from repro_torch.core.engine import SimConfig
    from repro_torch.core.fedleo import plan_cluster_round

    sim = SimConfig()
    # grid topology: a multi-plane cluster needs inter-plane ISLs
    sim = dataclasses.replace(
        sim, topology=dataclasses.replace(sim.topology, kind="grid")
    )
    env = CommsEnvironment.from_sim(sim)
    payload = 1e8
    plan = ISLPlan(intra=sim.isl, inter=sim.isl_inter)
    plans = {}
    for lazy in (False, True):
        routing = get_routing_table(
            sim.constellation, sim.topology, plan, payload, lazy=lazy
        )
        assert routing.lazy is lazy
        train = np.full(2 * sim.constellation.sats_per_plane, 600.0)
        plans[lazy] = plan_cluster_round(
            env=env, routing=routing, planes=(0, 1), t=0.0,
            payload_bits=payload, train_times=train,
        )
    a, b = plans[False].decision, plans[True].decision
    assert a.t_upload_done == b.t_upload_done
    assert a.t_upload_start == b.t_upload_start


# ---------------------------------------------------------------------------
# engine falsy-zero regressions + real single-job transparency
# ---------------------------------------------------------------------------

def _tiny_task(**overrides):
    from repro_torch.core import FederatedTask, TrainHyperparams
    from repro_torch.data import (
        make_classification_dataset,
        partition_noniid_by_orbit,
    )
    from repro_torch.models.cnn import apply_cnn, init_cnn
    from repro_torch.optim import get_optimizer

    ds = make_classification_dataset("mnist-like", num_samples=200, seed=0)
    test = make_classification_dataset("mnist-like", num_samples=80,
                                       seed=99)
    clients = partition_noniid_by_orbit(ds, 5, 8)
    hp = TrainHyperparams(local_epochs=20, learning_rate=0.05,
                          batch_size=16)
    return FederatedTask(
        init_fn=lambda r: init_cnn(r, (28, 28, 1), 10, widths=(8,),
                                   hidden=16),
        apply_fn=apply_cnn,
        clients=clients,
        test_set=test,
        optimizer=get_optimizer("sgd", 0.05),
        hp=hp,
        sim_epochs=2,
        device="cpu",
        **overrides,
    )


def test_max_sim_hours_zero_runs_no_rounds():
    """Regression: ``max_sim_hours or horizon`` silently replaced an
    explicit 0 with the full horizon."""
    from repro_torch.core.baselines import FedAvgStar
    from repro_torch.core.engine import SimConfig

    res = FedAvgStar(_tiny_task(), SimConfig()).run(
        max_rounds=3, max_sim_hours=0.0
    )
    assert res.history == []


def test_payload_override_zero_respected():
    """Regression: ``payload_bits_override or computed`` dropped an
    explicit 0-bit override."""
    assert _tiny_task(payload_bits_override=0).payload_bits == 0


def test_single_job_scheduler_bit_identical_to_standalone():
    """The acceptance check: one job through the JobScheduler is the
    standalone ``FLStrategy.run``, bit for bit."""
    from repro_torch.core.baselines import FedAvgStar
    from repro_torch.core.engine import SimConfig

    sim = SimConfig()
    result = FedAvgStar(_tiny_task(), sim).run(max_rounds=2)

    sched = JobScheduler(sim)
    runners = []

    def factory(env):
        s = FedAvgStar(_tiny_task(), sim, env)
        runners.append(s)
        return s

    sched.submit(JobSpec(name="solo", rounds=2), factory)
    rec = sched.run()[0]
    assert rec.status == "finished"
    assert len(result.history) == len(runners[0].history) == 2
    for a, b in zip(result.history, runners[0].history):
        assert a.t_hours == b.t_hours
        assert a.round_index == b.round_index
        assert a.metrics == b.metrics


# ---------------------------------------------------------------------------
# two concurrent jobs: the port's scheduler against the reference's
# ---------------------------------------------------------------------------

def _two_job_run(pkg):
    """FedLEO and FedAvgStar over one shared ledger through ``pkg``'s
    JobScheduler; tiny-CNN tasks whose clients fit one batch, so local
    training does not depend on the framework's sample order.  The
    port's task starts from the reference's initial parameters."""
    import jax

    import repro.core as J
    import repro_torch.core as T
    from repro import data as jdata
    from repro.core.baselines import FedAvgStar as JFedAvgStar
    from repro.models.cnn import apply_cnn as japply_cnn
    from repro.models.cnn import init_cnn as jinit_cnn
    from repro.multitenant import JobScheduler as JJobScheduler
    from repro.multitenant import JobSpec as JJobSpec
    from repro.optim import get_optimizer as jget_optimizer
    from repro_torch import data as tdata
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.baselines import FedAvgStar as TFedAvgStar
    from repro_torch.models.cnn import apply_cnn as tapply_cnn
    from repro_torch.optim import get_optimizer as tget_optimizer

    hp = dict(local_epochs=100, learning_rate=0.05, batch_size=32)
    init = jax.tree_util.tree_map(np.asarray, jinit_cnn(
        jax.random.PRNGKey(0), (28, 28, 1), 10, widths=(4,), hidden=8))
    if pkg == "reference":
        core, data, strategies = J, jdata, (J.FedLEO, JFedAvgStar)
        sched_cls, spec_cls = JJobScheduler, JJobSpec
        task_kw = dict(init_fn=lambda r: jax.tree_util.tree_map(jax.numpy.asarray, init),
                       apply_fn=japply_cnn, optimizer=jget_optimizer("sgd", 0.05))
    else:
        core, data, strategies = T, tdata, (T.FedLEO, TFedAvgStar)
        sched_cls, spec_cls = JobScheduler, JobSpec
        task_kw = dict(init_fn=lambda r: params_from_numpy(init, "cpu"),
                       apply_fn=tapply_cnn, optimizer=tget_optimizer("sgd", 0.05),
                       device="cpu")
    ds = data.make_classification_dataset("mnist-like", num_samples=800, seed=0)
    test = data.make_classification_dataset("mnist-like", num_samples=200, seed=99)
    clients = data.partition_noniid_by_orbit(ds, 5, 8)
    sim = core.SimConfig(horizon_hours=72.0, use_kernel=True, gs_rb_capacity=2)
    sched = sched_cls(sim, sanitize=True)
    runners = {}
    for name, cls in zip(("fedleo", "fedavg"), strategies):
        def factory(env, cls=cls, name=name):
            task = core.FederatedTask(clients=clients, test_set=test,
                                      hp=core.TrainHyperparams(**hp), sim_epochs=2,
                                      **task_kw)
            runners[name] = cls(task, sim, env)
            return runners[name]
        sched.submit(spec_cls(name=name, rounds=2), factory)
    return sched.run(), runners


@pytest.fixture(scope="module")
def two_job_runs():
    return _two_job_run("reference"), _two_job_run("port")


def test_two_job_records_equal_reference(two_job_runs):
    import dataclasses

    (jrecs, _), (trecs, _) = two_job_runs
    assert [r.status for r in trecs] == ["finished", "finished"]
    assert [dataclasses.asdict(r) for r in trecs] == [dataclasses.asdict(r) for r in jrecs]


def test_two_job_histories_match_reference(two_job_runs):
    (_, jrun), (_, trun) = two_job_runs
    for name in ("fedleo", "fedavg"):
        jh, th = jrun[name].history, trun[name].history
        assert len(th) == len(jh) == 2
        assert [h.t_hours for h in th] == [h.t_hours for h in jh]
        assert [h.events for h in th] == [h.events for h in jh]
        for a, b in zip(th, jh):
            assert abs(a.metrics["accuracy"] - b.metrics["accuracy"]) <= 2 / 200 + 1e-6
            assert a.metrics["loss"] == pytest.approx(b.metrics["loss"], abs=1e-4)
        assert trun[name].env.sanitizer.report() == []
