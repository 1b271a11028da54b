# Copied from src/repro/multitenant/scheduler.py; imports rebound to repro_torch.
"""Multi-tenant FL: N concurrent jobs scheduled over one constellation.

The ROADMAP's "millions of users" scenario: independent FL jobs
(different models, payload sizes, deadlines) share the same ground
segment — the per-station RB pools of eqs. 13-16 — instead of each
pretending the constellation is private.  FedSpace (So et al. 2022)
shows GS connectivity scheduling is exactly where naive multi-client
schedulers collapse; Razmi et al. (2109.01348) motivate the
admission/queueing semantics when jobs arrive over time.

``JobScheduler`` runs one ``CommsEnvironment`` session per job
(``derive`` over the base session), all backed by ONE shared
``GSResourceLedger``: every job's planner prices its uploads against
the residual capacity every other job's bookings leave behind, and
ledger booking ids keep identical intervals distinguishable across
sessions.  On top of the shared substrate the scheduler adds:

  admission   at arrival, a job's projected RB-seconds demand
              (``projected_demand_rb_s``: rounds x uploads/round x the
              eq. 16 per-RB service time z / (R / N)) is compared
              against the ledger's residual RB-seconds over
              [arrival, deadline] (``residual_fraction``): infeasible
              even on an EMPTY ledger -> rejected; feasible but not in
              the current residual -> queued (re-checked whenever a
              job finishes); otherwise admitted.
  tiers       jobs advance strictly by priority tier (lower first);
              within a tier, weighted max-min fairness over served
              RB-seconds — the next round always goes to the running
              job with the smallest served_rb_s / weight (ties: the
              earlier job clock, then submission order).  Service is
              metered through the session's ``on_commit``/
              ``on_release`` hooks (net booked RB-seconds), so
              re-admission churn cancels out.
  re-packing  ``SimConfig.readmit_policy="repack"`` upgrades every
              job's queued-upload repair from per-entry monotone to
              the regret-based swap re-packer
              (``CommsEnvironment.readmit``); the monotone result
              stays a per-entry floor either way.

Each job advances one FL round at a time (``FLStrategy.run_round`` —
any object satisfying ``RoundRunner`` works, e.g. the benchmark's
planner-level jobs).  Job clocks are independent; expiry of spent
bookings is held back to the slowest running job's clock
(``release_floor``) so one job's progress never purges intervals a
slower job still prices against the shared ledger.  With a single job
the floor is the job's own clock, admission is trivially satisfied and
the scheduler executes exactly the call sequence of
``FLStrategy.run`` — bit-identical to the standalone run
(equivalence-tested; the repo's degenerate-case discipline).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Protocol, Tuple

import numpy as np

from repro_torch.comms.environment import CommsEnvironment
from repro_torch.comms.link import LinkConfig
from repro_torch.core.engine import SimConfig

# job lifecycle states
QUEUED = "queued"
RUNNING = "running"
FINISHED = "finished"
STALLED = "stalled"          # a round found no feasible window
REJECTED = "rejected"

# rid namespace stride between job sessions: reservation ids stay
# globally unique across concurrent sessions, so merged traces and
# cross-session tooling never conflate two jobs' bookings
RID_STRIDE = 1_000_000


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One tenant's FL job, as the admission controller sees it."""

    name: str
    arrival_s: float = 0.0              # job submission (absolute sim s)
    deadline_s: Optional[float] = None  # absolute completion deadline
    rounds: Optional[int] = None        # FL rounds to run (None = horizon)
    tier: int = 0                       # priority tier (lower runs first)
    weight: float = 1.0                 # max-min fairness weight in tier
    payload_bits: Optional[float] = None    # per-upload model size z
    uploads_per_round: int = 1          # projected RB bookings per round

    def __post_init__(self) -> None:
        if self.weight <= 0:
            raise ValueError(f"job {self.name!r}: weight must be > 0")
        if self.uploads_per_round < 1:
            raise ValueError(
                f"job {self.name!r}: uploads_per_round must be >= 1"
            )


class RoundRunner(Protocol):
    """What the scheduler drives: one FL round per call.  ``FLStrategy``
    satisfies this; the benchmarks use planner-level runners."""

    env: CommsEnvironment
    release_floor_fn: Optional[Callable[[float], float]]

    def run_round(self, t: float, verbose: bool = False) -> Optional[float]:
        ...

    def finish(self, t: float) -> None:
        ...


# builds the job's runner over its derived (shared-ledger) session
RunnerFactory = Callable[[CommsEnvironment], RoundRunner]


@dataclasses.dataclass
class JobRecord:
    """Outcome of one job through the scheduler."""

    name: str
    status: str
    tier: int
    weight: float
    arrival_s: float
    deadline_s: Optional[float]
    admitted_at_s: Optional[float] = None
    finished_at_s: Optional[float] = None
    rounds_done: int = 0
    # absolute completion time of every finished round, in order
    round_completions_s: List[float] = dataclasses.field(
        default_factory=list
    )
    served_rb_s: float = 0.0

    @property
    def deadline_met(self) -> Optional[bool]:
        if self.deadline_s is None or self.finished_at_s is None:
            return None
        return self.finished_at_s <= self.deadline_s

    def round_latencies_s(self) -> List[float]:
        """Per-round completion latency measured from job arrival —
        the benchmark's p95 metric."""
        return [t - self.arrival_s for t in self.round_completions_s]


@dataclasses.dataclass
class _Job:
    spec: JobSpec
    index: int
    factory: RunnerFactory
    record: JobRecord
    runner: Optional[RoundRunner] = None
    env: Optional[CommsEnvironment] = None
    t: float = 0.0                      # the job's own simulated clock


def registry_payload_bits(
    arch_id: str, *, bits_per_param: int = 32, smoke: bool = True
) -> float:
    """Per-upload payload size z (bits) for a tenant training one of
    the registry architectures — param count estimate x quantization.
    ``smoke=True`` (default) sizes the scaled-down smoke config, the
    realistic per-satellite shard for multi-tenant scenarios; the full
    configs are far beyond any single eq. 16 window."""
    from repro_torch.configs.registry import get_config, get_smoke_config

    cfg = get_smoke_config(arch_id) if smoke else get_config(arch_id)
    return float(cfg.param_count_estimate()) * bits_per_param


def projected_demand_rb_s(
    spec: JobSpec, link: Optional[LinkConfig]
) -> Optional[float]:
    """The admission controller's demand projection: RB-seconds this
    job will book if admitted — rounds x uploads/round x the nominal
    eq. 16 per-RB service time (payload z over the per-RB rate ceiling
    R / N; distance-dependent rate loss makes the true figure larger,
    so this projection is deliberately optimistic and admission errs
    toward queueing at the residual check, not here).  None when the
    spec carries no payload size (nothing to project)."""
    if spec.payload_bits is None or link is None:
        return None
    rounds = spec.rounds if spec.rounds is not None else 1
    rb_rate_bps = link.data_rate_bps / link.num_resource_blocks
    per_upload_s = float(spec.payload_bits) / rb_rate_bps
    return rounds * spec.uploads_per_round * per_upload_s


class JobScheduler:
    """N concurrent FL jobs over one constellation and one shared
    RB ledger.  ``submit`` every job, then ``run`` to completion.

    Args:
      sim: the shared scenario (constellation, stations, RB capacity,
        horizon).  ``sim.gs_rb_capacity`` sizes the SHARED ledger.
      base_env: optional pre-built base session (e.g. to share an
        expensive predictor across benchmark arms); defaults to
        ``CommsEnvironment.from_sim(sim)``.  Its ledger becomes the
        shared one.
      sanitize/trace: attach a per-job ``ScheduleSanitizer`` /
        ``TraceRecorder`` to every job session (violations and events
        carry the job label).
      admission_margin: admit only when projected demand fits within
        this fraction of the residual RB-seconds (1.0 = exact fit).
      fairness: within-tier round ordering — "maxmin" (weighted max-min
        over served RB-seconds, the default) or "edf" (earliest
        absolute deadline first; deadline-less jobs last in the tier).
    """

    def __init__(
        self,
        sim: SimConfig,
        *,
        base_env: Optional[CommsEnvironment] = None,
        sanitize: bool = False,
        trace: bool = False,
        admission_margin: float = 1.0,
        fairness: str = "maxmin",
    ) -> None:
        if fairness not in ("maxmin", "edf"):
            raise ValueError(
                f"unknown fairness {fairness!r}; have ('maxmin', 'edf')"
            )
        self.sim = sim
        self.base_env = (
            CommsEnvironment.from_sim(sim) if base_env is None else base_env
        )
        self.ledger = self.base_env.ledger
        self.sanitize = bool(sanitize)
        self.trace = bool(trace)
        self.admission_margin = float(admission_margin)
        self.fairness = fairness
        self._jobs: List[_Job] = []
        self._horizon_s = sim.horizon_hours * 3600.0

    # -- submission / admission ------------------------------------------------
    def submit(self, spec: JobSpec, factory: RunnerFactory) -> None:
        """Register one job; admission runs when ``run`` reaches its
        arrival time."""
        if any(j.spec.name == spec.name for j in self._jobs):
            raise ValueError(f"duplicate job name {spec.name!r}")
        record = JobRecord(
            name=spec.name, status=QUEUED, tier=spec.tier,
            weight=spec.weight, arrival_s=spec.arrival_s,
            deadline_s=spec.deadline_s,
        )
        self._jobs.append(_Job(spec, len(self._jobs), factory, record))

    def admission_verdict(self, spec: JobSpec, t_from: float) -> str:
        """Admission control at time ``t_from``: RUNNING (admit),
        QUEUED (feasible but the current residual can't hold it) or
        REJECTED (infeasible even on an empty ledger, or the deadline
        already passed).  Jobs without a deadline or payload projection
        are always admitted — nothing to gate on."""
        demand = projected_demand_rb_s(spec, self.base_env.link)
        if spec.deadline_s is None or demand is None:
            return RUNNING
        span = spec.deadline_s - t_from
        if span <= 0:
            return REJECTED
        if self.ledger is None:
            return RUNNING
        caps = self.ledger.capacity
        if any(not np.isfinite(c) for c in caps):
            return RUNNING                  # unlimited station capacity
        empty_supply = sum(caps) * span
        if demand > empty_supply:
            return REJECTED                 # can never fit by deadline
        frac = self.ledger.residual_fraction(t_from, spec.deadline_s)
        residual = float(sum(f * c for f, c in zip(frac, caps))) * span
        if demand <= self.admission_margin * residual:
            return RUNNING
        return QUEUED

    # -- shared-substrate plumbing ---------------------------------------------
    def _release_floor(self, t: float) -> float:
        """Expiry floor for ``release_before`` on the SHARED ledger:
        the slowest running job's clock.  One job's advance must never
        purge bookings a slower job still prices; with a single job
        this is the job's own clock — the standalone behavior."""
        clocks = [
            j.t for j in self._jobs if j.record.status == RUNNING
        ]
        return min([t] + clocks)

    def _meter(self, job: _Job) -> None:
        """Meter the job's net booked RB-seconds through its session
        hooks (commits add leg spans, releases subtract freed spans —
        re-admission's release/restore churn cancels out)."""
        assert job.env is not None

        def on_commit(reservation: Any) -> None:
            job.record.served_rb_s += sum(
                t1 - t0 for _, t0, t1 in reservation.legs
            )

        def on_release(_reservation: Any, freed: Any) -> None:
            job.record.served_rb_s -= sum(t1 - t0 for _, t0, t1 in freed)

        job.env.on_commit(on_commit)
        job.env.on_release(on_release)

    def _start(self, job: _Job, t0: float) -> None:
        env = self.base_env.derive(
            ledger=self.ledger, sanitize=self.sanitize, trace=self.trace,
            job=job.spec.name,
        )
        # disjoint reservation-id namespaces across sessions
        env.set_rid_base(job.index * RID_STRIDE)
        job.env = env
        self._meter(job)
        job.runner = job.factory(env)
        job.runner.release_floor_fn = self._release_floor
        job.t = t0
        job.record.status = RUNNING
        job.record.admitted_at_s = t0

    def _finish(self, job: _Job, status: str) -> None:
        assert job.runner is not None
        job.runner.finish(job.t)
        job.record.status = status
        job.record.finished_at_s = job.t

    # -- the multiplexing loop -------------------------------------------------
    def _eligible(self, job: _Job) -> bool:
        """May this running job start another round?  Mirrors the
        ``FLStrategy.run`` loop condition exactly (t < horizon, rounds
        below the cap) so a single job is bit-identical."""
        if job.t >= self._horizon_s:
            return False
        r = job.spec.rounds
        return r is None or job.record.rounds_done < r

    def _fairness_key(self, job: _Job) -> Tuple[int, float, float, int]:
        """Within-tier round-ordering key (min wins).  "maxmin":
        weighted max-min over served RB-seconds (the default).  "edf":
        earliest absolute deadline first — deadline-less jobs sort last
        within their tier (inf), falling back to the job clock.  Both
        keep the strict tier precedence and the (job clock, submission
        order) tie-break, so single-job runs are unaffected by the
        choice."""
        if self.fairness == "edf":
            d = job.spec.deadline_s
            urgency = float("inf") if d is None else float(d)
        else:
            urgency = job.record.served_rb_s / job.spec.weight
        return (job.spec.tier, urgency, job.t, job.index)

    def _recheck_queued(self, queued: List[_Job], running: List[_Job],
                        t_now: float) -> None:
        """Capacity changed (a job finished): re-run admission for the
        queue in submission order."""
        for job in list(queued):
            t0 = max(job.spec.arrival_s, t_now)
            verdict = self.admission_verdict(job.spec, t0)
            if verdict == RUNNING:
                queued.remove(job)
                self._start(job, t0)
                running.append(job)
            elif verdict == REJECTED:
                queued.remove(job)
                job.record.status = REJECTED

    def run(self) -> List[JobRecord]:
        """Drive every submitted job to completion (or rejection) and
        return the records in submission order."""
        pending = sorted(
            self._jobs, key=lambda j: (j.spec.arrival_s, j.index)
        )
        queued: List[_Job] = []
        running: List[_Job] = []
        while pending or queued or running:
            # process arrivals up to the causal frontier (the slowest
            # running clock; with nothing running, the next arrival)
            frontier = (
                min(j.t for j in running) if running
                else (pending[0].spec.arrival_s if pending else None)
            )
            while pending and (
                frontier is None or pending[0].spec.arrival_s <= frontier
            ):
                job = pending.pop(0)
                verdict = self.admission_verdict(
                    job.spec, job.spec.arrival_s
                )
                if verdict == RUNNING:
                    self._start(job, job.spec.arrival_s)
                    running.append(job)
                elif verdict == QUEUED:
                    queued.append(job)
                else:
                    job.record.status = REJECTED
                if not running:
                    frontier = (
                        pending[0].spec.arrival_s if pending else None
                    )
            if not running:
                if pending:
                    continue
                # nothing running and nothing arriving: no future
                # release events can admit the starved queue
                for job in queued:
                    job.record.status = REJECTED
                break
            # tiers, then weighted max-min fairness over RB-seconds
            job = min(running, key=self._fairness_key)
            if not self._eligible(job):
                running.remove(job)
                self._finish(job, FINISHED)
                self._recheck_queued(queued, running, job.t)
                continue
            assert job.runner is not None
            t_next = job.runner.run_round(job.t)
            if t_next is None:
                running.remove(job)
                self._finish(job, STALLED)
                self._recheck_queued(queued, running, job.t)
                continue
            job.record.rounds_done += 1
            job.record.round_completions_s.append(t_next)
            job.t = t_next
        return [j.record for j in self._jobs]
