"""Event-driven Satcom FL engine: shared substrate for FedLEO + baselines.

The engine separates:
  * the *simulated clock* — visibility windows, link latencies (eqs.
    5-8, 13-16, 20-21), training durations (eq. 11) — advanced by each
    strategy's scheduling logic, and
  * the *learning* — real PyTorch training/aggregation via FederatedTask.

Each strategy implements ``step(t) -> (t_next, events)`` which performs
one logical round (sync) or one server event (async) starting at
simulated time t, mutating ``self.global_params``.  ``run`` iterates
until the simulated-hours budget is exhausted, evaluating the global
model after every step to produce the accuracy-vs-time history that the
paper's Table II and Fig. 5 report.

The counterpart of ``src/repro/core/engine.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.comms.environment import CommsEnvironment
from repro_torch.comms.isl import ISLConfig
from repro_torch.comms.link import LinkConfig
from repro_torch.compute.fleet import FleetComputeModel
from repro_torch.compute.profiles import SatelliteComputeProfile
from repro_torch.core.fltask import FederatedTask
from repro_torch.obs import (
    NULL_RECORDER,
    GroupDecomposition,
    RoundDecomposition,
    TraceRecorder,
    format_round_line,
    round_log_record,
)
from repro_torch.orbits.constellation import (
    ConstellationConfig,
    GroundStation,
    MultiShellConfig,
)
from repro_torch.orbits.topology import TopologyConfig

PyTree = Any


@dataclasses.dataclass
class SimConfig:
    constellation: "ConstellationConfig | MultiShellConfig" = (
        dataclasses.field(default_factory=ConstellationConfig)
    )
    ground_station: GroundStation = dataclasses.field(
        default_factory=GroundStation
    )
    # Multi-GS scenarios: when non-empty this is the FULL station list
    # (``ground_station`` is ignored) and scheduling uses the union of
    # every station's visibility windows.
    ground_stations: Tuple[GroundStation, ...] = ()
    link: LinkConfig = dataclasses.field(default_factory=LinkConfig)
    isl: ISLConfig = dataclasses.field(default_factory=ISLConfig)
    # ISL graph shape (ring = the paper's intra-plane-only topology) and
    # the optional inter-plane (FSO cross-link) provisioning; intra-
    # plane links keep using ``isl``.  None falls back to ``isl``.
    topology: TopologyConfig = dataclasses.field(
        default_factory=TopologyConfig
    )
    isl_inter: Optional[ISLConfig] = None
    horizon_hours: float = 72.0           # paper simulates 3 days
    coarse_step_s: float = 10.0
    # Peak-transient budget for the vectorized visibility scan: chunk
    # lengths adapt to (num satellites, horizon) to stay under this
    # many MB of concurrent scan arrays (results are bit-identical
    # across budgets — chunking only partitions evaluation).
    mem_budget_mb: float = 256.0
    # Per-station downlink resource-block cap (eq. 13-16: N RBs of B_D
    # each).  None = contention-free (the pre-ledger degenerate case:
    # concurrent sink uploads never compete); an int enables the shared
    # GSResourceLedger so uploads are priced against residual capacity.
    gs_rb_capacity: Optional[int] = None
    # Mid-window station handover: allow a sink upload to split into
    # segments across *different* stations' access windows
    # (plan_segmented_transfer) instead of pinning the whole transfer
    # to one station.  A segmented plan is adopted only when it
    # strictly beats the single-window completion, so False — and any
    # single-station ground segment — is bit-identical to the
    # unsegmented scheduler.
    gs_handover: bool = False
    # Rolling-horizon visibility prediction: chunk length in hours, or
    # None for the legacy prebuilt table over 1.5x horizon_hours.  The
    # rolling table grows on demand (capped at 1.5x horizon_hours) and
    # is bit-identical to the prebuilt one on overlapping ranges.
    rolling_horizon_hours: Optional[float] = None
    # Event-driven async re-admission: the asynchronous strategies
    # (_AsyncStar family, AsyncFLEO) book every upload at schedule
    # time; with this on they register an on_release hook with their
    # CommsEnvironment and re-admit queued uploads in model-ready
    # order whenever a reservation RELEASES capacity
    # (CommsEnvironment.readmit).  Releases come from env.release —
    # an aborted/cancelled cycle, or any other component sharing the
    # session; the stock strategies never abort a booked upload on
    # their own, so until such an event fires the stream is identical
    # to the book-at-schedule-time default.  False (default) does not
    # arm the hook at all; meaningful only under RB contention.
    async_readmit: bool = False
    # Re-admission repair policy (CommsEnvironment.readmit): "monotone"
    # is the per-entry repair (the default; bit-identical to PR 5),
    # "repack" layers the regret-based swap-accepting global re-packer
    # on top — no queued completion may regress vs. the monotone floor.
    readmit_policy: str = "monotone"
    noniid_alpha: float = 0.5             # non-IID-aware weighting blend
    use_kernel: bool = False              # CUDA aggregation kernel path
    # Runtime schedule sanitizer (repro_torch.analysis.sanitizer): every
    # commit/release/readmit on the strategy's CommsEnvironment is
    # checked against the paper's feasibility invariants (eqs. 13-16
    # RB capacity, eq. 15 window containment, eqs. 21-22 re-admission
    # monotonicity) and a reservation-leak report runs at sim end.
    # On by default — tests and --quick benchmark smokes run sanitized;
    # timed benchmark arms turn it off.
    sanitize: bool = True
    # Observability (repro_torch.obs): attach a TraceRecorder to the
    # strategy's CommsEnvironment — every plan/commit/release/readmit,
    # rolling-horizon extension and FL round lands in a typed,
    # sim-timestamped trace (export via repro_torch.obs.export, report
    # via ``python -m repro_torch.obs.report``).  Tracing is zero-interference:
    # a traced run is bit-identical to an untraced one (schedules,
    # sink decisions, metrics) — equivalence-tested.  Off by default.
    trace: bool = False
    # Heterogeneous fleet compute model (repro_torch.compute): assigns each
    # plane/satellite a device tier + model arch whose roofline step
    # time replaces eq. (11)'s uniform c_k/f_k, and (opt-in) whose real
    # param count replaces the task's uniform payload.  None (default)
    # keeps the paper's uniform fleet — bit-identical schedules, sink
    # decisions and metrics (equivalence-tested); so does a profile
    # whose every assignment is the degenerate ``arch=None`` tier.
    compute: Optional[SatelliteComputeProfile] = None
    seed: int = 0

    @property
    def all_ground_stations(self) -> Tuple[GroundStation, ...]:
        return tuple(self.ground_stations) or (self.ground_station,)


@dataclasses.dataclass
class HistoryPoint:
    t_hours: float
    round_index: int
    metrics: Dict[str, float]
    events: Dict[str, Any]
    # typed per-round phase decomposition (repro.obs) — the structured
    # replacement for scraping the ``events`` dicts; always populated
    # by ``FLStrategy.run`` (groups are empty for strategies without a
    # group planner)
    decomposition: Optional[RoundDecomposition] = None


@dataclasses.dataclass
class RunResult:
    name: str
    history: List[HistoryPoint]

    @property
    def final_accuracy(self) -> float:
        return self.history[-1].metrics["accuracy"] if self.history else 0.0

    @property
    def final_time_hours(self) -> float:
        return self.history[-1].t_hours if self.history else 0.0

    def convergence_time_hours(self, target_accuracy: float) -> Optional[float]:
        for h in self.history:
            if h.metrics["accuracy"] >= target_accuracy:
                return h.t_hours
        return None

    def summary(self) -> Dict[str, float]:
        return {
            "final_accuracy": self.final_accuracy,
            "final_time_hours": self.final_time_hours,
            "rounds": len(self.history),
        }


class FLStrategy:
    """Base class; subclasses implement one scheduling discipline each."""

    name = "base"

    def __init__(
        self,
        task: FederatedTask,
        sim: SimConfig,
        env: Optional[CommsEnvironment] = None,
    ):
        self.task = task
        self.sim = sim
        # ONE scheduling session per strategy: the environment owns the
        # predictor, the shared RB ledger and the handover policy, and
        # every planning/booking call routes through it.  The
        # multi-tenant JobScheduler injects a per-job session derived
        # over a SHARED ledger; standalone strategies build their own.
        self.env = CommsEnvironment.from_sim(sim) if env is None else env
        self.walker = self.env.walker
        self.gs_list = list(self.env.ground_stations)
        self.gs = self.gs_list[0]
        self.global_params = task.global_params
        self.rng = torch.Generator().manual_seed(sim.seed)
        self.round_index = 0
        # the session's trace recorder (attached by from_sim when
        # SimConfig.trace), or the no-op NULL_RECORDER — engine-level
        # call sites never branch
        self.recorder: TraceRecorder = (
            self.env.recorder if self.env.recorder is not None
            else NULL_RECORDER
        )
        # per-round group decompositions, stashed by the round drivers
        # (_SyncRoundMixin) and drained into each HistoryPoint
        self._round_groups: List[GroupDecomposition] = []
        # accumulated accuracy-vs-time history (one point per round);
        # ``run`` drives it for standalone strategies, the multi-tenant
        # JobScheduler through ``run_round`` directly
        self.history: List[HistoryPoint] = []
        self._completed = True
        # heterogeneous fleet compute model: resolved strategy-side
        # from SimConfig.compute (falling back to any model already on
        # the task) WITHOUT mutating the shared task, so one task can
        # serve arms with different fleets.  None = uniform paper fleet.
        if sim.compute is not None:
            num_planes = getattr(sim.constellation, "num_planes", 0)
            self.compute: Optional[FleetComputeModel] = FleetComputeModel(
                sim.compute, num_planes
            )
        else:
            self.compute = task.compute
        # multi-tenant release floor: with a SHARED ledger, dropping
        # bookings up to this strategy's own clock could purge
        # intervals a slower concurrent job still prices against — the
        # JobScheduler installs min-over-active-job-clocks here.  None
        # (standalone) releases up to the strategy's own clock, the
        # bit-identical single-tenant behavior.
        self.release_floor_fn: Optional[Any] = None

    @property
    def predictor(self) -> Any:
        """The session's visibility predictor (back-compat alias)."""
        return self.env.predictor

    @property
    def ledger(self) -> Any:
        """The session's RB ledger, or None (back-compat alias)."""
        return self.env.ledger

    # -- helpers ---------------------------------------------------------------
    def _next_rng(self) -> torch.Generator:
        """A fresh CPU generator seeded from the strategy's stream."""
        seed = int(torch.randint(0, 2**62, (), generator=self.rng))
        return torch.Generator().manual_seed(seed)

    @property
    def payload_bits(self) -> float:
        return float(self.task.payload_bits)

    def train_time_s(self, client_id: int) -> float:
        """Eq. (11) training time of one client, heterogeneous-fleet
        aware: with a compute model resolved, the client satellite's
        roofline per-sample cost prices the batches the task actually
        executes; otherwise (or for degenerate-tier satellites) this is
        exactly ``task.train_time_s``."""
        if self.compute is not None:
            c = self.task.clients[client_id]
            hp = self.task.hp
            n_batches, bsz = self.task.executed_batches(client_id)
            t = self.compute.train_time_s(
                c.plane, c.slot, local_epochs=hp.local_epochs,
                n_batches=n_batches, batch_size=bsz,
            )
            if t is not None:
                return t
        return self.task.train_time_s(client_id)

    def sat_payload_bits(self, plane: int, slot: int = 0) -> float:
        """Comm payload z|N| of satellite (plane, slot): the task's
        uniform payload unless the compute profile opts into
        arch-derived sizes (``payload_from_arch``)."""
        if self.compute is not None and self.compute.payload_aware:
            bits = self.compute.payload_bits(plane, slot)
            if bits is not None:
                return float(bits)
        return float(self.task.payload_bits)

    def group_payload_bits(self, planes: Sequence[int]) -> float:
        """Conservative payload for a multi-plane group transfer: the
        max over member planes' slot-0 payloads (intra-plane
        propagation ships one aggregated model per plane, so the widest
        member bounds every hop).  Equals ``payload_bits`` for
        payload-unaware fleets."""
        if self.compute is None or not self.compute.payload_aware:
            return self.payload_bits
        return max(self.sat_payload_bits(p) for p in planes)

    def plane_clients(self, plane: int) -> List[int]:
        return self.task.clients_on_plane(plane)

    def open_reservations(self) -> FrozenSet[int]:
        """Reservation ids this strategy still legitimately holds at
        sim end — exempted from the sanitizer's leak report.  The async
        strategies override the ``_pending`` queue this reads: a queued
        upload booked beyond the horizon is live state, not a leak."""
        pending = getattr(self, "_pending", None) or {}
        return frozenset(
            p.reservation.rid for p in pending.values()
        )

    def _take_round_groups(self) -> Tuple[GroupDecomposition, ...]:
        """Drain the group decompositions the last ``step`` stashed
        (empty for strategies without a group planner)."""
        groups = tuple(self._round_groups)
        self._round_groups = []
        return groups

    # -- strategy API -----------------------------------------------------------
    def step(self, t: float) -> Tuple[float, Dict[str, Any]]:
        raise NotImplementedError

    def run_round(self, t: float, verbose: bool = False) -> Optional[float]:
        """Advance the strategy by ONE FL round starting at simulated
        time ``t``: expire spent bookings, run ``step``, evaluate the
        global model and append the ``HistoryPoint``.  Returns the
        round completion time (the next round's start), or None when no
        feasible progress exists inside the horizon — the aborted step
        may leave half-planned bookings, so the final leak report is
        skipped.  ``run`` drives this for standalone strategies; the
        multi-tenant ``JobScheduler`` calls it directly to interleave
        rounds of concurrent jobs (a single job through the scheduler
        executes the identical call sequence — bit-identical)."""
        # simulated time is monotone: bookings that ended before this
        # round can never affect another fit (under a shared ledger the
        # floor callback holds back expiry for slower concurrent jobs)
        floor = t if self.release_floor_fn is None else self.release_floor_fn(t)
        self.env.release_before(floor)
        t_next, events = self.step(t)
        if t_next is None or t_next <= t:
            self._completed = False
            return None
        self.round_index += 1
        metrics = self.task.evaluate(self.global_params)
        decomposition = RoundDecomposition(
            round_index=self.round_index,
            t_start=t,
            t_end=t_next,
            groups=self._take_round_groups(),
        )
        self.history.append(
            HistoryPoint(
                t_hours=t_next / 3600.0,
                round_index=self.round_index,
                metrics=metrics,
                events=events,
                decomposition=decomposition,
            )
        )
        self.recorder.on_round(decomposition, metrics)
        if verbose:
            record = round_log_record(
                self.name, self.round_index, t_next / 3600.0, metrics
            )
            self.recorder.on_round_log(record)
            print(format_round_line(record))
        return t_next

    def finish(self, t: float) -> None:
        """Close the session at simulated time ``t`` (sanitizer leak
        report, unless a round aborted mid-plan)."""
        self.env.finish_session(
            t, open_rids=self.open_reservations(),
            check_leaks=self._completed,
        )

    def run(
        self,
        max_sim_hours: Optional[float] = None,
        max_rounds: Optional[int] = None,
        verbose: bool = False,
    ) -> RunResult:
        # `is None`, not `or`: max_sim_hours=0 means a zero-length run,
        # not the full horizon
        hours = self.sim.horizon_hours if max_sim_hours is None else max_sim_hours
        max_s = hours * 3600.0
        t = 0.0
        while t < max_s and (max_rounds is None or self.round_index < max_rounds):
            t_next = self.run_round(t, verbose=verbose)
            if t_next is None:
                break
            t = t_next
        self.finish(t)
        return RunResult(name=self.name, history=list(self.history))
