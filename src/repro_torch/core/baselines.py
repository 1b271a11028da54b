# Copied from src/repro/core/baselines.py; imports rebound to repro_torch.
"""Baseline FL-Satcom strategies the paper benchmarks against (§II, §V).

Implemented on the same engine/simulator as FedLEO so the comparison is
apples-to-apples (identical constellation, link budget, datasets,
training):

  * FedAvgStar       — vanilla synchronous FedAvg [6]/[8]: star topology,
                       every satellite individually downloads/uploads.
  * FedSatSched      — [10]: star sync + visibility-aware scheduling
                       (train during invisible gaps, same-window upload).
  * FedISL           — [3]: ISL ring + naive sink (first visitor, ignores
                       window duration). ``ideal=True`` puts the GS at the
                       North Pole (regular visits), the paper's ideal setup.
  * FedHAP           — [2]: sync star against two always-high-visibility
                       HAP servers (extra hardware).
  * FedAsync         — [13]: asynchronous star with staleness-decayed
                       server mixing.
  * FedSat           — [9]: async with NP ground station (ideal setup),
                       periodic buffer aggregation.
  * FedSpace         — [7]: async buffered aggregation triggered at a
                       predicted buffer fill fraction, stale down-weights.
  * AsyncFLEO        — [4]: intra-plane propagation + naive sink (ignores
                       the sink's visible-period constraint) + async
                       staleness-weighted orbit-partial mixing.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import aggregation
from repro_torch.core.engine import FLStrategy, SimConfig
from repro_torch.core.fltask import FederatedTask
from repro_torch.core.propagation import broadcast_schedule, ring_hops_matrix
from repro_torch.comms.environment import CommsEnvironment, PendingUpload
from repro_torch.comms.isl import isl_hop_time
from repro_torch.configs.constellations import GROUND_STATION_PRESETS
from repro_torch.orbits.constellation import Satellite
from repro_torch.orbits.prediction import VisibilityPredictor
from repro_torch.orbits.visibility import VisibilityWindow


class _StarMixin:
    """Window-search helpers shared by star-topology strategies."""

    def _first_tx(
        self, sat: Satellite, t: float, payload_bits: float, downlink: bool,
        env: Optional[CommsEnvironment] = None,
        same_window: bool = True,
    ) -> Optional[float]:
        """Completion time of the earliest feasible transfer after t.

        A window is feasible if its remaining duration after
        max(t, start) covers the transfer time computed with the true
        slant range against the window's own station (multi-GS union
        predictors tag every window with its gs_index).
        ``same_window=False`` forces the transfer to start at a window
        *after* t (the naive FedAvg behaviour of eq. (10) case 2: wait
        for the next visit).

        Everything routes through the scheduling session: uploads
        (``downlink=True``) are priced against the session's resource
        ledger and the chosen transfer is committed on it — splitting
        into station-handover segments per the session's policy;
        downloads are full-band broadcasts of the shared global model
        (eq. 15) and never contend or segment.  ``env`` overrides the
        strategy session when a strategy pairs its own
        predictor/station sets (FedHAP's per-server sessions).
        """
        env = env if env is not None else self.env

        skip = None
        if not same_window:
            def skip(w: VisibilityWindow) -> bool:
                # skip the in-progress window
                return w.contains(t) and w.t_start < t

        if downlink:
            dec = env.plan_upload(sat, t, payload_bits, skip_window=skip)
            if dec is None:
                return None
            env.commit(dec)
            return dec.t_done
        dec = env.plan_download(sat, t, payload_bits, skip_window=skip)
        return None if dec is None else dec.t_done


# --- synchronous star baselines ----------------------------------------------------
class FedAvgStar(FLStrategy, _StarMixin):
    """Vanilla sync FedAvg over the star topology (eq. 10 timing)."""

    name = "FedAvg"
    same_window_upload = False  # naive: upload waits for the *next* visit

    def step(self, t: float) -> Tuple[Optional[float], Dict[str, Any]]:
        task, sim = self.task, self.sim
        done_times = []
        for cid, client in enumerate(task.clients):
            sat = Satellite(client.plane, client.slot)
            bits = self.sat_payload_bits(client.plane, client.slot)
            t_dl = self._first_tx(sat, t, bits, downlink=False)
            if t_dl is None:
                return None, {"failed_client": cid}
            t_tr = t_dl + self.train_time_s(cid)
            t_ul = self._first_tx(
                sat, t_tr, bits, downlink=True,
                same_window=self.same_window_upload,
            )
            if t_ul is None:
                return None, {"failed_client": cid}
            done_times.append(t_ul)

        stacked = task.local_train(
            self.global_params, range(len(task.clients)), self._next_rng()
        )
        counts = [task.num_samples(c) for c in range(len(task.clients))]
        self.global_params = aggregation.global_aggregate(
            stacked, counts, use_kernel=sim.use_kernel
        )
        t_end = max(done_times)
        return t_end, {"slowest_client_h": (t_end - t) / 3600.0}


class FedSatSched(FedAvgStar):
    """[10]: visibility-aware scheduling — a satellite may finish its
    upload inside the window it downloaded in (if long enough), and
    trains during the invisible interval otherwise."""

    name = "FedSatSched"
    same_window_upload = True


class FedHAP(FLStrategy, _StarMixin):
    """[2]: replaces the GS with two HAPs (20 km altitude, near-zero
    minimum elevation -> wide frequent windows). Extra hardware, better
    visibility; synchronous aggregation."""

    name = "FedHAP"

    def __init__(self, task: FederatedTask, sim: SimConfig,
                 env: Optional[CommsEnvironment] = None):
        super().__init__(task, sim, env)
        hap_a = dataclasses.replace(
            sim.ground_station, alt_m=20_000.0, min_elevation_deg=2.0,
            name="HAP-A",
        )
        hap_b = dataclasses.replace(
            sim.ground_station, lon_deg=sim.ground_station.lon_deg + 180.0,
            alt_m=20_000.0, min_elevation_deg=2.0, name="HAP-B",
        )
        horizon = sim.horizon_hours * 3600.0 * 1.5
        # one scheduling session per HAP server: the paper's extra-
        # dedicated-hardware baseline has private capacity (no ledger),
        # and the session constructor checks each server matches its
        # own predictor's ground segment
        self.servers = [
            CommsEnvironment(
                walker=self.walker,
                predictor=VisibilityPredictor(
                    self.walker, hap, horizon,
                    coarse_step_s=sim.coarse_step_s,
                ),
                link=sim.link, isl=sim.isl,
                handover=sim.gs_handover, gs=hap,
            )
            for hap in (hap_a, hap_b)
        ]

    def _best_tx(
        self, sat: Satellite, t: float, payload_bits: float, downlink: bool
    ) -> Optional[float]:
        outs = [
            self._first_tx(sat, t, payload_bits, downlink, env=env)
            for env in self.servers
        ]
        outs = [o for o in outs if o is not None]
        return min(outs) if outs else None

    def step(self, t: float) -> Tuple[Optional[float], Dict[str, Any]]:
        task, sim = self.task, self.sim
        done_times = []
        for cid, client in enumerate(task.clients):
            sat = Satellite(client.plane, client.slot)
            bits = self.sat_payload_bits(client.plane, client.slot)
            t_dl = self._best_tx(sat, t, bits, downlink=False)
            if t_dl is None:
                return None, {"failed_client": cid}
            t_tr = t_dl + self.train_time_s(cid)
            t_ul = self._best_tx(sat, t_tr, bits, downlink=True)
            if t_ul is None:
                return None, {"failed_client": cid}
            done_times.append(t_ul)
        stacked = task.local_train(
            self.global_params, range(len(task.clients)), self._next_rng()
        )
        counts = [task.num_samples(c) for c in range(len(task.clients))]
        self.global_params = aggregation.global_aggregate(
            stacked, counts, use_kernel=sim.use_kernel
        )
        return max(done_times), {}


# --- ISL ring baselines --------------------------------------------------------------
class FedISL(FLStrategy, _StarMixin):
    """[3]: intra-plane ISL relay with a *naive* sink (the next satellite
    to visit the server, ignoring window duration — uploads that do not
    fit retry at the sink's next window).  ``ideal=True`` moves the GS to
    the North Pole, the paper's ideal setup with regular visits."""

    name = "FedISL"
    ideal = False

    def __init__(self, task: FederatedTask, sim: SimConfig):
        if self.ideal:
            sim = dataclasses.replace(
                sim,
                ground_station=GROUND_STATION_PRESETS["north-pole"],
                ground_stations=(),
            )
        super().__init__(task, sim)

    def _upload_with_retries(self, sat: Satellite, t_ready: float,
                             payload_bits: float) -> Optional[float]:
        # windows too short (or with no free RB) are skipped: the naive
        # sink retries at its next window — exactly _first_tx's
        # earliest-feasible upload (ledger booking included)
        return self._first_tx(sat, t_ready, payload_bits, downlink=True)

    def step(self, t: float) -> Tuple[Optional[float], Dict[str, Any]]:
        task, sim = self.task, self.sim
        L, K = sim.constellation.num_planes, sim.constellation.sats_per_plane
        completions, partials, counts = [], [], []

        for plane in range(L):
            clients = self.plane_clients(plane)
            bits = self.group_payload_bits((plane,))
            t_hop = isl_hop_time(sim.isl, bits)
            dl = self.env.first_visible_download(plane, t, bits)
            if dl is None:
                return None, {"failed_plane": plane}
            src_slot, t_recv = dl
            events = broadcast_schedule(
                K, [src_slot], [t_recv], bits, sim.isl
            )
            t_done = [
                events[s].t_receive + self.train_time_s(clients[s])
                for s in range(K)
            ]
            # naive sink: earliest next visitor after completion (one
            # batched per-plane window sweep)
            t_ready0 = max(t_done)
            sink = self.env.naive_sink_slot(plane, t_ready0)
            if sink is None:
                return None, {"failed_plane": plane}
            t_ready = float(np.max(
                np.asarray(t_done) + ring_hops_matrix(K)[sink] * t_hop
            ))
            t_ul = self._upload_with_retries(
                Satellite(plane, sink), t_ready, bits
            )
            if t_ul is None:
                return None, {"failed_plane": plane}
            completions.append(t_ul)

            stacked = task.local_train(
                self.global_params, clients, self._next_rng()
            )
            c = [task.num_samples(cid) for cid in clients]
            partials.append(
                aggregation.partial_aggregate(stacked, c,
                                              use_kernel=sim.use_kernel)
            )
            counts.append(int(np.sum(c)))

        self.global_params = aggregation.global_aggregate(
            aggregation.stack_pytrees(partials), counts,
            use_kernel=sim.use_kernel,
        )
        return max(completions), {}


class FedISLIdeal(FedISL):
    name = "FedISL-ideal"
    ideal = True


# --- asynchronous baselines ------------------------------------------------------------
class _AsyncQueueMixin:
    """Book-at-schedule-time upload queue shared by the asynchronous
    strategies, with optional event-driven re-admission
    (``SimConfig.async_readmit``).

    Every async cycle plans download -> train -> upload at schedule
    time and *books* the upload on the session ledger — under scarce RB
    capacity an upload whose model is ready early can therefore queue
    behind bookings merely made earlier.  With re-admission on, the
    strategy registers an ``on_release`` hook with its
    ``CommsEnvironment``; whenever booked capacity is RELEASED
    (``env.release`` — an aborted cycle, or any other component
    sharing the session; the stock strategies never abort a booked
    upload themselves), the next server event re-admits the queued
    uploads in model-ready order (``CommsEnvironment.readmit``) and
    re-keys the event queue to the re-priced completions.  Until such
    an event fires — and always with ``async_readmit=False`` — the
    schedule is bit-identical to the book-at-schedule-time baseline.
    """

    def _init_async_queue(self) -> None:
        # (t_upload_done, key, t_model_version) priority queue
        self._queue: List[Tuple[float, Any, float]] = []
        self.readmit = bool(self.sim.async_readmit)
        self._pending: Dict[Any, PendingUpload] = {}
        self._versions: Dict[Any, float] = {}
        self._capacity_freed = False
        if self.readmit:
            self.env.on_release(self._note_release)

    def _note_release(self, _reservation: Any, _freed: Any) -> None:
        # the release hook: booked capacity freed somewhere — re-admit
        # the queued uploads at the next server event
        self._capacity_freed = True

    def _admit_upload(
        self, key: Any, sat: Satellite, t_ready: float, payload_bits: float,
        version: float,
    ) -> Optional[float]:
        """Plan + book one upload at schedule time; tracked as pending —
        for re-admission when it is on, and always as the strategy's
        declared open reservations (the sanitizer's leak report exempts
        a live async queue).  Identical plan/commit path either way, so
        the schedule does not depend on ``readmit``.  Returns the
        completion."""
        dec = self.env.plan_upload(sat, t_ready, payload_bits)
        if dec is None:
            return None
        res = self.env.commit(dec)
        self._pending[key] = PendingUpload(
            key, sat, t_ready, payload_bits, dec, res
        )
        self._versions[key] = version
        return dec.t_done

    def _pop_pending(self, key: Any) -> None:
        self._pending.pop(key, None)
        self._versions.pop(key, None)

    def _readmit_queued(self, t_now: float) -> None:
        """Re-admit the queued uploads (release -> re-price in ready
        order) and re-key the event queue to the new completions."""
        self._capacity_freed = False
        if not self.readmit or not self._pending:
            return
        updated, _ = self.env.readmit(
            list(self._pending.values()), t_now,
            policy=self.sim.readmit_policy,
        )
        self._pending = {p.key: p for p in updated}
        self._queue = [
            (p.decision.t_done, p.key, self._versions[p.key])
            for p in self._pending.values()
        ]
        heapq.heapify(self._queue)
        self._capacity_freed = False


class _AsyncStar(FLStrategy, _StarMixin, _AsyncQueueMixin):
    """Shared machinery: every satellite loops download->train->upload
    independently; the server consumes an arrival stream."""

    name = "_async"
    mix_rate = 0.6            # alpha: server mixing rate
    staleness_power = 0.5     # weight = alpha / (1 + staleness_h)^power

    def __init__(self, task: FederatedTask, sim: SimConfig,
                 env: Optional[CommsEnvironment] = None):
        super().__init__(task, sim, env)
        self._init_async_queue()
        for cid, client in enumerate(task.clients):
            self._push_next(cid, 0.0)

    def _push_next(self, cid: int, t: float) -> None:
        client = self.task.clients[cid]
        sat = Satellite(client.plane, client.slot)
        bits = self.sat_payload_bits(client.plane, client.slot)
        t_dl = self._first_tx(sat, t, bits, downlink=False)
        if t_dl is None:
            return
        t_tr = t_dl + self.train_time_s(cid)
        t_ul = self._admit_upload(cid, sat, t_tr, bits, t_dl)
        if t_ul is None:
            return
        heapq.heappush(self._queue, (t_ul, cid, t_dl))

    def _staleness_weight(self, t_now: float, t_version: float) -> float:
        stale_h = max(0.0, (t_now - t_version)) / 3600.0
        return self.mix_rate / (1.0 + stale_h) ** self.staleness_power

    def step(self, t: float) -> Tuple[Optional[float], Dict[str, Any]]:
        if self._capacity_freed:
            self._readmit_queued(t)    # an external release freed capacity
        if not self._queue:
            return None, {"drained": True}
        t_ul, cid, t_version = heapq.heappop(self._queue)
        self._pop_pending(cid)
        stacked = self.task.local_train(
            self.global_params, [cid], self._next_rng()
        )
        local = aggregation.index_pytree(stacked, 0)
        alpha = self._staleness_weight(t_ul, t_version)
        self.global_params = aggregation.weighted_average(
            aggregation.stack_pytrees([self.global_params, local]),
            np.asarray([1.0 - alpha, alpha]),
            use_kernel=self.sim.use_kernel,
        )
        self._push_next(cid, t_ul)
        return t_ul, {"client": cid, "alpha": alpha}


class FedAsync(_AsyncStar):
    """[13]: asynchronous federated optimization with staleness decay."""

    name = "FedAsync"


class FedSat(_AsyncStar):
    """[9]: ideal NP ground station; arrivals buffered and folded in at a
    fixed cadence (one orbital period) with uniform weights."""

    name = "FedSat-ideal"

    def __init__(self, task: FederatedTask, sim: SimConfig):
        sim = dataclasses.replace(
            sim,
            ground_station=GROUND_STATION_PRESETS["north-pole"],
            ground_stations=(),
        )
        super().__init__(task, sim)
        self._buffer: List[Tuple[int, float]] = []
        self._next_agg = sim.constellation.period_s

    def step(self, t: float) -> Tuple[Optional[float], Dict[str, Any]]:
        if self._capacity_freed:
            self._readmit_queued(t)
        if not self._queue:
            return None, {"drained": True}
        t_ul, cid, t_version = heapq.heappop(self._queue)
        self._pop_pending(cid)
        self._buffer.append((cid, t_version))
        self._push_next(cid, t_ul)
        if t_ul < self._next_agg and self._queue:
            return t_ul, {"buffered": len(self._buffer)}
        # aggregation tick
        self._next_agg = t_ul + self.sim.constellation.period_s
        if not self._buffer:
            return t_ul, {"buffered": 0}
        cids = [c for c, _ in self._buffer]
        stacked = self.task.local_train(
            self.global_params, cids, self._next_rng()
        )
        counts = [self.task.num_samples(c) for c in cids]
        update = aggregation.global_aggregate(
            stacked, counts, use_kernel=self.sim.use_kernel
        )
        self.global_params = aggregation.weighted_average(
            aggregation.stack_pytrees([self.global_params, update]),
            np.asarray([1.0 - self.mix_rate, self.mix_rate]),
            use_kernel=self.sim.use_kernel,
        )
        self._buffer = []
        return t_ul, {"aggregated": len(cids)}


class FedSpace(_AsyncStar):
    """[7]: buffer-fill-triggered aggregation with stale down-weighting.

    (The raw-data-upload scheduling component of FedSpace violates FL
    privacy and is not reproduced; the buffer aggregation logic is.)
    """

    name = "FedSpace"
    buffer_fraction = 0.25

    def __init__(self, task: FederatedTask, sim: SimConfig,
                 env: Optional[CommsEnvironment] = None):
        super().__init__(task, sim, env)
        self._buffer: List[Tuple[int, float]] = []

    def step(self, t: float) -> Tuple[Optional[float], Dict[str, Any]]:
        if self._capacity_freed:
            self._readmit_queued(t)
        if not self._queue:
            return None, {"drained": True}
        t_ul, cid, t_version = heapq.heappop(self._queue)
        self._pop_pending(cid)
        self._buffer.append((cid, t_version))
        self._push_next(cid, t_ul)
        target = max(1, int(self.buffer_fraction * len(self.task.clients)))
        if len(self._buffer) < target and self._queue:
            return t_ul, {"buffered": len(self._buffer)}
        cids = [c for c, _ in self._buffer]
        versions = [v for _, v in self._buffer]
        stacked = self.task.local_train(
            self.global_params, cids, self._next_rng()
        )
        w = np.asarray(
            [
                self.task.num_samples(c)
                * self._staleness_weight(t_ul, v) / self.mix_rate
                for c, v in zip(cids, versions)
            ]
        )
        update = aggregation.weighted_average(
            stacked, w, use_kernel=self.sim.use_kernel
        )
        self.global_params = aggregation.weighted_average(
            aggregation.stack_pytrees([self.global_params, update]),
            np.asarray([1.0 - self.mix_rate, self.mix_rate]),
            use_kernel=self.sim.use_kernel,
        )
        self._buffer = []
        return t_ul, {"aggregated": len(cids)}


class AsyncFLEO(FLStrategy, _StarMixin, _AsyncQueueMixin):
    """[4]: intra-plane propagation + per-orbit partials like FedLEO, but
    the sink is the next visitor (its visible-period sufficiency is NOT
    checked -> upload retries), and the server mixes partials in
    asynchronously with staleness decay."""

    name = "AsyncFLEO"
    mix_rate = 0.6
    staleness_power = 0.5

    def __init__(self, task: FederatedTask, sim: SimConfig,
                 env: Optional[CommsEnvironment] = None):
        super().__init__(task, sim, env)
        self._init_async_queue()
        for plane in range(sim.constellation.num_planes):
            self._schedule_plane(plane, 0.0)

    def _schedule_plane(self, plane: int, t: float) -> None:
        sim, task = self.sim, self.task
        K = sim.constellation.sats_per_plane
        clients = self.plane_clients(plane)
        bits = self.group_payload_bits((plane,))
        dl = self.env.first_visible_download(plane, t, bits)
        if dl is None:
            return
        src_slot, t_recv = dl
        events = broadcast_schedule(
            K, [src_slot], [t_recv], bits, sim.isl
        )
        t_done = [
            events[s].t_receive + self.train_time_s(clients[s])
            for s in range(K)
        ]
        t_hop = isl_hop_time(sim.isl, bits)
        t_ready0 = max(t_done)
        sink = self.env.naive_sink_slot(plane, t_ready0)
        if sink is None:
            return
        t_ready = float(np.max(
            np.asarray(t_done) + ring_hops_matrix(K)[sink] * t_hop
        ))
        # naive upload with retries (window chosen after the fact, not
        # scheduled ahead like FedLEO); the booked RB makes later plane
        # schedules compete for residual station capacity
        t_ul = self._admit_upload(
            plane, Satellite(plane, sink), t_ready, bits,
            t_recv,
        )
        if t_ul is None:
            return
        heapq.heappush(self._queue, (t_ul, plane, t_recv))

    def step(self, t: float) -> Tuple[Optional[float], Dict[str, Any]]:
        if self._capacity_freed:
            self._readmit_queued(t)
        if not self._queue:
            return None, {"drained": True}
        t_ul, plane, t_version = heapq.heappop(self._queue)
        self._pop_pending(plane)
        clients = self.plane_clients(plane)
        stacked = self.task.local_train(
            self.global_params, clients, self._next_rng()
        )
        counts = [self.task.num_samples(c) for c in clients]
        partial = aggregation.partial_aggregate(
            stacked, counts, use_kernel=self.sim.use_kernel
        )
        stale_h = max(0.0, t_ul - t_version) / 3600.0
        alpha = self.mix_rate / (1.0 + stale_h) ** self.staleness_power
        self.global_params = aggregation.weighted_average(
            aggregation.stack_pytrees([self.global_params, partial]),
            np.asarray([1.0 - alpha, alpha]),
            use_kernel=self.sim.use_kernel,
        )
        self._schedule_plane(plane, t_ul)
        return t_ul, {"plane": plane, "alpha": alpha}


ALL_BASELINES = {
    "FedAvg": FedAvgStar,
    "FedSatSched": FedSatSched,
    "FedHAP": FedHAP,
    "FedISL": FedISL,
    "FedISL-ideal": FedISLIdeal,
    "FedAsync": FedAsync,
    "FedSat-ideal": FedSat,
    "FedSpace": FedSpace,
    "AsyncFLEO": AsyncFLEO,
}
