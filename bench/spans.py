"""The program's spans read against the device: per-phase device time,
and each idle gap of a profiler session put down to the host code that
ran during it.

The spans are the records of ``repro_torch.profiling.recording()``
(``Recording.records()``: name, id, parent, request, recompute, attrs,
host ``start_ns`` and ``end_ns`` on the profiler's clock, ``device_ms``
between the span's entry and exit events, and ``alloc_retries`` on the
roots).  A device-only session (``trace.device_profile``) stamps its
device records on the same clock, so a stretch with no device activity
in its ``trace.Profile`` lines up with the spans the host was inside
while it lasted.

A gap is labelled by the path to the innermost span that holds the most
of it: from the roots down, the child that overlaps the gap the most,
while it overlaps more than its parent does outside its children.  The
root is left out of a path that goes below it, and the path comes first,
so a cut label keeps it: ``replica1/backward/block17 before <kernel>``,
where ``trace.Profile.idle_gaps`` says ``before <kernel>``.  A gap that
no span overlaps is ``outside spans``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from bench.trace import LEAD_IN_KERNEL, Profile, merge

Interval = Tuple[int, int]
TRAIN_STEP = ("train_step.forward", "train_step.backward", "train_step.optimizer")


class Idle:
    """The idle gaps of one device-only session's ``trace.Profile``, put
    back on the profiler's clock: ``gaps`` holds (start ns, end ns, the
    operation that ended it), in time order."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        events = list(events)
        self.profile = profile = Profile(events)
        # the ns the profile counts its seconds from: its first device operation's start
        origin = min(e.start_ns() for e in events
                     if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                     and LEAD_IN_KERNEL not in e.name())
        starts = [s for _, s, _ in profile.ops]

        def ns(t: float) -> int:
            return origin + round(t * 1e9)

        self.gaps = [(ns(a), ns(b), profile.ops[bisect.bisect_left(starts, b)][0])
                     for (_, a), (b, _) in zip(profile.busy, profile.busy[1:])]

    def intervals(self) -> List[Interval]:
        return [(s, e) for s, e, _ in self.gaps]


def _overlap(sp: dict, s: int, e: int) -> int:
    return max(0, min(sp["end_ns"], e) - max(sp["start_ns"], s))


def _short(sp: dict) -> str:
    """``fedleo.replica`` r=1 -> ``replica1``, ``train_step.backward`` ->
    ``backward``, ``fedleo.aggregate.params`` -> ``aggregate.params``."""
    name = sp["name"].split(".", 1)[-1]
    if sp["attrs"]:
        name = name.split(".")[-1] + "".join(str(v) for v in sp["attrs"].values())
    return name


class Spans:
    """The records of one or more recordings, indexed by their tree (the
    ids of each recording after the first shifted past the last one's)."""

    def __init__(self, *recordings: Iterable[dict]):
        self.records: List[dict] = []
        for records in recordings:
            base = max((r["id"] for r in self.records), default=-1) + 1
            self.records += [dict(r, id=r["id"] + base,
                                  parent=None if r["parent"] is None else r["parent"] + base)
                             for r in records]
        self.children: Dict[Optional[int], List[dict]] = defaultdict(list)
        for r in self.records:
            self.children[r["parent"]].append(r)

    def named(self, name: str) -> List[dict]:
        return [r for r in self.records if r["name"] == name]

    def path(self, s: int, e: int) -> List[dict]:
        """The spans from a root down to the innermost one that holds
        the most of [s, e) (see the module's docstring); [] where none
        overlaps it."""
        out: List[dict] = []
        level, held = self.children[None], e - s
        while True:
            laps = [(_overlap(sp, s, e), sp) for sp in level]
            laps = [(ov, sp) for ov, sp in laps if ov > 0]
            if not laps:
                return out
            inside = sum(b - a for a, b in merge([(max(sp["start_ns"], s), min(sp["end_ns"], e))
                                                  for _, sp in laps]))
            ov, best = max(laps, key=lambda x: x[0])
            if out and ov < held - inside:
                return out
            out.append(best)
            level, held = self.children[best["id"]], ov

    def label(self, s: int, e: int) -> str:
        path = self.path(s, e)
        if not path:
            return "outside spans"
        return "/".join(_short(sp) for sp in (path[1:] if len(path) > 1 else path))

    def held(self, intervals: Sequence[Interval], names: Optional[Sequence[str]] = None) -> int:
        """ns of ``intervals`` (disjoint) during which the host was inside
        a span (one named in ``names``, where given)."""
        host = merge([(r["start_ns"], r["end_ns"]) for r in self.records
                      if names is None or r["name"] in names])
        return sum(max(0, min(b, e) - max(a, s)) for s, e in intervals for a, b in host
                   if a < e and b > s)


def idle_gaps(idle: Idle, spans: Spans, k: int = 10) -> List[list]:
    """The k longest idle gaps as [label, seconds], longest first."""
    return [[f"{spans.label(s, e)} before {nxt}", (e - s) * 1e-9]
            for s, e, nxt in sorted(idle.gaps, key=lambda g: g[0] - g[1])[:k]]


def idle_by_label(idle: Idle, spans: Spans, depth: int = 2) -> Dict[str, float]:
    """Seconds of idle time by gap label, cut to its first ``depth``
    components (``replica1/backward``), most first."""
    by: Dict[str, float] = defaultdict(float)
    for s, e, _ in idle.gaps:
        by["/".join(spans.label(s, e).split("/")[:depth])] += (e - s) * 1e-9
    return dict(sorted(by.items(), key=lambda r: -r[1]))


def _per(total_ms: float, count: int) -> Optional[float]:
    return total_ms / count if count else None


def train_split(spans: Spans) -> Dict[str, Optional[float]]:
    """Device time of the training phases, each a mean: a local step
    (s) and an aggregation (ms) per call; forward, backward, remat's
    recompute inside the backward and the optimizer per replica step;
    the copy-out per replica; allocator retries per tau-cycle (one
    aggregation ends each)."""
    def ms(name):
        return sum(r["device_ms"] for r in spans.named(name))

    steps = len(spans.named("train_step.forward"))
    step_s = _per(ms("fedleo.local_step"), len(spans.named("fedleo.local_step")))
    cycles = len(spans.named("fedleo.aggregate"))
    roots = [r["alloc_retries"] for r in spans.records if r["parent"] is None
             and r["alloc_retries"] is not None]
    return {
        "local_step_device_s": None if step_s is None else step_s * 1e-3,
        "aggregate_device_ms": _per(ms("fedleo.aggregate"), cycles),
        "forward_ms": _per(ms("train_step.forward"), steps),
        "backward_ms": _per(ms("train_step.backward"), steps),
        "recompute_ms": _per(sum(r["device_ms"] for r in spans.named("mamba.block")
                                 if r["recompute"]), steps),
        "optimizer_ms": _per(ms("train_step.optimizer"), steps),
        "copy_out_ms": _per(ms("fedleo.copy_out"), len(spans.named("fedleo.copy_out"))),
        "alloc_retries": _per(sum(roots), cycles) if roots else None,
    }


def train_step_idle_ms(idle: Idle, spans: Spans) -> Optional[float]:
    """Device idle ms of a profiled cycle during which the host was
    inside a ``train_step.*`` span, per replica step."""
    steps = len(spans.named("train_step.forward"))
    return _per(spans.held(idle.intervals(), TRAIN_STEP) * 1e-6, steps)


def prefill_split(spans: Spans) -> Dict[str, Optional[float]]:
    """Per prefill call: the call's device ms, ``mamba.ssd``'s, and the
    Mamba blocks' less their scans (norm, projections, conv, gate)."""
    calls = len(spans.named("serve.prefill"))
    block_ids = {r["id"] for r in spans.named("mamba.block")}
    ssd = sum(r["device_ms"] for r in spans.named("mamba.ssd") if r["parent"] in block_ids)
    blocks = sum(r["device_ms"] for r in spans.named("mamba.block"))
    return {"call_device_ms": _per(sum(r["device_ms"] for r in spans.named("serve.prefill")),
                                   calls),
            "ssd_ms": _per(ssd, calls), "block_self_ms": _per(blocks - ssd, calls)}
