# Copied from src/repro/obs/report.py; imports rebound to repro_torch.
"""CLI trace reporter: ``python -m repro.obs.report <trace.jsonl>``.

Prints the round-time decomposition table (one row per round: mean
phase seconds across the round's plane groups) and the per-station
RB-utilization table reconstructed from the trace's commit/release
lifecycle, plus the session counters (predictor queries, horizon
extensions, routing-cache hits, plan/commit/release totals).

``--perfetto out.json`` additionally writes the Chrome trace-event
export — load it in Perfetto (ui.perfetto.dev) or chrome://tracing to
see rounds, per-plane phase spans and per-station RB bookings as
tracks.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.obs.decomposition import RoundDecomposition
from repro_torch.obs.export import read_trace, to_chrome_trace
from repro_torch.obs.trace import TraceEvent
from repro_torch.obs.utilization import trace_rb_utilization

_PHASE_COLS = (
    ("broadcast_s_mean", "bcast"),
    ("propagate_s_mean", "propag"),
    ("train_s_mean", "train"),
    ("relay_s_mean", "relay"),
    ("window_wait_s_mean", "wwait"),
    ("queue_delay_s_mean", "queue"),
    ("upload_s_mean", "upload"),
)


def round_decompositions(
    events: Sequence[TraceEvent],
) -> List[RoundDecomposition]:
    """The typed per-round decompositions a trace carries (one per
    ``round`` span, in round order)."""
    out = []
    for ev in events:
        if ev.kind == "round" and "decomposition" in ev.attrs:
            out.append(
                RoundDecomposition.from_dict(ev.attrs["decomposition"])
            )
    out.sort(key=lambda d: d.round_index)
    return out


def _fmt(x: Optional[float], width: int = 8) -> str:
    if x is None:
        return " " * (width - 1) + "-"
    return f"{x:{width}.1f}"


def print_decomposition_table(
    decomps: Sequence[RoundDecomposition], out: Any = sys.stdout
) -> None:
    if not decomps:
        print("no round decompositions in trace", file=out)
        return
    header = "round  groups " + "".join(
        f"{label:>9}" for _, label in _PHASE_COLS
    ) + f"{'round_s':>10}"
    print("per-round phase decomposition (mean seconds per group):",
          file=out)
    print(header, file=out)
    for d in decomps:
        means = d.phase_means()
        cols = "".join(
            _fmt(means.get(key), 9) for key, _ in _PHASE_COLS
        )
        print(
            f"{d.round_index:5d}  {len(d.groups):6d} {cols}"
            f"{d.round_s:10.1f}",
            file=out,
        )


def print_utilization_table(
    meta: Mapping[str, Any],
    events: Sequence[TraceEvent],
    out: Any = sys.stdout,
) -> None:
    spans = [ev for ev in events if ev.kind in ("round", "commit")]
    if not spans:
        print("no commit/round events in trace — no utilization to "
              "report", file=out)
        return
    t0 = min(ev.t_start_s for ev in spans)
    t1 = max(ev.t_end_s for ev in spans)
    caps = meta.get("rb_capacity")
    util = trace_rb_utilization(events, t0, t1, capacities=caps)
    stations = list(meta.get("stations") or [])
    if not util:
        print("no committed uploads in trace", file=out)
        return
    print(f"per-station RB utilization over [{t0:.0f}s, {t1:.0f}s]:",
          file=out)
    print(f"{'station':>20} {'capacity':>9} {'booked%':>8}", file=out)
    for gi in sorted(util):
        name = stations[gi] if gi < len(stations) else f"gs/{gi}"
        cap = (
            caps[gi] if caps is not None and gi < len(caps) else None
        )
        cap_s = str(cap) if cap else "inf"
        print(
            f"{name:>20} {cap_s:>9} {100.0 * util[gi]:8.2f}",
            file=out,
        )


def print_counters(
    counters: Mapping[str, int], out: Any = sys.stdout
) -> None:
    if not counters:
        return
    print("session counters:", file=out)
    for k in sorted(counters):
        print(f"  {k:32s} {counters[k]}", file=out)


def report(
    path: str,
    perfetto_out: Optional[str] = None,
    out: Any = sys.stdout,
) -> Dict[str, Any]:
    """Run the full report; returns the parsed (meta, counters,
    decomposition count) summary for programmatic callers/tests."""
    meta, counters, events = read_trace(path)
    print(
        f"trace {path}: schema {meta.get('schema')}, "
        f"run {meta.get('run_id')}, {len(events)} events, "
        f"stations {meta.get('stations')}",
        file=out,
    )
    decomps = round_decompositions(events)
    print_decomposition_table(decomps, out=out)
    print_utilization_table(meta, events, out=out)
    print_counters(counters, out=out)
    if perfetto_out:
        with open(perfetto_out, "w") as f:
            json.dump(to_chrome_trace(meta, events, counters), f)
        print(f"wrote Perfetto/Chrome trace: {perfetto_out}", file=out)
    return {
        "meta": meta, "counters": dict(counters),
        "events": len(events), "rounds": len(decomps),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.obs.report",
        description="Decomposition/utilization report over a recorded "
                    "scheduling trace (JSONL).",
    )
    ap.add_argument("trace", help="path to a JSONL trace file")
    ap.add_argument(
        "--perfetto", metavar="OUT",
        help="also write a Chrome trace-event JSON for Perfetto",
    )
    args = ap.parse_args(argv)
    try:
        report(args.trace, perfetto_out=args.perfetto)
    except FileNotFoundError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
