# Copied from src/repro/obs/export.py; imports rebound to repro_torch.
"""Trace exporters: append-only JSONL and Chrome trace-event (Perfetto).

JSONL layout (one JSON object per line, safely appendable):

  {"kind": "meta", "schema": 1, "run_id": ..., "recorded_unix_s": ...,
   "stations": [...], "counters": {...}, ...}     <- header
  {"kind": "plan"|"commit"|..., "seq": ..., "track": ..., "name": ...,
   "t0": <sim s>, "t1": <sim s>, "attrs": {...}}  <- one per event

``read_trace`` tolerates blank and truncated lines (the same
corrupt-tail discipline as the BENCH trajectory) and accepts
concatenated traces (a later meta line starts a new header; the last
one wins for ``meta``, counters are summed).

``to_chrome_trace`` emits the Chrome trace-event JSON that Perfetto /
``chrome://tracing`` load directly: tracks map to process/thread rows
(rounds, one row per orbital plane, one per ground station), commit
spans become complete ("X") events, instants become "i" events, and
each station gets a booked-RB counter ("C") row reconstructed from the
commit/release lifecycle.  Sim seconds map to microseconds (the
format's native unit).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Mapping, Optional, Sequence, TextIO, Tuple

import numpy as np

from repro_torch.obs import _walltime
from repro_torch.obs.trace import TRACE_SCHEMA_VERSION, TraceEvent, TraceRecorder
from repro_torch.obs.utilization import occupancy_timeline

# stable process ids per track family (Perfetto groups rows by pid)
_PID_ROUNDS = 1
_PID_PLANES = 2
_PID_STATIONS = 3
_PID_PREDICTOR = 4
_PID_OTHER = 9


def _json_default(obj: Any) -> Any:
    """Serialize the numpy scalars that ride along in event attrs."""
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON-serializable: {type(obj).__name__}")


def write_trace(
    recorder: TraceRecorder,
    path: str,
    *,
    append: bool = False,
) -> int:
    """Write the recorder's events as JSONL (meta header first).
    ``append=True`` adds a new header+events block to an existing file
    (``read_trace`` merges blocks).  Returns the number of event lines
    written."""
    meta = dict(recorder.meta)
    meta.setdefault("schema", TRACE_SCHEMA_VERSION)
    meta["kind"] = "meta"
    meta["counters"] = dict(recorder.counters)
    meta["recorded_unix_s"] = _walltime.recorded_unix_s()
    meta.setdefault("run_id", _walltime.run_id())
    prefix = ""
    if append:
        # quarantine a truncated final line (a recorder killed
        # mid-write) so this block's meta starts a fresh parseable line
        # — the same corrupt-tail discipline as the BENCH trajectory
        try:
            with open(path, "rb") as fb:
                fb.seek(-1, 2)
                if fb.read(1) not in (b"\n", b""):
                    prefix = "\n"
        except (FileNotFoundError, OSError):
            pass
    with open(path, "a" if append else "w") as f:
        f.write(prefix)
        _dump_line(f, meta)
        for ev in recorder.events:
            _dump_line(f, ev.as_dict())
    return len(recorder.events)


def _dump_line(f: TextIO, obj: Mapping[str, Any]) -> None:
    f.write(json.dumps(obj, default=_json_default) + "\n")


def read_trace(
    path: str,
) -> Tuple[Dict[str, Any], Dict[str, int], List[TraceEvent]]:
    """Parse a JSONL trace: ``(meta, counters, events)``.  Unparseable
    lines (a truncated tail, a corrupt append) are skipped, never
    fatal; multiple meta headers merge (last meta wins, counters sum)."""
    meta: Dict[str, Any] = {}
    counters: Dict[str, int] = {}
    events: List[TraceEvent] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict):
                continue
            if rec.get("kind") == "meta":
                for k, v in (rec.get("counters") or {}).items():
                    counters[k] = counters.get(k, 0) + int(v)
                meta.update(
                    {k: v for k, v in rec.items() if k != "counters"}
                )
                continue
            try:
                events.append(TraceEvent.from_dict(rec))
            except (KeyError, TypeError, ValueError):
                continue
    return meta, counters, events


# --- Chrome trace-event / Perfetto ---------------------------------------------
def _track_row(track: str) -> Tuple[int, int]:
    """(pid, tid) of a track string."""
    if track == "rounds":
        return _PID_ROUNDS, 0
    if track == "predictor":
        return _PID_PREDICTOR, 0
    fam, _, idx = track.partition("/")
    if fam == "plane" and idx:
        return _PID_PLANES, int(idx)
    if fam == "gs" and idx:
        return _PID_STATIONS, int(idx)
    return _PID_OTHER, abs(hash(track)) % 1000


def _meta_event(pid: int, name: str, tid: Optional[int] = None,
                label: str = "") -> Dict[str, Any]:
    ev: Dict[str, Any] = {
        "ph": "M", "pid": pid,
        "name": "process_name" if tid is None else "thread_name",
        "args": {"name": label or name},
    }
    if tid is not None:
        ev["tid"] = tid
    return ev


def to_chrome_trace(
    meta: Mapping[str, Any],
    events: Sequence[TraceEvent],
    counters: Optional[Mapping[str, int]] = None,
) -> Dict[str, Any]:
    """Chrome trace-event JSON (the dict; ``json.dump`` it) with
    rounds/planes/stations as named tracks and per-station booked-RB
    counter rows.  Timestamps are simulated microseconds."""
    stations = list(meta.get("stations") or [])
    out: List[Dict[str, Any]] = [
        _meta_event(_PID_ROUNDS, "rounds", label="FL rounds"),
        _meta_event(_PID_PLANES, "planes", label="orbital planes"),
        _meta_event(_PID_STATIONS, "stations", label="ground stations"),
        _meta_event(_PID_PREDICTOR, "predictor",
                    label="visibility predictor"),
    ]
    named_rows = set()
    for ev in events:
        pid, tid = _track_row(ev.track)
        if (pid, tid) not in named_rows:
            label = ev.track
            if pid == _PID_STATIONS and tid < len(stations):
                label = f"{stations[tid]} (gs/{tid})"
            out.append(_meta_event(pid, ev.track, tid=tid, label=label))
            named_rows.add((pid, tid))
        base = {
            "name": ev.name, "cat": ev.kind, "pid": pid, "tid": tid,
            "ts": ev.t_start_s * 1e6, "args": dict(ev.attrs),
        }
        if ev.t_end_s > ev.t_start_s:
            base["ph"] = "X"
            base["dur"] = ev.duration_s * 1e6
        else:
            base["ph"] = "i"
            base["s"] = "t"                 # thread-scoped instant
        out.append(base)
    # booked-RB counter rows reconstructed from the commit/release spans
    for gi, (times, occ) in sorted(occupancy_timeline(events).items()):
        label = (
            f"RBs booked @ {stations[gi]}" if gi < len(stations)
            else f"RBs booked @ gs/{gi}"
        )
        for t, n in zip(times, occ):
            out.append({
                "name": label, "ph": "C", "pid": _PID_STATIONS,
                "tid": gi, "ts": float(t) * 1e6,
                "args": {"booked_rbs": int(n)},
            })
    trace: Dict[str, Any] = {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": meta.get("schema", TRACE_SCHEMA_VERSION),
            "run_id": meta.get("run_id"),
            "counters": dict(counters or {}),
        },
    }
    return trace
