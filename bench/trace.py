"""The traced window: one torch.profiler session, read for device time.

``device_profile`` is a frozen copy of the program's lead-in
(``repro_torch.profiling.device_profile``): on the H100 with torch
2.11's CUPTI every session of a process but its first loses the records
of the first kernels it runs, so a session opens with 512 empty spin
kernels that take the loss, and fails if none of them was recorded.
The session records the device alone: recording every host operation
as well slows the host so much that the device waits for it (a mamba2
local step's traced cycle took 8.5-12.3 s for 5.85 s of device work).

``Profile`` reads the session: device activity (kernels, copies and
fills; the spin kernels left out), the window from its first operation's
start to its last one's end, its busy time as the union of the
operations' intervals, the operations that took most time, and the
longest idle gaps, each named by the operation the device waited for.
"""
from __future__ import annotations

import bisect
import contextlib
import sys
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

LEAD_IN = 512
LEAD_IN_KERNEL = "spin_kernel"   # the device kernel of torch.cuda._sleep


@contextlib.contextmanager
def device_profile(lead_in: int = LEAD_IN):
    """``torch.profiler.profile`` of the host and the device over the
    block, opened on the device by ``lead_in`` empty spin kernels and
    closed by a synchronise.  Raises if no spin kernel's record survived
    (the loss may have reached the block)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(lead_in):
            torch.cuda._sleep(0)
        yield prof
        torch.cuda.synchronize()
    if lead_in and not any(LEAD_IN_KERNEL in e.name()
                           for e in prof.profiler.kineto_results.events()):
        raise RuntimeError(f"the profiler dropped all {lead_in} lead-in kernels of the "
                           "session; it may have dropped the profiled work's too")


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Profile:
    """Device activity of one session, in seconds from its first
    operation's start (the spin kernels of the lead-in left out)."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        device = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                  if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()
                  and LEAD_IN_KERNEL not in e.name()]
        if not device:
            raise RuntimeError("the profile holds no device operation")
        w0 = min(s for _, s, _ in device)
        self.window_s = (max(e for _, _, e in device) - w0) * 1e-9
        self.ops = sorted(((n, (s - w0) * 1e-9, (e - w0) * 1e-9) for n, s, e in device),
                          key=lambda r: r[1])
        self.busy = merge([(s, e) for _, s, e in self.ops])
        self.busy_s = sum(e - s for s, e in self.busy)

    def count(self, name: str) -> int:
        """Device operations whose name holds ``name``."""
        return sum(name in n for n, _, _ in self.ops)

    def seconds(self, name: str) -> float:
        """Device time of the operations whose name holds ``name``."""
        return sum(e - s for n, s, e in self.ops if name in n)

    def total_s(self) -> float:
        """Device time of every operation, overlaps counted each."""
        return sum(e - s for _, s, e in self.ops)

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = defaultdict(float)
        for n, s, e in self.ops:
            by[n] += e - s
        return [[n, t] for n, t in sorted(by.items(), key=lambda r: -r[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The k longest stretches with no device activity, each named
        ``before <operation>`` by the operation that ended it: the one
        the host had not yet issued."""
        starts = [s for _, s, _ in self.ops]
        gaps = sorted(((self.busy[i + 1][0] - self.busy[i][1], self.busy[i + 1][0])
                       for i in range(len(self.busy) - 1)), reverse=True)[:k]
        out = []
        for length, end in gaps:
            nxt = self.ops[bisect.bisect_left(starts, end)][0]
            out.append([f"before {nxt}", length])
        return out

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def read(prof) -> Profile:
    return Profile(prof.profiler.kineto_results.events())


SESSIONS = 4


def whole_profile(session: Callable[[], Tuple[Profile, List[Tuple[Tuple[str, ...], int]]]],
                  attempts: int = SESSIONS) -> Profile:
    """The first of up to ``attempts`` sessions that holds every launch
    of the hand-written kernels that the program's counters saw in it.

    ``session()`` profiles one more cycle and returns its ``Profile``
    with (kernel names, launches counted) pairs; pairs of the same names
    (two uses of one kernel) are summed.  The profiler drops a
    record now and then in the middle of a long session (one K1 launch
    of a mamba2 training cycle, 6 s and some 10^4 kernels, in one traced
    run of four on the H100 with torch 2.11); a session that lost one is
    read no further and the next cycle is profiled.  Raises if every
    session lost one."""
    lost = []
    for _ in range(attempts):
        profile, pairs = session()
        made: Dict[Tuple[str, ...], int] = defaultdict(int)
        for names, n_made in pairs:           # uses of one kernel count together
            made[names] += n_made
        held = [(names, sum(profile.count(n) for n in names), n_made)
                for names, n_made in made.items()]
        if all(h == m for _, h, m in held):
            return profile
        lost.append([f"{h} of {m} {'/'.join(names)}" for names, h, m in held if h != m])
        print(f"bench: a profiler session held {lost[-1]}; profiling the next cycle",
              file=sys.stderr)
    raise RuntimeError(f"every one of {attempts} profiler sessions lost a launch of its "
                       f"hand-written kernels: {lost}")
