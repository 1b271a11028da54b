"""Profiling on the card: torch.profiler sessions that hold every device
record, and the step tracer's spans.

On the H100 (torch 2.11.0+cu128, its CUPTI) every profiling session of a
process but its first loses the records of the first kernels it runs: one
more for about every 12 s since the process's first session (20 at 240
s), whichever kernels they are, PyTorch's own as well as the port's, and
however the port's libraries link the CUDA runtime
(``tools/profiler_probe.py``).  A session opened by ``device_profile``
starts on the device with ``lead_in`` empty spin kernels, which take
those losses, and checks afterwards that one of them at least was
recorded: every record after it was.

The step tracer marks the layers of the train and prefill paths with
``span(name, **attrs)``.  Outside ``recording(device)`` a span is one
shared object that does nothing.  Inside it, each span keeps its place
in the tree (parent, the request it serves), its attributes, its host
interval on the clock that torch.profiler stamps its records with
(Unix-epoch ns, ``time.time_ns``), so spans line up with a profile's
device records, and, where the recorded work runs on a CUDA device, a
pair of timing events recorded on that device's current stream at entry
and exit.  The tracer never synchronises: the events are read by
``Recording.records()``, after the caller's own synchronise.

    with profiling.recording(device) as rec:
        state, metrics = local_step(state, batch)
        torch.cuda.synchronize()
    spans = rec.records()
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter
from typing import Dict, Iterator, List, Optional

import torch

# spin kernels that open a session: a loss of 512 records would take some
# 100 minutes since the process's first session
LEAD_IN = 512
# the device kernel of torch.cuda._sleep, as the profiler names it
LEAD_IN_KERNEL = "spin_kernel"

@contextlib.contextmanager
def device_profile(lead_in: int = LEAD_IN):
    """``torch.profiler.profile`` of the host and the device over the
    block, opened on the device by ``lead_in`` empty spin kernels and
    closed by a synchronise.  Raises if no spin kernel's record survived
    (the loss may have reached the block).  Leave the kernels named
    ``LEAD_IN_KERNEL`` out of what the profile is read for."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead_in):
            torch.cuda._sleep(0)
        yield prof
        torch.cuda.synchronize()
    if lead_in and not any(LEAD_IN_KERNEL in e.key for e in prof.key_averages()):
        raise RuntimeError(f"the profiler dropped all {lead_in} lead-in kernels of the session; "
                           "it may have dropped the profiled work's too")


class _NoSpan:
    """What ``span`` returns outside ``recording()``: one object, shared."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NO_SPAN = _NoSpan()
_active: Optional["Recording"] = None


def span(name: str, adopt: bool = False, **attrs):
    """A context manager that records the block as span ``name`` inside
    ``recording()``, and the shared ``NO_SPAN`` outside it.

    ``adopt`` marks the span that autograd's backward pass runs in.
    While it is open, a span opened on a thread with no open span of its
    own (the autograd engine's, where remat recomputes a block on CUDA)
    is its child; every span below it is marked ``recompute``."""
    rec = _active
    if rec is None:
        return NO_SPAN
    return _Span(rec, name, adopt, attrs)


class _Span:
    __slots__ = ("rec", "name", "adopt", "attrs", "id", "parent", "request", "recompute",
                 "start_ns", "end_ns", "events", "retries")

    def __init__(self, rec: "Recording", name: str, adopt: bool, attrs: dict):
        self.rec, self.name, self.adopt, self.attrs = rec, name, adopt, attrs
        self.end_ns = self.events = self.retries = None

    def __enter__(self) -> "_Span":
        self.rec._open(self)
        return self

    def __exit__(self, *exc) -> None:
        self.rec._close(self)


class Recording:
    """The spans of one ``recording()`` block, in memory only."""

    def __init__(self, device):
        device = torch.device(device)
        # the device the recorded work runs on, where it is a CUDA one
        self.cuda = device if device.type == "cuda" else None
        self._spans: List[_Span] = []
        self._ids = itertools.count()
        self._roots: Counter = Counter()
        self._adopters: List[_Span] = []
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, sp: _Span) -> None:
        stack = self._stack()
        parent = stack[-1] if stack else (self._adopters[-1] if self._adopters else None)
        sp.parent = parent
        if parent is None:
            with self._lock:
                sp.request = self._roots[sp.name]
                self._roots[sp.name] += 1
            sp.recompute = False
            if self.cuda is not None:
                sp.retries = self._alloc_retries()
        else:
            sp.request = parent.request
            sp.recompute = parent.recompute or parent.adopt
        sp.id = next(self._ids)
        self._spans.append(sp)
        if sp.adopt:
            self._adopters.append(sp)
        stack.append(sp)
        sp.start_ns = time.time_ns()
        if self.cuda is not None:
            sp.events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            sp.events[0].record(torch.cuda.current_stream(self.cuda))

    def _close(self, sp: _Span) -> None:
        if sp.events is not None:
            sp.events[1].record(torch.cuda.current_stream(self.cuda))
        sp.end_ns = time.time_ns()
        if sp.retries is not None:
            sp.retries = self._alloc_retries() - sp.retries
        self._stack().pop()
        if sp.adopt:
            self._adopters.remove(sp)

    def _alloc_retries(self) -> int:
        return torch.cuda.memory_stats(self.cuda)["num_alloc_retries"]

    def records(self) -> List[Dict]:
        """The closed spans in the order they opened, each a dict: name,
        id, parent (its id, or None for a root), request (a root's index
        among the roots of its name, shared by its descendants),
        recompute, attrs, start_ns and end_ns (host), device_ms (entry
        event to exit event on a CUDA device, the host interval
        elsewhere) and alloc_retries (the allocator's retries over a
        root span on a CUDA device, else None).  On CUDA, read after a
        synchronise that follows the spans' work."""
        out = []
        for sp in self._spans:
            if sp.end_ns is None:
                continue
            device_ms = (sp.events[0].elapsed_time(sp.events[1]) if sp.events is not None
                         else (sp.end_ns - sp.start_ns) * 1e-6)
            out.append({"name": sp.name, "id": sp.id,
                        "parent": None if sp.parent is None else sp.parent.id,
                        "request": sp.request,
                        "recompute": sp.recompute, "attrs": dict(sp.attrs),
                        "start_ns": sp.start_ns, "end_ns": sp.end_ns, "device_ms": device_ms,
                        "alloc_retries": sp.retries})
        return out


@contextlib.contextmanager
def recording(device) -> Iterator[Recording]:
    """Record every ``span`` entered in the block, on any thread, into
    the ``Recording`` it yields.  The only switch of the tracer.
    ``device`` is the one the recorded work runs on: only on a CUDA
    device do spans record events and read the allocator."""
    global _active
    if _active is not None:
        raise RuntimeError("recording() is already on")
    rec = _active = Recording(device)
    try:
        yield rec
    finally:
        _active = None
