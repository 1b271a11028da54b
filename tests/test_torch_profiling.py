"""The step tracer of ``repro_torch.profiling``: ``span`` and ``recording``.

On the CPU: a span outside ``recording()`` is one shared object that
reads no clock and makes no CUDA event; a recording of work on the CPU
makes no CUDA event and reads no allocator, card or no card; inside it,
spans nest by thread, share their root's request id, and a span opened
on a thread with no open span (autograd's, where remat recomputes a
block on the card) is a child of the open adopting (backward) span,
marked ``recompute``; traced runs of a
FedLEO local step and aggregate (remat on) and of a prefill call equal
untraced ones bit for bit; a span's host start lies on the profiler's
clock.  Marked ``cuda`` (skip without a card): a kernel launched in a
span starts on the device just after the span's host start, and the
tracer adds no synchronise to a local step.  This file imports no JAX,
so the card tests run where JAX is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_profiling.py
"""
import dataclasses
import threading
import time
import warnings

import pytest
import torch

from repro_torch import profiling
from repro_torch.configs import build_model, get_smoke_config
from repro_torch.optim import get_optimizer
from repro_torch.train import fedleo_step, steps
from repro_torch.tree import tree_leaves

CPU = torch.device("cpu")
BACKWARD = "train_step.backward"
FEDLEO_SPANS = {"fedleo.local_step", "fedleo.replica", "train_step.forward",
                "train_step.backward", "train_step.optimizer", "fedleo.copy_out",
                "mamba.block", "mamba.ssd", "fedleo.aggregate", "fedleo.aggregate.params",
                "fedleo.aggregate.opt_state"}


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the spans' device events and the device's clock")
    return torch.device("cuda")


def _by_id(records):
    return {r["id"]: r for r in records}


def test_span_outside_recording_is_the_shared_noop(monkeypatch):
    def touched(*args, **kwargs):
        raise AssertionError("the tracer read the clock or made a CUDA event while off")

    monkeypatch.setattr(time, "time_ns", touched)
    monkeypatch.setattr(torch.cuda, "Event", touched)
    for sp in (profiling.span("fedleo.local_step"), profiling.span("mamba.block", layer=3)):
        assert sp is profiling.NO_SPAN
        with sp as entered:
            assert entered is profiling.NO_SPAN


def test_a_recording_on_the_cpu_leaves_the_card_alone(monkeypatch):
    def touched(*args, **kwargs):
        raise AssertionError("a recording of work on the CPU touched the card")

    # as on a host with a card: the device given decides, not the card's presence
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("Event", "memory_stats", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, touched)
    with profiling.recording(CPU) as rec:
        with profiling.span("root"), profiling.span(BACKWARD, adopt=True):
            pass
    records = rec.records()
    assert [r["name"] for r in records] == ["root", BACKWARD]
    for r in records:
        assert r["alloc_retries"] is None
        assert r["device_ms"] == pytest.approx((r["end_ns"] - r["start_ns"]) * 1e-6)


def test_recording_nests_spans_and_shares_the_root_request():
    with profiling.recording(CPU) as rec:
        for _ in range(2):
            with profiling.span("root"):
                with profiling.span("child", r=0):
                    with profiling.span("leaf"):
                        pass
                with profiling.span("child", r=1):
                    pass
    assert profiling.span("root") is profiling.NO_SPAN
    records = rec.records()
    assert [r["name"] for r in records] == ["root", "child", "leaf", "child"] * 2
    by_id = _by_id(records)
    for r in records:
        if r["name"] == "root":
            assert r["parent"] is None
        else:
            parent = by_id[r["parent"]]
            assert parent["name"] == ("child" if r["name"] == "leaf" else "root")
            assert parent["request"] == r["request"]
            assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] <= parent["end_ns"]
        assert r["device_ms"] == pytest.approx((r["end_ns"] - r["start_ns"]) * 1e-6)
        assert r["alloc_retries"] is None and not r["recompute"]
    assert [r["request"] for r in records] == [0] * 4 + [1] * 4
    assert [r["attrs"] for r in records[:4]] == [{}, {"r": 0}, {}, {"r": 1}]


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()


def test_a_span_on_a_thread_without_open_spans_is_a_recompute_of_the_backward():
    def engine():
        with profiling.span("mamba.block", layer=1), profiling.span("mamba.ssd"):
            pass

    with profiling.recording(CPU) as rec:
        with profiling.span("fedleo.local_step"):
            with profiling.span("train_step.forward"):
                with profiling.span("mamba.block", layer=1):
                    pass
            with profiling.span(BACKWARD, adopt=True):
                _in_thread(engine)
        _in_thread(engine)
    by_id = _by_id(rec.records())
    backward = next(r for r in by_id.values() if r["name"] == BACKWARD)
    forward_block = next(r for r in by_id.values() if r["name"] == "mamba.block")
    assert not forward_block["recompute"]
    inside, outside = [r for r in by_id.values()
                       if r["name"] == "mamba.block" and r is not forward_block]
    assert inside["parent"] == backward["id"] and inside["recompute"]
    assert inside["request"] == backward["request"]
    ssd = next(r for r in by_id.values() if r["parent"] == inside["id"])
    assert ssd["name"] == "mamba.ssd" and ssd["recompute"]
    # with no backward span open, the thread's span is a root of its own
    assert outside["parent"] is None and not outside["recompute"] and outside["request"] == 0


def test_recording_is_not_reentrant_and_ends_on_an_error():
    with pytest.raises(ValueError):
        with profiling.recording(CPU):
            with pytest.raises(RuntimeError, match="already on"):
                with profiling.recording(CPU):
                    pass
            raise ValueError
    assert profiling.span("x") is profiling.NO_SPAN


def _mamba(remat: bool, ssd_impl: str, device="cpu"):
    cfg = dataclasses.replace(get_smoke_config("mamba2-780m"), remat=remat)
    model = build_model(cfg, ssd_impl=ssd_impl, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    return cfg, model, model.init(gen), gen


def _fedleo(device="cpu"):
    """(run, cfg): ``run()`` takes a smoke mamba2's two orbit replicas
    (remat, Adam) through one local step and the aggregation."""
    cfg, model, params, gen = _mamba(True, "xla", device)
    opt = get_optimizer("adam", 1e-3)
    state = fedleo_step.replicate_for_orbits(steps.TrainState(
        params, opt.init(params), torch.zeros((), dtype=torch.int32, device=device)), 2)
    local_step = fedleo_step.make_fedleo_local_step(model, opt)
    aggregate = fedleo_step.make_fedleo_aggregate(use_kernel=True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1, 2, 32), generator=gen, device=device)
    samples = torch.tensor([3.0, 1.0], device=device)

    def run():
        new, metrics = local_step(state, {"tokens": tokens})
        return tree_leaves(aggregate(new, samples)) + tree_leaves(metrics)

    return run, cfg


def _prefill(device="cpu"):
    cfg, model, params, gen = _mamba(False, "pallas", device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen, device=device)
    prefill = steps.make_prefill_step(model)
    return (lambda: [prefill(params, {"tokens": tokens})]), cfg


@pytest.mark.parametrize("path", ["fedleo", "prefill"])
def test_traced_run_equals_untraced_to_the_bit(path):
    run, cfg = {"fedleo": _fedleo, "prefill": _prefill}[path]()
    untraced = run()
    with profiling.recording(CPU) as rec:
        traced = run()
    assert len(traced) == len(untraced)
    for a, b in zip(traced, untraced):
        assert torch.equal(a, b)
    records = rec.records()
    names = [r["name"] for r in records]
    layers = cfg.num_layers
    if path == "prefill":
        assert names == ["serve.prefill"] + ["mamba.block", "mamba.ssd"] * layers
        return
    assert set(names) == FEDLEO_SPANS
    blocks = [r for r in records if r["name"] == "mamba.block"]
    # each replica's blocks run forward, then again as remat recomputes them
    assert len(blocks) == 2 * 2 * layers
    assert sum(r["recompute"] for r in blocks) == 2 * layers
    by_id = _by_id(records)
    for r in blocks:
        assert (by_id[r["parent"]]["name"] == BACKWARD) == r["recompute"]
    assert [r["attrs"]["r"] for r in records if r["name"] == "fedleo.replica"] == [0, 1]
    roots = [r["name"] for r in records if r["parent"] is None]
    assert roots == ["fedleo.local_step", "fedleo.aggregate"]


def test_span_host_start_is_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    starts = []
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.recording(CPU) as rec:
        for i in range(3):
            with profiling.span("mark"), record_function(f"mark{i}"):
                starts.append(torch.ones(8).sum())
    marks = sorted((e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("mark"))
    assert len(marks) == 3
    for (_, profiled_ns), r in zip(marks, rec.records()):
        assert abs(profiled_ns - r["start_ns"]) < 1_000_000


@pytest.mark.cuda
def test_a_kernel_in_a_span_starts_just_after_its_host_start():
    device = _card()
    with profiling.device_profile() as prof:
        torch.cuda.synchronize()
        with profiling.recording(device) as rec:
            with profiling.span("sleep"):
                torch.cuda._sleep(100_000)
        torch.cuda.synchronize()
    span = rec.records()[0]
    spins = [e.start_ns() for e in prof.profiler.kineto_results.events()
             if profiling.LEAD_IN_KERNEL in e.name() and e.device_type().name == "CUDA"]
    kernel_ns = max(spins)
    assert span["start_ns"] <= kernel_ns < span["start_ns"] + 1_000_000
    assert span["device_ms"] > 0 and span["alloc_retries"] == 0


@pytest.mark.cuda
def test_the_tracer_adds_no_synchronise():
    device = _card()
    run, _ = _fedleo(device)
    run()
    torch.cuda.synchronize()

    def synchronisations(traced: bool) -> int:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                if traced:
                    with profiling.recording(device) as rec:
                        run()
                else:
                    run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if traced:
            records = rec.records()
            assert {r["name"] for r in records} == FEDLEO_SPANS
            assert all(r["device_ms"] >= 0 for r in records)
            roots = [r for r in records if r["parent"] is None]
            assert all(isinstance(r["alloc_retries"], int) for r in roots)
        # setting the mode first warns that it is a prototype: not a synchronise
        return sum("called a synchronizing" in str(w.message) for w in caught)

    assert synchronisations(True) == synchronisations(False)
