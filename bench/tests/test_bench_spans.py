"""``bench/spans.py``: idle gaps labelled by the program's spans on a
synthetic profile, the device-time split on synthetic spans, and the
split of small traced runs of the cells on the CPU."""
import dataclasses

import pytest
import torch

from bench import harness, spans, trace as tracing, weights
from bench.drivers.fedleo_train import Setup
from bench.tests.smoke import small_cell
from repro_torch import profiling


@dataclasses.dataclass
class Event:
    """What ``spans.Idle`` and ``trace.Profile`` read of a profiler record."""
    label: str
    start: int
    end: int

    def name(self):
        return self.label

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA

    def is_user_annotation(self):
        return False


# device busy [0,100) [200,300) [1000,1100) [1500,1600) [3000,3100), a lead-in spin before,
# on a clock that starts far from 0, as the profiler's Unix-epoch ns do
T0 = 1_790_000_000_000_000_000
EVENTS = [Event(tracing.LEAD_IN_KERNEL, -500, -400), Event("k1", 0, 100), Event("k2", 200, 300),
          Event("k3", 1000, 1100), Event("k4", 1500, 1600), Event("k5", 3000, 3100)]
EVENTS = [dataclasses.replace(e, start=T0 + e.start, end=T0 + e.end) for e in EVENTS]


def _span(id_, name, start, end, parent=None, **attrs):
    return {"name": name, "id": id_, "parent": parent, "request": 0,
            "recompute": False, "attrs": attrs, "start_ns": T0 + start, "end_ns": T0 + end,
            "device_ms": (end - start) * 1e-6, "alloc_retries": None}


SPANS = [
    _span(0, "fedleo.local_step", 0, 1550),
    _span(1, "fedleo.replica", 50, 1540, 0, r=1),
    _span(2, "train_step.backward", 250, 1400, 1),
    _span(3, "mamba.block", 320, 900, 2, layer=17),
    _span(4, "mamba.block", 950, 1050, 2, layer=16),
]


def test_the_gaps_are_the_profiles_on_the_profilers_clock():
    idle = spans.Idle(EVENTS)
    assert idle.gaps == [(T0 + 100, T0 + 200, "k2"), (T0 + 300, T0 + 1000, "k3"),
                         (T0 + 1100, T0 + 1500, "k4"), (T0 + 1600, T0 + 3000, "k5")]
    want = tracing.Profile(EVENTS).idle_gaps()
    got = sorted(idle.gaps, key=lambda g: g[0] - g[1])
    assert [f"before {n}" for _, _, n in got] == [w[0] for w in want]
    assert [(e - s) * 1e-9 for s, e, _ in got] == pytest.approx([w[1] for w in want])


@pytest.mark.parametrize("gap, label", [
    # the innermost span holding most of the gap: block17 580 of backward's 700
    ((300, 1000), "replica1/backward/block17"),
    # the replica alone: no child overlaps
    ((100, 200), "replica1"),
    # backward holds 300 of the replica's 400: into backward, whose blocks miss it
    ((1100, 1500), "replica1/backward"),
    # no span overlaps
    ((1600, 3000), "outside spans"),
])
def test_a_gap_is_labelled_by_the_span_holding_most_of_it(gap, label):
    assert spans.Spans(SPANS).label(T0 + gap[0], T0 + gap[1]) == label


def test_a_parent_keeps_a_gap_its_children_hold_less_of():
    # backward ends at 1200: it holds 100 of the gap, the replica 300 outside it
    short = [dict(r, end_ns=1200) if r["id"] == 2 else r for r in SPANS]
    assert spans.Spans(short).label(T0 + 1100, T0 + 1500) == "replica1"
    # of two siblings, the one holding more
    assert spans.Spans(SPANS).label(T0 + 880, T0 + 1000) == "replica1/backward/block16"


def test_labelled_gaps_longest_first():
    got = spans.idle_gaps(spans.Idle(EVENTS), spans.Spans(SPANS))
    assert [g[0] for g in got] == ["outside spans before k5", "replica1/backward/block17 before k3",
                                   "replica1/backward before k4", "replica1 before k2"]
    assert [g[1] for g in got] == pytest.approx([1400e-9, 700e-9, 400e-9, 100e-9])
    by = spans.idle_by_label(spans.Idle(EVENTS), spans.Spans(SPANS), depth=2)
    assert by == pytest.approx({"outside spans": 1400e-9, "replica1/backward": 1100e-9,
                                "replica1": 100e-9})


def test_held_idle_by_span_name():
    s = spans.Spans(SPANS)
    idle = spans.Idle(EVENTS).intervals()
    assert s.held(idle) == 100 + 700 + 400     # the last gap starts after the spans end
    assert s.held(idle, ["train_step.backward"]) == 700 + 300


def test_recordings_join_without_id_clashes():
    joined = spans.Spans(SPANS, SPANS)
    assert sorted(r["id"] for r in joined.records) == list(range(10))
    assert [r["parent"] for r in joined.records[5:]] == [None, 5, 6, 7, 7]
    assert len(joined.children[None]) == 2


def test_the_split_of_a_small_traced_training_run():
    cell = small_cell("fedleo_train.mamba2-780m")
    st = Setup(cell, 3, torch.device("cpu"))
    with profiling.recording(torch.device("cpu")) as rec:
        st.cycle()
    s = spans.Spans(rec.records())
    split = spans.train_split(s)
    assert split.pop("alloc_retries") is None      # counted on the card only
    assert all(v is not None and v > 0 for v in split.values()), split
    tau, r = cell.traffic["tau"], cell.traffic["replicas"]
    assert len(s.named("train_step.forward")) == tau * r
    assert split["recompute_ms"] <= split["backward_ms"]
    parts = r * (split["forward_ms"] + split["backward_ms"] + split["optimizer_ms"]
                 + split["copy_out_ms"])
    assert parts <= split["local_step_device_s"] * 1e3
    # a device busy from before the cycle to after it: no idle time to hold
    first = min(r["start_ns"] for r in s.records)
    busy = [Event("k", first - 10, first - 5), Event("k", first - 5, first + 10**12)]
    assert spans.train_step_idle_ms(spans.Idle(busy), s) == 0.0


def test_the_split_of_a_small_traced_prefill_call():
    from repro_torch.configs import build_model
    from repro_torch.train import steps

    cell = small_cell("prefill.mamba2-780m")
    cfg, sv = cell.config, cell.config["serve"]
    model = build_model(harness.program_config(cfg), ssd_impl=sv["ssd_impl"],
                        dtype=torch.float32, device="cpu")
    params = weights.make(cfg, 3, torch.float32, torch.device("cpu"))
    tokens = torch.randint(0, cfg["vocab_size"], (2, 48))
    with profiling.recording(torch.device("cpu")) as rec:
        steps.make_prefill_step(model)(params, {"tokens": tokens})
    split = spans.prefill_split(spans.Spans(rec.records()))
    assert all(v > 0 for v in split.values()), split
    assert split["ssd_ms"] + split["block_self_ms"] <= split["call_device_ms"]


@pytest.mark.parametrize("reader", [spans.train_split, spans.prefill_split])
def test_the_split_reads_none_without_spans(reader):
    assert all(v is None for v in reader(spans.Spans([])).values())
