"""The example twins (``examples/*_torch.py``) against the reference's
examples, on the CPU.

  * quickstart and sota_comparison (``--fast``): the reference example
    (loaded through importlib, its strategies' results recorded) and its
    twin run in this process; every strategy's round times, per-plane
    events and decompositions equal the reference's exactly, and so do
    the printed lines but for accuracy and loss.  The synthetic data
    differ from process to process, so accuracy is compared only here,
    within one process: both quickstarts learn (above 0.5 by round 4).
  * train_arch ``--small --steps 20 --tau 10``: the loss falls.
  * serve_decode: both cache modes generate (4, 32) tokens in range.
  * Without ``--device`` each twin runs on the card, and raises without
    one.
"""
import dataclasses
import importlib.util
import pathlib
import re
import sys

import pytest
import torch

import repro.core.engine as jengine

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
# the numbers each example prints that depend on training, not the schedule
_TRAINED = re.compile(r"(acc=|accuracy=|loss=)\d+\.\d+|^(\S+\s+)\d+\.\d+(?=\s+\d+\.\d+\s+\d+$)")


@pytest.fixture(autouse=True)
def one_thread():
    """The twins' small CPU operations on one thread: the suite's workers
    share the cores, and threads that wait on each other there spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}", ROOT / "examples"
                                                  / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _schedule_lines(text):
    return [_TRAINED.sub(lambda m: (m.group(1) or m.group(2)) + "*", line)
            for line in text.splitlines() if line.strip()]


@pytest.fixture
def recorded(monkeypatch):
    """The results of every reference strategy's ``run``, in order."""
    results = []
    run = jengine.FLStrategy.run

    def recording(self, *args, **kwargs):
        results.append(run(self, *args, **kwargs))
        return results[-1]

    monkeypatch.setattr(jengine.FLStrategy, "run", recording)
    return results


def _assert_same_schedule(ours, ref):
    assert ours.name == ref.name
    assert [h.t_hours for h in ours.history] == [h.t_hours for h in ref.history]
    assert [h.round_index for h in ours.history] == [h.round_index for h in ref.history]
    assert [h.events for h in ours.history] == [h.events for h in ref.history]
    assert [dataclasses.asdict(h.decomposition) for h in ours.history] == \
        [dataclasses.asdict(h.decomposition) for h in ref.history]


def test_quickstart_twin_equals_reference(recorded, capsys):
    _load("quickstart").main()
    ref_out = capsys.readouterr().out
    ours = _load("quickstart_torch").main(CPU)
    our_out = capsys.readouterr().out
    (ref,) = recorded
    _assert_same_schedule(ours, ref)
    assert len(ours.history) == 4 and len(ours.history[0].events["planes"]) == 5
    assert _schedule_lines(our_out) == _schedule_lines(ref_out)
    assert "schedule decomposition (round 1):" in our_out
    # accuracy, within this process only: both learn
    assert ref.final_accuracy > 0.5 and ours.final_accuracy > 0.5


def test_sota_comparison_fast_twin_equals_reference(recorded, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["sota_comparison.py", "--fast"])
    _load("sota_comparison").main()
    ref_out = capsys.readouterr().out
    ours = _load("sota_comparison_torch").main(["--fast", *CPU])
    our_out = capsys.readouterr().out
    assert list(ours) == ["FedLEO", "FedAvg", "FedISL-ideal", "FedHAP", "FedAsync",
                          "AsyncFLEO"]
    assert len(recorded) == len(ours)
    for res, ref in zip(ours.values(), recorded):
        _assert_same_schedule(res, ref)
        assert 0.0 <= res.final_accuracy <= 1.0
    assert _schedule_lines(our_out) == _schedule_lines(ref_out)
    assert len(_schedule_lines(our_out)) == 7


def test_train_arch_twin_small_loss_falls(capsys):
    out = _load("train_arch_torch").main(["--small", "--steps", "20", "--tau", "10", *CPU])
    assert out["steps"] == 20 and 20e6 < out["params"] < 30e6
    assert out["last_loss"] < out["first_loss"]
    assert [p[0] for p in out["printed"]] == [20]
    text = capsys.readouterr().out
    assert "model: 25.2M params, 4L d_model=512" in text
    assert "done: loss" in text


def test_serve_decode_twin_generates():
    out = _load("serve_decode_torch").main(CPU)
    assert list(out) == ["full-cache", "sliding-window(8)"]
    for gen in out.values():
        assert tuple(gen.shape) == (4, 32) and gen.dtype == torch.int32
        assert int(gen.min()) >= 0 and int(gen.max()) < 512


@pytest.mark.parametrize("name,argv", [
    ("quickstart_torch", []), ("sota_comparison_torch", ["--fast"]),
    ("train_arch_torch", ["--small", "--steps", "1"]), ("serve_decode_torch", []),
])
def test_twin_runs_on_the_card_by_default(name, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main(argv)
