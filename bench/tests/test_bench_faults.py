"""The check catches what it is there to catch.  A run on the CPU, with
the harness's look for a card skipped, at a small size of each cell:
sound, it comes out correct; with each fault that the cell's traffic
kind can have planted in the program's timed path, not correct; and the
control (the plain reference in the program's place, its products'
operands rounded to float8) is caught by the cell's limits too."""
import time

import pytest
import torch

from bench import check, faults, harness
from bench.reference import model as rm
from bench.tests.smoke import small_cell

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 29


def run(cell):
    rec = harness.driver(cell.kind).run(cell, SEED, 0.2, False, CPU, time.perf_counter())
    return rec, harness.result(cell, rec, trace=False)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    assert run(small_cell(name))[1]["correct"] is True


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in faults.FAULTS[harness.resolve(c).kind]])
def test_a_planted_fault_is_not_correct(name, fault):
    cell = small_cell(name)
    with faults.planted(fault):
        _, out = run(cell)
    assert out["correct"] is False, out["checked"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small_cell(name)
    rec, _ = run(cell)
    rd = rec["readings"]
    if cell.kind == "fedleo_train":
        control = harness.driver(cell.kind).reference(cell, SEED, rd["fed"], CPU, rm.fp8)
        numbers = check.train_numbers(control, rd["reference"])
    else:
        control = [rm.last_logits(rd["ref_params"], t, cell.config, cell.family.reference.blocks,
                                  rm.fp8) for t in rd["prompts"]]
        numbers = check.prefill_numbers(control, rd["reference"])
    ok, checked = harness.judge(numbers, cell.limits)
    assert ok is False, checked
