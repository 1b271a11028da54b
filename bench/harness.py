"""The benchmark's harness: finds a cell's files by name, runs its
driver, reads its per-layer metrics and decides ``correct``.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

  * configuration: the ``file`` of its ``configs`` entry (sizes, dtypes,
    routes), whose ``family`` names ``bench/families/<family>.py``: the
    program's configuration, the weight layout, the FLOP count, the plain
    reference of the layers (in ``bench/reference/``) and the prefill's
    hand-written kernels of that family (see ``bench/families/``);
  * traffic mix: ``bench/traffic/<traffic>.json``, whose ``kind`` names
    the driver ``bench/drivers/<kind>.py`` that generates it; it holds
    the driver's ``KEYS`` and, besides, only ``kind``, ``why`` and
    ``source``, so a parameter that no driver reads is refused;
  * per-layer metric: ``bench/metrics/<name>.py``, whose ``read(run)``
    returns the metric or None when the run holds nothing to read;
  * cell: ``bench/limits/<cell>.json``, the limit of each number that the
    check compares.

A driver returns a run record (see ``bench/drivers/``); the harness
turns it into the result line.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DESCRIPTIVE = {"kind", "why", "source"}


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    chips: int = 1

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def family(self):
        return family(self.config)


class KernelUse(NamedTuple):
    """One use of a hand-written kernel on a driver's timed path.

    ``key`` names its launches' shapes in a run record's ``launches``,
    ``names`` its device kernels as the profiler names them, ``count()``
    reads the program's launch counter of this use, and ``shape(batch,
    length)`` gives one launch's shape in a call of ``batch`` rows of
    ``length`` tokens, as the metric that reads ``key`` takes it."""
    key: str
    names: Tuple[str, ...]
    count: Callable[[], int]
    shape: Callable[[int, int], tuple]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    """Whether ``cell`` reports the per-layer ``metric``: a metric with a
    ``workloads`` key in the cells it lists, one without it in every cell
    that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def resolve(name: str, benchmark: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files read."""
    bm = benchmark if benchmark is not None else load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bm["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bm["configs"]}[w["config"]]
    e2e = [m for m in bm["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bm["per_layer"] if _reports(m, name, e2e_names)]
    traffic = load_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    keys = driver(traffic["kind"]).KEYS
    if set(traffic) - DESCRIPTIVE != keys:
        raise ValueError(f"traffic {w['traffic']!r}: driver {traffic['kind']!r} reads "
                         f"{sorted(keys)}, the file has {sorted(set(traffic) - DESCRIPTIVE)}")
    return Cell(
        name=name,
        config=load_json(root / cfg_entry["file"]),
        traffic=traffic,
        end_to_end=e2e,
        per_layer=per_layer,
        limits=load_json(root / "bench" / "limits" / f"{name}.json"),
        chips=w["chips"],
    )


def driver(kind: str):
    return importlib.import_module(f"bench.drivers.{kind}")


def metric_reader(name: str, root: Path = ROOT):
    """``read`` of ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def family(cfg: dict):
    """The module ``bench/families/<family>.py`` of a configuration file's
    ``family``."""
    return importlib.import_module(f"bench.families.{cfg['family']}")


def program_config(cfg: dict, **overrides):
    """The program's ``ArchConfig`` holding exactly the sizes of the
    configuration file, as its family builds it."""
    return family(cfg).program_config(cfg, **overrides)


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def device_info(device, peak_bytes: int) -> dict:
    """The result's ``device``: the card's name, one card, the peak."""
    import torch

    on_card = device.type == "cuda"
    return {"platform": "gpu" if on_card else device.type,
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": 1, "memory_peak_bytes": peak_bytes}


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name, the part before the first
    dot, is one of ``FORBIDDEN`` as a whole word."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def judge(numbers: Dict[str, float], limits: dict) -> tuple:
    """(correct, checked): every number at most its limit; a number that
    is missing or not finite fails."""
    checked, ok = {}, True
    for name, spec in limits["limits"].items():
        value = numbers.get(name, math.nan)
        checked[name] = {"value": value, "limit": spec["limit"]}
        ok &= math.isfinite(value) and value <= spec["limit"]
    return ok, checked


def result(cell: Cell, run: dict, trace: bool) -> dict:
    """The result line of a run record."""
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct, checked = judge(run["numbers"], cell.limits)
    correct &= run["failed"] == 0
    device = dict(run["device"])
    out = {"correct": correct, "attempted": run["attempted"], "failed": run["failed"],
           "metrics": metrics, "device": device}
    if trace and run.get("profile") is not None:
        device["busy_s"] = run["profile"].busy_s
        device["window_s"] = run["profile"].window_s
        out["breakdown"] = run["profile"].breakdown()
    out["checked"] = checked
    return out
