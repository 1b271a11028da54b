"""The harness: cells found by name, data files alone to add one, a new
family's files alone to add a configuration of it, inputs as a function
of the seed, whole tau-cycles, the JAX check, the result line, and the
entry point's refusals without a card."""
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench import counts, harness, trace as tracing, weights
from bench.drivers import fedleo_train, prefill
from bench.tests.smoke import small_cell

BM = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BM["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_by_name(name):
    cell = harness.resolve(name)
    assert cell.config["arch"] == [w for w in BM["workloads"] if w["name"] == name][0]["config"]
    assert harness.driver(cell.kind).run
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
        assert m["moves"] in {e["name"] for e in cell.end_to_end}
    assert set(cell.limits["limits"]) and all("limit" in v for v in cell.limits["limits"].values())
    fam = cell.family                        # found through the file's family
    assert fam.__name__ == f"bench.families.{cell.config['family']}"
    acfg = harness.program_config(cell.config)      # the program runs the file's sizes
    assert acfg == fam.program_config(cell.config) and acfg.num_layers == cell.config["num_layers"]
    assert fam.param_count(cell.config) == sum(
        math.prod(shape) for _, shape, _, _ in weights.leaves(cell.config))
    assert counts.prefill_flops(cell.config, 1, 64) > 0
    assert callable(fam.reference.blocks) and fam.SMALL and cell.kind in fam.SMALL_LIMITS
    assert all(isinstance(k, harness.KernelUse) for k in fam.prefill_kernels(cell.config, 2))


def test_a_new_cell_mix_and_metric_need_new_files_only(tmp_path):
    """A later change adds a configuration, a traffic mix, a per-layer
    metric and a cell as files and entries; nothing that exists changes."""
    shutil.copytree(harness.BENCH, tmp_path / "bench")
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    bm = json.loads(json.dumps(BM))
    cfg = harness.load_json(harness.BENCH / "configs" / "mamba2-780m.json")
    (tmp_path / "bench" / "configs" / "mamba2-780m-b.json").write_text(json.dumps(cfg))
    bm["configs"].append({"name": "mamba2-b", "source": "https://arxiv.org/abs/2405.21060",
                          "file": "bench/configs/mamba2-780m-b.json", "reduced": [], "why": "x"})
    mix = harness.load_json(harness.BENCH / "traffic" / "prefill_b128_s2048.json")
    mix.update(batch=1, lengths=[8192, 16384])
    (tmp_path / "bench" / "traffic" / "prefill_long_b1.json").write_text(json.dumps(mix))
    (tmp_path / "bench" / "metrics" / "calls.prefill.py").write_text(
        "def read(run):\n    return float(run['window']['calls'])\n")
    (tmp_path / "bench" / "limits" / "prefill_long.mamba2-b.json").write_text(
        json.dumps({"limits": {"served_gap": {"limit": 1.0}}}))
    bm["workloads"].append({"name": "prefill_long.mamba2-b", "config": "mamba2-b",
                            "traffic": "prefill_long_b1", "chips": 1, "why": "x"})
    bm["per_layer"].append({"name": "calls.prefill", "unit": "calls", "better": "higher",
                            "source": "program_counter", "layer": "serving step",
                            "moves": "prefill_tokens_per_s", "workloads": ["prefill_long.mamba2-b"]})
    for m in bm["end_to_end"]:
        if m["name"] != "setup_s" and "prefill" in m["name"]:
            m["workloads"].append("prefill_long.mamba2-b")
    cell = harness.resolve("prefill_long.mamba2-b", bm, root=tmp_path)
    assert cell.traffic["lengths"] == [8192, 16384] and cell.kind == "prefill"
    assert "calls.prefill" in [m["name"] for m in cell.per_layer]
    assert harness.metric_reader("calls.prefill", root=tmp_path)({"window": {"calls": 3}}) == 3.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


NEW_FAMILY = '''"""Mamba2 stacks under a second family name: the ssm family's functions."""
from bench.families import ssm
from bench.families.ssm import (SMALL, SMALL_LIMITS, forward_flops, leaves,  # noqa: F401
                                param_count, prefill_kernels, reference)


def program_config(cfg, **overrides):
    return ssm.program_config(dict(cfg, family="ssm"), **overrides)
'''

RUN_NEW_FAMILY = '''
import json, sys, time
from pathlib import Path
import torch
from bench import harness
from bench.tests.smoke import small_cell
assert harness.ROOT == Path.cwd().resolve(), harness.ROOT
out = {}
for name in sys.argv[1:]:
    cell = small_cell(name)
    assert cell.family.__name__ == "bench.families.ssm2", cell.family
    run = harness.driver(cell.kind).run(cell, 2 ** 31 + 41, 0.0, False, torch.device("cpu"),
                                        time.perf_counter())
    out[name] = [cell.kind, harness.result(cell, run, trace=False)["correct"]]
print(json.dumps(out))
'''


def test_a_configuration_of_a_new_family_needs_new_files_only(tmp_path):
    """A configuration of another family joins with new files and entries:
    its family module, its configuration, its cells' limits.  Both drivers
    run its cells on the CPU, in a copy of the benchmark, correct; nothing
    that exists changes."""
    shutil.copytree(harness.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    bench = tmp_path / "bench"
    (bench / "families" / "ssm2.py").write_text(NEW_FAMILY)
    cfg = harness.load_json(harness.BENCH / "configs" / "mamba2-780m.json")
    (bench / "configs" / "mamba2-ssm2.json").write_text(json.dumps(dict(cfg, family="ssm2")))
    bm = json.loads(json.dumps(BM))
    bm["configs"].append({"name": "mamba2-ssm2", "source": "https://arxiv.org/abs/2405.21060",
                          "file": "bench/configs/mamba2-ssm2.json", "reduced": [], "why": "x"})
    names = []
    for w in BM["workloads"]:
        name = w["name"].split(".")[0] + ".mamba2-ssm2"
        names.append(name)
        bm["workloads"].append(dict(w, name=name, config="mamba2-ssm2"))
        (bench / "limits" / f"{name}.json").write_bytes(
            (bench / "limits" / f"{w['name']}.json").read_bytes())
        for m in bm["end_to_end"]:
            if w["name"] in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bm))
    proc = subprocess.run([sys.executable, "-c", RUN_NEW_FAMILY, *names], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": os.pathsep.join(
                              [str(tmp_path), str(harness.ROOT / "src")])})
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert sorted(kind for kind, _ in out.values()) == ["fedleo_train", "prefill"]
    assert all(correct is True for _, correct in out.values()), out
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_metric_without_workloads_is_reported_where_its_end_to_end_metric_is():
    bm = json.loads(json.dumps(BM))
    bm["per_layer"].append({"name": "calls.prefill", "unit": "calls", "better": "higher",
                            "source": "program_counter", "layer": "serving step",
                            "moves": "prefill_tokens_per_s"})
    for name in CELLS:
        cell = harness.resolve(name, bm)
        reports = {m["name"] for m in cell.end_to_end} >= {"prefill_tokens_per_s"}
        assert ("calls.prefill" in {m["name"] for m in cell.per_layer}) == reports


@pytest.mark.parametrize("change", [{"callers": 8}, {"loop": "open"}, {"checked_prompts": None}])
def test_a_traffic_parameter_no_driver_reads_is_refused(tmp_path, change):
    shutil.copytree(harness.BENCH, tmp_path / "bench")
    path = tmp_path / "bench" / "traffic" / "prefill_b128_s2048.json"
    mix = json.loads(path.read_text())
    mix.update(change)
    mix = {k: v for k, v in mix.items() if v is not None}
    path.write_text(json.dumps(mix))
    name = [w["name"] for w in BM["workloads"] if w["traffic"] == "prefill_b128_s2048"][0]
    with pytest.raises(ValueError, match="driver 'prefill' reads"):
        harness.resolve(name, BM, root=tmp_path)


def test_token_ids_follow_the_seed():
    cell = small_cell("fedleo_train.mamba2-780m")
    cpu = torch.device("cpu")

    def first(seed, n=3):
        feed = fedleo_train.batches(cell.config, cell.traffic, seed, cpu)
        return [next(feed)["tokens"] for _ in range(n)]

    a, b, c = first(2 ** 31 + 11), first(2 ** 31 + 11), first(2 ** 31 + 12)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not any(torch.equal(x, y) for x, y in zip(a, c))
    assert not torch.equal(a[0], a[1])                  # every step's rows differ
    assert a[0].shape == (cell.traffic["replicas"], 1, cell.traffic["batch"],
                          cell.traffic["seq_len"])


def test_length_order_follows_the_seed():
    lengths = [512, 1024, 2048, 4096]

    def first(seed, n=40):
        order = prefill.length_order(lengths, seed)
        return [next(order) for _ in range(n)]

    a = first(2 ** 33 + 5)
    assert a == first(2 ** 33 + 5) and a != first(2 ** 33 + 6)
    for i in range(0, 40, 4):                           # every cycle holds each length once
        assert sorted(a[i:i + 4]) == lengths


def test_weights_follow_the_seed():
    cfg = small_cell("prefill.mamba2-780m").config
    a, b = (weights.make(cfg, 5, torch.float32, "cpu") for _ in range(2))
    c = weights.make(cfg, 6, torch.float32, "cpu")
    la, lb, lc = (dict(harness_leaves(t)) for t in (a, b, c))
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert not any(torch.equal(la[k], lc[k]) for k in la)


def test_weights_are_pinned():
    """The small configuration's weights for one seed, leaf by leaf, as
    they were drawn before the layout moved into the families."""
    cfg = small_cell("prefill.mamba2-780m").config
    h = hashlib.sha256()
    for k, v in harness_leaves(weights.make(cfg, 7, torch.float32, "cpu")):
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == "8926bab2944dc76c430d2f62d6fbaaafc712bd9bd1676b14c2c4ed8796d3adaf"


def test_prefill_launch_shapes_are_pinned(monkeypatch):
    """One profiled cycle of the prefill cell: 48 launches of each kernel
    a call, K3's shapes as they were before they moved into the family,
    K5's two uses counted apart."""
    from repro_torch.kernels import mamba_fused

    cell = harness.resolve("prefill.mamba2-780m")
    kernels = cell.family.prefill_kernels(cell.config, 2)
    norm = mamba_fused.gated_rmsnorm
    monkeypatch.setattr(norm, "launches", 0)
    monkeypatch.setattr(norm, "norm_launches", 0)
    before = [k.count() for k in kernels]
    norm.launches, norm.norm_launches = 5, 2
    assert [k.count() - n for k, n in zip(kernels, before)][2:] == [3, 2]
    shapes = prefill.launch_shapes(kernels, [48, 48, 48, 48], 128, [2048])
    assert shapes == {
        "ssd": [(128, 2048, 48, 64, 1, 128, 128, 2)] * 48,
        "causal_conv_silu": [(128, 2048, 3328, 2)] * 48,
        "gated_rmsnorm": [(128, 2048, 3072, True, 2)] * 48 + [(128, 2048, 1536, False, 2)] * 48,
    }
    assert prefill.launch_shapes(kernels, [4, 4, 8, 2], 3, [16, 32])["gated_rmsnorm"] == [
        (3, 16, 3072, True, 2)] * 4 + [(3, 32, 3072, True, 2)] * 4 + [
        (3, 16, 1536, False, 2), (3, 32, 1536, False, 2)]


def harness_leaves(tree):
    from bench.reference.model import leaf_items

    return leaf_items(tree)


def test_seed_streams_take_large_and_negative_seeds():
    seeds = {weights.seed_for(s, k) for s in (0, 1, -1, 2 ** 31 + 1, 2 ** 40) for k in range(4)}
    assert len(seeds) == 20 and all(0 <= s < 2 ** 63 for s in seeds)


def test_the_window_ends_on_whole_tau_cycles():
    cell = small_cell("fedleo_train.mamba2-780m")
    run = fedleo_train.run(cell, 17, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert run["attempted"] % cell.traffic["tau"] == 0 and run["attempted"] >= cell.traffic["tau"]
    assert run["window"]["tokens"] == run["attempted"] * cell.traffic["replicas"] \
        * cell.traffic["batch"] * cell.traffic["seq_len"]


def test_the_prefill_window_ends_on_whole_length_cycles():
    cell = small_cell("prefill.mamba2-780m")
    run = prefill.run(cell, 18, 0.2, False, torch.device("cpu"), time.perf_counter())
    tf = cell.traffic
    cycles, rest = divmod(run["attempted"], tf["batch"] * len(tf["lengths"]))
    assert rest == 0 and cycles >= 1
    assert run["window"]["tokens"] == cycles * tf["batch"] * sum(tf["lengths"])


def test_checked_prompts_follow_the_seed_and_hold_a_longest():
    gen = torch.Generator().manual_seed(0)
    calls = [(s, torch.randint(0, 9, (b, s), generator=gen), None)
             for s, b in [(16, 40), (48, 3), (16, 40), (32, 40)]]

    def pick(seed, count):
        return prefill.checked_prompts(calls, seed, count)

    a = pick(2 ** 32 + 3, 50)
    assert a == pick(2 ** 32 + 3, 50) and a != pick(2 ** 32 + 4, 50)
    assert sum(len(rows) for _, rows in a) == 50
    assert all(0 < len(rows) <= prefill.REF_BLOCK for _, rows in a)
    assert 1 in {i for i, _ in a}                       # a prompt of the longest call
    seen = [(i, r) for i, rows in a for r in rows]
    assert len(set(seen)) == len(seen)
    assert sum(len(rows) for _, rows in pick(5, 1000)) == 123


def test_a_session_that_lost_a_launch_is_profiled_again():
    class Held:
        def __init__(self, n):
            self.n = n

        def count(self, name):
            return self.n if name == "k1" else 0

    held = iter([1, 2, 2])
    got = tracing.whole_profile(lambda: (Held(next(held)), [(("k1", "k1_f32"), 2)]))
    assert got.n == 2 and next(held) == 2
    with pytest.raises(RuntimeError, match="every one of 3 profiler sessions"):
        tracing.whole_profile(lambda: (Held(1), [(("k1",), 2)]), attempts=3)
    # two uses of one kernel (K5 gated and as the input norm) are held together
    got = tracing.whole_profile(lambda: (Held(2), [(("k1",), 1), (("k1",), 1)]), attempts=1)
    assert got.n == 2


def test_forbidden_modules_compare_whole_top_level_names():
    loaded = ["repro_torch", "repro_torch.models", "reprox", "jaxtyping", "flaxen", "torch",
              "repro", "repro.core", "jax.numpy", "jaxlib", "flax.linen"]
    assert harness.forbidden_modules(loaded) == ["flax.linen", "jax.numpy", "jaxlib", "repro",
                                                 "repro.core"]


def test_result_line_holds_the_contract_keys():
    cell = small_cell("prefill.mamba2-780m")
    run = prefill.run(cell, 19, 0.1, False, torch.device("cpu"), time.perf_counter())
    out = harness.result(cell, run, trace=False)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    assert set(out["metrics"]) == {"prefill_tokens_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert out["correct"] is True
    assert set(out["checked"]) == set(cell.limits["limits"])
    json.dumps(out)


def test_a_number_that_is_not_finite_fails():
    ok, checked = harness.judge({"a": float("nan"), "b": 0.0},
                                {"limits": {"a": {"limit": 1.0}, "b": {"limit": 1.0}}})
    assert not ok and checked["b"]["value"] == 0.0
    assert harness.judge({}, {"limits": {"a": {"limit": 1.0}}})[0] is False


def _run_py(cwd, *args):
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = _run_py(harness.ROOT, "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_with_only_the_benchmark_files_prints_no_result(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "bench")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    proc = _run_py(tmp_path, "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card only")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_on_the_card_is_correct(cuda_device, name):
    proc = _run_py(harness.ROOT, "--workload", name, "--seed", "2147483701", "--seconds", "2",
                   "--trace", "1")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
    want = {m["name"] for m in harness.resolve(name).per_layer}
    assert set(out["metrics"]) == want
