"""The ``hybrid`` family (zamba2-7b): both drivers on its small size on
the CPU, correct, through the same reference and check as the cells;
its file against the published keys; K2's launch shapes, yardstick and
roofline reader; the ssm family's reference in step with the hybrid's
copy of its mixer."""
import copy
import json
import math
import time

import pytest
import torch

from bench import harness, weights
from bench.drivers import fedleo_train, prefill
from bench.flash_bound import flash_bound_ms
from bench.reference import mamba2 as rmamba
from bench.reference import model as rm
from bench.reference import zamba2 as rz
from bench.tests.smoke import TRAFFIC, small_cell

CELL = "prefill.zamba2-7b"


def small_training_cell() -> harness.Cell:
    """The training cell's traffic and check at the hybrid family's small
    size (zamba2-7b has no training cell on the card)."""
    cell = copy.deepcopy(harness.resolve("fedleo_train.mamba2-780m"))
    cell.config = harness.load_json(harness.BENCH / "configs" / "zamba2-7b.json")
    fam = cell.family
    cell.config.update(copy.deepcopy(fam.SMALL))
    cell.config.pop("params", None)
    cell.traffic.update(TRAFFIC["fedleo_train"])
    cell.limits = {"limits": {k: {"limit": v}
                              for k, v in fam.SMALL_LIMITS["fedleo_train"].items()}}
    return cell


@pytest.mark.parametrize("kind", ["prefill", "fedleo_train"])
@pytest.mark.parametrize("seed", [2 ** 31 + 7, 2 ** 33 + 1])
def test_both_drivers_run_the_hybrid_family_correct(kind, seed):
    cell = small_cell(CELL) if kind == "prefill" else small_training_cell()
    assert cell.family.__name__ == "bench.families.hybrid"
    run = harness.driver(kind).run(cell, seed, 0.0, False, torch.device("cpu"),
                                   time.perf_counter())
    out = harness.result(cell, run, trace=False)
    assert out["correct"] is True, out["checked"]
    assert out["failed"] == 0 and run["window"]["flops"] > 0


def test_the_float8_control_fails_the_small_prefill():
    """The reference in float8 in the program's place reads above a limit
    of the small size on every seed tried."""
    from bench import check

    cell = small_cell(CELL)
    for seed in (3, 4):
        run = prefill.run(cell, seed, 0.0, False, torch.device("cpu"), time.perf_counter())
        rd = run["readings"]
        control = [rm.last_logits(rd["ref_params"], t, cell.config, cell.family.reference.blocks,
                                  rm.fp8) for t in rd["prompts"]]
        ok, _ = harness.judge(check.prefill_numbers(control, rd["reference"]), cell.limits)
        assert not ok


def test_the_file_holds_the_published_keys_and_agrees_with_them():
    cfg = harness.resolve(CELL).config
    cat = {"hidden_size": 3584, "num_hidden_layers": 81, "attention_head_dim": 224,
           "attention_hidden_size": 7168, "mamba_ngroups": 2, "mamba_d_state": 64,
           "n_mamba_heads": 112, "chunk_size": 256, "num_mem_blocks": 2, "adapter_rank": 128,
           "intermediate_size": 14336, "rms_norm_eps": 1e-5, "max_position_embeddings": 4096,
           "use_shared_attention_adapter": False, "use_shared_mlp_adapter": True,
           "hidden_act": "gelu", "vocab_size": 32000}
    assert {k: cfg[k] for k in cat} == cat and cfg["reduced"] == []
    assert cfg["layers_block_type"].count("hybrid") == len(cfg["hybrid_layer_ids"]) == 13
    cell = harness.resolve(CELL)
    assert cell.family.param_count(cfg) == cfg["params"] == 7_356_749_648
    bad = dict(cfg, hidden_size=4096)
    with pytest.raises(ValueError, match="disagree"):
        cell.family.program_config(bad)


def test_prefill_launch_shapes_of_a_call():
    """One call of 16 x 4096: 81 launches of K3 and K4, 81 of each K5 use,
    13 of K2, each shape as its yardstick takes it."""
    cell = harness.resolve(CELL)
    kernels = cell.family.prefill_kernels(cell.config, 2)
    assert [k.key for k in kernels] == ["ssd", "causal_conv_silu", "gated_rmsnorm",
                                        "gated_rmsnorm", "flash"]
    shapes = prefill.launch_shapes(kernels, [81, 81, 81, 81, 13], 16, [4096])
    assert shapes["ssd"] == [(16, 4096, 112, 64, 2, 64, 256, 2)] * 81
    assert shapes["causal_conv_silu"] == [(16, 4096, 7424, 2)] * 81
    assert shapes["gated_rmsnorm"] == [(16, 4096, 7168, True, 2)] * 81 + [
        (16, 4096, 3584, False, 2)] * 81
    assert shapes["flash"] == [(16, 4096, 32, 32, 224, True, 2)] * 13


@pytest.mark.parametrize("s,causal", [(1, True), (7, True), (64, False), (200, True)])
def test_flash_bound_counts_the_visible_pairs(s, causal):
    pairs = sum(q + 1 if causal else s for q in range(s))
    ms, by, nbytes, flops = flash_bound_ms(2, s, 4, 2, 224, causal, 2)
    assert flops == 4.0 * 2 * 4 * 224 * pairs
    assert nbytes == (2 * 2 * s * 4 * 224 + 2 * 2 * s * 2 * 224) * 2
    assert by in ("bytes", "operations") and ms > 0


def test_flash_roofline_reads_the_profiled_kernels():
    read = harness.metric_reader("flash_roofline")

    class Prof:
        def seconds(self, name):
            return {"flash_fwd_tc_kernel": 0.02, "flash_fwd_kernel": 0.0}[name]

    shape = (16, 4096, 32, 32, 224, True, 2)
    got = read({"profile": Prof(), "launches": {"flash": [shape] * 2}})
    assert got == pytest.approx(100.0 * 2 * flash_bound_ms(*shape)[0] * 1e-3 / 0.02)
    assert read({"profile": Prof(), "launches": {}}) is None       # the parent: no reading
    assert read({"profile": None, "launches": {"flash": [shape]}}) is None


def test_the_ssm_reference_is_pinned():
    """mamba2-780m's reference block at the small size, in float32 and
    under the float8 control, equal to the bit to the hybrid reference's
    mixer after the block's input norm plus the residual: the two Mamba2
    references (``reference/mamba2.py`` and the copy of its mixer in
    ``reference/zamba2.py``) stay in step."""
    cell = small_cell("prefill.mamba2-780m")
    cfg = cell.config
    params = weights.make(cfg, 31, torch.float32, "cpu")
    x = torch.randn((3, 40, cfg["d_model"]), generator=torch.Generator().manual_seed(9))
    for i in range(cfg["num_layers"]):
        p = rm.layer(params["layers"], i)
        for prec in (rm.exact, rm.fp8):
            u = rm.rmsnorm(x, p["norm"]["scale"], cfg["rms_norm_eps"])
            assert torch.equal(rmamba.mamba_block(p, x, cfg, prec), x + rz.mixer(p, u, cfg, prec))


def test_the_new_cell_is_sized_to_the_whole_context():
    cell = harness.resolve(CELL)
    tf = cell.traffic
    assert (tf["batch"], tf["lengths"], tf["checked_prompts"]) == (16, [4096], 32)
    flops = sum(cell.family.forward_flops(cell.config, 16, 4096, 1).values())
    assert 1.4e15 < flops < 1.6e15
    bm = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    w = [w for w in bm["workloads"] if w["name"] == CELL][0]
    assert w["chips"] == 1 and math.isclose(cell.config["rms_norm_eps"], 1e-5)
