"""The frozen counts: against hand counts at a small shape, against the
bounds the kernel table records, against 6 N D at full width, and
mamba2-780m's counts pinned at the values they had before the counts
moved into the families."""
import json

import pytest

from bench import counts, harness
from bench.families import ssm

CONFIGS = {c["name"]: harness.load_json(harness.ROOT / c["file"])
           for c in harness.load_json(harness.ROOT / "BENCHMARK.json")["configs"]}


def test_bounds_equal_the_kernel_tables():
    """The bounds that the port's kernel table records (chip_smoke.py)."""
    assert counts.aggregate_bound_ms(8, 421_642, 4)[0] == pytest.approx(0.00453, rel=2e-3)
    assert counts.aggregate_bound_ms(8, 2 ** 25, 2)[0] == pytest.approx(0.1803, rel=2e-3)
    ms, by, _, _ = counts.ssd_bound_ms(4, 2048, 48, 64, 1, 128, 128, 2)
    assert (ms, by) == (pytest.approx(0.0336, rel=5e-3), "bytes")
    # K4 and K5 at the prefill cell's 128 x 2048, bf16: chip_smoke.py's fused_inputs bytes
    assert counts.causal_conv_silu_bound_ms(128, 2048, 3328, 2)[:2] == (
        pytest.approx(1.0417, rel=1e-4), "bytes")
    assert counts.gated_rmsnorm_bound_ms(128, 2048, 3072, True, 2)[:2] == (
        pytest.approx(1.9231, rel=1e-4), "bytes")
    assert counts.gated_rmsnorm_bound_ms(128, 2048, 1536, False, 2)[:2] == (
        pytest.approx(0.4808, rel=1e-4), "bytes")


def test_forward_flops_by_hand():
    cfg = {"family": "ssm", "d_model": 8, "vocab_size": 10, "num_layers": 3,
           "ssm": {"state_dim": 2, "head_dim": 4, "num_groups": 1, "chunk_size": 4,
                   "conv_width": 3, "expand": 2}}
    b, s = 2, 5
    t = ssm.forward_flops(cfg, b, s, 1)
    # d_inner 16, 4 heads, in_proj 8 -> 16 + 16 + 2 + 2 + 4 = 40, out_proj 16 -> 8
    assert t["mamba_proj"] == 3 * b * s * 2 * (8 * 40 + 16 * 8)
    assert t["mamba_conv"] == 3 * b * s * 2 * 3 * 20
    # 2 chunks of 4 per (sequence, head): 2*16*2 + 2*16*4 + 4*4*4*2
    assert t["scan"] == 3 * b * 4 * 2 * (64 + 128 + 128)
    assert t["head"] == b * 1 * 2 * 8 * 10
    assert set(t) == {"mamba_proj", "mamba_conv", "scan", "head"}
    assert counts.prefill_flops(cfg, b, s) == sum(t.values())
    assert counts.train_step_flops(cfg, b, s) == 3 * sum(ssm.forward_flops(cfg, b, s, s).values())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_flops_are_6nd_beside_the_scan(name):
    """Outside the scan's term a training step is 6 N D of the parameters
    that enter products (every one but the norm scales and the
    per-channel vectors), within 0.3 % of 6 N D of all its parameters."""
    cfg = CONFIGS[name]
    b, s = 1, 2048
    fwd = ssm.forward_flops(cfg, b, s, s)
    rest = 3 * sum(v for k, v in fwd.items() if k != "scan") / (b * s)
    d_inner, heads, g, n, conv_ch, proj = ssm.dims(cfg)
    d = cfg["d_model"]
    products = cfg["num_layers"] * (d * proj + cfg["ssm"]["conv_width"] * conv_ch + d_inner * d) \
        + cfg["vocab_size"] * d
    assert rest == pytest.approx(6 * products, rel=1e-12)
    assert rest == pytest.approx(6 * ssm.param_count(cfg), rel=3e-3)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_count_is_the_configuration_s(name):
    cfg = CONFIGS[name]
    assert harness.family(cfg).param_count(cfg) == cfg["params"]
    assert json.dumps(cfg)      # the file is plain JSON


def test_mamba2_780m_counts_are_pinned():
    """The values the counts had before they moved into the families."""
    cfg = CONFIGS["mamba2-780m"]
    assert ssm.param_count(cfg) == 780_148_992
    assert counts.prefill_flops(cfg, 128, 2048) == 417825599520768.0
    assert counts.train_step_flops(cfg, 4, 2048) == 42965309325312.0
