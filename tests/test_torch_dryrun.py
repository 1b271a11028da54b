"""The port's dry run against the reference's on one (2, 4) data x model
mesh: 8 host devices for the reference (XLA), 8 fake ranks for the port
(DTensor), each in a subprocess of its own.

Smoke configs whose kv heads do not split 4 ways (kimi-k2's and
internvl2's: 8 query heads in 2 kv groups), and gemma-7b's train step.
Prefill pairs run 8 x 512 tokens, train pairs 16 x 2048: there the
activations, the expert buffers and the loss hold 10-1000x the
parameters' bytes, so the memory compared is theirs.

  * A device's memory (argument + output + temp - alias bytes) is within
    2x of the reference's on every pair.
  * Attention runs regrouped: each device's query heads and the kv heads
    they read.
  * The loss and the expert buffers are sharded: the largest storage a
    train step allocates on a device is under half the float32 logits of
    the global batch (a loss sharded over the batch alone holds half of
    them, its gradient's global-batch zeros all of them), and under the
    bytes of the global expert buffers.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# (arch, shape, global batch, sequence)
PAIRS = [("kimi-k2-1t-a32b", "prefill_32k", 8, 512),
         ("internvl2-26b", "prefill_32k", 8, 512),
         ("gemma-7b", "train_4k", 16, 2048),
         ("kimi-k2-1t-a32b", "train_4k", 16, 2048)]
IDS = [f"{a}-{s}" for a, s, _, _ in PAIRS]

_RUN = """
import dataclasses, json
from {pkg}.configs import get_smoke_config
from {pkg}.configs.base import INPUT_SHAPES
from {pkg}.launch.dryrun import lower_pair
from {pkg}.launch.mesh import make_mesh_compat

mesh = make_mesh_compat((2, 4), ("data", "model"))
out = {{}}
for arch, shape, batch, seq in {pairs!r}:
    base = INPUT_SHAPES[shape]
    INPUT_SHAPES[shape] = dataclasses.replace(base, global_batch=batch, seq_len=seq)
    try:
        lowered, meta = lower_pair(arch, shape, mesh, cfg=get_smoke_config(arch))
        compiled = lowered.compile()
    finally:
        INPUT_SHAPES[shape] = base
    mem = compiled.memory_analysis()
    out[f"{{arch}}|{{shape}}"] = {{
        "per_device": (mem.argument_size_in_bytes + mem.output_size_in_bytes
                       + mem.temp_size_in_bytes - mem.alias_size_in_bytes),
        "largest": getattr(compiled, "largest_buffer_bytes", None),
        "meta": {{k: v for k, v in meta.items() if isinstance(v, (str, int, bool))}},
    }}
print("RESULT:" + json.dumps(out))
"""


def _run(pkg: str, prefix: str = "") -> dict:
    script = prefix + textwrap.dedent(_RUN.format(pkg=pkg, pairs=PAIRS))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT:")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[0][len("RESULT:"):])


@pytest.fixture(scope="module")
def reference():
    return _run("repro", 'import os\nos.environ["XLA_FLAGS"] = '
                         '"--xla_force_host_platform_device_count=8"\n')


@pytest.fixture(scope="module")
def port():
    return _run("repro_torch")


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_per_device_memory_within_2x_of_reference(reference, port, pair):
    key = f"{pair[0]}|{pair[1]}"
    ratio = port[key]["per_device"] / reference[key]["per_device"]
    assert 0.5 <= ratio <= 2.0, (key, port[key]["per_device"], reference[key]["per_device"])


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_attention_runs_regrouped(port, pair):
    meta = port[f"{pair[0]}|{pair[1]}"]["meta"]
    assert meta["attention"].startswith("regrouped: each device's query heads")


@pytest.mark.parametrize("pair", [p for p in PAIRS if p[1] == "train_4k"],
                         ids=[i for i, p in zip(IDS, PAIRS) if p[1] == "train_4k"])
def test_loss_and_expert_buffers_sharded(port, pair):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe import capacity

    arch, shape, batch, seq = pair
    cfg = get_smoke_config(arch)
    rec = port[f"{arch}|{shape}"]
    assert rec["meta"]["loss"].startswith("loss-parallel")
    global_logits_f32 = batch * seq * cfg.vocab_size * 4
    assert rec["largest"] < global_logits_f32 / 2
    if cfg.moe is not None:
        assert rec["meta"]["experts"].startswith("expert-parallel")
        n = batch * seq
        global_buffers = cfg.moe.num_experts * capacity(cfg.moe, n) * cfg.d_model * 2
        assert rec["largest"] < global_buffers
