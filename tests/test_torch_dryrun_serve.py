"""The port's dry run of the serving steps against the reference's, each
package's dry run in a subprocess of its own.

  * Decode at a global batch of one lowers on a (2, 4) data x model mesh
    (smoke configs, 512 positions): no mesh dim splits the batch, so the
    KV cache splits its head dim over the model axis alone.
  * On the production 16 x 16 mesh, at full width and 2 units of each
    layer stack, a decode step moves no more than 4x the reference's
    collective bytes (or 16 MB) and holds no more than 2x its per-device
    bytes (or 0.25 GB); mamba2-780m's prefill moves no more than 4x.
    The reference's program moves activations and keeps every weight
    split; a step that gathers weights reads 10-1000x here.
  * Each serving route is named in the record.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
# (arch, shape, global batch, sequence) on the (2, 4) mesh, smoke configs
BATCH_ONE = [("gemma-7b", "long_500k", 1, 512), ("zamba2-1.2b", "long_500k", 1, 512),
             ("seamless-m4t-large-v2", "long_500k", 1, 512), ("mamba2-780m", "long_500k", 1, 512)]
SMOKE_ROUTES = [("kimi-k2-1t-a32b", "decode_32k", 8, 512), ("gemma-7b", "prefill_32k", 8, 512)]
# (arch, shape) on the 16 x 16 mesh, full width, 2 units of each stack
PRODUCTION = [("gemma-7b", "decode_32k"), ("gemma-7b", "long_500k"),
              ("mamba2-780m", "decode_32k"), ("mamba2-780m", "long_500k"),
              ("mamba2-780m", "prefill_32k")]
DEPTH = 2
DECODE_COLLECTIVE = (4.0, 16e6)      # x the reference's, or bytes, whichever is larger
DECODE_MEMORY = (2.0, 0.25e9)
PREFILL_COLLECTIVE = 4.0

_SMOKE = """
import dataclasses, json
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch.dryrun import lower_pair
from repro_torch.launch.mesh import make_mesh_compat

mesh = make_mesh_compat((2, 4), ("data", "model"))
out = {{}}
for arch, shape, batch, seq in {pairs!r}:
    base = INPUT_SHAPES[shape]
    INPUT_SHAPES[shape] = dataclasses.replace(base, global_batch=batch, seq_len=seq)
    try:
        lowered, meta = lower_pair(arch, shape, mesh, cfg=get_smoke_config(arch))
        lowered.compile()
        rec = {{"ok": True, "meta": {{k: v for k, v in meta.items() if isinstance(v, str)}}}}
    except Exception as e:
        rec = {{"ok": False, "error": f"{{type(e).__name__}}: {{e}}"}}
    finally:
        INPUT_SHAPES[shape] = base
    out[f"{{arch}}|{{shape}}"] = rec
print("RESULT:" + json.dumps(out))
"""

_PRODUCTION = """
import dataclasses, json
from {pkg}.configs import get_config
from {pkg}.launch.dryrun import collective_bytes, lower_pair
from {pkg}.launch.mesh import make_mesh_compat, use_mesh_compat

mesh = make_mesh_compat((16, 16), ("data", "model"))
out = {{}}
for arch, shape in {pairs!r}:
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers={depth} * (cfg.moe_every if cfg.moe else 1))
    try:
        with use_mesh_compat(mesh):
            lowered, meta = lower_pair(arch, shape, mesh, cfg=cfg)
            compiled = lowered.compile()
    except Exception as e:
        out[f"{{arch}}|{{shape}}"] = {{"error": f"{{type(e).__name__}}: {{e}}"}}
        continue
    mem = compiled.memory_analysis()
    out[f"{{arch}}|{{shape}}"] = {{
        "per_device": (mem.argument_size_in_bytes + mem.output_size_in_bytes
                       + mem.temp_size_in_bytes - mem.alias_size_in_bytes),
        "collective": sum(collective_bytes(compiled.as_text()).values()),
        "meta": {{k: v for k, v in meta.items() if isinstance(v, str)}},
    }}
print("RESULT:" + json.dumps(out))
"""


def _run(script: str) -> dict:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=600, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT:")]
    assert line, proc.stdout[-2000:]
    return json.loads(line[0][len("RESULT:"):])


@pytest.fixture(scope="module")
def smoke():
    return _run(textwrap.dedent(_SMOKE.format(pairs=BATCH_ONE + SMOKE_ROUTES)))


@pytest.fixture(scope="module")
def reference():
    prefix = ('import os\nos.environ["XLA_FLAGS"] = '
              '"--xla_force_host_platform_device_count=256"\n')
    return _run(prefix + textwrap.dedent(_PRODUCTION.format(pkg="repro", pairs=PRODUCTION,
                                                            depth=DEPTH)))


@pytest.fixture(scope="module")
def port():
    return _run(textwrap.dedent(_PRODUCTION.format(pkg="repro_torch", pairs=PRODUCTION,
                                                   depth=DEPTH)))


def _key(pair) -> str:
    return f"{pair[0]}|{pair[1]}"


def _lowered(records: dict, pair) -> dict:
    rec = records[_key(pair)]
    assert "error" not in rec, rec.get("error")
    return rec


@pytest.mark.parametrize("pair", BATCH_ONE, ids=[p[0] for p in BATCH_ONE])
def test_batch_one_decode_lowers(smoke, pair):
    rec = smoke[_key(pair)]
    assert rec["ok"], rec.get("error")


DECODES = [p for p in PRODUCTION if p[1] != "prefill_32k"]


@pytest.mark.parametrize("pair", DECODES, ids=[_key(p) for p in DECODES])
def test_decode_collectives_within_target(reference, port, pair):
    ref, got = _lowered(reference, pair)["collective"], _lowered(port, pair)["collective"]
    ratio, floor = DECODE_COLLECTIVE
    assert got <= max(ratio * ref, floor), (pair, got, ref)


@pytest.mark.parametrize("pair", DECODES, ids=[_key(p) for p in DECODES])
def test_decode_memory_within_target(reference, port, pair):
    ref, got = _lowered(reference, pair)["per_device"], _lowered(port, pair)["per_device"]
    ratio, floor = DECODE_MEMORY
    assert got <= max(ratio * ref, floor), (pair, got, ref)


def test_ssm_prefill_collectives_within_target(reference, port):
    pair = ("mamba2-780m", "prefill_32k")
    ref, got = _lowered(reference, pair)["collective"], _lowered(port, pair)["collective"]
    assert got <= PREFILL_COLLECTIVE * ref, (got, ref)


def test_decode_routes_named(port, smoke):
    meta = _lowered(port, ("gemma-7b", "decode_32k"))["meta"]
    assert meta["weights"].startswith("split: no parameter moves")
    assert meta["embedding"].startswith("split: a masked lookup")
    assert meta["head"].startswith("vocabulary-parallel")
    assert meta["cache_writes"] == "on each device's shard of the cache"
    assert smoke["kimi-k2-1t-a32b|decode_32k"]["meta"]["experts"].startswith(
        "expert-parallel with d_model slices")


def test_prefill_routes_named(port, smoke):
    meta = _lowered(port, ("mamba2-780m", "prefill_32k"))["meta"]
    assert meta["weights"].startswith("FSDP")
    assert meta["ssd"].startswith("per-head")
    assert smoke["gemma-7b|prefill_32k"]["meta"]["products"].startswith("tensor-parallel")
