"""repro_torch stands alone: it imports neither jax nor the reference
package, and its copied numpy modules stay verbatim copies.

  * A subprocess blocks ``jax*`` and ``repro``/``repro.*`` in
    ``sys.meta_path``, imports repro_torch (the baselines, compute,
    multitenant and obs exporters included), runs one CPU FedLEO round
    and one traced CPU FedAvgStar round, and reports on its trace;
    another imports the serving slice (configs, transformer, serving
    steps) and serves a smoke gemma on the CPU; a third prefills and
    decodes smoke mamba2 and zamba2 models on the CPU; a fourth prefills,
    decodes and trains smoke llama4, kimi-k2, internvl2 and seamless
    models (the moe, vlm and audio families); a fifth runs the training
    driver (``python -m repro_torch.launch.train``) in FedLEO mode on the
    CPU with a checkpoint; a sixth imports the launch layer (mesh,
    sharding, specs, dryrun, calibrate) and prices a step in the
    roofline's ``compiled`` mode; and one a twin runs each example twin
    (``examples/*_torch.py``) on the CPU.
  * An AST scan of every module of the port, of ``chip_smoke.py`` and of
    the example twins finds no import of jax or of the reference package.
  * Every copied module equals its reference file with the imports
    rebound to repro_torch, under a one-line header naming the source.
"""
import ast
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

COPIED = [
    "orbits/constellation.py", "orbits/visibility.py", "orbits/prediction.py",
    "orbits/topology.py",
    "comms/link.py", "comms/isl.py", "comms/ledger.py", "comms/routing.py",
    "comms/environment.py",
    "core/propagation.py", "core/scheduling.py", "core/fedleo.py",
    "core/baselines.py",
    "compute/__init__.py", "compute/fleet.py", "compute/profiles.py",
    "compute/roofline.py",
    "multitenant/__init__.py", "multitenant/scheduler.py",
    "obs/decomposition.py", "obs/trace.py", "obs/utilization.py",
    "obs/_walltime.py", "obs/export.py", "obs/report.py",
    "analysis/sanitizer.py",
    "data/synthetic.py", "data/partition.py",
    "configs/__init__.py", "configs/base.py", "configs/constellations.py",
    "configs/gemma_7b.py", "configs/internvl2_26b.py", "configs/kimi_k2_1t_a32b.py",
    "configs/llama4_maverick_400b_a17b.py", "configs/mamba2_780m.py",
    "configs/minitron_8b.py", "configs/mistral_large_123b.py",
    "configs/phi3_medium_14b.py", "configs/seamless_m4t_large_v2.py",
    "configs/zamba2_1p2b.py",
]
# the example twins: each runs with jax and the reference blocked, with these
# arguments (train_arch cut to 4 steps)
TWINS = {
    "quickstart_torch": ["--device", "cpu"],
    "sota_comparison_torch": ["--fast", "--device", "cpu"],
    "train_arch_torch": ["--small", "--steps", "4", "--tau", "2", "--device", "cpu"],
    "serve_decode_torch": ["--device", "cpu"],
}
_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro(?=[.\s])", re.M)


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"] + [f"examples/{name}.py" for name in TWINS],
)
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imports(ROOT / path) if _banned(mod)]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_verbatim(rel):
    ref = (ROOT / "src" / "repro" / rel).read_text()
    ours = (PORT / rel).read_text()
    header = f"# Copied from src/repro/{rel}; imports rebound to repro_torch.\n"
    assert ours == header + _IMPORT.sub(r"\1repro_torch", ref)


_ISOLATED_RUN = textwrap.dedent("""
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import torch
    import repro_torch
    from repro_torch.core import FedLEO, FederatedTask, SimConfig, TrainHyperparams
    from repro_torch.data import make_classification_dataset, partition_noniid_by_orbit
    from repro_torch.models.cnn import apply_cnn, init_cnn
    from repro_torch.optim import get_optimizer

    train = make_classification_dataset("mnist-like", num_samples=400, seed=0)
    test = make_classification_dataset("mnist-like", num_samples=100, seed=99)
    task = FederatedTask(
        init_fn=lambda r: init_cnn(r, (28, 28, 1), 10, widths=(4,), hidden=8),
        apply_fn=apply_cnn, clients=partition_noniid_by_orbit(train, 5, 8),
        test_set=test, optimizer=get_optimizer("sgd", 0.05),
        hp=TrainHyperparams(batch_size=16), sim_epochs=1, device="cpu",
    )
    res = FedLEO(task, SimConfig(horizon_hours=72.0, use_kernel=True)).run(max_rounds=1)
    assert len(res.history) == 1 and res.history[0].t_hours > 0
    import os, tempfile
    import repro_torch.compute, repro_torch.multitenant
    from repro_torch.core.baselines import FedAvgStar
    from repro_torch.obs import export, report
    star = FedAvgStar(task, SimConfig(horizon_hours=72.0, use_kernel=True, trace=True))
    res_star = star.run(max_rounds=1)
    assert len(res_star.history) == 1 and res_star.history[0].t_hours > res.history[0].t_hours
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.jsonl")
        assert export.write_trace(star.recorder, path) > 0
        assert report.main([path]) == 0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, loaded
    print("ISOLATED-OK", res.history[0].t_hours)
""")


def test_port_runs_a_round_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED_RUN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-OK" in proc.stdout


_ISOLATED_SERVE = _ISOLATED_RUN[:_ISOLATED_RUN.index("import repro_torch")] + textwrap.dedent("""
    import repro_torch.configs, repro_torch.models.transformer, repro_torch.train.steps
    from repro_torch.configs import build_model, get_smoke_config, make_sim_config
    from repro_torch.train.steps import make_greedy_decode, make_prefill_step

    assert make_sim_config("paper-5x8").horizon_hours > 0
    cfg = get_smoke_config("gemma-7b")
    model = build_model(cfg, attn_impl="pallas", device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    logits = make_prefill_step(model)(params, {"tokens": tokens})
    cache = model.init_cache(2, 20)
    toks, cache = make_greedy_decode(model, 4)(params, tokens[:, :1], cache, 0)
    assert logits.shape == (2, cfg.vocab_size) and toks.shape == (2, 4)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, loaded
    print("ISOLATED-SERVE-OK")
""")


def test_serving_slice_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED_SERVE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-SERVE-OK" in proc.stdout


_ISOLATED_SSM = _ISOLATED_RUN[:_ISOLATED_RUN.index("import repro_torch")] + textwrap.dedent("""
    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.train.steps import make_greedy_decode, make_prefill_step

    for arch in ("mamba2-780m", "zamba2-1.2b"):
        cfg = get_smoke_config(arch)
        model = build_model(cfg, attn_impl="pallas", ssd_impl="pallas", device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                               generator=torch.Generator().manual_seed(1))
        logits = make_prefill_step(model)(params, {"tokens": tokens})
        cache = model.init_cache(2, 8)
        toks, cache = make_greedy_decode(model, 3)(params, tokens[:, :1], cache, 0)
        assert logits.shape == (2, cfg.vocab_size) and toks.shape == (2, 3)
        assert bool(torch.isfinite(logits.float()).all())
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, loaded
    print("ISOLATED-SSM-OK")
""")


def test_ssm_serving_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED_SSM], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-SSM-OK" in proc.stdout


_ISOLATED_ZOO = _ISOLATED_RUN[:_ISOLATED_RUN.index("import repro_torch")] + textwrap.dedent("""
    from repro_torch.configs import build_model, get_smoke_config
    from repro_torch.optim import get_optimizer
    from repro_torch.train.steps import (TrainState, make_greedy_decode, make_prefill_step,
                                         make_train_step)

    gen = torch.Generator().manual_seed(1)
    for arch in ("llama4-maverick-400b-a17b", "kimi-k2-1t-a32b", "internvl2-26b",
                 "seamless-m4t-large-v2"):
        cfg = get_smoke_config(arch)
        model = build_model(cfg, attn_impl="pallas", device="cpu")
        params = model.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)}
        if cfg.family == "vlm":
            batch["extra"] = torch.randn((2, cfg.vision.num_patches, cfg.d_model), generator=gen)
        if cfg.family == "audio":
            batch["source"] = torch.randn((2, 16, cfg.d_model), generator=gen)
            cache = model.init_cache(params, batch["source"], 8)
        else:
            cache = model.init_cache(2, 8)
        logits = make_prefill_step(model)(params, batch)
        toks, cache = make_greedy_decode(model, 3)(params, batch["tokens"][:, :1], cache, 0)
        assert logits.shape == (2, cfg.vocab_size) and toks.shape == (2, 3)
        assert bool(torch.isfinite(logits.float()).all())
        plain = build_model(cfg, dtype=torch.float32, device="cpu")
        opt = get_optimizer("sgd", 0.1)
        p32 = plain.init(torch.Generator().manual_seed(0))
        state = TrainState(p32, opt.init(p32), torch.zeros((), dtype=torch.int32))
        state, metrics = make_train_step(plain, opt)(state, batch)
        assert bool(torch.isfinite(metrics["total_loss"])) and int(state.step) == 1
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, loaded
    print("ISOLATED-ZOO-OK")
""")


def test_moe_vlm_and_encdec_run_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED_ZOO], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-ZOO-OK" in proc.stdout


_ISOLATED_TRAIN = _ISOLATED_RUN[:_ISOLATED_RUN.index("import repro_torch")] + textwrap.dedent("""
    import os, runpy, tempfile
    from repro_torch.ckpt import latest_step

    with tempfile.TemporaryDirectory() as tmp:
        sys.argv = ["train", "--arch", "mamba2-780m", "--smoke", "--fedleo", "--device", "cpu",
                    "--steps", "4", "--tau", "2", "--batch", "2", "--seq", "32",
                    "--ckpt-dir", tmp, "--ckpt-every", "2"]
        runpy.run_module("repro_torch.launch.train", run_name="__main__")
        assert latest_step(tmp) == 4, os.listdir(tmp)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, loaded
    print("ISOLATED-TRAIN-OK")
""")


def test_training_driver_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED_TRAIN], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-TRAIN-OK" in proc.stdout
    assert proc.stdout.count("[aggregated]") == 2


_ISOLATED_LAUNCH = _ISOLATED_RUN[:_ISOLATED_RUN.index("import repro_torch")] + textwrap.dedent("""
    from repro_torch.launch import calibrate, dryrun, mesh, sharding, specs
    from repro_torch.compute import DEVICE_TIERS, roofline

    cost = roofline.compiled_step_cost("mamba2-780m", "train_4k")
    assert cost.flops > 0 and cost.hbm_bytes > 0
    assert roofline.step_time_s("mamba2-780m", "train_4k", DEVICE_TIERS["orbital-gpu"],
                                mode="compiled") > 0
    assert calibrate.measure_smoke_step_s("mamba2-780m", seq_len=16, global_batch=2,
                                          iters=1, device="cpu") > 0
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, loaded
    print("ISOLATED-LAUNCH-OK")
""")


def test_compiled_mode_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED_LAUNCH], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-LAUNCH-OK" in proc.stdout


_ISOLATED_TWIN = _ISOLATED_RUN[:_ISOLATED_RUN.index("import torch")] + textwrap.dedent("""
    import runpy
    sys.argv = [sys.argv[1], *sys.argv[2:]]
    runpy.run_path(sys.argv[0], run_name="__main__")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not loaded, loaded
    print("ISOLATED-TWIN-OK")
""")


@pytest.mark.parametrize("name", sorted(TWINS))
def test_example_twin_runs_with_jax_and_reference_blocked(name):
    # one thread: the suite's workers share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _ISOLATED_TWIN, str(ROOT / "examples" / f"{name}.py"),
         *TWINS[name]],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-TWIN-OK" in proc.stdout
