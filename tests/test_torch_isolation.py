"""repro_torch stands alone: it imports neither jax nor the reference
package, and its copied numpy modules stay verbatim copies.

  * A subprocess blocks ``jax*`` and ``repro``/``repro.*`` in
    ``sys.meta_path``, imports repro_torch and runs one CPU FedLEO round.
  * An AST scan of every module of the port and of ``chip_smoke.py``
    finds no import of jax or of the reference package.
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
    "obs/decomposition.py", "obs/trace.py", "obs/utilization.py",
    "analysis/sanitizer.py",
    "data/synthetic.py", "data/partition.py",
]
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
    + ["chip_smoke.py"],
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
