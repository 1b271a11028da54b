"""repro_torch.analysis.lint against the reference's lint.

  * Twins of ``tests/test_lint.py``: each AST rule fires on a minimal
    violation planted under ``repro_torch/`` and stays quiet on its
    compliant twin (one parametrised case per snippet), the legacy
    booking shim keeps its mutation, the CLI's exit codes and the
    finding's text.
  * Parity: every snippet, planted under ``repro/`` for the reference's
    lint and under ``repro_torch/`` for the port's (imports renamed),
    gives the same (rule, line) findings from both.
  * The port's own tree is clean.
"""
import textwrap
from pathlib import Path

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis import lint

SRC_ROOT = Path(__file__).resolve().parent.parent / "src"

# (case, path inside the package, snippet, the rules it must raise, in
# order, and a text the first finding's message must hold)
CASES = [
    ("ledger-mutation-outside-session", "core/foo.py", """
        def book(ledger: object) -> None:
            ledger.reserve(0, 1.0, 2.0)
    """, ["ledger-encapsulation"], "CommsEnvironment.commit"),
    ("ledger-mutation-in-owner-file", "comms/environment.py", """
        def commit(self, legs: object) -> None:
            for gi, t0, t1 in legs:
                self.ledger.reserve(gi, t0, t1)
    """, [], None),
    ("ledger-read", "core/foo.py", """
        def fit(ledger: object) -> float:
            return ledger.earliest_fit(0, 1.0, 2.0, 0.5)
    """, [], None),
    ("shim-call", "core/foo.py", """
        from PKG.core.scheduling import earliest_transfer

        def plan(**kw: object) -> None:
            earliest_transfer(**kw)
    """, ["deprecated-shim"], "earliest_transfer"),
    ("shim-alias-and-module-call", "orbits/foo.py", """
        import PKG.core.scheduling as sched
        from PKG.core.scheduling import select_sink as pick

        def plan(**kw):
            pick(**kw)
            sched.naive_sink_slot(None, 0, 0.0)
    """, ["annotation", "annotation", "deprecated-shim", "deprecated-shim"], None),
    ("shim-lazy-module-call", "core/foo.py", """
        def plan(x: int) -> None:
            S = _sched()
            S.reserve_decision(x)
    """, ["deprecated-shim"], "reserve_decision"),
    ("shim-import-alone", "core/foo.py", """
        from PKG.core.scheduling import earliest_transfer, select_sink
    """, [], None),
    ("unitless-numeric-field", "comms/link.py", """
        import dataclasses

        @dataclasses.dataclass(frozen=True)
        class Budget:
            duration: float
            bandwidth_hz: float = 1.0e6
            t_start: float = 0.0
            gs_index: int = 0
    """, ["unit-suffix"], "Budget.duration"),
    ("unit-rule-outside-scheduling-files", "models/foo.py", """
        import dataclasses

        @dataclasses.dataclass
        class Widths:
            hidden: int = 32
    """, [], None),
    ("unit-exempt-fields", "comms/ledger.py", """
        import dataclasses

        @dataclasses.dataclass
        class Rec:
            rid: int
            seed: int = 0
            plane: int = 0
    """, [], None),
    ("wall-clock-in-sim-package", "orbits/foo.py", """
        import time

        def now() -> float:
            return time.time()
    """, ["wall-clock"], "time.time()"),
    ("wall-clock-outside-sim-packages", "launch/foo.py", """
        import time

        def now() -> float:
            return time.perf_counter()
    """, [], None),
    ("wall-clock-shim", "obs/_walltime.py", """
        import datetime

        def stamp() -> str:
            return str(datetime.now())
    """, [], None),
    ("unannotated-def", "core/foo.py", """
        def f(x, y: int):
            return x
    """, ["annotation", "annotation"], "unannotated parameter(s): x"),
    ("annotated-def-and-init", "core/foo.py", """
        class C:
            def __init__(self, x: int):
                self.x = x

            def get(self) -> int:
                return self.x
    """, [], None),
    ("annotation-skips-learning-substrate", "models/foo.py", """
        def f(x):
            return x
    """, [], None),
    ("annotation-covers-orbits", "orbits/foo.py", """
        def f(x):
            return x
    """, ["annotation", "annotation"], "unannotated parameter(s): x"),
    ("syntax-error", "core/foo.py", "def broken(:\n", ["syntax"], "unparseable"),
]


def _plant(root: Path, package: str, rel: str, code: str) -> Path:
    f = root / package / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(code).replace("PKG.", f"{package}."))
    return root / package


def run_on(tmp_path, rel, code):
    """The port's lint over one snippet planted at ``repro_torch/rel``."""
    findings, n_files = lint.run_lint([_plant(tmp_path, "repro_torch", rel, code)])
    assert n_files == 1
    return findings


def rules(findings):
    return [f.rule for f in findings]


@pytest.mark.parametrize("name,rel,code,expected,text", CASES, ids=[c[0] for c in CASES])
def test_rule_on_snippet(tmp_path, name, rel, code, expected, text):
    findings = run_on(tmp_path, rel, code)
    assert rules(findings) == expected
    if text is not None:
        assert text in findings[0].message
    assert all(f.path == f"repro_torch/{rel}" for f in findings)


@pytest.mark.parametrize("name,rel,code,expected,text", CASES, ids=[c[0] for c in CASES])
def test_same_findings_as_reference(tmp_path, name, rel, code, expected, text):
    ref, n_ref = ref_lint.run_lint([_plant(tmp_path / "ref", "repro", rel, code)])
    ours, n_ours = lint.run_lint([_plant(tmp_path / "port", "repro_torch", rel, code)])
    assert n_ref == n_ours == 1
    assert [(f.rule, f.line) for f in ours] == [(f.rule, f.line) for f in ref]
    assert [f.message for f in ours] == [f.message for f in ref]


def test_reserve_transfer_shim_grandfathered():
    """The one legacy booking function keeps its direct mutation."""
    findings, n_files = lint.run_lint([SRC_ROOT / "repro_torch" / "core" / "scheduling.py"])
    assert n_files == 1
    assert "ledger-encapsulation" not in rules(findings)


def test_finding_str_format(tmp_path):
    findings = run_on(tmp_path, "core/foo.py", """
        def f(x):
            return x
    """)
    assert str(findings[0]).startswith("repro_torch/core/foo.py:2: [annotation]")


def test_cli_exit_codes(tmp_path, capsys):
    ok = tmp_path / "repro_torch" / "core"
    ok.mkdir(parents=True)
    (ok / "good.py").write_text("def f(x: int) -> int:\n    return x\n")
    assert lint.main([str(tmp_path / "repro_torch")]) == 0
    (ok / "bad.py").write_text("def f(x):\n    return x\n")
    assert lint.main([str(tmp_path / "repro_torch")]) == 1
    assert "lint: 2 files, 2 finding(s)" in capsys.readouterr().err


def test_port_tree_is_clean():
    """The port's own tree has no finding (the reference's gate, held
    here for ``src/repro_torch``)."""
    findings, n_files = lint.run_lint([SRC_ROOT / "repro_torch"])
    assert n_files > 80
    assert findings == [], "\n".join(str(f) for f in findings)


def test_module_runs_on_its_own_package(capsys):
    assert lint.main([]) == 0
    assert "0 finding(s)" in capsys.readouterr().err
