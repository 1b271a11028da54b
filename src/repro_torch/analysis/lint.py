"""The port's static lint over ``src/repro_torch``:
``python -m repro_torch.analysis.lint [paths...]``.

The counterpart of ``src/repro/analysis/lint.py``: the same five AST
rules, each over the port's own files, keyed on paths relative to the
directory that holds the ``repro_torch`` package.

  ledger-encapsulation   ``GSResourceLedger`` bookings change
                         (``reserve``, ``release``, ``release_booking``,
                         ``release_before`` on a receiver named like a
                         ledger) only in the ledger, in
                         ``CommsEnvironment`` and in the legacy
                         ``reserve_transfer`` shim; the rest books
                         through the session, so that the sanitizer and
                         the release listeners see every booking.
  deprecated-shim        nothing but ``core/scheduling.py`` calls the
                         legacy free-function shims (``select_sink``,
                         ``reserve_decision``, ...), by name or through
                         the scheduling module.
  unit-suffix            a numeric field of a dataclass in the
                         scheduling files names its unit (``_s``,
                         ``_bits``, ``_hz``, ...) or is in the exemption
                         table below.
  wall-clock             no wall-clock read (``time.time`` and the like)
                         in the simulation packages; the one sanctioned
                         shim is ``repro_torch/obs/_walltime.py``, which
                         stamps exported trace files.
  annotation             every function of the simulation and config
                         packages annotates its parameters and its
                         return.

Exits 1 when it reports a finding, 0 on a clean tree.
"""
from __future__ import annotations

import ast
import dataclasses
import sys
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Set, Tuple

PACKAGE = "repro_torch"


def _in_package(*paths: str) -> Tuple[str, ...]:
    return tuple(f"{PACKAGE}/{p}" for p in paths)


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str                   # relative to the directory holding the package, "/"-separated
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


# ledger-encapsulation: who may change a booking, and how
LEDGER_MUTATORS = frozenset({"reserve", "release", "release_booking", "release_before"})
LEDGER_OWNERS = _in_package("comms/ledger.py", "comms/environment.py")
LEDGER_OWNER_FUNCTIONS = frozenset({(f"{PACKAGE}/core/scheduling.py", "reserve_transfer")})

# deprecated-shim: the legacy free functions of the scheduling module
SCHEDULING_FILE = f"{PACKAGE}/core/scheduling.py"
SCHEDULING_MODULE = f"{PACKAGE}.core.scheduling"
LEGACY_SHIMS = frozenset({
    "earliest_transfer", "select_sink", "select_sink_cluster", "naive_sink_slot",
    "first_visible_download", "first_visible_download_sats", "reserve_transfer",
    "reserve_decision",
})

# unit-suffix: the files whose dataclasses hold scheduling quantities
UNIT_FILES = _in_package(
    "comms/environment.py", "comms/isl.py", "comms/link.py", "comms/ledger.py",
    "comms/routing.py", "core/scheduling.py", "core/engine.py",
)
UNIT_SUFFIXES = ("_s", "_bits", "_hz", "_bps", "_hours", "_m", "_deg", "_dbm", "_dbi",
                 "_k", "_db", "_fraction", "_factor", "_index", "_slot", "_mb")
UNIT_PREFIXES = ("t_", "num_")
# fields without a unit suffix, each with the reason it needs none
UNIT_EXEMPT: Dict[str, str] = {
    "rid": "opaque reservation id",
    "seed": "RNG seed, dimensionless",
    "plane": "topology coordinate, not a quantity",
    "bits": "the field is the unit (a TransferSegment's payload)",
    "candidates_considered": "plain count",
    "spectral_efficiency": "the link budget's standard name (bit/s/Hz)",
    "noniid_alpha": "dimensionless mixing blend",
    "gs_rb_capacity": "resource blocks per station",
    "window_start": "absolute seconds; a legacy TransferSegment field",
    "window_end": "absolute seconds; a legacy TransferSegment field",
}
NUMERIC_ANNOTATIONS = frozenset({
    "int", "float", "Optional[int]", "Optional[float]", "int | None", "float | None",
    "Optional[Union[int, Sequence[int]]]",
})

# wall-clock: the packages that run on the simulated clock
SIMULATION_PACKAGES = _in_package("core/", "comms/", "orbits/", "obs/", "compute/",
                                  "multitenant/")
WALL_CLOCK_SHIM = f"{PACKAGE}/obs/_walltime.py"
WALL_CLOCK_READS = frozenset({
    ("time", "time"), ("time", "perf_counter"), ("time", "monotonic"),
    ("time", "process_time"), ("time", "time_ns"),
    ("datetime", "now"), ("datetime", "today"), ("datetime", "utcnow"),
})

# annotation: the packages held to full annotations (mypy's disallow_untyped_defs)
ANNOTATED_PACKAGES = _in_package("comms/", "configs/", "core/", "obs/", "orbits/",
                                 "compute/", "multitenant/")

_Functions = (ast.FunctionDef, ast.AsyncFunctionDef)


def _calls(tree: ast.Module) -> Iterator[ast.Call]:
    return (node for node in ast.walk(tree) if isinstance(node, ast.Call))


def _innermost_functions(tree: ast.Module) -> Dict[ast.AST, str]:
    """Each node's innermost enclosing function name ("<module>" at top level)."""
    names: Dict[ast.AST, str] = {}
    stack: List[Tuple[ast.AST, str]] = [(tree, "<module>")]
    while stack:
        node, name = stack.pop()
        if isinstance(node, _Functions):
            name = node.name
        for child in ast.iter_child_nodes(node):
            names[child] = name
            stack.append((child, name))
    return names


def ledger_encapsulation(rel: str, tree: ast.Module) -> Iterator[Finding]:
    if rel in LEDGER_OWNERS:
        return
    functions = _innermost_functions(tree)
    for call in _calls(tree):
        func = call.func
        if not isinstance(func, ast.Attribute) or func.attr not in LEDGER_MUTATORS:
            continue
        receiver = ast.unparse(func.value)
        if "ledger" not in receiver.lower():
            continue
        if (rel, functions.get(call, "<module>")) in LEDGER_OWNER_FUNCTIONS:
            continue
        yield Finding(rel, call.lineno, "ledger-encapsulation",
                      f"direct ledger mutation `{receiver}.{func.attr}(...)` — book through "
                      "CommsEnvironment.commit/release so the session (and its sanitizer) "
                      "owns every reservation")


def _shim_bindings(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    """The names bound to a legacy shim, and those bound to the
    scheduling module (``import ... as S``, or ``S = _sched()``)."""
    shims: Set[str] = set()
    modules: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == SCHEDULING_MODULE:
            shims.update(a.asname or a.name for a in node.names if a.name in LEGACY_SHIMS)
        elif isinstance(node, ast.Import):
            modules.update(a.asname or a.name.split(".")[0] for a in node.names
                           if a.name == SCHEDULING_MODULE)
        elif (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
              and isinstance(node.value.func, ast.Name) and node.value.func.id == "_sched"):
            modules.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return shims, modules


def deprecated_shim(rel: str, tree: ast.Module) -> Iterator[Finding]:
    if rel == SCHEDULING_FILE:
        return
    shims, modules = _shim_bindings(tree)
    for call in _calls(tree):
        func = call.func
        if isinstance(func, ast.Name) and func.id in shims:
            name = func.id
        elif (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
              and func.value.id in modules and func.attr in LEGACY_SHIMS):
            name = func.attr
        else:
            continue
        yield Finding(rel, call.lineno, "deprecated-shim",
                      f"call to legacy scheduling shim `{name}` — use the CommsEnvironment "
                      "session API instead")


def _names_its_unit(field: str) -> bool:
    return (field in UNIT_EXEMPT or field.endswith(UNIT_SUFFIXES)
            or field.startswith(UNIT_PREFIXES))


def unit_suffix(rel: str, tree: ast.Module) -> Iterator[Finding]:
    if rel not in UNIT_FILES:
        return
    for cls in ast.walk(tree):
        if not (isinstance(cls, ast.ClassDef)
                and any("dataclass" in ast.unparse(d) for d in cls.decorator_list)):
            continue
        for stmt in cls.body:
            if not (isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name)
                    and ast.unparse(stmt.annotation) in NUMERIC_ANNOTATIONS):
                continue
            if not _names_its_unit(stmt.target.id):
                yield Finding(rel, stmt.lineno, "unit-suffix",
                              f"numeric field `{cls.name}.{stmt.target.id}` carries no unit "
                              "suffix (_s/_bits/_hz/_bps/...) and is not in the lint "
                              "exemption table")


def wall_clock(rel: str, tree: ast.Module) -> Iterator[Finding]:
    if not rel.startswith(SIMULATION_PACKAGES) or rel == WALL_CLOCK_SHIM:
        return
    for call in _calls(tree):
        func = call.func
        if (isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name)
                and (func.value.id, func.attr) in WALL_CLOCK_READS):
            yield Finding(rel, call.lineno, "wall-clock",
                          f"wall-clock read `{func.value.id}.{func.attr}()` in the simulation "
                          "path — the simulated clock is the only clock here")


def _unannotated(args: ast.arguments) -> List[str]:
    positional = args.posonlyargs + args.args
    if positional and positional[0].arg in ("self", "cls"):
        positional = positional[1:]
    every = positional + args.kwonlyargs + [a for a in (args.vararg, args.kwarg) if a]
    return [a.arg for a in every if a.annotation is None]


def annotation(rel: str, tree: ast.Module) -> Iterator[Finding]:
    if not rel.startswith(ANNOTATED_PACKAGES):
        return
    for fn in ast.walk(tree):
        if not isinstance(fn, _Functions):
            continue
        missing = _unannotated(fn.args)
        if missing:
            yield Finding(rel, fn.lineno, "annotation",
                          f"`{fn.name}` has unannotated parameter(s): {', '.join(missing)}")
        if fn.returns is None and fn.name != "__init__":
            yield Finding(rel, fn.lineno, "annotation", f"`{fn.name}` has no return annotation")


RULES: Tuple[Callable[[str, ast.Module], Iterator[Finding]], ...] = (
    ledger_encapsulation, deprecated_shim, unit_suffix, wall_clock, annotation,
)


def _anchor(path: Path) -> Path:
    """The directory holding the ``repro_torch`` package that ``path``
    lies in (or, outside one, the path's own directory)."""
    path = path.resolve()
    for ancestor in (path, *path.parents):
        if ancestor.name == PACKAGE:
            return ancestor.parent
    return path if path.is_dir() else path.parent


def _relative(path: Path, anchors: Sequence[Path]) -> str:
    resolved = path.resolve()
    for anchor in anchors:
        if resolved.is_relative_to(anchor):
            return resolved.relative_to(anchor).as_posix()
    return path.as_posix()


def lint_file(path: Path, anchors: Sequence[Path]) -> List[Finding]:
    rel = _relative(path, anchors)
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as exc:
        return [Finding(rel, exc.lineno or 0, "syntax", f"unparseable: {exc.msg}")]
    return [finding for rule in RULES for finding in rule(rel, tree)]


def python_files(paths: Iterable[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    return files


def run_lint(paths: Sequence[Path]) -> Tuple[List[Finding], int]:
    """(findings sorted by path, line and rule; files read) over every
    Python file under ``paths``, wherever the command runs from."""
    anchors = [_anchor(p) for p in paths]
    files = python_files(paths)
    findings = [f for path in files for f in lint_file(path, anchors)]
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule)), len(files)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    paths = [Path(a) for a in args] or [Path(__file__).resolve().parent.parent]
    findings, n_files = run_lint(paths)
    for finding in findings:
        print(finding)
    print(f"lint: {n_files} files, {len(findings)} finding(s)", file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
