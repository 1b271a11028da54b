"""The benchmark's tests: ``python -m pytest bench/tests`` from the root of
the checkout (the repository's own tests, under ``tests/``, do not
collect them).  Tests that need the card carry the ``cuda`` marker and
skip elsewhere."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
