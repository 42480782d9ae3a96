"""The benchmark's own CPU tests: python -m pytest perfbench/tests -q
(they import neither JAX nor the repository's tests/)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent))
