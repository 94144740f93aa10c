"""The benchmark's own tests: its modules are importable as the harness
imports them (``benchmark/`` on the path)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
