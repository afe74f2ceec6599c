"""Tests of the benchmark's harness, run on the CPU from the root of
the checkout:

    python3 -m pytest portbench/tests -q

They import the port (``valle_tpu_torch``) as the harness does; the
reference under ``portbench/reference`` stays free of it."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
