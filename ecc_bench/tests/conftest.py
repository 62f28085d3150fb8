"""The harness's tests, on the CPU at a tiny size: ``src`` and the
checkout's root on the path, as ``python -m pytest`` from the root with
``PYTHONPATH=src`` has them."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
