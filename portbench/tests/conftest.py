"""The harness's modules import as top-level names (``run.py`` puts
``portbench/`` and the repository's root on the path); the tests do the
same."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent, HERE.parent.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
