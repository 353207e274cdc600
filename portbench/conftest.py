"""pytest settings of the benchmark's own tests (``portbench/tests``):
the repository's root on the path and the ``card`` marker, for tests
that need a CUDA card; each decides inside the test whether there is
one and skips without."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")
