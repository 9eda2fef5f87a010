"""The benchmark's tests: on the CPU at small sizes, and, marked ``cuda``,
on a card at the cells' own sizes (they skip without one):

    python -m pytest -p no:cacheprovider perfbench/tests
"""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the cells at their own "
        "sizes); skips without one")
