"""The benchmark's own tests: CPU tests at small sizes, and tests marked
`card` that need a CUDA device and skip without one (decided inside the
test). Run from the repo's root: python -m pytest phybench/tests -q"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device; skips without one")
