"""Offline test bootstrap: when the real `hypothesis` package is not
installed (this container has no network), register the deterministic
shim from `_hypothesis_stub.py` under its name before test modules
import it."""
import sys
from pathlib import Path

try:
    import hypothesis  # noqa: F401  (real package wins when present)
except ModuleNotFoundError:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import _hypothesis_stub

    _hypothesis_stub.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")
