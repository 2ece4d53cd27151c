import os
import sys

# tests see ONE cpu device (the dry-run sets 512 in its own process only)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips without one")
