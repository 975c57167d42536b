import os
import sys

# Tests run on the single real CPU device; kernels run in interpret mode.
# (The 512-device dry-run sets XLA_FLAGS only inside launch/dryrun.py.)
os.environ.setdefault("REPRO_KERNELS", "interpret")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where there is none")
