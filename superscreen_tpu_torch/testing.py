"""Run the port's test suite from a checkout (counterpart of
``superscreen_tpu/testing.py``)."""

import glob
import os
import subprocess
import sys

__all__ = ["run"]


def run() -> int:
    """Runs the port's tests (``tests/test_torch_*.py``) via pytest with
    matplotlib's Agg backend; returns pytest's exit code.  The parity
    tests import the JAX package too; ``tests/test_torch_cuda.py`` needs a
    card and skips without one."""
    env = os.environ.copy()
    env["MPLBACKEND"] = "Agg"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    files = sorted(glob.glob(os.path.join(repo_root, "tests", "test_torch_*.py")))
    return subprocess.call([sys.executable, "-m", "pytest", *files, "-q"], env=env)
