"""Execute every tutorial of the port end to end on the CPU.

Each script of ``diffdrr_tpu_torch/tutorials`` runs in a subprocess with
``--cpu``, as a user would run it, and must exit 0 and print
``all checks passed`` (its own assertions fail it otherwise). Marked
``slow``, as ``tests/test_tutorials.py`` is.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

TUTORIALS = sorted(
    (Path(__file__).resolve().parent.parent / "diffdrr_tpu_torch" / "tutorials").glob("*.py"))


def test_there_are_nine():
    assert [p.name[:2] for p in TUTORIALS] == [f"{i:02d}" for i in range(1, 10)]


@pytest.mark.slow
@pytest.mark.parametrize("script", TUTORIALS, ids=lambda p: p.stem)
def test_tutorial_runs(script):
    # Two threads a script unless the caller set it: several workers each
    # running a script with a thread per core oversubscribe the cores.
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "2")
    proc = subprocess.run([sys.executable, str(script), "--cpu"], capture_output=True,
                          text=True, timeout=1200, env=env)
    assert proc.returncode == 0, (
        f"{script.name} failed\n--- stdout ---\n{proc.stdout[-3000:]}"
        f"\n--- stderr ---\n{proc.stderr[-3000:]}")
    assert "all checks passed" in proc.stdout
