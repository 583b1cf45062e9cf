"""chip_smoke.py refuses to run anywhere but on a GPU: without one it
exits non-zero at once and prints no result line."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).parent.parent


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_smoke_refuses_cpu(tmp_path, where):
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    p = subprocess.run(
        [sys.executable, str(script)], cwd=script.parent, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr
