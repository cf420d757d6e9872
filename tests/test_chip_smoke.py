"""chip_smoke.py's contract where it can be checked without a GPU: it
refuses to run on the CPU (exit code != 0, no result line) and its result
line has exactly the agreed shape."""

import json
import os
import subprocess
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_refuses_the_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_result_line_shape():
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }
    assert json.loads(chip_smoke.result_line([dev] * 4))["device"]["count"] == 4
