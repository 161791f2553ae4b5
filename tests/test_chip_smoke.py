"""chip_smoke.py's contract where there is no GPU: it refuses to run and
prints no result; its result line has exactly the keys the card run
reports."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )


def _has_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return isinstance(json.loads(lines[-1]), dict)
    except ValueError:
        return False


def test_refuses_the_cpu(tmp_path):
    proc = _run(REPO, tmp_path)
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)
    assert "needs a GPU" in proc.stderr


def test_fails_without_the_repo(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    proc = _run(str(alone), tmp_path)
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)


def test_result_line_format():
    sys.path.insert(0, REPO)
    import chip_smoke

    class _Dev:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    line = chip_smoke.result_line([_Dev()])
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
    }
