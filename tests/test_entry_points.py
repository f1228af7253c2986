"""The measurement entry points refuse to run without a GPU, and the main
path imports neither ``h5py`` nor ``orbax``."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _json_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_entry_point_exits_nonzero_without_gpu(script):
    r = _run([os.path.join(ROOT, script)])
    assert r.returncode != 0
    assert _json_lines(r.stdout) == []
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it fails before printing a result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run([str(tmp_path / "chip_smoke.py")], cwd=str(tmp_path))
    assert r.returncode != 0
    assert _json_lines(r.stdout) == []


def test_main_path_imports_neither_h5py_nor_orbax():
    code = (
        "import sys\n"
        "import bench, chip_smoke\n"
        "from adversarial_learning_on_pointclouds.train import "
        "adversarial, runner\n"
        "from adversarial_learning_on_pointclouds.data import "
        "synthetic_shapenet\n"
        "synthetic_shapenet(num_shapes=8, num_points=16)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('h5py', 'orbax'))\n"
        "assert not bad, bad\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]
