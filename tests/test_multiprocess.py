"""TRUE multi-process multi-host validation (SURVEY.md §2.8, ROADMAP #6).

Everything else in the suite emulates 8 devices inside one process; this
test spawns two REAL OS processes (4 CPU devices each) connected via
``jax.distributed`` (gRPC coordinator, Gloo collectives standing in for
the network between hosts) and runs the full adversarial G+D jitted step
over the ``('host', 'local')`` mesh with per-process input feeding — asserting the
distributed losses equal the single-device step at rel 1e-5 (the check
itself lives in ``scripts/multihost_check.py``).
"""

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_multihost_adversarial_step():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, os.path.join(_REPO, "scripts",
                                      "multihost_check.py")],
        env=env, capture_output=True, timeout=600)
    out = r.stdout.decode() + r.stderr.decode()
    assert r.returncode == 0, out[-3000:]
    assert "MULTIHOST OK" in out, out[-3000:]
