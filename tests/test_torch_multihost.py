"""Two gloo ranks on the CPU (the twin of ``tests/test_multihost.py``):
``python -m auncel_tpu_torch.parallel.distributed`` spawns them, merges a
row-sharded exact top-4 by the all_gather, checks it against a local exact
search and runs one global sum."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_multihost_smoke():
    p = subprocess.run([sys.executable, "-m",
                        "auncel_tpu_torch.parallel.distributed"],
                       cwd=REPO, capture_output=True, timeout=300)
    out = p.stdout.decode() + p.stderr.decode()
    assert p.returncode == 0, out
    assert "rank 0: ok" in out and "rank 1: ok" in out
    assert "multihost smoke: PASS" in out
