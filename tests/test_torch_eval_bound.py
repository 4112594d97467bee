"""``bound.run`` in both packages on one workload, the JAX run first: the
port's run starts once the JAX run has written the centroid cache (the
JAX run goes on in its own process) and loads that cache; both give equal
decisions (worst-case recall, mean lists scanned, the calibrated
multipler)."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from torch_parity import DEVICE

REPO = Path(__file__).resolve().parent.parent
CONFIG = dict(db="synth10K", ts=100, ses=60, input_k=10, error_bound=0.10,
              nlist=32, max_topk=50, batch_latency=2)
KEYS = ("bound_ok", "min_recall", "mean_nscan", "multipler", "std_m",
        "multirow_rows")


def _start_jax_run(cwd: Path, err) -> subprocess.Popen:
    code = ("import json, sys\n"
            "from auncel_tpu.eval_harness import bound\n"
            f"r = bound.run(log_dir='jax', **{CONFIG!r})\n"
            f"print(json.dumps({{k: r[k] for k in {KEYS!r}}}))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    return subprocess.Popen([sys.executable, "-c", code], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=err, text=True)


def test_bound_run_matches_jax(tmp_path, monkeypatch):
    from auncel_tpu_torch.eval_harness import bound
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    monkeypatch.chdir(tmp_path)
    for sub in ("jax", "port"):
        (tmp_path / sub).mkdir()
    err_path = tmp_path / "jax.err"
    with open(err_path, "w") as err:
        proc = _start_jax_run(tmp_path, err)
    try:
        # the JAX run logs "index built" after it has written the cache
        t0 = time.monotonic()
        while ("index built" not in err_path.read_text()
               and proc.poll() is None and time.monotonic() - t0 < 300):
            time.sleep(0.2)
        cache = tmp_path / "trained_index" / "synth10K_IVF32,Flat_trained.npz"
        assert cache.exists(), err_path.read_text()

        def no_kmeans(*a, **k):
            pytest.fail("the port trained k-means instead of loading the "
                        "JAX-written cache")
        monkeypatch.setattr(IVFFlatIndex, "train", no_kmeans)
        got = bound.run(log_dir="port", device=DEVICE, **CONFIG)
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err_path.read_text()
    ref = json.loads(out.strip().splitlines()[-1])
    assert got["bound_ok"] and ref["bound_ok"]
    assert got["min_recall"] == ref["min_recall"]
    assert got["mean_nscan"] == ref["mean_nscan"]
    assert got["multipler"] == pytest.approx(ref["multipler"], rel=1e-5)
    assert got["std_m"] == ref["std_m"]
    assert got["multirow_rows"] == ref["multirow_rows"]
    lat = np.loadtxt(tmp_path / "port" / "Auncel_Latency_synth10K_10_10.log")
    assert lat.shape == (2,) and np.all(lat > 0)
