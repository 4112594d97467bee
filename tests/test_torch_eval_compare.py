"""The compare experiment (Auncel against the ELP and LAET baselines): a
port-only run on synth10K with the invariants of the harness's other
experiments, and ``compare.run`` in both packages on one workload.

In the parity test the JAX run goes first, in its own process: the port's
run starts once the JAX run has written the centroid cache and loads that
cache (k-means in the port fails the test). ELP picks the cheapest point
by its measured time, and two points of equal recall may swap places by
timing noise, so both runs charge each point its nprobe instead of its
seconds: ELP's pick is then the smallest nprobe that meets the bound in
both packages, which the test holds equal. LAET's rows are held only to
their shape: the two packages' MLPs start from different draws (JAX's
PRNG and torch's generator), and even from one shared init their trained
parameters differ by about 6e-7 (fp32 contraction order,
tests/test_torch_laet.py), which moves a query's predicted nprobe across
a rounding boundary and so its probes and recall."""

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
              nlist=32, max_topk=50, reps=1)
STORAGES = ("f32", "sq8")

# run in each package's process: the cost of an ELP point is its nprobe,
# and the Auncel calibration's (multipler, std_m) is recorded
PATCHES = """
def _nprobe_cost(autotune):
    real = autotune.OperatingPoints.add

    def add(self, pt):
        n = float(dict(p.split("=") for p in pt.key.split(","))["nprobe"])
        real(self, autotune.OperatingPoint(pt.key, pt.perf, n))
    autotune.OperatingPoints.add = add


def _record_calibration(error_sys, seen):
    real = error_sys.ErrorSys.calibrate

    def calibrate(self, *a, **kw):
        out = real(self, *a, **kw)
        seen.update(multipler=float(self.multipler), std_m=float(self.std_m))
        return out
    error_sys.ErrorSys.calibrate = calibrate
"""


def _start_jax_run(cwd: Path, storage: str, err) -> subprocess.Popen:
    code = (PATCHES
            + "import json\n"
            "import auncel_tpu.autotune as autotune\n"
            "import auncel_tpu.profile.error_sys as error_sys\n"
            "from auncel_tpu.eval_harness import common, compare\n"
            "seen = {}\n"
            "_nprobe_cost(autotune)\n"
            "_record_calibration(error_sys, seen)\n"
            "real_build = common.build_or_load_index\n"
            "def build(*a, **kw):\n"
            "    idx = real_build(*a, **kw)\n"
            "    print('index built', file=sys.stderr, flush=True)\n"
            "    return idx\n"
            "common.build_or_load_index = build\n"
            f"rows = compare.run(log_dir='jax', storage={storage!r}, "
            f"**{CONFIG!r})\n"
            "print(json.dumps(dict(rows=rows, **seen)))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    return subprocess.Popen([sys.executable, "-c", "import sys\n" + code],
                            cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=err, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both storages' JAX runs, started together, and the port's run in
    each one's directory once that run has written the centroid cache:
    {storage: (JAX process, its directory, its stderr file, the port's
    rows, the port's calibration)}."""
    import auncel_tpu_torch.autotune as autotune
    import auncel_tpu_torch.profile.error_sys as error_sys
    from auncel_tpu_torch.eval_harness import compare
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    procs = {}
    out = {}

    def no_kmeans(*a, **k):
        pytest.fail("the port trained k-means instead of loading the "
                    "JAX-written cache")
    try:
        for storage in STORAGES:
            cwd = tmp_path_factory.mktemp(f"compare_{storage}")
            for sub in ("jax", "port"):
                (cwd / sub).mkdir()
            err = cwd / "jax.err"
            with open(err, "w") as f:
                procs[storage] = (_start_jax_run(cwd, storage, f), cwd, err)
        patches = {}
        exec(PATCHES, patches)
        for storage, (proc, cwd, err) in procs.items():
            t0 = time.monotonic()
            while ("index built" not in err.read_text()
                   and proc.poll() is None and time.monotonic() - t0 < 300):
                time.sleep(0.2)
            stag = "Flat" if storage == "f32" else storage.upper()
            cache = (cwd / "trained_index"
                     / f"synth10K_IVF32,{stag}_trained.npz")
            assert cache.exists(), err.read_text()
            seen = {}
            with pytest.MonkeyPatch.context() as m:
                m.chdir(cwd)
                m.setattr(IVFFlatIndex, "train", no_kmeans)
                m.setattr(autotune.OperatingPoints, "add",
                          autotune.OperatingPoints.add)
                m.setattr(error_sys.ErrorSys, "calibrate",
                          error_sys.ErrorSys.calibrate)
                patches["_nprobe_cost"](autotune)
                patches["_record_calibration"](error_sys, seen)
                rows = compare.run(log_dir="port", storage=storage,
                                   device=DEVICE, **CONFIG)
            out[storage] = (proc, cwd, err, rows, seen)
        yield out
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# first in the file, so that the JAX runs go on while this one runs
@pytest.mark.usefixtures("runs")
def test_compare_end_to_end(tmp_path):
    from auncel_tpu_torch.eval_harness import compare
    rows = compare.run(db="synth10K", ts=100, ses=50, input_k=10,
                       nlist=64, max_topk=50, log_dir=str(tmp_path),
                       reps=1, device=DEVICE)
    names = [r["system"] for r in rows]
    assert names[0] == "auncel" and names[1] == "elp"
    assert names[-2:] == ["laet", "laet_worst"]
    by = {r["system"]: r for r in rows}
    assert by["auncel"]["min_recall"] >= 0.9
    assert 1 <= by["elp"]["mean_probes"] <= 64
    assert all(r["qps"] > 0 and 0 <= r["min_recall"] <= r["mean_recall"]
               <= 1 for r in rows)
    lines = (tmp_path / "Compare_synth10K.log").read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == names
    assert all(len(ln.split()) == 5 for ln in lines)


@pytest.mark.parametrize("storage", STORAGES)
def test_compare_run_matches_jax(runs, storage):
    proc, cwd, err, rows, seen = runs[storage]
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, err.read_text()
    ref = json.loads(out.strip().splitlines()[-1])
    got = {r["system"]: r for r in rows}
    want = {r["system"]: r for r in ref["rows"]}
    assert list(got) == list(want)
    for name in ("elp", "elp_margin"):
        if name in want:
            assert got[name]["mean_probes"] == want[name]["mean_probes"]
    for key in ("mean_probes", "min_recall", "mean_recall"):
        assert got["auncel"][key] == want["auncel"][key], key
    assert got["auncel"]["min_recall"] >= 0.9
    assert seen["std_m"] == ref["std_m"]
    assert seen["multipler"] == pytest.approx(ref["multipler"], rel=1e-5)
    for name in ("laet", "laet_worst"):
        r = got[name]
        assert set(r) == set(want[name])
        assert r["qps"] > 0 and 1 <= r["mean_probes"] <= CONFIG["nlist"]
        assert 0 <= r["min_recall"] <= r["mean_recall"] <= 1
    lines = (cwd / "port" / "Compare_synth10K.log").read_text().splitlines()
    assert [ln.split()[0] for ln in lines] == list(want)
