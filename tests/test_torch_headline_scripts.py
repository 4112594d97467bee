"""The ported headline scripts' bodies on the CPU against the JAX
package: ``scripts/torch_matrix10M.py::run`` (the k x eps matrix) and
``scripts/torch_latency_fig.py::run`` (batch-1 Auncel against ELP) on the
shared fixture's index, carried into the port by ``convert``, each held to
the JAX script's loop run on a JAX ``ErrorSys`` of the same index, ground
truth and queries. ELP picks the cheapest point by its measured time, and
two points of equal recall may swap places by timing noise, so both
packages charge each point its nprobe instead (as
tests/test_torch_eval_compare.py does): the pick is then the smallest
nprobe that meets the bound. Neither script imports jax or auncel_tpu."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import D, NLIST, jax_fixture, port_state

REPO = Path(__file__).resolve().parent.parent
SCRIPTS = ("torch_matrix10M", "torch_latency_fig")
MAX_TOPK = 50                  # the matrix's largest k
N_PROF, N_CAL, N_EVAL = 40, 40, 20   # the fixture's 100 queries
KS, EPSS = (10, 50), (0.10, 0.05)
N_LAT = 3


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nprobe_cost(monkeypatch, autotune) -> None:
    real = autotune.OperatingPoints.add

    def add(self, pt):
        n = float(dict(p.split("=") for p in pt.key.split(","))["nprobe"])
        real(self, autotune.OperatingPoint(pt.key, pt.perf, n))
    monkeypatch.setattr(autotune.OperatingPoints, "add", add)


@pytest.fixture
def systems(monkeypatch):
    """(port ErrorSys, JAX ErrorSys, ground truth D, queries): both on the
    fixture's index with the multi-row layout, max_topk 50, the JAX
    ground truth, profiles trained on the first N_PROF queries; the JAX
    index's nprobe restored after the test."""
    import auncel_tpu as at
    import auncel_tpu.autotune as jautotune
    import auncel_tpu_torch as att
    import auncel_tpu_torch.autotune as autotune
    f = jax_fixture()
    jidx = f["idx"]
    monkeypatch.setattr(jidx, "nprobe", jidx.nprobe)
    _, arrays, mr, _ = port_state()
    idx = att.IVFFlatIndex.from_state(f["centers"], arrays, multirow=mr)
    xq = f["xq"]
    gt_D, gt_I = jidx.exact_search(xq, MAX_TOPK)
    nq = N_PROF + N_CAL + N_EVAL
    out = []
    for pkg, index in ((att, idx), (at, jidx)):
        es = pkg.ErrorSys(index, train_num=nq, max_topk=MAX_TOPK)
        es.set_gt(gt_D, gt_I)
        es.sys_train(N_PROF, xq)
        out.append(es)
    for mod in (autotune, jautotune):
        _nprobe_cost(monkeypatch, mod)
    return out[0], out[1], gt_D, xq


def _jax_matrix(jes, gt_D, xq) -> list:
    """scripts/matrix10M.py's loop on the JAX ErrorSys (its timing
    left out)."""
    from auncel_tpu.eval_harness import common
    nq = N_PROF + N_CAL + N_EVAL
    e0 = N_PROF + N_CAL
    acc = np.zeros(nq, np.float32)
    rows = []
    for k in KS:
        jes.set_topk(k)
        for eps in EPSS:
            acc[:] = 1.0 - eps
            jes.set_queries(nq, xq, acc)
            jes.calibrate(N_PROF, N_CAL, target_bound=1.0 - eps)
            Dq, _ = jes.search(e0, N_EVAL)
            ok, minf = common.check_bound(Dq, gt_D[e0:nq], k, eps,
                                          jes.index.metric)
            rows.append(dict(k=k, eps=eps, multipler=float(jes.multipler),
                             std_m=float(jes.std_m),
                             min_recall=round(minf, 4), bound_ok=bool(ok),
                             mean_scan=round(float(
                                 jes.n_scanned[e0:nq].mean()), 1)))
    return rows


def test_matrix_matches_jax(systems, tmp_path):
    es, jes, gt_D, xq = systems
    multiplers = []
    real = es.calibrate

    def calibrate(*a, **kw):
        multiplers.append(real(*a, **kw))
        return multiplers[-1]
    es.calibrate = calibrate
    rows = _script("torch_matrix10M").run(
        es, gt_D, xq, "fixture", N_PROF, N_CAL, N_EVAL, KS, EPSS,
        out_dir=str(tmp_path))
    want = _jax_matrix(jes, gt_D, xq)
    assert [(r["k"], r["eps"]) for r in rows] == [(r["k"], r["eps"])
                                                  for r in want]
    for r, w, m in zip(rows, want, multiplers):
        assert m == pytest.approx(w["multipler"], rel=1e-5), w
        assert r["multipler"] == round(w["multipler"], 3)
        for key in ("std_m", "min_recall", "bound_ok", "mean_scan"):
            assert r[key] == w[key], (key, w)
        assert r["qps"] > 0
    assert any(r["bound_ok"] for r in rows)
    lines = (tmp_path / "Matrix_fixture.log").read_text().splitlines()
    assert len(lines) == len(KS) * len(EPSS)


def test_latency_matches_jax(systems, tmp_path):
    from auncel_tpu.autotune import ParameterSpace
    from auncel_tpu.eval_harness import common
    es, jes, gt_D, xq = systems
    ts, ses, k, eps = N_PROF + N_CAL, N_EVAL, 10, 0.10
    res = _script("torch_latency_fig").run(
        es, gt_D, xq, "fixture", ts, ses, k, eps, N_LAT, N_PROF,
        out_dir=str(tmp_path))
    # scripts/latency_fig.py's decisions on the JAX ErrorSys
    jes.set_topk(k)
    jes.set_queries(ses, xq, np.full(ts + ses, 1.0 - eps, np.float32))
    jes.calibrate(N_PROF, min(ts - N_PROF, 2000), target_bound=1.0 - eps)
    Dq, _ = jes.search(ts, ses)
    ok, minf = common.check_bound(Dq, gt_D[ts:], k, eps, jes.index.metric)
    nprobe = ParameterSpace(jes.index).tune_for_bound(
        xq[:ts], gt_D[:ts], k, eps, headroom=1.0 / k)
    assert (res["bound_ok"], res["min_recall"]) == (ok, minf)
    assert res["multipler"] == pytest.approx(jes.multipler, rel=1e-5)
    assert res["std_m"] == jes.std_m
    assert res["elp_nprobe"] == nprobe and 1 <= nprobe <= NLIST
    De, _ = jes.index.search(xq[ts:ts + ses], k, nprobe=nprobe)
    assert ((res["elp_bound_ok"], res["elp_min_recall"])
            == common.check_bound(De, gt_D[ts:], k, eps, jes.index.metric))
    for path in res["logs"].values():
        lat = np.loadtxt(path, ndmin=1)
        assert lat.shape == (N_LAT,) and np.all(lat > 0)
        assert len(Path(path).read_text().splitlines()) == N_LAT
    assert res["slowdown"] > 0
    figs = sorted(p.name for p in (tmp_path / "figures_out").iterdir())
    assert figs == ["latency_cdf_fixture_10_10.png",
                    "slowdown_fixture_10_10.png"]
    assert all(Path(p).stat().st_size > 0 for p in res["figures"])


def test_scripts_import_neither_jax_nor_the_jax_package():
    code = ("import importlib.util, sys\n"
            f"for name in {SCRIPTS!r}:\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            f"        name, {str(REPO / 'scripts')!r} + f'/{{name}}.py')\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec("
            "spec))\n"
            "import auncel_tpu_torch.figures.plots\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'auncel_tpu'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
