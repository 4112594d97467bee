"""The port's copy of the figure module (``auncel_tpu_torch/figures``)
against the JAX package's: the same logs give the same returned values,
and every plot writes a PNG; the validation map reads the port's
``ErrorSys`` profile (torch tensors)."""

import os

import numpy as np
import pytest

from auncel_tpu.figures import plots as jplots
from auncel_tpu_torch.figures import plots


@pytest.fixture()
def logs(tmp_path):
    rng = np.random.RandomState(1234)
    lat_a, lat_b = tmp_path / "a.log", tmp_path / "b.log"
    np.savetxt(lat_a, np.abs(rng.randn(100)) * 1e-3 + 1e-4)
    np.savetxt(lat_b, np.abs(rng.randn(100)) * 2e-3 + 2e-4)
    eff = tmp_path / "eff.log"
    req = rng.choice([0.9, 0.7, 0.5], 100)
    ach = np.clip(req + rng.randn(100) * 0.05, 0, 1.2)
    np.savetxt(eff, np.stack([req, ach], 1))
    tb = tmp_path / "tb.log"
    budget = rng.choice([5.0, 10.0, 20.0], 100)
    np.savetxt(tb, np.stack([budget, budget * rng.uniform(0.3, 1.2, 100)],
                            1))
    cal = tmp_path / "cal.log"
    np.savetxt(cal, [[s, m, 4.0, 0.85 + 0.01 * m, 20 + m]
                     for s in (500, 1000) for m in (1.0, 1.5, 2.0)])
    return {"a": str(lat_a), "b": str(lat_b), "eff": str(eff),
            "tb": str(tb), "cal": str(cal)}


CASES = {
    "latency_cdf": lambda m, L, out: m.latency_cdf(
        {"ours": L["a"], "baseline": L["b"]}, out),
    "latency_slowdown": lambda m, L, out: m.latency_slowdown(L["b"], L["a"],
                                                             out),
    "bound_satisfaction": lambda m, L, out: m.bound_satisfaction(L["eff"],
                                                                 out),
    "time_budget": lambda m, L, out: m.time_budget(L["tb"], out),
    "dist_scaling": lambda m, L, out: m.dist_scaling(
        [1, 2, 4, 8], [3.5, 4.0, 5.5, 9.0], out),
    "calib_margin": lambda m, L, out: m.calib_margin(L["cal"], out),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plot_matches_jax(name, logs, tmp_path):
    got = CASES[name](plots, logs, str(tmp_path / "port.png"))
    want = CASES[name](jplots, logs, str(tmp_path / "jax.png"))
    assert got == want
    assert os.path.getsize(tmp_path / "port.png") > 1000


def test_validation_map_on_port_profile(tmp_path):
    from tests.torch_parity import padded_systems
    es, _ = padded_systems()
    out = str(tmp_path / "f15.png")
    plots.validation_map(es, 0, out)
    assert os.path.getsize(out) > 1000
