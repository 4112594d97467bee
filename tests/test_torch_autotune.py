"""Parity of the port's ELP baseline (``autotune.py``: ParameterSpace,
the operating points, the recall criteria, MatrixStats) with the JAX
package's."""

import numpy as np
import pytest

from torch_parity import (
    D, K, NLIST, ROW_CAP, jax_fixture, port_state)

EPS = 0.1


def _indexes():
    """Fresh indexes of both packages on the fixture's state with the
    multi-row layout (the sweep leaves its knobs on them)."""
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    jidx = JIVF(D, NLIST)
    jidx.set_centroids(f["centers"])
    jidx.add(f["xb"])
    jidx.enable_multirow(row_cap=ROW_CAP)
    _, arrays, mr, _ = port_state()
    return jidx, IVFFlatIndex.from_state(f["centers"], arrays, multirow=mr)


class _NprobeClock:
    """A stand-in for the ``time`` module whose clock advances by the
    index's nprobe at every reading: each timed search then costs its
    nprobe, so the sweep's choice does not hang on timing noise (with
    measured times, points of equal recall swap places under load)."""

    def __init__(self, index):
        self.index, self.t = index, 0.0

    def perf_counter(self):
        self.t += self.index.nprobe
        return self.t


def test_parameter_space_sweep_matches_jax(monkeypatch):
    import auncel_tpu.autotune as ja
    import auncel_tpu_torch.autotune as ta
    f = jax_fixture()
    jidx, idx = _indexes()
    monkeypatch.setattr(ja, "time", _NprobeClock(jidx))
    monkeypatch.setattr(ta, "time", _NprobeClock(idx))
    jps, ps = ja.ParameterSpace(jidx), ta.ParameterSpace(idx)
    assert ps.candidate_nprobes() == jps.candidate_nprobes()
    assert ps.parameter_ranges() == jps.parameter_ranges()
    xq, gt_D = f["xq"], f["gt_D"]
    jops, ops = jps.explore(xq, gt_D, K), ps.explore(xq, gt_D, K)
    assert [p.key for p in ops.all_pts] == [p.key for p in jops.all_pts]
    assert [p.perf for p in ops.all_pts] == [p.perf for p in jops.all_pts]
    assert [p.cost for p in ops.all_pts] == [p.cost for p in jops.all_pts]
    for headroom in (0.0, 1.0 / K):
        jn = ja.ParameterSpace(jidx).tune_for_bound(xq, gt_D, K, EPS,
                                                    headroom=headroom)
        ps = ta.ParameterSpace(idx)
        n = ps.tune_for_bound(xq, gt_D, K, EPS, headroom=headroom)
        assert n == jn
        assert idx.nprobe == n and ps.best_combo == {"nprobe": float(n)}
    assert ps.ops.optimal()[-1].perf >= 0.999


def test_tune_for_bound_unreachable_leaves_full_scan():
    from auncel_tpu_torch.autotune import ParameterSpace
    f = jax_fixture()
    _, idx = _indexes()
    ps = ParameterSpace(idx)
    n = ps.tune_for_bound(f["xq"], f["gt_D"] * 0.0 - 1.0, K, EPS)
    assert n == NLIST and idx.nprobe == NLIST
    assert ps.best_combo == {"nprobe": NLIST}


def test_set_index_parameters():
    from auncel_tpu_torch.autotune import (
        ParameterSpace, set_index_parameter, set_index_parameters)
    _, idx = _indexes()
    set_index_parameters(idx, "nprobe=7,max_codes=300")
    assert (idx.nprobe, idx.max_codes) == (7, 300)
    set_index_parameter(idx, "max_codes", np.inf)
    assert idx.max_codes == 0
    set_index_parameter(idx, "ht", 12)   # the polysemous filter's knob
    assert idx.polysemous_ht == 12
    idx.polysemous_ht = 0
    for knob in ("efSearch", "k_factor"):
        with pytest.raises(ValueError):
            set_index_parameter(idx, knob, 4)
    assert ParameterSpace(object()).parameter_ranges() == []


def test_operating_points_match_jax():
    import auncel_tpu.autotune as ja
    import auncel_tpu_torch.autotune as ta
    rng = np.random.RandomState(0)
    pts = [(f"nprobe={i}", float(p), float(c)) for i, (p, c) in
           enumerate(zip(rng.rand(30).round(1), rng.rand(30).round(2)))]
    jops, ops = ja.OperatingPoints(), ta.OperatingPoints()
    for key, perf, cost in pts:
        jops.add(ja.OperatingPoint(key, perf, cost))
        ops.add(ta.OperatingPoint(key, perf, cost))
    assert [p.key for p in ops.optimal()] == [p.key for p in jops.optimal()]
    for target in (0.0, 0.35, 0.8, 0.95, 1.5):
        a, b = ops.cheapest_meeting(target), jops.cheapest_meeting(target)
        assert (a is None and b is None) or a.key == b.key


def test_recall_criteria_match_jax():
    import auncel_tpu.autotune as ja
    import auncel_tpu_torch.autotune as ta
    rng = np.random.RandomState(1)
    gt_I = rng.randint(0, 50, (40, 10))
    I = np.where(rng.rand(40, 10) < 0.6, gt_I, rng.randint(0, 50, (40, 10)))
    for R in (1, 5, 10):
        assert ta.one_recall_at_r(I, gt_I, R) == ja.one_recall_at_r(
            I, gt_I, R)
        assert ta.intersection_at_r(I, gt_I, R) == ja.intersection_at_r(
            I, gt_I, R)


@pytest.mark.parametrize("case", ["plain", "dups_nan", "normalized"])
def test_matrix_stats_text_matches_jax(case):
    import auncel_tpu.autotune as ja
    import auncel_tpu_torch.autotune as ta
    rng = np.random.RandomState(2)
    x = rng.randn(200, 12).astype(np.float32)
    if case == "dups_nan":
        x[50:60] = x[0]
        x[7, 3] = np.nan
        x[9, 1] = np.inf
        x[:, 5] = 1.0
        x[11] = 0.0
    elif case == "normalized":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    assert str(ta.MatrixStats(x)) == str(ja.MatrixStats(x))
