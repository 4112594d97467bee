"""The time-budget mode, port against the JAX package on identical index
state: exact per-query probe counts (``nprobe_search`` on the padded
layout, ``nprobe_search_mr`` on the rows), budgets converted to counts in
float32 (``budgeted_search(_mr)``, with budgets that land next to integer
counts), the cost-table inversion (``_budget_to_probes``,
``time_cost_ms``), ``ErrorSys.time_search`` under the linear model and
under a table, and ``calibrate_time`` on the CPU (a monotone table; the
times themselves mean nothing here). Equal ids and counts, values within
rtol 1e-5. Also profile mode (``t_recalls``) on the padded layout.

Every engine call runs WINDOW queries, a batch bucket of the JAX ErrorSys,
so its ``time_search`` pads nothing and reuses the programs compiled here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (K, MAX_TOPK, N_TEST, N_TRAIN, NLIST, jax_fixture,
                          padded_systems, port_state, tnp)
import auncel_tpu_torch as att
from auncel_tpu.profile import bounded as jb
from auncel_tpu.profile import bounded_mr as jbm
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.profile import bounded as tb
from auncel_tpu_torch.profile import bounded_mr as tbm
from auncel_tpu_torch.types import Metric

WINDOW = 16
PER_PROBE_MS = 0.05


def _queries():
    return jax_fixture()["xq"][N_TRAIN:N_TRAIN + WINDOW]


def _near_integer_budgets():
    """Budgets whose count ceil(0.95 b / t - 1) sits within float32
    rounding of an integer, from both sides, and a few far from one."""
    n = np.arange(1, WINDOW + 1) * 2
    b = (n + 1) * PER_PROBE_MS / 0.95
    b[::3] = np.nextafter(b[::3].astype(np.float32), np.float32(0))
    b[1::3] = np.nextafter(b[1::3].astype(np.float32), np.float32(1))
    b[2::5] *= 1.37
    return b.astype(np.float32)


def _same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_array_equal(got[2], want[2])


def _oneshot_plans():
    rpl = tnp(port_state()[2].rows_per_list)
    return tbm.plan_oneshot(rpl, NLIST), jbm.plan_oneshot(rpl, NLIST)


@pytest.mark.parametrize("layout", ["padded", "multirow"])
def test_nprobe_search_matches_jax(layout):
    f = jax_fixture()
    _, arrays, mr, _ = port_state()
    q = _queries()
    probes = np.random.RandomState(3).randint(0, NLIST + 3, WINDOW).astype(
        np.int32)   # clipped to [1, nlist] by both
    qt, pt = torch.from_numpy(q), torch.from_numpy(probes)
    if layout == "padded":
        got = tb.nprobe_search(arrays, qt, pt, MAX_TOPK, Metric.L2)
        want = jb.nprobe_search(f["idx"].arrays, jnp.asarray(q),
                                jnp.asarray(probes), MAX_TOPK, JMetric.L2)
    else:
        tplan, jplan = _oneshot_plans()
        got = tbm.nprobe_search_mr(arrays, mr, qt, pt, MAX_TOPK, Metric.L2,
                                   tplan)
        want = jbm.nprobe_search_mr(f["idx"].arrays, f["idx"].multirow,
                                    jnp.asarray(q), jnp.asarray(probes),
                                    MAX_TOPK, JMetric.L2, jplan)
    _same([tnp(x) for x in got], [np.asarray(x) for x in want])
    assert tnp(got[2]).min() == 1 and tnp(got[2]).max() == NLIST


@pytest.mark.parametrize("layout", ["padded", "multirow"])
def test_budgeted_search_matches_jax(layout):
    f = jax_fixture()
    _, arrays, mr, _ = port_state()
    q = _queries()
    b = _near_integer_budgets()
    qt, bt = torch.from_numpy(q), torch.from_numpy(b)
    pp = torch.tensor(PER_PROBE_MS, dtype=torch.float32)
    if layout == "padded":
        got = tb.budgeted_search(arrays, qt, bt, pp, MAX_TOPK, Metric.L2)
        want = jb.budgeted_search(f["idx"].arrays, jnp.asarray(q),
                                  jnp.asarray(b), jnp.float32(PER_PROBE_MS),
                                  MAX_TOPK, JMetric.L2)
    else:
        tplan, jplan = _oneshot_plans()
        got = tbm.budgeted_search_mr(arrays, mr, qt, bt, pp, MAX_TOPK,
                                     Metric.L2, tplan)
        want = jbm.budgeted_search_mr(
            f["idx"].arrays, f["idx"].multirow, jnp.asarray(q),
            jnp.asarray(b), jnp.float32(PER_PROBE_MS), MAX_TOPK, JMetric.L2,
            jplan)
    got = [tnp(x) for x in got]
    _same(got, [np.asarray(x) for x in want])
    # the float32 conversion really sits on both sides of integers
    f64 = np.ceil(0.95 * b.astype(np.float64) / PER_PROBE_MS - 1.0)
    assert (np.clip(f64, 1, NLIST) != got[2]).any()


def _systems():
    """(port ErrorSys, JAX ErrorSys) on the fixture's multi-row index, the
    window's budgets bound as require_acc."""
    import auncel_tpu as at
    f = jax_fixture()
    index = port_state()[0]
    es = att.ErrorSys(index, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    jes = at.ErrorSys(f["idx"], train_num=N_TRAIN + N_TEST,
                      max_topk=MAX_TOPK)
    budgets = np.full(N_TRAIN + N_TEST, 1.0, np.float32)
    budgets[N_TRAIN:N_TRAIN + WINDOW] = _near_integer_budgets()
    for e in (es, jes):
        e.set_topk(K)
        e.set_queries(N_TEST, f["xq"], budgets)
    return es, jes, budgets


def _table():
    """A staircase cost curve: big jumps where a new wave would start."""
    steps = np.where(np.arange(NLIST) % 7 == 0, 0.5, 0.02)
    return np.maximum.accumulate(np.cumsum(steps))


def test_budget_to_probes_and_time_cost_match_jax():
    es, jes, _ = _systems()
    tbl = _table()
    budgets = np.linspace(0.01, float(tbl[-1]) * 1.2, 200).astype(np.float32)
    for e in (es, jes):
        e._time_cost_table = tbl.copy()
        e.per_probe_ms = 999.0   # ignored while the table exists
    n = es._budget_to_probes(budgets)
    np.testing.assert_array_equal(n, jes._budget_to_probes(budgets))
    np.testing.assert_array_equal(es.time_cost_ms(n), jes.time_cost_ms(n))
    # the largest count that fits 0.95 x budget, where any count fits
    m = 0.95 * budgets.astype(np.float64)
    fits = m >= tbl[0]
    assert (es.time_cost_ms(n)[fits] <= m[fits]).all()
    room = fits & (n < NLIST)
    assert (es.time_cost_ms(n[room] + 1) > m[room]).all()
    for e in (es, jes):
        e._time_cost_table = None
        e.per_probe_ms = PER_PROBE_MS
    np.testing.assert_array_equal(es.time_cost_ms(n), jes.time_cost_ms(n))


@pytest.mark.parametrize("model", ["linear", "table"])
def test_time_search_matches_jax(model):
    """time_search on the multi-row layout (and, under the table, on the
    padded one): equal n_scanned, my_nprobe and ids."""
    es, jes, budgets = _systems()
    systems = [(es, jes)]
    if model == "table":
        pes, pjes = padded_systems()
        for e in (pes, pjes):
            e.set_topk(K)
            e.set_queries(N_TEST, jax_fixture()["xq"], budgets)
        systems.append((pes, pjes))
    for port, ref in systems:
        for e in (port, ref):
            e.per_probe_ms = PER_PROBE_MS
            e._time_cost_table = (_table() / 2.0 if model == "table"
                                  else None)
        D, I = port.time_search(N_TRAIN, WINDOW)
        jD, jI = ref.time_search(N_TRAIN, WINDOW)
        sl = slice(N_TRAIN, N_TRAIN + WINDOW)
        np.testing.assert_array_equal(port.n_scanned[sl], ref.n_scanned[sl])
        np.testing.assert_array_equal(port.my_nprobe[sl], ref.my_nprobe[sl])
        np.testing.assert_array_equal(I, jI)
        np.testing.assert_allclose(D, jD, rtol=1e-5)
        if model == "table":
            np.testing.assert_array_equal(
                port.n_scanned[sl], port._budget_to_probes(budgets[sl]))
        assert len(set(port.n_scanned[sl].tolist())) > 4
        port._time_cost_table = ref._time_cost_table = None


@pytest.mark.parametrize("layout", ["padded", "multirow"])
def test_calibrate_time_builds_a_monotone_table(layout):
    """calibrate_time on the CPU at a tiny grid: one table entry per list
    count, monotone, starting at zero cost, and a positive per-probe
    slope. No timing parity: these are host times of the CPU route."""
    es = padded_systems()[0] if layout == "padded" else _systems()[0]
    es.set_queries(N_TEST, jax_fixture()["xq"],
                   np.full(N_TRAIN + N_TEST, 1.0, np.float32))
    slope = es.calibrate_time(reps=1, sample_q=2, grid=[1, 4, NLIST])
    tbl = es._time_cost_table
    assert tbl.shape == (NLIST,) and tbl[0] == 0.0
    assert (np.diff(tbl) >= 0).all()
    assert slope == es.per_probe_ms > 0
    es._time_cost_table, es.per_probe_ms = None, None


def test_profile_mode_padded_matches_jax():
    """t_recalls on the padded layout: a two-phase window and batch-1
    windows (single phase) in both packages."""
    f = jax_fixture()
    es, jes = padded_systems()
    bounds = np.full(N_TRAIN + N_TEST, 0.9, np.float32)
    for e in (es, jes):
        e.set_topk(K)
        e.set_queries(N_TEST, f["xq"], bounds)
        e.set_hyper(5.0, 1.0)   # budgets past nlist/8
        e.profile = True
    try:
        for start, size in ((N_TRAIN, 16), (N_TRAIN + 1, 1)):
            es.search(start, size)
            jes.search(start, size)
            sl = slice(start, start + size)
            np.testing.assert_array_equal(es.t_recalls[sl],
                                          jes.t_recalls[sl])
            np.testing.assert_array_equal(es.n_scanned[sl], jes.n_scanned[sl])
        assert es.t_recalls[N_TRAIN:N_TRAIN + 16].min() > 0
    finally:
        for e in (es, jes):
            e.profile = False
