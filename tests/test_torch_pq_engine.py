"""ErrorSys on PQ storage, port against the JAX package (the slice as a
whole): the shared fixture's data with ``storage="pq4"``, residual and
plain, built once by the JAX package and carried over by ``convert``, on
the padded layout (the multi-row layout refuses PQ): ground truth from
``exact_search``, profile training, calibration, the two-phase decide
(with ``decided_at``), ErrorSys's windows and batch-1 windows, and the
bounded search of ``tests/test_pq.py::test_bounded_search_on_pq``
(multipler 8, worst recall@10 >= 0.9). Ids, my_nprobe, n_scanned and
decided_at equal, values within 1e-5 of their terms (||q - c_l||^2 +
db_sq)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity as tp
from torch_parity import (ACC, K, MAX_TOPK, N_TEST, N_TRAIN, as_numpy,
                          jax_fixture, pq_fixture, tnp)
import auncel_tpu as at
import auncel_tpu_torch as att
from auncel_tpu.autotune import recall_counts as j_recall_counts
from auncel_tpu.profile import bounded as jb
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.autotune import recall_counts
from auncel_tpu_torch.profile import bounded as tb
from auncel_tpu_torch.types import Metric

STD_M_GRID = (1.0, 4.0)
MULTIPLER = 5.0   # budgets past nlist/8: phase B runs


def _terms(es, start: int, ids: np.ndarray) -> np.ndarray:
    """||q - c_l||^2 + db_sq of each result (c_l zero for plain PQ)."""
    a = es.index.arrays
    vid = tnp(a.vec_ids)
    live = vid >= 0
    owner = np.zeros(vid.max() + 1, np.int64)
    owner[vid[live]] = np.nonzero(live)[0]
    norms = np.zeros(vid.max() + 1, np.float32)
    norms[vid[live]] = tnp(a.db_sq)[live]
    q = jax_fixture()["xq"][start:start + ids.shape[0]]
    safe = np.maximum(ids, 0)
    cl = (tnp(a.centroids)[owner[safe]] if a.pq_residual
          else np.zeros(safe.shape + (q.shape[1],), np.float32))
    return ((q[:, None, :] - cl) ** 2).sum(-1) + norms[safe]


def _same(es, start, got, want):
    """(vals, ids, then int vectors) of both packages."""
    np.testing.assert_array_equal(got[1], want[1])
    fin = np.isfinite(want[0])
    np.testing.assert_array_equal(np.isfinite(got[0]), fin)
    terms = _terms(es, start, want[1])
    assert (np.abs(got[0][fin] - want[0][fin])
            <= 1e-5 * terms[fin] + 1e-6).all()
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)


def _train(es, xq, gt):
    es.set_gt(*gt)
    es.sys_train(N_TRAIN, xq)
    es.set_topk(K)
    es.set_queries(N_TEST, xq, np.full(N_TRAIN + N_TEST, ACC, np.float32))
    es.calibrate(0, N_TRAIN, target_bound=ACC, std_m_grid=STD_M_GRID)
    return es


@functools.lru_cache(maxsize=None)
def _systems(residual: bool):
    """(port ErrorSys, JAX ErrorSys), each trained and calibrated on the
    PQ index, the port on the carried state; the port's ground truth is
    held to the JAX package's first."""
    f = jax_fixture()
    jidx, index = pq_fixture(residual)
    gt = jidx.exact_search(f["xq"], MAX_TOPK)
    port_gt = index.exact_search(f["xq"], MAX_TOPK)
    jes = _train(at.ErrorSys(jidx, train_num=N_TRAIN + N_TEST,
                             max_topk=MAX_TOPK), f["xq"], gt)
    es = att.ErrorSys(index, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    return _train(es, f["xq"], gt), jes, port_gt, gt


@pytest.mark.parametrize("residual", [True, False])
def test_pq_ground_truth_training_and_calibration_match_jax(residual):
    es, jes, port_gt, gt = _systems(residual)
    assert es.index.arrays.db.dtype == torch.uint8
    assert es.index.arrays.pq_residual == residual
    _same(es, 0, [port_gt[0], port_gt[1]], [gt[0], gt[1]])
    ours, ref = as_numpy(jes.traces), es.traces
    np.testing.assert_array_equal(tnp(ref.n_bins), ours["n_bins"])
    for name in ("phi", "u", "std"):
        np.testing.assert_allclose(tnp(getattr(ref, name)), ours[name],
                                   rtol=1e-5, atol=1e-5)
    assert (es.multipler, es.std_m) == (jes.multipler, jes.std_m)


@pytest.mark.parametrize("residual", [True, False])
def test_pq_errorsys_windows_match_jax(residual):
    """The calibrated window and batch-1 windows, then a window at a
    multipler whose stragglers take phase B."""
    es, jes, _, _ = _systems(residual)
    f = jax_fixture()
    for start, size in ((N_TRAIN, N_TEST), (N_TRAIN, 1), (N_TRAIN + 1, 1)):
        D, I = es.search(start, size)
        jD, jI = jes.search(start, size)
        sl = slice(start, start + size)
        _same(es, start, [D, I, es.my_nprobe[sl], es.n_scanned[sl]],
              [np.asarray(jD), np.asarray(jI), jes.my_nprobe[sl],
               jes.n_scanned[sl]])
    bounds = np.full(N_TRAIN + N_TEST, 0.9, np.float32)
    bounds[N_TRAIN::3] = 0.95
    hyper = [(e.multipler, e.std_m) for e in (es, jes)]
    for e in (es, jes):
        e.set_queries(N_TEST, f["xq"], bounds)
        e.set_hyper(MULTIPLER, 1.0)
    D, I = es.search(N_TRAIN, N_TEST)
    jD, jI = jes.search(N_TRAIN, N_TEST)
    sl = slice(N_TRAIN, N_TRAIN + N_TEST)
    _same(es, N_TRAIN, [D, I, es.my_nprobe[sl], es.n_scanned[sl]],
          [np.asarray(jD), np.asarray(jI), jes.my_nprobe[sl],
           jes.n_scanned[sl]])
    assert es.n_scanned[sl].max() > tp.NLIST // 8
    for e, h in zip((es, jes), hyper):
        e.set_queries(N_TEST, f["xq"], np.full(N_TRAIN + N_TEST, ACC,
                                               np.float32))
        e.set_hyper(*h)


def test_pq_padded_decide_matches_jax():
    """The two-phase decide on residual PQ codes: vals, ids, my_nprobe,
    decided_at and the ranking prefix."""
    es, jes, _, _ = _systems(True)
    f = jax_fixture()
    q = f["xq"][N_TRAIN:N_TRAIN + N_TEST]
    acc = np.full(N_TEST, 0.9, np.float32)
    acc[::3] = 0.95
    got = tb.bounded_search_decide(
        es.index.arrays, es.traces, torch.from_numpy(q),
        torch.from_numpy(acc), torch.tensor(MULTIPLER), torch.tensor(1.0),
        K, MAX_TOPK, Metric.L2, decide_margin=True)
    want = jb.bounded_search_decide(
        jes.index.arrays, jes.traces, jnp.asarray(q), jnp.asarray(acc),
        jnp.float32(MULTIPLER), jnp.float32(1.0), K, MAX_TOPK, JMetric.L2,
        decide_margin=True)
    got = [tnp(x) for x in got[:5]]
    want = [np.asarray(x) for x in want[:5]]
    _same(es, N_TRAIN, got[:2], want[:2])
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)


def test_bounded_search_on_pq_holds_the_bound():
    """tests/test_pq.py::test_bounded_search_on_pq on the carried state:
    multipler 8, both packages equal, worst recall@10 >= 0.9."""
    es, jes, _, gt = _systems(True)
    hyper = [(e.multipler, e.std_m) for e in (es, jes)]
    for e in (es, jes):
        e.set_hyper(8.0, 1.0)
    D, I = es.search(N_TRAIN, N_TEST)
    jD, jI = jes.search(N_TRAIN, N_TEST)
    sl = slice(N_TRAIN, N_TRAIN + N_TEST)
    _same(es, N_TRAIN, [D, I, es.n_scanned[sl]],
          [np.asarray(jD), np.asarray(jI), jes.n_scanned[sl]])
    cnt = recall_counts(D, gt[0][sl], K, Metric.L2)
    np.testing.assert_array_equal(
        cnt, j_recall_counts(np.asarray(jD), gt[0][sl], K, JMetric.L2))
    assert cnt.min() / K >= 0.9
    for e, h in zip((es, jes), hyper):
        e.set_hyper(*h)
