"""ErrorSys on SQ8 storage, port against the JAX package: the shared
fixture's data with ``storage="sq8"``, built once by the JAX package and
carried over by ``convert``. On the multi-row layout: ground truth,
profile training, calibration, a one-shot window and batch-1 windows; on
the padded layout: the two-phase decide (with ``decided_at``) and
ErrorSys's two-phase and batch-1 windows. Ids, my_nprobe, n_scanned and
decided_at equal, values within rtol 1e-5, as tests/test_torch_errsys.py
holds float32 storage."""

import functools
import os
import tempfile

import numpy as np
import torch

import jax.numpy as jnp

import torch_parity as tp
from torch_parity import (ACC, K, MAX_TOPK, N_TEST, N_TRAIN, NLIST,
                          as_numpy, codec_fixture, jax_fixture, tnp)
import auncel_tpu as at
import auncel_tpu_torch as att
from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
from auncel_tpu.profile import bounded as jb
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch import convert
from auncel_tpu_torch.profile import bounded as tb
from auncel_tpu_torch.types import Metric

STD_M_GRID = (1.0, 4.0)
MULTIPLER = 5.0   # budgets past nlist/8: phase B runs
N_BATCH1 = 3


def _same(got, want):
    """(vals, ids, then int vectors) of both packages."""
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
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
def _systems():
    """(port ErrorSys, JAX ErrorSys), each trained and calibrated on the
    SQ8 index with the multi-row layout, the port on the carried state."""
    f = jax_fixture()
    jidx = codec_fixture("sq8")
    gt = jidx.exact_search(f["xq"], MAX_TOPK)
    jes = _train(at.ErrorSys(jidx, train_num=N_TRAIN + N_TEST,
                             max_topk=MAX_TOPK), f["xq"], gt)
    arrays = convert.ivf_arrays_from_numpy(as_numpy(jidx.arrays), tp.DEVICE)
    mr = convert.multirow_from_numpy(as_numpy(jidx.multirow), tp.DEVICE)
    index = att.IVFFlatIndex.from_state(f["centers"], arrays, multirow=mr)
    es = att.ErrorSys(index, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    port_gt = index.exact_search(f["xq"], MAX_TOPK)
    np.testing.assert_array_equal(port_gt[1], gt[1])
    np.testing.assert_allclose(port_gt[0], gt[0], rtol=1e-5)
    return _train(es, f["xq"], gt), jes


def test_sq8_training_and_calibration_match_jax():
    es, jes = _systems()
    assert es.index.arrays.db.dtype == torch.uint8
    assert es.index.multirow.rows.db.dtype == torch.uint8
    ours, ref = as_numpy(jes.traces), es.traces
    np.testing.assert_array_equal(tnp(ref.n_bins), ours["n_bins"])
    for name in ("phi", "u", "std"):
        np.testing.assert_allclose(tnp(getattr(ref, name)), ours[name],
                                   rtol=1e-5, atol=1e-5)
    assert (es.multipler, es.std_m) == (jes.multipler, jes.std_m)


def test_sq8_multirow_windows_match_jax():
    """The one-shot window and batch-1 windows (the latency plan)."""
    es, jes = _systems()
    for start, size in ((N_TRAIN, N_TEST),) + tuple(
            (N_TRAIN + i, 1) for i in range(N_BATCH1)):
        D, I = es.search(start, size)
        jD, jI = jes.search(start, size)
        sl = slice(start, start + size)
        _same([D, I, es.my_nprobe[sl], es.n_scanned[sl]],
              [jD, jI, jes.my_nprobe[sl], jes.n_scanned[sl]])
    from auncel_tpu_torch.autotune import worst_case_recall
    D, _ = es.search(N_TRAIN, N_TEST)
    assert worst_case_recall(D, es.gt_D[N_TRAIN:], K, Metric.L2) >= ACC


@functools.lru_cache(maxsize=None)
def _padded_systems():
    """(port ErrorSys, JAX ErrorSys) on the SQ8 index WITHOUT the multi-row
    layout, serving the multi-row systems' profile."""
    f = jax_fixture()
    es0, jes0 = _systems()
    jidx = JIVF(tp.D, NLIST, storage="sq8")
    jidx.set_centroids(f["centers"])
    jidx.add(f["xb"])
    index = att.IVFFlatIndex.from_state(f["centers"], es0.index.arrays)
    es = att.ErrorSys(index, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    jes = at.ErrorSys(jidx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.npz")
        jes0.save_profile(path)
        for e in (es, jes):
            e.set_gt(jes0.gt_D, jes0.gt_I)
            e.load_profile(path)
            e.set_topk(K)
    return es, jes


def test_sq8_padded_decide_matches_jax():
    """The padded two-phase decide on SQ codes: vals, ids, my_nprobe,
    decided_at and the ranking prefix."""
    es, jes = _padded_systems()
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
    _same([tnp(x) for x in got[:5]], [np.asarray(x) for x in want[:5]])


def test_sq8_padded_errorsys_matches_jax():
    """ErrorSys without the multi-row layout: a two-phase window whose
    stragglers take phase B, and batch-1 windows."""
    es, jes = _padded_systems()
    f = jax_fixture()
    bounds = np.full(N_TRAIN + N_TEST, 0.9, np.float32)
    bounds[N_TRAIN::3] = 0.95
    for e in (es, jes):
        e.set_queries(N_TEST, f["xq"], bounds)
        e.set_hyper(MULTIPLER, 1.0)
    for start, size in ((N_TRAIN, N_TEST), (N_TRAIN, 1), (N_TRAIN + 1, 1)):
        D, I = es.search(start, size)
        jD, jI = jes.search(start, size)
        sl = slice(start, start + size)
        _same([D, I, es.my_nprobe[sl], es.n_scanned[sl]],
              [jD, jI, jes.my_nprobe[sl], jes.n_scanned[sl]])
    assert es.n_scanned[N_TRAIN:].max() > NLIST // 8
