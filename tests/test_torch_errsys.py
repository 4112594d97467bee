"""The slice end to end through ErrorSys, port against the JAX package:
build from the same centroids and vectors, value-consistent ground truth,
profile training, calibration, a batched window and batch-1 windows. Ids,
my_nprobe and n_scanned equal; distances and profile bins within the 1e-5
kscaling band."""

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import (ACC, K, MAX_TOPK, N_TEST, N_TRAIN, as_numpy,
                          jax_fixture, port_state, tnp)
import auncel_tpu as at
import auncel_tpu_torch as att

STD_M_GRID = (1.0, 4.0)
N_BATCH1 = 4


def _flow(es, xq):
    """The main path after the index build, identical for both packages."""
    es.sys_train(N_TRAIN, xq)
    es.set_topk(K)
    es.set_queries(N_TEST, xq, np.full(N_TRAIN + N_TEST, ACC, np.float32))
    es.calibrate(0, N_TRAIN, target_bound=ACC, std_m_grid=STD_M_GRID)
    D, I = es.search(N_TRAIN, N_TEST)
    out = dict(D=D, I=I, np=es.my_nprobe[N_TRAIN:].copy(),
               ns=es.n_scanned[N_TRAIN:].copy(), mult=es.multipler,
               std_m=es.std_m)
    b1 = [es.search(N_TRAIN + i, 1) for i in range(N_BATCH1)]
    out["D1"] = np.concatenate([d for d, _ in b1])
    out["I1"] = np.concatenate([i for _, i in b1])
    out["np1"] = es.my_nprobe[N_TRAIN:N_TRAIN + N_BATCH1].copy()
    return out


def _same(got, want):
    np.testing.assert_array_equal(got["np"], want["np"])
    np.testing.assert_array_equal(got["ns"], want["ns"])
    np.testing.assert_array_equal(got["I"], want["I"])
    np.testing.assert_allclose(got["D"], want["D"], rtol=1e-5)
    np.testing.assert_array_equal(got["np1"], want["np1"])
    np.testing.assert_array_equal(got["I1"], want["I1"])
    np.testing.assert_allclose(got["D1"], want["D1"], rtol=1e-5)


def test_errorsys_end_to_end_matches_jax():
    f = jax_fixture()
    xq = f["xq"]
    jes = at.ErrorSys(f["idx"], train_num=N_TRAIN + N_TEST,
                      max_topk=MAX_TOPK)
    jes.set_gt(f["gt_D"], f["gt_I"])
    want = _flow(jes, xq)

    idx = att.IVFFlatIndex(tp.D, tp.NLIST)
    idx.set_centroids(f["centers"])
    idx.add(f["xb"])
    idx.enable_multirow(row_cap=tp.ROW_CAP)
    gt_D, gt_I = idx.exact_search(xq, MAX_TOPK)
    np.testing.assert_array_equal(gt_I, f["gt_I"])
    np.testing.assert_allclose(gt_D, f["gt_D"], rtol=1e-5)
    es = att.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    got = _flow(es, xq)

    ours, ref = as_numpy(jes.traces), es.traces
    np.testing.assert_array_equal(tnp(ref.n_bins), ours["n_bins"])
    for name in ("phi", "u", "std"):
        np.testing.assert_allclose(tnp(getattr(ref, name)), ours[name],
                                   rtol=1e-5, atol=1e-5)
    assert (got["mult"], got["std_m"]) == (want["mult"], want["std_m"])
    _same(got, want)
    # the bound holds on the held-out window, and batch-1 decisions are
    # conservative against the batched ones
    from auncel_tpu_torch.autotune import worst_case_recall
    assert worst_case_recall(got["D"], gt_D[N_TRAIN:], K, att.Metric.L2) \
        >= ACC
    assert (got["np1"] >= got["np"][:N_BATCH1]).all()


def test_errorsys_search_on_carried_state_matches_jax(tmp_path):
    """The port serving the JAX package's index state and saved profile."""
    from auncel_tpu.profile.trace import save_trace_set
    f = jax_fixture()
    index, _, _, _ = port_state()
    path = str(tmp_path / "profile.npz")
    save_trace_set(f["es"].traces, path)
    es = att.ErrorSys(index, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(f["gt_D"], f["gt_I"])
    es.load_profile(path)
    jes = f["es"]
    for e in (es, jes):
        e.set_topk(K)
        e.set_queries(N_TEST, f["xq"],
                      np.full(N_TRAIN + N_TEST, ACC, np.float32))
        e.set_hyper(2.0, 1.0)
    for start, size in ((N_TRAIN, N_TEST), (N_TRAIN + 3, 1)):
        D, I = es.search(start, size)
        jD, jI = jes.search(start, size)
        np.testing.assert_array_equal(I, jI)
        np.testing.assert_allclose(D, jD, rtol=1e-5)
        sl = slice(start, start + size)
        np.testing.assert_array_equal(es.my_nprobe[sl], jes.my_nprobe[sl])
        np.testing.assert_array_equal(es.n_scanned[sl], jes.n_scanned[sl])


def test_errorsys_without_multirow_is_not_ported():
    f = jax_fixture()
    idx = att.IVFFlatIndex(tp.D, tp.NLIST)
    idx.set_centroids(f["centers"])
    idx.add(f["xb"][:500])
    es = att.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(*idx.exact_search(f["xq"], MAX_TOPK))
    es.sys_train(N_TRAIN, f["xq"])
    es.set_queries(N_TEST, f["xq"], np.full(N_TRAIN + N_TEST, ACC,
                                            np.float32))
    with pytest.raises(NotImplementedError):
        es.search(N_TRAIN, 2)


def test_errorsys_helpers_match_jax(tmp_path):
    """recall, setparam, the decide-margin flag and save_profile against
    the JAX package (no search)."""
    from auncel_tpu.profile.trace import load_trace_set
    f = jax_fixture()
    index, _, _, traces = port_state()
    es = att.ErrorSys(index, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    jes = at.ErrorSys(f["idx"], train_num=N_TRAIN + N_TEST,
                      max_topk=MAX_TOPK)
    gi = f["gt_I"]
    for row, other in ((0, 0), (0, 1), (5, 7)):
        assert es.recall(gi[row], gi[other], K) == \
            jes.recall(gi[row], gi[other], K)
    for e in (es, jes):
        e.setparam(6)
        e.set_topk(K)
    assert (es.multipler, es.std_m) == (jes.multipler, jes.std_m)
    for acc in (0.9, 0.95):
        bounds = np.full(N_TRAIN + N_TEST, acc, np.float32)
        for e in (es, jes):
            e.set_queries(N_TEST, f["xq"], bounds)
        assert es._decide_margin_flag() == jes._decide_margin_flag()
    es.traces, es.is_trained = traces, True
    path = str(tmp_path / "port.npz")
    es.save_profile(path)
    for a, b in zip(load_trace_set(path), f["es"].traces):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
