"""The port on a CUDA card, skipped without one: K1 and K2 against their
plain versions, and the bounded-search slices (the multi-row path and the
padded path) on the card against the same slices on the CPU, where the
kernels' plain versions run. The entry points' default device is checked
everywhere. This file imports no jax, so it also runs where jax is not
installed, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import inspect

import numpy as np
import pytest
import torch

import auncel_tpu_torch as att
from auncel_tpu_torch import convert
from auncel_tpu_torch.index.ivf import compute_interdis
from auncel_tpu_torch.kernels.rowscan import rowscan_dots, rowscan_dots_ref
from auncel_tpu_torch.kernels.scan_scores import scan_scores, scan_scores_ref
from auncel_tpu_torch.ops.kmeans import kmeans
from auncel_tpu_torch.types import Metric
from torch_parity import (ACC, D, K, MAX_TOPK, N_TEST, N_TRAIN, NLIST,
                          ROW_CAP, make_data)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def test_entry_points_default_to_the_card():
    """Every entry point allocates on the card unless the caller passes
    device="cpu"; without a card the first allocation raises instead of
    falling back to the CPU."""
    for fn in (att.IVFFlatIndex.__init__, compute_interdis, kmeans,
               convert.ivf_arrays_from_numpy, convert.multirow_from_numpy,
               convert.traces_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    centers, _, _ = make_data()
    idx = att.IVFFlatIndex(D, NLIST)
    assert idx.device.type == "cuda"
    if torch.cuda.is_available():
        idx.set_centroids(centers)
        assert idx.arrays.db.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            idx.set_centroids(centers)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    for n_rows, row_cap, d, T in ((300, 256, 128, 4093), (40, 77, 100, 33),
                                  (8, 3, 4, 0)):
        s = d ** -0.5  # O(1) dots: the 1e-5 tolerance checks the kernel
        db = torch.randn((n_rows, row_cap, d), generator=gen, device=dev) * s
        rows = torch.randint(0, n_rows, (T,), generator=gen, device=dev,
                             dtype=torch.int32)
        qs = torch.randn((T, d), generator=gen, device=dev) * s
        before = rowscan_dots.launches
        got = rowscan_dots(db, rows, qs)
        torch.cuda.synchronize()
        assert rowscan_dots.launches == before + (T > 0)
        torch.testing.assert_close(got, rowscan_dots_ref(db, rows, qs),
                                   rtol=1e-5, atol=1e-5)


def padded_inputs(nlist, cap, d, B, n_slots, device, seed=0):
    """A padded layout with ragged lists, a dead id inside a list, and
    probes with inactive slots (-1) and out-of-range list ids; entries
    ~ N(0, 1/d), so scores are O(1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = d ** -0.5
    sizes = torch.randint(0, cap + 1, (nlist,), generator=gen, device=device,
                          dtype=torch.int32)
    slot = torch.arange(cap, device=device)
    live = slot[None, :] < sizes[:, None]
    ids = torch.where(live, torch.arange(nlist * cap, device=device,
                                         dtype=torch.int32).reshape(nlist, cap),
                      -1)
    ids[0, 0] = -1
    db = torch.randn((nlist, cap, d), generator=gen, device=device) * s
    db = torch.where(live[:, :, None], db, 0.0)
    q = torch.randn((B, d), generator=gen, device=device) * s
    lists = torch.randint(-1, nlist + 2, (B, n_slots), generator=gen,
                          device=device, dtype=torch.int32)
    return (db, (db * db).sum(-1), ids.to(torch.int32), sizes, q,
            (q * q).sum(-1), lists)


@pytest.mark.cuda
def test_k2_matches_plain_version():
    dev = _card()
    for nlist, cap, d, B, n_slots in ((64, 1000, 128, 40, 5),
                                      (9, 77, 100, 7, 3), (4, 8, 16, 0, 2)):
        args = padded_inputs(nlist, cap, d, B, n_slots, dev)
        for metric in (Metric.L2, Metric.IP):
            before = scan_scores.launches
            scores, ids = scan_scores(*args, metric)
            torch.cuda.synchronize()
            assert scan_scores.launches == before + (B > 0)
            want_s, want_i = scan_scores_ref(*args, metric)
            torch.testing.assert_close(scores, want_s, rtol=1e-5, atol=1e-5)
            assert torch.equal(ids, want_i)


def _slice(device):
    """The main path after k-means, at the parity fixture's size."""
    centers, xb, xq = make_data()
    idx = att.IVFFlatIndex(D, NLIST, device=device)
    idx.set_centroids(centers)
    idx.add(xb)
    idx.enable_multirow(row_cap=ROW_CAP)
    gt_D, gt_I = idx.exact_search(xq, MAX_TOPK)
    es = att.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    es.sys_train(N_TRAIN, xq)
    es.set_topk(K)
    es.set_queries(N_TEST, xq, np.full(N_TRAIN + N_TEST, ACC, np.float32))
    es.calibrate(0, N_TRAIN, target_bound=ACC, std_m_grid=(1.0, 4.0))
    D_out, I_out = es.search(N_TRAIN, N_TEST)
    out = dict(gt_I=gt_I, D=D_out, I=I_out, mult=es.multipler,
               np=es.my_nprobe[N_TRAIN:].copy(),
               ns=es.n_scanned[N_TRAIN:].copy())
    D1, I1 = es.search(N_TRAIN + 1, 1)
    out.update(D1=D1, I1=I1, np1=int(es.my_nprobe[N_TRAIN + 1]))
    return out


@pytest.mark.cuda
def test_slice_on_the_card_matches_the_cpu():
    dev = _card()
    cpu = _slice("cpu")
    before = rowscan_dots.launches
    card = _slice(dev)
    assert rowscan_dots.launches > before
    np.testing.assert_array_equal(card["gt_I"], cpu["gt_I"])
    assert card["mult"] == cpu["mult"]
    for name in ("I", "np", "ns", "I1", "np1"):
        np.testing.assert_array_equal(card[name], cpu[name])
    for name in ("D", "D1"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-5)


def _padded_slice(device):
    """The padded path at the fixture's size: profile training, calibration,
    a two-phase window and batch-1 windows on an index without the
    multi-row layout."""
    centers, xb, xq = make_data()
    idx = att.IVFFlatIndex(D, NLIST, device=device)
    idx.set_centroids(centers)
    idx.add(xb)
    gt_D, gt_I = idx.exact_search(xq, MAX_TOPK)
    es = att.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    es.sys_train(N_TRAIN, xq)
    es.set_topk(K)
    es.set_queries(N_TEST, xq, np.full(N_TRAIN + N_TEST, ACC, np.float32))
    es.calibrate(0, N_TRAIN, target_bound=ACC, std_m_grid=(1.0, 4.0))
    D_out, I_out = es.search(N_TRAIN, N_TEST)
    out = dict(D=D_out, I=I_out, mult=es.multipler,
               np=es.my_nprobe[N_TRAIN:].copy(),
               ns=es.n_scanned[N_TRAIN:].copy())
    b1 = [es.search(N_TRAIN + i, 1) for i in range(4)]
    out.update(D1=np.concatenate([d for d, _ in b1]),
               I1=np.concatenate([i for _, i in b1]),
               np1=es.my_nprobe[N_TRAIN:N_TRAIN + 4].copy(),
               ns1=es.n_scanned[N_TRAIN:N_TRAIN + 4].copy())
    return out


@pytest.mark.cuda
def test_padded_path_on_the_card_matches_the_cpu():
    dev = _card()
    cpu = _padded_slice("cpu")
    k1, k2 = rowscan_dots.launches, scan_scores.launches
    card = _padded_slice(dev)
    assert scan_scores.launches > k2 and rowscan_dots.launches == k1
    assert card["mult"] == cpu["mult"]
    for name in ("I", "np", "ns", "I1", "np1", "ns1"):
        np.testing.assert_array_equal(card[name], cpu[name])
    for name in ("D", "D1"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-5)
