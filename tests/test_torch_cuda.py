"""The port on a CUDA card, skipped without one: K1 against its plain
version, and the bounded-search slice on the card against the same slice
on the CPU (where K1's plain version runs). This file imports no jax, so
it also runs where jax is not installed, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import auncel_tpu_torch as att
from auncel_tpu_torch.kernels.rowscan import rowscan_dots, rowscan_dots_ref
from torch_parity import (ACC, D, K, MAX_TOPK, N_TEST, N_TRAIN, NLIST,
                          ROW_CAP, make_data)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


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
