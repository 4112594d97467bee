"""``Index2Layer`` and ``transfer_to_ivfpq`` (``index/twolayer.py``), port
against the JAX package: a 4000 x 32 Gaussian corpus over 16 coarse
lists with 8-byte PQ codes of the residuals, trained by the JAX package
and carried over (``convert.twolayer_from_numpy``). The codes of ``add``,
the reconstructions, the exact decoded search, the transfer into a
residual-PQ IVF index (exactly these codes, reconstructions bitwise
``reconstruct_n``'s, search by K2's plain version here), the code sizes,
the IMI coarse quantizer and the ``2Layer`` file in both directions. Ids
equal; values within 1e-5 relative."""

import functools

import numpy as np
import pytest

from auncel_tpu.index.imi import train_imi_centroids as j_train_imi
from auncel_tpu.index.twolayer import (IMICoarseQuantizer as JIMIQ,
                                       Index2Layer as J2L)
from auncel_tpu.types import Metric as JMetric
from torch_parity import DEVICE, tnp
from auncel_tpu_torch import convert
from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.index.twolayer import IMICoarseQuantizer, Index2Layer
from auncel_tpu_torch.ops.knn import knn
from auncel_tpu_torch.types import Metric

D, NLIST, M, K = 32, 16, 8, 10


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.RandomState(7)
    return (rng.randn(4000, D).astype(np.float32),
            rng.randn(64, D).astype(np.float32))


def _state(j) -> dict:
    return dict(d=j.d, nlist=j.nlist, M=j.M, metric=j.metric.value,
                centroids=j.centroids,
                books=np.asarray(j._pq.codebooks), list_ids=j.list_ids,
                codes=j.codes)


@functools.lru_cache(maxsize=None)
def _pair():
    xb, _ = _data()
    j = J2L(D, NLIST, M=M)
    j.train(xb)
    j.add(xb)
    return j, convert.twolayer_from_numpy(_state(j), device=DEVICE)


def test_add_matches_jax():
    """Adding the same vectors on the same coarse centroids and books gives
    the same list ids and PQ codes; reset empties both."""
    j, _ = _pair()
    xb, _ = _data()
    t = convert.twolayer_from_numpy(_state(j), device=DEVICE)
    t.reset()
    assert t.ntotal == 0
    t.add(xb[:2500])
    t.add(xb[2500:])
    np.testing.assert_array_equal(t.list_ids, j.list_ids)
    np.testing.assert_array_equal(t.codes, j.codes)
    assert t.codes.dtype == np.uint8 and t.list_ids.dtype == np.int32


def test_reconstruct_and_search_match_jax():
    j, t = _pair()
    _, xq = _data()
    np.testing.assert_array_equal(t.reconstruct_n(0, 300),
                                  j.reconstruct_n(0, 300))
    np.testing.assert_array_equal(t.reconstruct(1234), j.reconstruct(1234))
    tv, ti = t.search(xq, K)
    jv, ji = j.search(xq, K)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    assert ti.dtype == np.int64


def test_transfer_to_ivfpq_matches_jax():
    """The transferred index holds exactly the codes (the JAX package's
    layout: cap = the largest list, ids = positions), its decoded
    residual norms within 1e-5, reconstructions bitwise reconstruct_n's,
    and fixed-nprobe search the JAX transfer's ids."""
    j, t = _pair()
    _, xq = _data()
    ti, ji = t.transfer_to_ivfpq(), j.transfer_to_ivfpq()
    assert isinstance(ti, IVFFlatIndex) and ti.storage == f"pq{M}"
    a, ja = ti.arrays, ji.arrays
    assert a.pq_residual and ti.ntotal == t.ntotal
    for name in ("db", "vec_ids", "list_sizes", "pq_codebooks",
                 "centroids"):
        np.testing.assert_array_equal(tnp(getattr(a, name)),
                                      np.asarray(getattr(ja, name)))
    np.testing.assert_allclose(tnp(a.db_sq), np.asarray(ja.db_sq),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ti.reconstruct_n(0, t.ntotal),
                                  t.reconstruct_n())
    for nprobe in (2, NLIST):
        tv, tids = ti.search(xq, K, nprobe=nprobe)
        jv, jids = ji.search(xq, K, nprobe=nprobe)
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    # at nprobe = nlist the IVF scan is the exact decoded search
    np.testing.assert_array_equal(ti.search(xq, K, nprobe=NLIST)[1],
                                  t.search(xq, K)[1])


def test_train_builds_a_working_index():
    """The port's own train (k-means, or a given quantizer) and add: the
    JAX test's reconstruction and recall checks, the code sizes."""
    xb, xq = _data()
    gt = knn(xq, xb, K, Metric.L2, device=DEVICE).ids
    t = Index2Layer(D, NLIST, M=M, device=DEVICE)
    t.train(xb)
    t.add(xb)
    assert (t.code_size_1, t.code_size_2, t.code_size) == (1, M, 1 + M)
    assert Index2Layer(D, 1 << 10, M=M, device=DEVICE).code_size_1 == 2
    rec = t.reconstruct_n(0, 200)
    assert np.square(rec - xb[:200]).sum() / np.square(xb[:200]).sum() \
        < 0.35
    _, ids = t.search(xq, K)
    assert np.mean([len(set(a) & set(b)) / K
                    for a, b in zip(ids.tolist(), gt.tolist())]) > 0.5


def test_imi_coarse_quantizer_matches_jax():
    """IMICoarseQuantizer on the JAX package's product centroids: the same
    assignment, and an Index2Layer over it encodes the same list ids."""
    xb, _ = _data()
    cents = j_train_imi(xb, 16, JMetric.L2)
    jq, tq = JIMIQ(D, 2), IMICoarseQuantizer(D, 2, device=DEVICE)
    jq.centroids, tq.centroids = cents, cents
    assert tq.nlist == 16
    np.testing.assert_array_equal(tq.assign(xb), jq.assign(xb))
    j = J2L(D, 16, M=M, quantizer=jq)
    j.train(xb)
    j.add(xb[:500])
    t = Index2Layer(D, 16, M=M, quantizer=tq, device=DEVICE)
    t.centroids, t._pq, t.is_trained = (
        cents, convert.twolayer_from_numpy(_state(j), DEVICE)._pq, True)
    t.add(xb[:500])
    np.testing.assert_array_equal(t.list_ids, j.list_ids)
    np.testing.assert_array_equal(t.codes, j.codes)
    fresh = IMICoarseQuantizer(D, 2, device=DEVICE)
    fresh.train(xb)
    assert fresh.centroids.shape == (16, D)


@pytest.mark.parametrize("trained", [True, False])
def test_2layer_files_in_both_directions(tmp_path, trained):
    """Each package reads the other's 2Layer file: the same codes,
    reconstructions and (trained) searches."""
    from auncel_tpu.index.io import load_index as jload, save_index as jsave
    from auncel_tpu_torch.index.io import load_index, save_index
    j, t = _pair() if trained else (J2L(D, NLIST, M=M),
                                    Index2Layer(D, NLIST, M=M,
                                                device=DEVICE))
    _, xq = _data()
    save_index(t, str(tmp_path / "t.npz"))
    jsave(j, str(tmp_path / "j.npz"))
    back_j = jload(str(tmp_path / "t.npz"))
    back_t = load_index(str(tmp_path / "j.npz"), device=DEVICE)
    assert isinstance(back_t, Index2Layer)
    for x in (back_j, back_t):
        assert x.is_trained == trained and x.ntotal == t.ntotal
        np.testing.assert_array_equal(x.codes, j.codes)
        np.testing.assert_array_equal(x.list_ids, j.list_ids)
    if trained:
        np.testing.assert_array_equal(back_t.reconstruct_n(),
                                      j.reconstruct_n())
        np.testing.assert_array_equal(back_j.search(xq, K)[1],
                                      j.search(xq, K)[1])
        np.testing.assert_array_equal(back_t.search(xq, K)[1],
                                      j.search(xq, K)[1])
