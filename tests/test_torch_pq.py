"""Product quantization, port against the JAX package on the shared
fixture's data: ``ops/pq.py`` (encode, decode, training), the polysemous
reordering, and the PQ branches of the scan core (``scan_probe_range``,
``ivf_full_scan``, ``ivf_search_fixed_ht``, K2's plain version) on the same
residual and plain PQ state, carried over by ``convert``, on both metrics:
ids equal, values within 1e-5 of their terms (||q - c_l||^2 + db_sq for L2,
|<c_l, q>| + ||q|| ||r|| for IP), the SQ codecs' tolerance. The multi-row
layout refuses PQ in both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (D, DEVICE, NLIST, jax_fixture, pq_fixture, tnp)
from auncel_tpu.index import scan as jscan
from auncel_tpu.index.multirow import build_multirow as j_build_multirow
from auncel_tpu.ops import kmeans as jkm
from auncel_tpu.ops import pq as jpq
from auncel_tpu.ops import polysemous as jpoly
from auncel_tpu.ops.topk import init_topk as j_init_topk
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.index import scan as tscan
from auncel_tpu_torch.index.multirow import build_multirow
from auncel_tpu_torch.kernels.scan_scores import scan_scores_ref
from auncel_tpu_torch.ops import kmeans as tkm
from auncel_tpu_torch.ops import pq as tpq
from auncel_tpu_torch.ops import polysemous as tpoly
from auncel_tpu_torch.ops.topk import init_topk
from auncel_tpu_torch.types import Metric

NPROBE, K, B = 6, 10, 20
CASES = [(res, m) for res in (True, False) for m in ("l2", "ip")]


def _queries():
    return jax_fixture()["xq"][:B]


def _terms(idx, q: np.ndarray, ids: np.ndarray, metric: str) -> np.ndarray:
    """[B, k] magnitude of each result's score terms: ||q - c_l||^2 + db_sq
    (L2) or |<c_l, q>| + ||q|| ||r|| (IP), c_l the result's list centroid
    (zero for plain PQ), r its decoded code."""
    a = idx.arrays
    vid = tnp(a.vec_ids)
    live = vid >= 0
    lists = np.broadcast_to(np.arange(vid.shape[0])[:, None], vid.shape)
    owner = np.zeros(vid.max() + 1, np.int64)
    owner[vid[live]] = lists[live]
    norms = np.zeros(vid.max() + 1, np.float32)
    norms[vid[live]] = tnp(a.db_sq)[live]
    safe = np.maximum(ids, 0)
    cl = (tnp(a.centroids)[owner[safe]] if a.pq_residual
          else np.zeros(safe.shape + (q.shape[1],), np.float32))
    if metric == "l2":
        return ((q[:, None, :] - cl) ** 2).sum(-1) + norms[safe]
    return (np.abs((cl * q[:, None, :]).sum(-1))
            + np.sqrt((q * q).sum(1))[:, None] * np.sqrt(norms[safe]))


def _same(idx, q, got, want, metric):
    tv, ti = (np.asarray(x) for x in got)
    jv, ji = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    terms = _terms(idx, q, ji, metric)
    assert (np.abs(tv[fin] - jv[fin]) <= 1e-5 * terms[fin] + 1e-6).all()


def test_encode_decode_match_jax():
    """On the JAX index's own codebooks: equal codes (the argmin of c_sq -
    2 dot), and the decode bitwise (a gather)."""
    jidx, _ = pq_fixture()
    books = np.asarray(jidx.arrays.pq_codebooks)
    x = jax_fixture()["xb"][:1500]
    jcodes = np.asarray(jpq.encode_pq(jpq.PQCodebooks(jnp.asarray(books)),
                                      jnp.asarray(x)))
    tbooks = tpq.PQCodebooks(torch.from_numpy(books))
    tcodes = tnp(tpq.encode_pq(tbooks, torch.from_numpy(x)))
    np.testing.assert_array_equal(tcodes, jcodes)
    rec = tnp(tpq.decode_pq(tbooks, torch.from_numpy(jcodes)))
    want = np.asarray(jpq.decode_pq(jpq.PQCodebooks(jnp.asarray(books)),
                                    jnp.asarray(jcodes)))
    assert rec.tobytes() == want.tobytes()


def test_train_pq_matches_jax(monkeypatch):
    """train_pq from the same sample and seeds (seed + m a subspace): with
    numpy-drawn initial centroids in both packages (k-means++ draws from
    each framework's own generator, ops/kmeans.py), the codebooks agree
    within 1e-5."""
    for mod, kmod in ((tpq, tkm), (jpq, jkm)):
        real = kmod.KmeansParams
        monkeypatch.setattr(mod, "KmeansParams",
                            lambda real=real, **kw: real(init="random", **kw))
    x = jax_fixture()["xb"][:1024]
    t = tnp(tpq.train_pq(x, 4, niter=6, device=DEVICE).codebooks)
    j = np.asarray(jpq.train_pq(x, 4, niter=6).codebooks)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_reorder_codebook_same_permutation():
    jidx, _ = pq_fixture()
    book = np.asarray(jidx.arrays.pq_codebooks)[1]
    perm = tpoly.reorder_codebook(book, n_iter=2000, seed=7)
    np.testing.assert_array_equal(
        perm, jpoly.reorder_codebook(book, n_iter=2000, seed=7))
    assert tpoly.hamming_fit(book, perm) == jpoly.hamming_fit(book, perm)
    np.testing.assert_array_equal(tpoly.POPCOUNT8, jpoly.POPCOUNT8)
    b = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    np.testing.assert_array_equal(tnp(tscan.popcount8(b)), jpoly.POPCOUNT8)


@pytest.mark.parametrize("residual, metric", CASES)
def test_scan_probe_range_matches_jax(residual, metric):
    jidx, idx = pq_fixture(residual, metric)
    q = _queries()
    jm, tm = JMetric.parse(metric), Metric.parse(metric)
    qj, qt = jnp.asarray(q), torch.from_numpy(q)
    q_sq = (q * q).sum(1)
    _, jcids = jscan.coarse_rank(jidx.arrays, qj, jm)
    _, tcids = tscan.coarse_rank(idx.arrays, qt, tm)
    np.testing.assert_array_equal(tnp(tcids), np.asarray(jcids))
    limit = np.random.RandomState(1).randint(1, NPROBE + 1, B).astype(
        np.int32)
    jv, ji = j_init_topk((B,), K, jm)
    want = jscan.scan_probe_range(
        jidx.arrays, qj, jnp.asarray(q_sq), jcids, jv, ji,
        jnp.asarray(limit), 0, NPROBE, jm)
    tv, ti = init_topk((B,), K, tm, DEVICE)
    got = tscan.scan_probe_range(
        idx.arrays, qt, torch.from_numpy(q_sq), tcids, tv, ti,
        torch.from_numpy(limit), 0, NPROBE, tm)
    _same(idx, q, [tnp(x) for x in got], want, metric)


@pytest.mark.parametrize("residual, metric", CASES)
def test_ivf_full_scan_matches_jax(residual, metric):
    jidx, idx = pq_fixture(residual, metric)
    q = _queries()
    want = jscan.ivf_full_scan(jidx.arrays, jnp.asarray(q), K,
                               JMetric.parse(metric))
    got = tscan.ivf_full_scan(idx.arrays, torch.from_numpy(q), K,
                              Metric.parse(metric))
    _same(idx, q, [tnp(x) for x in got], want, metric)


@pytest.mark.parametrize("residual, metric", CASES)
def test_ivf_search_fixed_ht_matches_jax(residual, metric):
    """The polysemous filter at three thresholds (of the 32 bits of 4
    codes): equal ids and values; the tightest drops candidates that the
    unfiltered search returns."""
    jidx, idx = pq_fixture(residual, metric)
    q = _queries()
    for ht in (6, 10, 16):
        want = jscan.ivf_search_fixed_ht(jidx.arrays, jnp.asarray(q), K,
                                         NPROBE, jnp.int32(ht),
                                         JMetric.parse(metric))
        got = tscan.ivf_search_fixed_ht(idx.arrays, torch.from_numpy(q), K,
                                        NPROBE, ht, Metric.parse(metric))
        _same(idx, q, [tnp(x) for x in got], want, metric)
        if ht == 6:
            _, plain = tscan.ivf_search_fixed(idx.arrays, torch.from_numpy(q),
                                              K, NPROBE, Metric.parse(metric))
            assert (tnp(got[1]) != tnp(plain)).any()


@pytest.mark.parametrize("residual, metric", CASES)
def test_scan_scores_ref_matches_jax_route(residual, metric):
    """K2's plain version on PQ codes against the JAX package's scan over
    the same probes: every live candidate's score, read back by id from a
    top-k as wide as the probes' slots."""
    jidx, idx = pq_fixture(residual, metric)
    a = idx.arrays
    q = _queries()
    S = 3
    lists = np.random.RandomState(2).randint(-1, NLIST, (B, S)).astype(
        np.int32)
    q_sq = (q * q).sum(1)
    tm, jm = Metric.parse(metric), JMetric.parse(metric)
    scores, ids = scan_scores_ref(
        a.db, a.db_sq, a.vec_ids, a.list_sizes, torch.from_numpy(q),
        torch.from_numpy(q_sq), torch.from_numpy(lists), tm,
        **a.codec_kwargs())
    width = S * a.cap
    # the JAX scan takes a query's active probes as its first slots
    order = np.argsort(lists < 0, axis=1, kind="stable")
    lists_sorted = np.take_along_axis(lists, order, 1)
    jv, ji = jscan.scan_probe_range(
        jidx.arrays, jnp.asarray(q), jnp.asarray(q_sq),
        jnp.asarray(np.maximum(lists_sorted, 0)), *j_init_topk(
            (B,), width, jm), jnp.asarray((lists >= 0).sum(1).astype(
                np.int32)), 0, S, jm)
    jv, ji = np.asarray(jv), np.asarray(ji)
    sc, si = tnp(scores), tnp(ids)
    for b in range(B):
        mine = {int(i): float(v) for i, v in zip(si[b], sc[b]) if i >= 0}
        ref = {int(i): float(v) for i, v in zip(ji[b], jv[b]) if i >= 0}
        assert mine.keys() == ref.keys()
        keys = np.fromiter(ref, np.int64)
        terms = _terms(idx, q[b:b + 1], keys[None], metric)[0]
        diff = np.abs(np.array([mine[k] for k in keys])
                      - np.array([ref[k] for k in keys]))
        assert (diff <= 1e-5 * terms + 1e-6).all()


def test_multirow_refuses_pq_in_both_packages():
    jidx, idx = pq_fixture()
    with pytest.raises(AssertionError, match="multirow does not support PQ"):
        j_build_multirow(jidx.arrays, 64)
    with pytest.raises(AssertionError, match="multirow does not support PQ"):
        build_multirow(idx.arrays, 64)
    with pytest.raises(AssertionError):
        jidx.enable_multirow(64)
    with pytest.raises(AssertionError):
        idx.enable_multirow(64)


def test_port_pack_matches_jax():
    """The port's own _pack on the JAX package's codebooks reproduces its
    codes and norms: the same assignment, residuals and encode."""
    jidx, idx = pq_fixture()
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    ours = IVFFlatIndex(D, NLIST, device=DEVICE, storage="pq4")
    ours.set_centroids(f["centers"])
    ours.add(f["xb"])
    books = idx.arrays.pq_codebooks
    ours._train_pq = lambda x, assign, M: books
    a, ja = ours.arrays, jidx.arrays
    assert a.pq_residual
    for name in ("vec_ids", "list_sizes", "db"):
        np.testing.assert_array_equal(tnp(getattr(a, name)),
                                      np.asarray(getattr(ja, name)))
    np.testing.assert_allclose(tnp(a.db_sq), np.asarray(ja.db_sq),
                               rtol=1e-6, atol=1e-6)
