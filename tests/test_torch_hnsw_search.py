"""HNSW search on float data, port against the JAX package on one graph: a
build on generic floats can flip an occlusion comparison by an ulp between
the packages (their fp32 products sum in other orders), so each graph here
is the port's build carried into the JAX package by its file
(``torch_parity.jax_hnsw_from_port``) and back by ``convert``; then equal
ids and values within 1e-5, under L2 and inner product. Also the
reconstruct-from-neighbours re-rank (``index/hnsw_recons.py``) on the JAX
package's codebook, and the ``IVFn_HNSWm`` coarse quantizer (the lists of
fixed-nprobe search ranked through a graph over the centroids, then K2's
padded scan) against the JAX package's ``_search_hnsw_coarse``."""

import functools

import numpy as np
import pytest

from auncel_tpu.index.hnsw_recons import ReconstructFromNeighbors as JRFN
from torch_parity import DEVICE, as_numpy, hnsw_state, jax_hnsw_from_port
from auncel_tpu_torch import convert
from auncel_tpu_torch.index import hnsw as th
from auncel_tpu_torch.index.hnsw_recons import ReconstructFromNeighbors
from auncel_tpu_torch.index.ivf import IVFFlatIndex

D, N, NQ, M, EF = 16, 600, 40, 8, 24


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.RandomState(12)
    c = rng.randn(12, D).astype(np.float32)
    xb = (c[rng.randint(0, 12, N)] + 0.4 * rng.randn(N, D)).astype(
        np.float32)
    xq = (c[rng.randint(0, 12, NQ)] + 0.5 * rng.randn(NQ, D)).astype(
        np.float32)
    return xb, xq


@functools.lru_cache(maxsize=None)
def _graphs(metric: str):
    xb, _ = _data()
    t = th.HNSWIndex(D, M=M, metric=metric, ef_construction=24,
                     device=DEVICE)
    t.add(xb)
    t.build()
    return t, jax_hnsw_from_port(t)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_search_on_one_graph_matches_jax(metric):
    t, j = _graphs(metric)
    _, xq = _data()
    jv, ji = j.search(xq, 10, ef=EF)
    tv, ti = t.search(xq, 10, ef=EF)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    # and the JAX graph carried back by convert answers alike
    c = convert.hnsw_from_numpy(hnsw_state(j), device=DEVICE)
    np.testing.assert_array_equal(c.search(xq, 10, ef=EF)[1], ji)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_batch1_equals_the_batch(metric):
    """Each query's search is independent of the others in its batch."""
    t, _ = _graphs(metric)
    _, xq = _data()
    v, i = t.search(xq, 10, ef=EF)
    for r in (0, 7, NQ - 1):
        v1, i1 = t.search(xq[r:r + 1], 10, ef=EF)
        np.testing.assert_array_equal(i1[0], i[r])
        np.testing.assert_array_equal(v1[0], v[r])


@functools.lru_cache(maxsize=None)
def _recons():
    """The JAX package's codebook, trained on the L2 graph (k-means draws
    differ between the packages, so the codebook is carried across)."""
    t, j = _graphs("l2")
    xb, _ = _data()
    jr = JRFN(j, k=16, nsq=2)
    jr.train_codebook(xb[:300])
    jr.add_codes(xb)
    tr = ReconstructFromNeighbors(t, k=16, nsq=2)
    tr.codebook = np.array(jr.codebook)
    tr.add_codes(xb)
    return jr, tr


def test_recons_codes_and_reconstructions_match_jax():
    jr, tr = _recons()
    np.testing.assert_array_equal(tr.codes, jr.codes)
    np.testing.assert_allclose(tr.reconstruct_n(0, 50),
                               jr.reconstruct_n(0, 50), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tr.reconstruct(7), jr.reconstruct(7),
                               rtol=1e-5, atol=1e-5)
    _, xq = _data()
    short = np.array([[3, 9, -1], [0, 1, 2]])
    np.testing.assert_allclose(tr.compute_distances(xq[:2], short),
                               jr.compute_distances(xq[:2], short),
                               rtol=1e-5, atol=1e-5)


def test_recons_rerank_matches_jax():
    """``reconstruct_from_neighbors`` re-ranks the top k_reorder by the
    refined reconstructions, as the JAX package's search does; a
    converted index carries the codebook and codes across."""
    jr, tr = _recons()
    t, j = _graphs("l2")
    _, xq = _data()
    jr.k_reorder = tr.k_reorder = 5
    j.reconstruct_from_neighbors, t.reconstruct_from_neighbors = jr, tr
    try:
        jv, ji = j.search(xq, 10, ef=EF)
        tv, ti = t.search(xq, 10, ef=EF)
        c = convert.hnsw_from_numpy(hnsw_state(j), device=DEVICE)
        cv, ci = c.search(xq, 10, ef=EF)
    finally:
        j.reconstruct_from_neighbors = t.reconstruct_from_neighbors = None
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ci, ji)
    assert c.reconstruct_from_neighbors.k_reorder == 5
    plain = t.search(xq, 10, ef=EF)[1]
    assert not np.array_equal(plain[:, :5], ti[:, :5])   # it re-ranked


def test_recons_trains_its_own_codebook():
    """The port's own training (k-means on its own generator): each
    node's code is the codebook row whose weights reconstruct it best, a
    segment at a time."""
    t, _ = _graphs("l2")
    xb, _ = _data()
    r = ReconstructFromNeighbors(t, k=16, nsq=2)
    r.train_codebook(xb[:300])
    r.add_codes(xb)
    assert r.codebook.shape == (2, 16, 2 * M + 1) and r.ntotal == N
    ids = np.arange(0, N, 29)
    T = r.get_neighbor_table(ids).astype(np.float64)     # [n, M+1, d]
    for s in range(2):
        seg = slice(s * (D // 2), (s + 1) * (D // 2))
        rec = np.einsum("ki,nid->nkd", r.codebook[s].astype(np.float64),
                        T[:, :, seg])
        err = ((rec - xb[ids][:, None, seg]) ** 2).sum(-1)   # [n, k]
        chosen = err[np.arange(ids.size), r.codes[ids, s]]
        np.testing.assert_allclose(chosen, err.min(1), rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _ivf(metric: str):
    """IVF16_HNSW6 in both packages on the JAX package's packed arrays and
    one coarse graph (the port's, carried into the JAX index)."""
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    xb, _ = _data()
    rng = np.random.RandomState(2)
    cents = xb[rng.permutation(N)[:16]]
    j = JIVF(D, 16, metric)
    j.set_centroids(cents)
    j.add(xb)
    j.coarse_hnsw_m = 6
    t = IVFFlatIndex.from_state(cents, convert.ivf_arrays_from_numpy(
        as_numpy(j.arrays), DEVICE), metric)
    t.coarse_hnsw_m = 6
    j._hnswq = jax_hnsw_from_port(t.hnsw_quantizer())
    return j, t


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("nprobe", [2, 5])
def test_ivf_hnsw_coarse_matches_jax(metric, nprobe):
    j, t = _ivf(metric)
    _, xq = _data()
    np.testing.assert_array_equal(
        t.hnsw_probes(xq, nprobe),
        j._hnsw_quantizer().search(xq, nprobe, ef=max(4 * nprobe, 64))[1])
    jv, ji = j.search(xq, 10, nprobe=nprobe)
    tv, ti = t.search(xq, 10, nprobe=nprobe)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    for row in ti:                    # no duplicate from a clamped probe
        real = row[row >= 0]
        assert len(set(real.tolist())) == real.size


def test_ivf_hnsw_graph_follows_the_centroids():
    """The coarse graph is built over the centroids at the first search
    and dropped when they change; the exact rank is untouched."""
    _, t = _ivf("l2")
    g = t.hnsw_quantizer()
    assert g.ntotal == 16 and g.M == 6 and g is t.hnsw_quantizer()
    np.testing.assert_array_equal(g._xb, t.centroids)
    t2 = IVFFlatIndex(D, 16, device=DEVICE)
    t2.set_centroids(t.centroids)
    t2.coarse_hnsw_m = 6
    g2 = t2.hnsw_quantizer()
    t2.set_centroids(t.centroids + 1.0)
    assert t2._hnswq is None and t2.hnsw_quantizer() is not g2
