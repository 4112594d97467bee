"""Fixed-nprobe ``IVFFlatIndex.search``, port against the JAX package: the
route it takes on the multi-row layout (the dense crossover or the row
gathers) for the same ``dense_cut``, batch, nprobe and row count, with the
JAX package's ids; and the ``max_codes`` code-visit budget on both layouts
at the cases of tests/test_max_codes.py."""

import functools

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import DEVICE, jax_fixture, tnp
from auncel_tpu.index import ivf as jivf
from auncel_tpu.index import multirow as jmr
from auncel_tpu_torch.index import ivf as tivf

B, K = 20, 10


@functools.lru_cache(maxsize=None)
def _indexes(row_cap: int):
    """(port, JAX) indexes on the fixture's centroids and vectors with the
    multi-row layout at ``row_cap`` (1: 4000 rows, past the 2048-row
    floor; 64: fewer than it)."""
    f = jax_fixture()
    out = []
    for cls, kw in ((tivf.IVFFlatIndex, dict(device=DEVICE)),
                    (jivf.IVFFlatIndex, {})):
        idx = cls(tp.D, tp.NLIST, **kw)
        idx.set_centroids(f["centers"])
        idx.add(f["xb"])
        idx.enable_multirow(row_cap=row_cap)
        out.append(idx)
    return tuple(out)


def _routed(monkeypatch, module, name):
    """Count the calls of module.name (the dense route's entry)."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, spy)
    return calls


# (row_cap, dense_cut, nprobe, dense): the JAX route for B = 20 queries.
# Past the floor the batch goes dense iff B * nprobe >= 64 * 0.25 * nlist
# (= 512): nprobe 26 and more.
ROUTES = [(1, 0.25, 8, False), (1, 0.25, 30, True), (1, None, 30, False),
          (64, 0.25, 30, False), (64, 0.0, 8, True), (1, 0.0, 3, True)]


@pytest.mark.parametrize("row_cap, cut, nprobe, dense", ROUTES)
def test_dense_crossover_route_matches_jax(monkeypatch, row_cap, cut,
                                           nprobe, dense):
    idx, jidx = _indexes(row_cap)
    assert (idx.multirow.rows.db.shape[0] >= 2048) == (row_cap == 1)
    q = jax_fixture()["xq"][:B]
    t_calls = _routed(monkeypatch, tivf, "multirow_dense_fixed")
    j_calls = _routed(monkeypatch, jmr, "multirow_dense_fixed")
    for i in (idx, jidx):
        i.dense_cut = cut
    route = idx.dense_route(B, nprobe)
    D, I = idx.search(q, K, nprobe=nprobe)
    jD, jI = jidx.search(q, K, nprobe=nprobe)
    for i in (idx, jidx):
        i.dense_cut = 0.25
    assert route == dense
    assert (len(t_calls), len(j_calls)) == (int(dense), int(dense))
    np.testing.assert_array_equal(I, jI)
    a = idx.arrays
    live = tnp(a.vec_ids) >= 0
    norms = np.zeros(tnp(a.vec_ids).max() + 1, np.float32)
    norms[tnp(a.vec_ids)[live]] = tnp(a.db_sq)[live]
    terms = (q * q).sum(1)[:, None] + norms[jI]
    assert (np.abs(D - jD) <= 1e-5 * terms).all()


def test_dense_and_gather_routes_agree():
    """The dense pass and the gathers have the same candidates."""
    idx, _ = _indexes(1)
    q = jax_fixture()["xq"][:B]
    idx.dense_cut = 0.0
    D, I = idx.search(q, K, nprobe=12)
    idx.dense_cut = None
    gD, gI = idx.search(q, K, nprobe=12)
    idx.dense_cut = 0.25
    np.testing.assert_array_equal(I, gI)
    np.testing.assert_allclose(D, gD, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _mc_indexes(multirow: bool):
    """(port, JAX) indexes on tests/test_max_codes.py's data and the JAX
    k-means centroids, padded or with rows of 32."""
    rng = np.random.RandomState(7)
    nb, d, nlist = 4000, 32, 32
    xb = rng.randn(nb, d).astype(np.float32)
    xq = rng.randn(20, d).astype(np.float32)
    jidx = jivf.IVFFlatIndex(d, nlist)
    jidx.train(xb)
    jidx.add(xb)
    idx = tivf.IVFFlatIndex(d, nlist, device=DEVICE)
    idx.set_centroids(jidx.centroids)
    idx.add(xb)
    if multirow:
        jidx.enable_multirow(row_cap=32)
        idx.enable_multirow(row_cap=32)
    return idx, jidx, xq


@pytest.mark.parametrize("multirow", [False, True])
@pytest.mark.parametrize("max_codes", [600, 10 ** 9])
def test_max_codes_matches_jax(multirow, max_codes):
    idx, jidx, xq = _mc_indexes(multirow)
    nprobe, k = 16, 5
    for i in (idx, jidx):
        i.max_codes = max_codes
    D, I = idx.search(xq, k, nprobe=nprobe)
    jD, jI = jidx.search(xq, k, nprobe=nprobe)
    for i in (idx, jidx):
        i.max_codes = 0
    np.testing.assert_array_equal(I, jI)
    np.testing.assert_allclose(D, jD, rtol=1e-5)
    if max_codes > 10 ** 6:   # never binds: the unlimited search
        D0, I0 = idx.search(xq, k, nprobe=nprobe)
        np.testing.assert_array_equal(I0, I)
        return
    # the budget binds, and each query's result is the fixed-nprobe search
    # at its own limit (the reference's break rule)
    _, cids = jidx.coarse_rank_np(xq)
    sizes = np.asarray(jidx.arrays.list_sizes)[cids[:, :nprobe]]
    g = np.minimum(nprobe, (np.cumsum(sizes, 1) < max_codes).sum(1) + 1)
    assert g.min() < nprobe
    for b in range(xq.shape[0]):
        Db, Ib = idx.search(xq[b:b + 1], k, nprobe=int(g[b]))
        np.testing.assert_array_equal(I[b], Ib[0])
