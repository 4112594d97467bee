"""The LSH indexes (``index/lsh.py``), port against the JAX package on a
clustered corpus (4000 x 32, queries at the clusters' local scale):
``random_rotation``, ``IndexLSH`` with and without rotation and trained
thresholds, and ``IVFSpectralHashIndex`` with each threshold type on the
JAX package's coarse centroids (carried by
``convert.spectral_hash_from_numpy``). Codes are held equal except for
bits within 1e-5 relative of their threshold; searches on the same codes
give equal ids and distances. The factory cells and the empty index."""

import functools

import numpy as np
import pytest

import auncel_tpu.index.lsh as jlsh
from auncel_tpu.data.synthetic import make_clustered_dataset
from torch_parity import DEVICE, tnp
import auncel_tpu_torch.index.lsh as tlsh
from auncel_tpu_torch import convert
from auncel_tpu_torch.index.factory import index_factory
from auncel_tpu_torch.index.flat import FlatIndex

D, K, NLIST = 32, 10, 8
THRESHOLDS = ("global", "centroid", "centroid_half", "median")


@functools.lru_cache(maxsize=None)
def _ds():
    return make_clustered_dataset(nb=4000, nq=32, d=D, n_clusters=16,
                                  query_mode="perturb", seed=7)


def _same_codes(got, want, proj, thr, rel=1e-5):
    """{0,1} codes equal except where the projection lies within ``rel``
    (relative) of its threshold: a one-ulp difference there flips a bit."""
    near = np.abs(proj - thr) <= rel * np.maximum(np.abs(proj), 1.0)
    assert ((got == want) | near).all()


def test_random_rotation_matches_jax():
    for d, nbits in ((16, 16), (16, 40), (32, 8)):
        np.testing.assert_array_equal(tlsh.random_rotation(d, nbits, 3),
                                      jlsh.random_rotation(d, nbits, 3))
    r = tlsh.random_rotation(16, 16, seed=3)
    np.testing.assert_allclose(r.T @ r, np.eye(16), atol=1e-5)


@pytest.mark.parametrize("rotate, train", [(True, False), (True, True),
                                           (False, False), (False, True)])
def test_lsh_matches_jax(rotate, train):
    """The same signatures, then on the JAX package's signatures the same
    Hamming ids and distances (float, ties to the lower id)."""
    ds = _ds()
    nbits = 64 if rotate else 24
    j = jlsh.IndexLSH(D, nbits, rotate_data=rotate, train_thresholds=train)
    t = tlsh.IndexLSH(D, nbits, rotate_data=rotate, train_thresholds=train,
                      device=DEVICE)
    assert t.is_trained == j.is_trained == (not train)
    for x in (j, t):
        x.train(ds.xb[:2000])
        x.add(ds.xb)
    np.testing.assert_array_equal(t.thresholds, j.thresholds)
    _same_codes(t._bits, j._bits, j._project(ds.xb), j.thresholds)
    np.testing.assert_array_equal(t.codes, j.codes)
    tc = convert.lsh_from_numpy(dict(
        d=D, nbits=nbits, rotate_data=rotate, train_thresholds=train,
        rrot=j.rrot, thresholds=j.thresholds, bits=j._bits), device=DEVICE)
    for k in (1, K, 4100):
        tv, ti = tc.search(ds.xq, k)
        jv, ji = j.search(ds.xq, k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
    assert (ti[:, 4000:] == -1).all() and np.isinf(tv[:, 4000:]).all()
    # a stored vector is its own nearest signature
    v, i = t.search(ds.xb[:8], 1)
    assert (v[:, 0] == 0).all()


@functools.lru_cache(maxsize=None)
def _sh_pair(threshold_type: str):
    ds = _ds()
    j = jlsh.IVFSpectralHashIndex(D, NLIST, 16, threshold_type=threshold_type)
    j.train(ds.xb[:2000])
    j.add(ds.xb)
    return j


@pytest.mark.parametrize("threshold_type", THRESHOLDS)
def test_spectral_hash_matches_jax(threshold_type):
    """From the JAX package's coarse centroids the port trains the same
    thresholds and period; on the same state it stores the same codes in
    the same lists, and its search (the query binarised per probed list
    on the device) gives the same ids and distances."""
    ds = _ds()
    j = _sh_pair(threshold_type)
    t = tlsh.IVFSpectralHashIndex(D, NLIST, 16, threshold_type=threshold_type,
                                  device=DEVICE)
    t.set_centroids(ds.xb[:2000], j.centroids)
    assert t.period == j.period
    np.testing.assert_array_equal(t.trained, j.trained)
    tc = convert.spectral_hash_from_numpy(dict(
        d=D, nlist=NLIST, nbit=16, threshold_type=threshold_type,
        period=j.period, rrot=j.rrot, centroids=j.centroids,
        trained=j.trained, x=ds.xb, ids=np.arange(len(ds.xb))),
        device=DEVICE)
    tc._build()
    j._build()
    got, want = tc._packed, j._packed
    np.testing.assert_array_equal(tnp(got[3]), np.asarray(want[3]))
    assign = jlsh._assign_lists(ds.xb, j.centroids)
    proj = ds.xb @ j.rrot
    live = np.asarray(want[3]) >= 0
    # the stored planes, with the projections at their slots
    pslot = np.zeros(live.shape + (16,), np.float32)
    tslot = np.zeros_like(pslot)
    ids = np.asarray(want[3])[live]
    pslot[live] = proj[ids] * (2.0 / j.period)
    tslot[live] = j.trained[assign[ids]] * (2.0 / j.period)
    _same_codes(tnp(got[2]), np.asarray(want[2]), pslot, tslot)
    for nprobe in (1, 3, NLIST):
        tv, ti = tc.search(ds.xq, K, nprobe=nprobe)
        jv, ji = j.search(ds.xq, K, nprobe=nprobe)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)


def test_spectral_hash_chunked_search_and_recall(monkeypatch):
    """A scan cut into chunks of one query gives the same answer; the
    port's own build (k-means, the estimated period, 128 bits, every list
    probed) on tests/test_lsh.py's corpus finds neighbours far beyond
    chance, with the limits of test_spectral_hash_recall there."""
    ds = _ds()
    j = _sh_pair("centroid_half")
    tc = convert.spectral_hash_from_numpy(dict(
        d=D, nlist=NLIST, nbit=16, threshold_type="centroid_half",
        period=j.period, rrot=j.rrot, centroids=j.centroids,
        trained=j.trained, x=ds.xb, ids=np.arange(len(ds.xb))),
        device=DEVICE)
    want = tc.search(ds.xq, K, nprobe=2)
    monkeypatch.setattr(tlsh, "SH_BLOCK", 1)
    got = tc.search(ds.xq, K, nprobe=2)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    monkeypatch.undo()
    # the JAX test's corpus and cell
    big = make_clustered_dataset(nb=10_000, nq=32, d=D, n_clusters=32,
                                 query_mode="perturb", seed=7)
    idx = tlsh.IVFSpectralHashIndex(D, 32, 128, device=DEVICE)
    idx.train(big.xb[:5000])
    idx.add(big.xb)
    _, ids = idx.search(big.xq, K, nprobe=32)
    flat = FlatIndex(D, device=DEVICE)
    flat.add(big.xb)
    _, gt = flat.search(big.xq, K)
    rec = np.mean([len(set(a) & set(b)) / K
                   for a, b in zip(ids.tolist(), gt.tolist())])
    top1 = np.mean([g[0] in set(r.tolist()) for g, r in zip(gt, ids)])
    assert rec >= 0.15 and top1 >= 0.7, (rec, top1)


def test_factory_lsh_cells_and_empty_index():
    """LSHn[r][t] and IVFn,SHn build and serve; an empty trained spectral
    hash index answers -1 and inf, as the JAX package's does."""
    ds = _ds()
    lsh = index_factory(D, "LSH64rt", device=DEVICE)
    assert isinstance(lsh, tlsh.IndexLSH)
    assert (lsh.nbits, lsh.rotate_data, lsh.train_thresholds) == \
        (64, True, True)
    lsh.train(ds.xb)
    lsh.add(ds.xb)
    assert lsh.search(ds.xq, K)[1].shape == (32, K)
    sh = index_factory(D, "IVF8,SH16", device=DEVICE)
    assert isinstance(sh, tlsh.IVFSpectralHashIndex) and sh.nbit == 16
    sh.train(ds.xb[:2000])
    v, i = sh.search(ds.xq[:3], 5, nprobe=2)
    jsh = jlsh.IVFSpectralHashIndex(D, NLIST, 16)
    jsh.train(ds.xb[:2000])
    jv, ji = jsh.search(ds.xq[:3], 5, nprobe=2)
    np.testing.assert_array_equal(i, ji)
    assert (i == -1).all() and np.isinf(v).all() and np.isinf(jv).all()
    sh.add(ds.xb)
    assert sh.ntotal == 4000 and sh.search(ds.xq, K, nprobe=2)[1].min() >= 0
