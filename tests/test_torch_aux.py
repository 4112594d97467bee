"""Parity of the port's ``index/aux.py`` with the JAX package: the IVF
``range_search`` (K2's plain version here) on f32 L2 and IP, SQ8 and
residual PQ storage, with equal ``lims`` and ``labels`` and ``distances``
within 1e-5; ``remove_ids`` with both selectors on f32 and SQ8; and the
interrupt hook."""

import numpy as np
import pytest

from tests.torch_parity import (D, DEVICE, K, NLIST, as_numpy, codec_fixture,
                                jax_fixture, padded_systems, pq_fixture)


def _carried(jidx, metric="l2"):
    """The JAX index's packed state in a port index on the CPU."""
    from auncel_tpu_torch.convert import ivf_arrays_from_numpy
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    arrays = ivf_arrays_from_numpy(as_numpy(jidx.arrays), DEVICE)
    return IVFFlatIndex.from_state(jidx.centroids, arrays, metric=metric)


def _pair(kind: str):
    """(JAX index, port index on the same state) for a storage kind."""
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    if kind == "f32":
        es, jes = padded_systems()
        return jes.index, es.index
    if kind == "ip":
        f = jax_fixture()
        jidx = JIVF(D, NLIST, "ip")
        jidx.set_centroids(f["centers"])
        jidx.add(f["xb"])
        return jidx, _carried(jidx, "ip")
    if kind == "sq8":
        jidx = codec_fixture("sq8")
        return jidx, _carried(jidx)
    return pq_fixture(residual=True)


@pytest.mark.parametrize("kind", ["f32", "ip", "sq8", "pq_residual"])
def test_range_search_matches_jax(kind):
    from auncel_tpu.index.aux import range_search as jrange
    from auncel_tpu_torch.index.aux import range_search
    jidx, idx = _pair(kind)
    q = jax_fixture()["xq"][:30]
    v, _ = idx.search(q, K, nprobe=4)
    radius = float(np.median(v[:, K - 1]))
    for nprobe in (3, 12):
        want = jrange(jidx, q, radius, nprobe=nprobe)
        got = range_search(idx, q, radius, nprobe=nprobe)
        assert got.lims[-1] > 0
        np.testing.assert_array_equal(got.lims, want.lims)
        np.testing.assert_array_equal(got.labels, want.labels)
        np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5,
                                   atol=1e-5)


def test_range_search_query_chunks_change_nothing(monkeypatch):
    """Chunking over queries keeps the JAX package's row-major order."""
    import auncel_tpu_torch.index.aux as aux
    _, idx = _pair("f32")
    q = jax_fixture()["xq"][:25]
    whole = aux.range_search(idx, q, 4.0, nprobe=9)
    monkeypatch.setattr(aux, "RANGE_CHUNK_SLOTS", 1)
    chunked = aux.range_search(idx, q, 4.0, nprobe=9)
    for f in ("lims", "labels", "distances"):
        np.testing.assert_array_equal(getattr(chunked, f), getattr(whole, f))


@pytest.mark.parametrize("storage", ["f32", "sq8"])
@pytest.mark.parametrize("selector", ["range", "batch"])
def test_remove_ids_matches_jax(storage, selector):
    from auncel_tpu.index import aux as jaux
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.index import aux
    f = jax_fixture()
    jidx = JIVF(D, NLIST, storage=storage)
    jidx.set_centroids(f["centers"])
    jidx.add(f["xb"])
    idx = _carried(jidx)
    rng = np.random.RandomState(5)
    batch = rng.choice(len(f["xb"]), 300, replace=False)
    if selector == "range":
        jsel, sel = jaux.IDSelectorRange(100, 900), aux.IDSelectorRange(100,
                                                                       900)
    else:
        jsel, sel = jaux.IDSelectorBatch(batch), aux.IDSelectorBatch(batch)
    assert aux.remove_ids(idx, sel) == jaux.remove_ids(jidx, jsel)
    assert idx.ntotal == jidx.ntotal
    q = f["xq"][:30]
    jv, ji = jidx.search(q, K, nprobe=6)
    pv, pi = idx.search(q, K, nprobe=6)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-5)
    assert not np.isin(pi, batch if selector == "batch"
                       else np.arange(100, 900)).any()


def test_id_selectors_match_jax():
    from auncel_tpu.index import aux as jaux
    from auncel_tpu_torch.index import aux
    ids = np.arange(-3, 50)
    for jsel, sel in ((jaux.IDSelectorRange(5, 17), aux.IDSelectorRange(5,
                                                                       17)),
                      (jaux.IDSelectorBatch([3, 3, 40, 7]),
                       aux.IDSelectorBatch([3, 3, 40, 7])),
                      (jaux.IDSelectorBatch([]), aux.IDSelectorBatch([]))):
        np.testing.assert_array_equal(sel.is_member(ids),
                                      jsel.is_member(ids))


def test_interrupt_callback():
    from auncel_tpu_torch.index.aux import InterruptCallback
    flag = {"stop": False}
    InterruptCallback.install(lambda: flag["stop"])
    try:
        InterruptCallback.check()
        assert not InterruptCallback.is_interrupted()
        flag["stop"] = True
        assert InterruptCallback.is_interrupted()
        with pytest.raises(InterruptedError):
            InterruptCallback.check()
    finally:
        InterruptCallback.clear()
    InterruptCallback.check()
    assert not InterruptCallback.is_interrupted()
