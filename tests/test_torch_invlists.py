"""Parity of the port's composed inverted lists (``index/invlists.py``) and
``index/ivflib.py`` with the JAX package, on the shared fixture's
centroids and vectors split into two halves by id parity: each
composition gives the JAX package's lists (codes, ids, sizes, centroids)
and norms within 1e-6, and each ivflib function its indexes and search
ids."""

import functools

import numpy as np
import pytest

from tests.torch_parity import (D, DEVICE, K, NLIST, as_numpy, jax_fixture,
                                tnp)


@functools.lru_cache(maxsize=None)
def halves(storage: str = "f32"):
    """JAX indexes holding the even and the odd ids, and the full one, on
    the fixture's centroids, with each one's state carried into a port
    index: ((jax_even, jax_odd, jax_full), (even, odd, full))."""
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.convert import ivf_arrays_from_numpy
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    ids = np.arange(len(f["xb"]), dtype=np.int64)
    out = []
    for sel in (ids % 2 == 0, ids % 2 == 1, ids >= 0):
        j = JIVF(D, NLIST, storage=storage)
        j.set_centroids(f["centers"])
        j.add(f["xb"][sel], ids[sel])
        out.append(j)
    port = tuple(IVFFlatIndex.from_state(
        j.centroids, ivf_arrays_from_numpy(as_numpy(j.arrays), DEVICE))
        for j in out)
    return tuple(out), port


def _assert_same_lists(got, want):
    np.testing.assert_array_equal(tnp(got.vec_ids), np.asarray(want.vec_ids))
    np.testing.assert_array_equal(tnp(got.list_sizes),
                                  np.asarray(want.list_sizes))
    np.testing.assert_array_equal(tnp(got.db), np.asarray(want.db))
    np.testing.assert_array_equal(tnp(got.centroids),
                                  np.asarray(want.centroids))
    np.testing.assert_allclose(tnp(got.db_sq), np.asarray(want.db_sq),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("how", ["hstack", "vstack", "slice", "masked"])
def test_compositions_match_jax(how):
    from auncel_tpu.index import invlists as jil
    from auncel_tpu_torch.index import invlists as il
    (je, jo, _), (e, o, _) = halves()
    if how == "hstack":
        want = jil.hstack_invlists([je.arrays, jo.arrays])
        got = il.hstack_invlists([e.arrays, o.arrays])
    elif how == "vstack":
        want = jil.vstack_invlists([je.arrays, jo.arrays])
        got = il.vstack_invlists([e.arrays, o.arrays])
    elif how == "slice":
        want = jil.slice_invlists(jo.arrays, 5, 19)
        got = il.slice_invlists(o.arrays, 5, 19)
    else:
        # the lists of an index holding 40 vectors patched over the even
        # half: its empty lists keep the even half's
        from auncel_tpu_torch.convert import ivf_arrays_from_numpy
        from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
        f = jax_fixture()
        js = JIVF(D, NLIST)
        js.set_centroids(f["centers"])
        js.add(f["xb"][:40], np.arange(9000, 9040))
        small = ivf_arrays_from_numpy(as_numpy(js.arrays), DEVICE)
        assert (tnp(small.list_sizes) == 0).any()
        want = jil.masked_invlists(je.arrays, js.arrays)
        got = il.masked_invlists(e.arrays, small)
    _assert_same_lists(got, want)


def test_hstack_serves_the_union():
    """The two halves stacked list by list search like the full index."""
    from auncel_tpu_torch.index.invlists import hstack_invlists
    from auncel_tpu_torch.index.scan import ivf_search_fixed
    import torch
    _, (e, o, full) = halves()
    st = hstack_invlists([e.arrays, o.arrays])
    q = torch.as_tensor(jax_fixture()["xq"])
    v1, i1 = ivf_search_fixed(st, q, K, 8, full.metric)
    v2, i2 = ivf_search_fixed(full.arrays, q, K, 8, full.metric)
    np.testing.assert_array_equal(np.sort(tnp(i1), 1), np.sort(tnp(i2), 1))
    np.testing.assert_allclose(tnp(v1), tnp(v2), rtol=1e-5)


def test_compositions_check_the_codec():
    from auncel_tpu_torch.index import invlists as il
    _, (e, _, _) = halves()
    _, (s8, _, _) = halves("sq8")
    with pytest.raises(AssertionError, match="codec"):
        il.vstack_invlists([e.arrays, s8.arrays])
    with pytest.raises(AssertionError, match="codec"):
        il.masked_invlists(e.arrays, s8.arrays)


def _fresh(centers, metric="l2", storage="f32"):
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    j = JIVF(D, NLIST, metric, storage=storage)
    p = IVFFlatIndex(D, NLIST, metric, device=DEVICE, storage=storage)
    for x in (j, p):
        x.set_centroids(centers)
    return j, p


def _same_search(j, p, q, nprobe=6):
    jv, ji = j.search(q, K, nprobe=nprobe)
    pv, pi = p.search(q, K, nprobe=nprobe)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-5)


def test_merge_copy_subset_and_sliding_window():
    from auncel_tpu.index import ivflib as jlib
    from auncel_tpu_torch.index import ivflib as lib
    f = jax_fixture()
    q = f["xq"][:30]
    (je, jo, _), (e, o, _) = halves()
    jdst, dst = _fresh(f["centers"])
    assert (lib.copy_subset_to(o, dst, 1000, 3000)
            == jlib.copy_subset_to(jo, jdst, 1000, 3000))
    _same_search(jdst, dst, q)
    jsrc, src = _fresh(f["centers"])
    for x in (jsrc, src):
        x.add(f["xb"][:500], np.arange(5000, 5500))
    jlib.merge_into(jdst, jsrc)
    lib.merge_into(dst, src)
    assert src.ntotal == jsrc.ntotal == 0
    assert dst.ntotal == jdst.ntotal
    _same_search(jdst, dst, q)
    jw, w = _fresh(f["centers"])
    jwin, win = jlib.SlidingIndexWindow(jw, 2), lib.SlidingIndexWindow(w, 2)
    for s in range(3):
        x = f["xb"][s * 700:(s + 1) * 700]
        ids = np.arange(s * 700, (s + 1) * 700)
        jwin.step(x, ids)
        win.step(x, ids)
        assert w.ntotal == jw.ntotal
        _same_search(jw, w, q)
    assert tnp(w.arrays.vec_ids).min() == -1
    assert tnp(w.arrays.vec_ids)[tnp(w.arrays.vec_ids) >= 0].min() == 700


def test_invlist_ranges_and_parameters():
    from auncel_tpu.index import ivflib as jlib
    from auncel_tpu_torch.index import ivflib as lib
    f = jax_fixture()
    q = f["xq"][:30]
    (je, jo, jfull), (e, o, full) = halves()
    # lists 4-12 of the odd half spliced over the even half's
    jdst, dst = _fresh(f["centers"])
    jdst.add(*jlib.extract_vectors(je))
    dst.add(*lib.extract_vectors(e))
    jsl = jlib.get_invlist_range(jo, 4, 12)
    sl = lib.get_invlist_range(o, 4, 12)
    _assert_same_lists(sl, jsl)
    jlib.set_invlist_range(jdst, 4, 12, jsl)
    lib.set_invlist_range(dst, 4, 12, sl)
    assert dst.ntotal == jdst.ntotal
    _same_search(jdst, dst, q, nprobe=NLIST)
    with pytest.raises(ValueError, match="does not match"):
        lib.set_invlist_range(dst, 4, 13, sl)
    # one search at explicit settings leaves the index's own unchanged
    full.nprobe = jfull.nprobe = 1
    jv, ji = jlib.search_with_parameters(jfull, q, K, nprobe=5, max_codes=60)
    pv, pi = lib.search_with_parameters(full, q, K, nprobe=5, max_codes=60)
    np.testing.assert_array_equal(pi, ji)
    assert (full.nprobe, full.max_codes) == (1, 0)
    jv, ji, jc = jlib.search_and_return_centroids(jfull, q, K, 4)
    pv, pi, pc = lib.search_and_return_centroids(full, q, K, 4)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(lib.search_centroid(full, q),
                                  jlib.search_centroid(jfull, q))


def test_extract_and_check_compatible():
    from auncel_tpu_torch.index import ivflib as lib
    from auncel_tpu_torch.index.meta import IndexIDMap
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    _, (e, o, _) = halves()
    assert lib.extract_index_ivf(IndexIDMap(e)) is e
    with pytest.raises(TypeError, match="no IVF"):
        lib.extract_index_ivf(object())
    lib.check_compatible_for_merge(e, o)
    other = IVFFlatIndex(D, NLIST, device=DEVICE)
    other.set_centroids(f["centers"] + 1.0)
    with pytest.raises(ValueError, match="quantizer"):
        lib.check_compatible_for_merge(e, other)
    x, ids = lib.extract_vectors(o)
    np.testing.assert_array_equal(np.sort(ids), np.arange(1, 4000, 2))
    np.testing.assert_array_equal(x[np.argsort(ids)], f["xb"][1::2])
