"""``IndexIVFPQR`` (``index/ivfpqr.py``), port against the JAX package: a
4000 x 32 Gaussian corpus in IVF8 with PQ4 codes and a 16-byte refine PQ,
built by the JAX package and carried over with its codes
(``convert.ivfpqr_from_numpy``). Search at k_factors 1 to 64 (the base
IVFPQ scan at up to k 640, then the one-pass re-rank), the two-stage reconstructions,
the refine training from the same first stage (numpy-drawn initial
codebooks: k-means++ draws from each framework's own generator), the
``k_factor`` knob, the tiny and empty cases, the inner-product refusal,
the ``IVFPQR`` file in both directions, and the port's own build end to
end. Ids equal; values within 1e-5 relative; reconstructions bitwise."""

import functools

import numpy as np
import pytest
import torch

import auncel_tpu.autotune as jat
import auncel_tpu.ops.kmeans as jkm
import auncel_tpu.ops.pq as jpq
from auncel_tpu.index.ivfpqr import IndexIVFPQR as JPQR
from auncel_tpu.types import Metric as JMetric
from torch_parity import DEVICE, as_numpy, tnp
import auncel_tpu_torch.autotune as tat
import auncel_tpu_torch.ops.kmeans as tkm
import auncel_tpu_torch.ops.pq as tpq
from auncel_tpu_torch import convert
from auncel_tpu_torch.convert import ivf_arrays_from_numpy
from auncel_tpu_torch.index.factory import index_factory
from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.index.ivfpqr import IndexIVFPQR, first_stage
from auncel_tpu_torch.ops.knn import knn
from auncel_tpu_torch.types import Metric

D, NLIST, M, M_REFINE, K = 32, 8, 4, 16, 10


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.RandomState(7)
    xb = rng.randn(4000, D).astype(np.float32)
    xq = rng.randn(64, D).astype(np.float32)
    return xb, xq


def _state(j) -> dict:
    """A JAX IndexIVFPQR's state as the IVFPQR file holds it."""
    sorted_ids, pos, codes, books = j._ensure_refine()
    a = j.arrays
    return dict(d=j.d, nlist=j.nlist, M=int(j.storage[2:]),
                M_refine=j.M_refine, k_factor=j.k_factor,
                metric=j.metric.value, ntotal=j.ntotal,
                centroids=j.centroids, db=np.asarray(a.db),
                vec_ids=np.asarray(a.vec_ids),
                list_sizes=np.asarray(a.list_sizes),
                pq_books=np.asarray(a.pq_codebooks),
                refine_books=np.asarray(books),
                refine_codes=np.asarray(codes),
                refine_sorted_ids=np.asarray(sorted_ids),
                refine_pos=np.asarray(pos))


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX index, the port's on its codes)."""
    xb, _ = _data()
    j = JPQR(D, NLIST, M=M, M_refine=M_REFINE, k_factor=4.0)
    j.train(xb)
    j.add(xb)
    return j, convert.ivfpqr_from_numpy(_state(j), device=DEVICE)


def _terms(q, idx, ids):
    """||q||^2 + ||recon||^2 of each result: the scale of its distance."""
    rec = idx.reconstruct_batch(np.maximum(ids, 0).reshape(-1)).reshape(
        ids.shape + (D,))
    return (q * q).sum(1)[:, None] + (rec * rec).sum(-1)


@pytest.mark.parametrize("k_factor", [1.0, 4.0, 8.0, 64.0])
def test_search_matches_jax(k_factor):
    """k_factor 64 is the top of ParameterSpace's sweep: the base search
    asks for k 640."""
    j, t = _pair()
    _, xq = _data()
    for x in (j, t):
        x.k_factor = k_factor
    for nprobe in (1, 4):
        tv, ti = t.search(xq, K, nprobe=nprobe)
        jv, ji = j.search(xq, K, nprobe=nprobe)
        np.testing.assert_array_equal(ti, ji)
        terms = _terms(xq, t, ti)
        assert (np.abs(tv - jv) <= 1e-5 * terms).all()
    assert ti.dtype == np.int64 and tv.dtype == np.float32
    for x in (j, t):
        x.k_factor = 4.0


def test_reconstruct_matches_jax():
    """Two-stage reconstructions bitwise (the first stage is bitwise the
    base index's; KeyError for an id not stored)."""
    j, t = _pair()
    keys = np.array([5, 0, 3999, 17, 17], np.int64)
    np.testing.assert_array_equal(t.reconstruct_batch(keys),
                                  j.reconstruct_batch(keys))
    np.testing.assert_array_equal(t.reconstruct(42), j.reconstruct(42))
    sorted_ids, pos, _, _ = t._ensure_refine()
    rows = torch.as_tensor(np.searchsorted(sorted_ids, keys))
    np.testing.assert_array_equal(
        tnp(first_stage(t.arrays, pos[rows])),
        IVFFlatIndex.reconstruct_batch(t, keys))
    with pytest.raises(KeyError):
        t.reconstruct_batch(np.array([4000], np.int64))


def test_refine_training_matches_jax(monkeypatch):
    """The refine PQ trained on the JAX package's first stage, both from
    numpy-drawn initial codebooks: the same stored-id order and slots,
    codebooks within 1e-5 and equal codes."""
    for mod, kmod in ((tpq, tkm), (jpq, jkm)):
        real = kmod.KmeansParams
        monkeypatch.setattr(mod, "KmeansParams",
                            lambda real=real, **kw: real(init="random", **kw))
    xb, _ = _data()
    j = JPQR(D, NLIST, M=M, M_refine=M_REFINE)
    j.train(xb)
    j.add(xb[:1500])
    want = j._ensure_refine()
    t = IndexIVFPQR(D, NLIST, M=M, M_refine=M_REFINE, device=DEVICE)
    t.set_centroids(j.centroids)
    t.add(xb[:1500])
    # the JAX package's packed first stage in place of the port's own
    t._arrays = ivf_arrays_from_numpy(as_numpy(j.arrays), DEVICE)
    got = t._ensure_refine()
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(tnp(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(tnp(got[3]), np.asarray(want[3]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tnp(got[2]), np.asarray(want[2]))
    assert t._ensure_refine() is got    # cached until the next repack


def test_k_factor_knob_matches_jax():
    j, t = _pair()
    dims = dict(tat.ParameterSpace(t).parameter_ranges())
    assert dims == dict(jat.ParameterSpace(j).parameter_ranges())
    assert dims["k_factor"] == [1, 2, 4, 8, 16, 32, 64]
    tat.set_index_parameter(t, "k_factor", 8)
    assert t.k_factor == 8.0
    tat.set_index_parameters(t, "k_factor=4,nprobe=2")
    assert (t.k_factor, t.nprobe) == (4.0, 2)
    t.nprobe = 1


def test_tiny_and_empty_match_jax():
    """An empty index answers inf / -1; an index of fewer vectors than
    k_factor * k pads the base candidates with -1, masked in the re-rank,
    as in the JAX package."""
    xb, xq = _data()
    for x in (IndexIVFPQR(D, NLIST, M=M, M_refine=8, device=DEVICE),
              JPQR(D, NLIST, M=M, M_refine=8)):
        v, i = x.search(xq[:3], K)
        assert (i == -1).all() and np.isinf(v).all() and v.shape == (3, K)
    j = JPQR(D, 2, M=M, M_refine=8)
    j.train(xb[:500])
    j.add(xb[:6])
    t = convert.ivfpqr_from_numpy(_state(j), device=DEVICE)
    tv, ti = t.search(xq[:5], K, nprobe=2)
    jv, ji = j.search(xq[:5], K, nprobe=2)
    np.testing.assert_array_equal(ti, ji)
    assert (ti[:, 6:] == -1).all() and np.isinf(tv[:, 6:]).all()
    np.testing.assert_allclose(tv[:, :6], jv[:, :6], rtol=1e-5)


def test_inner_product_is_refused():
    with pytest.raises(AssertionError):
        IndexIVFPQR(D, NLIST, metric=Metric.IP, device=DEVICE)
    with pytest.raises(AssertionError):
        JPQR(D, NLIST, metric=JMetric.IP)
    with pytest.raises(AssertionError):
        index_factory(D, "IVF8,PQ4+8", Metric.IP, device=DEVICE)


def test_ivfpqr_files_in_both_directions(tmp_path):
    """Each package reads the other's IVFPQR file with the exact codes:
    equal searches and reconstructions; a loaded index refuses add until
    reset, as in the JAX package."""
    from auncel_tpu.index.io import load_index as jload, save_index as jsave
    from auncel_tpu_torch.index.io import load_index, save_index
    j, t = _pair()
    _, xq = _data()
    save_index(t, str(tmp_path / "t.npz"))
    jsave(j, str(tmp_path / "j.npz"))
    back_j = jload(str(tmp_path / "t.npz"))
    back_t = load_index(str(tmp_path / "j.npz"), device=DEVICE)
    _, want = j.search(xq, K, nprobe=4)
    for x in (back_j, back_t):
        np.testing.assert_array_equal(x.search(xq, K, nprobe=4)[1], want)
    keys = np.arange(0, 4000, 97, dtype=np.int64)
    np.testing.assert_array_equal(back_t.reconstruct_batch(keys),
                                  j.reconstruct_batch(keys))
    with pytest.raises(RuntimeError):
        back_t.add(xq)
    back_t.reset()
    assert back_t.ntotal == 0
    back_t.train(_data()[0])
    back_t.add(_data()[0][:300])
    assert back_t.search(xq[:2], K, nprobe=8)[1].min() >= 0


def test_port_build_beats_its_base_ivfpq():
    """The port's own train, add and search (tests/test_twolevel_pqr.py's
    check): the refine re-rank raises recall@10 over the IVFPQ it
    refines, and the second stage halves the reconstruction error. The
    factory builds the same cell."""
    xb, xq = _data()
    gt = knn(xq, xb, K, Metric.L2, device=DEVICE).ids
    base = IVFFlatIndex(D, NLIST, storage="pq4", device=DEVICE)
    pqr = index_factory(D, "IVF8,PQ4+16", device=DEVICE)
    assert isinstance(pqr, IndexIVFPQR) and pqr.M_refine == 16
    for x in (base, pqr):
        x.train(xb)
        x.add(xb)

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / K
                        for a, b in zip(ids.tolist(), gt.tolist())])
    r_base = recall(base.search(xq, K, nprobe=4)[1])
    r_pqr = recall(pqr.search(xq, K, nprobe=4)[1])
    assert r_pqr > r_base + 0.05, (r_pqr, r_base)
    keys = np.arange(50, dtype=np.int64)
    e1 = np.square(IVFFlatIndex.reconstruct_batch(pqr, keys) - xb[:50]).sum()
    e2 = np.square(pqr.reconstruct_batch(keys) - xb[:50]).sum()
    assert e2 < 0.5 * e1, (e2, e1)
