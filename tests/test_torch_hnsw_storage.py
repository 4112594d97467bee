"""HNSW over compressed storage, port against the JAX package:
``IndexHNSWSQ`` (SQ8 codes), ``IndexHNSWPQ`` (PQ codes) and
``IndexHNSW2Level`` (a coarse list id and the PQ code of the residual,
over k-means lists or IMI product cells). Each index is the port's build,
carried into the JAX package by its ``.npz`` and back by
``convert.hnsw_from_numpy`` (the JAX package fuses the SQ decode into one
FMA under jit, and its k-means draws differ, so both search one graph on
one set of codes): equal ids and values within 1e-5. The codes stay on the
device and decode at every gather; the host mirror holds the decoded
vectors."""

import functools
import io

import numpy as np
import pytest
import torch

from auncel_tpu.index import hnsw as jh
from torch_parity import DEVICE, hnsw_state, jax_hnsw_from_port
from auncel_tpu_torch import convert
from auncel_tpu_torch.index import hnsw as th
from auncel_tpu_torch.index.factory import index_factory

D, N, NQ, EF = 16, 500, 30, 24


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.RandomState(21)
    c = rng.randn(10, D).astype(np.float32)
    xb = (c[rng.randint(0, 10, N)] + 0.4 * rng.randn(N, D)).astype(
        np.float32)
    xq = (c[rng.randint(0, 10, NQ)] + 0.5 * rng.randn(NQ, D)).astype(
        np.float32)
    return xb, xq


CELLS = {"sq8": "HNSW8_SQ8", "pq4": "HNSW8_PQ4", "2level": "HNSW8_8+PQ4",
         "2level imi": "HNSW8_2x2+PQ4"}
KINDS = {"sq8": th.IndexHNSWSQ, "pq4": th.IndexHNSWPQ,
         "2level": th.IndexHNSW2Level, "2level imi": th.IndexHNSW2Level}
WIDTH = {"sq8": D, "pq4": 4, "2level": 8, "2level imi": 8}


@functools.lru_cache(maxsize=None)
def _built(cell: str):
    xb, _ = _data()
    t = index_factory(D, CELLS[cell], device=DEVICE)
    t.ef_construction = 24
    t.train(xb)
    t.add(xb)
    t.build()
    return t, jax_hnsw_from_port(t)


@pytest.mark.parametrize("cell", list(CELLS))
def test_storage_on_the_device(cell):
    """The device holds uint8 codes of the cell's width, and the host
    mirror the vectors they decode to (the device's decode, bitwise)."""
    t, _ = _built(cell)
    assert isinstance(t, KINDS[cell])
    store = t._dev[0]
    assert store.dtype == torch.uint8 and tuple(store.shape) == (N,
                                                                WIDTH[cell])
    dec = th.storage_decode(store, t._codec).numpy()
    np.testing.assert_array_equal(dec, t._xb)


@pytest.mark.parametrize("cell", list(CELLS))
def test_search_on_one_graph_matches_jax(cell):
    t, j = _built(cell)
    assert type(j).__name__ == type(t).__name__
    np.testing.assert_allclose(np.asarray(j._xb), t._xb, rtol=1e-6,
                               atol=1e-6)
    _, xq = _data()
    jv, ji = j.search(xq, 10, ef=EF)
    tv, ti = t.search(xq, 10, ef=EF)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    # distances are on the decoded vectors
    exact = ((xq[:, None, :] - t._xb[ti]) ** 2).sum(-1)
    np.testing.assert_allclose(tv, exact, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell", list(CELLS))
def test_converted_and_reloaded(cell):
    """convert.hnsw_from_numpy on the JAX index's state, and the JAX
    package's own file of it, give the port's index back: its codes,
    decoded vectors and answers."""
    t, j = _built(cell)
    _, xq = _data()
    want = t.search(xq, 10, ef=EF)[1]
    c = convert.hnsw_from_numpy(hnsw_state(j), device=DEVICE)
    buf = io.BytesIO()
    j.save(buf)
    buf.seek(0)
    back = th.HNSWIndex.load(buf, device=DEVICE)
    for idx in (c, back):
        assert type(idx) is type(t)
        assert torch.equal(idx._dev[0], t._dev[0])
        np.testing.assert_array_equal(idx._xb, t._xb)
        np.testing.assert_array_equal(idx.search(xq, 10, ef=EF)[1], want)


def test_compressed_recall_on_the_decoded_corpus():
    """Recall@10 against exact search over the decoded vectors (what the
    index can rank by) stays at the JAX tests' limits (SQ8 0.85, PQ
    0.80)."""
    _, xq = _data()
    for cell, limit in (("sq8", 0.85), ("pq4", 0.80)):
        t, _ = _built(cell)
        _, i = t.search(xq, 10, ef=64)
        gt = np.argsort(((xq[:, None, :] - t._xb[None]) ** 2).sum(-1),
                        axis=1, kind="stable")[:, :10]
        rec = np.mean([len(set(a) & set(b)) / 10
                       for a, b in zip(i.tolist(), gt.tolist())])
        assert rec >= limit, (cell, rec)


def test_untrained_save_and_reset():
    """An untrained compressed index saves (no codes) and loads untrained
    in both packages; reset empties codes and graph."""
    t = th.IndexHNSWPQ(D, pq_m=4, M=8, device=DEVICE)
    buf = io.BytesIO()
    t.save(buf)
    buf.seek(0)
    back = th.HNSWIndex.load(buf, device=DEVICE)
    assert isinstance(back, th.IndexHNSWPQ) and not back.is_trained
    buf.seek(0)
    assert not jh.HNSWIndex.load(buf).is_trained
    s, _ = _built("sq8")
    s2 = convert.hnsw_from_numpy(s.state(), device=DEVICE)
    s2.reset()
    assert s2.ntotal == 0 and s2._codes.shape == (0, D)


def test_factory_graph_cells_match_jax():
    """The HNSW cells build the JAX package's classes with its knobs."""
    from auncel_tpu.index.factory import index_factory as jfac
    for desc in ("HNSW16", "HNSW32,Flat", "HNSW16_SQ8", "HNSW16_PQ8",
                 "HNSW16_8+PQ4", "HNSW16_2x3+PQ4"):
        for metric in ("l2", "ip"):
            t, j = index_factory(32, desc, metric, device=DEVICE), \
                jfac(32, desc, metric)
            assert type(t).__name__ == type(j).__name__, desc
            assert (t.M, t.d, t.metric.value, t.ef_search,
                    t.ef_construction) == (j.M, j.d, j.metric.value,
                                           j.ef_search, j.ef_construction)
            assert getattr(t, "pq_m", None) == getattr(j, "pq_m", None)
            if hasattr(j, "storage"):
                assert (t.storage.nlist, t.storage.M) == (j.storage.nlist,
                                                          j.storage.M)
                assert type(t.storage.quantizer).__name__ == \
                    type(j.storage.quantizer).__name__
