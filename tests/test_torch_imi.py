"""The IMI coarse quantizer (``index/imi.py``, ``IVFFlatIndex(coarse="imi")``)
and ``ErrorSys`` over IMI cells, port against the JAX package: the shared
fixture's data (d 16) over IMI2x3 (64 product cells) on the JAX package's
product centroids (carried by ``convert.imi_from_numpy``), on both
layouts. Training from numpy-drawn initial centroids (k-means++ draws from
each framework's own generator), the per-subspace assignment,
``MultiIndexQuantizer`` and ``MultiIndexQuantizer2``, fixed-nprobe search
with and without ``max_codes``, the profile, windows, batch-1 windows and
the decision waves (``decided_at``), the ``max_codes`` knob and the index
file. Ids, my_nprobe, n_scanned and decided_at equal; values within 1e-5
relative."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (ACC, D, DEVICE, K, MAX_TOPK, N_TEST, N_TRAIN,
                          ROW_CAP, as_numpy, make_data, tnp)
import auncel_tpu as at
import auncel_tpu.autotune as jat
import auncel_tpu.index.imi as jimi
import auncel_tpu.ops.kmeans as jkm
from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
from auncel_tpu.profile import bounded as jb
from auncel_tpu.profile import bounded_mr as jbm
from auncel_tpu.types import Metric as JMetric
import auncel_tpu_torch as att
import auncel_tpu_torch.autotune as tat
import auncel_tpu_torch.index.imi as timi
import auncel_tpu_torch.ops.kmeans as tkm
from auncel_tpu_torch import convert
from auncel_tpu_torch.profile import bounded as tb
from auncel_tpu_torch.profile import bounded_mr as tbm
from auncel_tpu_torch.types import Metric

NBIT = 3
NLIST = (1 << NBIT) ** 2   # 64 product cells
MULTIPLER = 4.0
LAYOUTS = ("padded", "multirow")


@functools.lru_cache(maxsize=None)
def _centroids() -> np.ndarray:
    """The JAX package's IMI product centroids on the fixture's corpus."""
    _, xb, _ = make_data()
    return jimi.train_imi_centroids(xb, NLIST, JMetric.L2)


@functools.lru_cache(maxsize=None)
def _indexes(layout: str):
    """(JAX index, port index) on the same product centroids and vectors."""
    _, xb, _ = make_data()
    jidx = JIVF(D, NLIST, coarse="imi")
    jidx.set_centroids(_centroids())
    jidx.add(xb)
    idx = convert.imi_from_numpy(_centroids(), device=DEVICE)
    idx.add(xb)
    if layout == "multirow":
        jidx.enable_multirow(row_cap=ROW_CAP)
        idx.enable_multirow(row_cap=ROW_CAP)
    return jidx, idx


@functools.lru_cache(maxsize=None)
def _systems(layout: str):
    """(port ErrorSys, JAX ErrorSys), each with its profile trained on the
    JAX package's ground truth, bounds ACC and multipler 4."""
    _, _, xq = make_data()
    jidx, idx = _indexes(layout)
    gt = jidx.exact_search(xq, MAX_TOPK)
    out = []
    for cls, index in ((att.ErrorSys, idx), (at.ErrorSys, jidx)):
        es = cls(index, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
        es.set_gt(*gt)
        es.sys_train(N_TRAIN, xq)
        es.set_topk(K)
        es.set_queries(N_TEST, xq, np.full(N_TRAIN + N_TEST, ACC,
                                           np.float32))
        es.set_hyper(MULTIPLER, 1.0)
        out.append(es)
    return out[0], out[1], gt


def test_train_imi_centroids_matches_jax():
    """Both subspace k-means from the same numpy-drawn initial centroids:
    product centroids within 1e-5; a non-square nlist or an odd d
    raises in both."""
    _, xb, _ = make_data()
    x = xb[:2000]
    t = timi.train_imi_centroids(x, NLIST, Metric.L2,
                                 tkm.KmeansParams(init="random", niter=6),
                                 device=DEVICE)
    j = jimi.train_imi_centroids(x, NLIST, JMetric.L2,
                                 jkm.KmeansParams(init="random", niter=6))
    assert t.shape == (NLIST, D)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    # the product layout: row i*K + j is (c1[i], c2[j])
    K_ = 1 << NBIT
    np.testing.assert_array_equal(t[3 * K_ + 5, :D // 2], t[3 * K_, :D // 2])
    np.testing.assert_array_equal(t[3 * K_ + 5, D // 2:], t[5, D // 2:])
    for args in ((x, 48), (x[:, :15], NLIST)):
        with pytest.raises(ValueError):
            timi.train_imi_centroids(args[0], args[1], Metric.L2,
                                     device=DEVICE)
        with pytest.raises(ValueError):
            jimi.train_imi_centroids(args[0], args[1], JMetric.L2)


def test_index_trains_imi_cells_like_jax():
    """IVFFlatIndex(coarse="imi").train and the factory's IMI2x3 cell, on
    numpy-drawn initial centroids: the same product centroids."""
    _, xb, _ = make_data()
    t = att.IVFFlatIndex(D, NLIST, coarse="imi", device=DEVICE,
                         kmeans_params=tkm.KmeansParams(init="random",
                                                        niter=6))
    j = JIVF(D, NLIST, coarse="imi",
             kmeans_params=jkm.KmeansParams(init="random", niter=6))
    for x in (t, j):
        x.train(xb[:2000])
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=1e-5,
                               atol=1e-5)
    f = att.index_factory(D, "IMI2x3,SQ8", device=DEVICE)
    assert (f.coarse, f.nlist, f.storage) == ("imi", NLIST, "sq8")


def test_imi_assign_matches_jax_and_the_product_argmin():
    _, xb, xq = make_data()
    cents = _centroids()
    for x in (xb, xq):
        got = timi.imi_assign(x, cents, device=DEVICE)
        np.testing.assert_array_equal(got, jimi.imi_assign(x, cents))
        d2 = ((x[:, None, :] - cents[None]) ** 2).sum(-1)
        np.testing.assert_array_equal(got, d2.argmin(1))
    assert got.dtype == np.int64


def _miq_pair():
    _, xb, _ = make_data()
    j = jimi.MultiIndexQuantizer(D, M=2, nbits=NBIT)
    j.train(xb)
    t = convert.miq_from_numpy(j.codebooks, NBIT, device=DEVICE)
    return j, t


def test_multi_index_quantizer_matches_jax():
    """Exact product-cell ranking (ids equal, values within 1e-5), k past
    the grid padded with inf and -1, the mixed-radix reconstruct, add
    refused."""
    j, t = _miq_pair()
    _, _, xq = make_data()
    for k in (1, 7, NLIST + 3):
        tv, ti = t.search(xq, k)
        jv, ji = j.search(xq, k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    assert (ti[:, NLIST:] == -1).all() and np.isinf(tv[:, NLIST:]).all()
    assert t.ntotal == j.ntotal == NLIST
    for key in (0, 9, NLIST - 1):
        np.testing.assert_array_equal(t.reconstruct(key), j.reconstruct(key))
    with pytest.raises(RuntimeError):
        t.add(xq)
    with pytest.raises(NotImplementedError):
        timi.MultiIndexQuantizer(D, M=2, nbits=11, device=DEVICE)


def test_multi_index_quantizer2_over_flat_matches_jax():
    """MultiIndexQuantizer2 with a FlatIndex assign index a subspace: the
    shortlist product equals the JAX package's and, the assign indexes
    being exact, the exact MIQ's ranking."""
    from auncel_tpu.index.flat import FlatIndex as JFlat
    from auncel_tpu_torch.index.flat import FlatIndex
    _, xb, xq = make_data()
    j2 = jimi.MultiIndexQuantizer2(D, 2, NBIT, [JFlat(D // 2) for _ in
                                                range(2)])
    j2.train(xb)
    t2 = convert.miq_from_numpy(
        j2.codebooks, NBIT, cls=timi.MultiIndexQuantizer2, device=DEVICE,
        assign_indexes=[FlatIndex(D // 2, device=DEVICE) for _ in range(2)])
    assert all(s.ntotal == 1 << NBIT for s in t2.assign_indexes)
    tv, ti = t2.search(xq, 10)
    jv, ji = j2.search(xq, 10)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    ev, ei = convert.miq_from_numpy(j2.codebooks, NBIT,
                                    device=DEVICE).search(xq, 10)
    np.testing.assert_array_equal(ti, ei)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_imi_fixed_search_matches_jax(layout):
    """The packed product cells equal, and fixed-nprobe search at nprobe 8
    and 64 (all cells), and with max_codes, gives the JAX package's ids."""
    jidx, idx = _indexes(layout)
    _, _, xq = make_data()
    a, ja = idx.arrays, jidx.arrays
    np.testing.assert_array_equal(tnp(a.vec_ids), np.asarray(ja.vec_ids))
    np.testing.assert_array_equal(tnp(a.list_sizes),
                                  np.asarray(ja.list_sizes))
    np.testing.assert_allclose(tnp(a.interdis), np.asarray(ja.interdis),
                               rtol=1e-5, atol=1e-5)
    for max_codes in (0, 150):
        for x in (idx, jidx):
            x.max_codes = max_codes
        for nprobe in (8, NLIST):
            tv, ti = idx.search(xq, K, nprobe=nprobe)
            jv, ji = jidx.search(xq, K, nprobe=nprobe)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    for x in (idx, jidx):
        x.max_codes = 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_errorsys_over_imi_matches_jax(layout):
    """The profile over product cells, the held-out window and batch-1
    windows: ids, my_nprobe and n_scanned equal; recall@10 >= 0.9 on
    average, the limit the JAX package's own IMI test holds
    (tests/test_imi.py)."""
    es, jes, gt = _systems(layout)
    ours, ref = as_numpy(jes.traces), es.traces
    np.testing.assert_array_equal(tnp(ref.n_bins), ours["n_bins"])
    for name in ("phi", "u", "std"):
        np.testing.assert_allclose(tnp(getattr(ref, name)), ours[name],
                                   rtol=1e-5, atol=1e-5)
    for start, size in ((N_TRAIN, N_TEST), (N_TRAIN, 1), (N_TRAIN + 7, 1)):
        D_, I_ = es.search(start, size)
        jD, jI = jes.search(start, size)
        sl = slice(start, start + size)
        np.testing.assert_array_equal(I_, np.asarray(jI))
        np.testing.assert_allclose(D_, np.asarray(jD), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(es.my_nprobe[sl], jes.my_nprobe[sl])
        np.testing.assert_array_equal(es.n_scanned[sl], jes.n_scanned[sl])
        if size == N_TEST:
            rec = np.mean([len(set(a) & set(b)) / K for a, b in zip(
                I_[:, :K].tolist(), gt[1][sl, :K].tolist())])
            assert rec >= 0.9, rec


@pytest.mark.parametrize("layout", LAYOUTS)
def test_imi_decision_waves_match_jax(layout):
    """The decision pass alone (bounded_search_decide on the padded
    lists, bounded_search_decide_mr on the rows): vals, ids, my_nprobe
    and decided_at."""
    es, jes, _ = _systems(layout)
    _, _, xq = make_data()
    q = xq[N_TRAIN:N_TRAIN + N_TEST]
    acc = np.full(N_TEST, 0.9, np.float32)
    acc[::3] = 0.95
    idx, jidx = es.index, jes.index
    args = (torch.from_numpy(acc), torch.tensor(MULTIPLER),
            torch.tensor(1.0))
    jargs = (jnp.asarray(acc), jnp.float32(MULTIPLER), jnp.float32(1.0))
    if layout == "padded":
        got = tb.bounded_search_decide(idx.arrays, es.traces,
                                       torch.from_numpy(q), *args, K,
                                       MAX_TOPK, Metric.L2)
        want = jb.bounded_search_decide(jidx.arrays, jes.traces,
                                        jnp.asarray(q), *jargs, K,
                                        MAX_TOPK, JMetric.L2)
    else:
        rpl = tnp(idx.multirow.rows_per_list)
        tplan = tbm.plan_mr_waves(rpl, NLIST, decide_only=True)
        jplan = jbm.plan_mr_waves(rpl, NLIST, decide_only=True)
        got = tbm.bounded_search_decide_mr(
            idx.arrays, idx.multirow, es.traces, torch.from_numpy(q), *args,
            K, MAX_TOPK, Metric.L2, tplan)
        want = jbm.bounded_search_decide_mr(
            jidx.arrays, jidx.multirow, jes.traces, jnp.asarray(q), *jargs,
            K, MAX_TOPK, JMetric.L2, jplan)
        got, want = got[0], want[0]   # (the resumable state, q_sq)
    got = [tnp(x) for x in got[:4]]
    want = [np.asarray(x) for x in want[:4]]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert len(set(got[3].tolist())) > 1   # decisions at several stages


def test_imi_knobs_and_lazy_interdis():
    """max_codes is ranged (2^8 ... 2^19 and unlimited) on IMI cells as
    the JAX package ranges it; above INTERDIS_EAGER_MAX cells the
    inter-centroid matrix waits for ensure_interdis."""
    jidx, idx = _indexes("padded")
    dims = dict(tat.ParameterSpace(idx).parameter_ranges())
    assert dims == dict(jat.ParameterSpace(jidx).parameter_ranges())
    assert dims["max_codes"] == [1 << i for i in range(8, 20)] + [np.inf]
    tat.set_index_parameters(idx, "max_codes=inf")
    assert idx.max_codes == 0
    tat.set_index_parameter(idx, "max_codes", 4096)
    assert idx.max_codes == 4096
    idx.max_codes = 0
    _, xb, _ = make_data()
    big = att.IVFFlatIndex(D, 2 ** 14, coarse="imi", device=DEVICE)
    big.set_centroids(timi.train_imi_centroids(
        xb, 2 ** 14, Metric.L2, tkm.KmeansParams(niter=2), device=DEVICE))
    assert big.interdis is None and big.is_trained


def test_imi_index_files_in_both_directions(tmp_path):
    """An IMI index is written as kind IVFFlat (the header carries no
    coarse quantizer) by either package and loads in the other with the
    same lists and results."""
    from auncel_tpu.index.io import load_index as jload, save_index as jsave
    from auncel_tpu_torch.index.io import load_index, save_index
    jidx, idx = _indexes("padded")
    _, _, xq = make_data()
    save_index(idx, str(tmp_path / "t.npz"))
    jsave(jidx, str(tmp_path / "j.npz"))
    with np.load(str(tmp_path / "t.npz")) as z:
        assert '"kind": "IVFFlat"' in str(z["header"])
    back_j = jload(str(tmp_path / "t.npz"))
    back_t = load_index(str(tmp_path / "j.npz"), device=DEVICE)
    for x in (back_j, back_t):
        assert x.nlist == NLIST and x.ntotal == idx.ntotal
    _, want = jidx.search(xq, K, nprobe=8)
    np.testing.assert_array_equal(back_t.search(xq, K, nprobe=8)[1], want)
    np.testing.assert_array_equal(back_j.search(xq, K, nprobe=8)[1], want)
