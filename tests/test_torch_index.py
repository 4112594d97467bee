"""Parity of the port's index layer with the JAX package on the shared
fixture: coarse ranking, the probe scan (through K1's plain version on the
CPU), the multi-row repack and probe expansion, fixed-nprobe and exact
search, packing and k-means. Ids and decisions exact; distances rtol 1e-5
(the kscaling band: the same fp32 products, summed in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (D, DEVICE, NLIST, ROW_CAP, as_numpy, jax_fixture,
                          port_state, tnp)
from auncel_tpu.index import scan as jscan
from auncel_tpu.index import multirow as jmr
from auncel_tpu.index.ivf import compute_interdis as j_interdis
from auncel_tpu.ops import kmeans as jkm
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.index import scan as tscan
from auncel_tpu_torch.index import multirow as tmr
from auncel_tpu_torch.index.ivf import IVFFlatIndex, compute_interdis
from auncel_tpu_torch.ops import kmeans as tkm
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.topk import init_topk
from auncel_tpu_torch.types import Metric

L2 = Metric.L2


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_coarse_rank_and_interdis_match():
    f = jax_fixture()
    _, arrays, _, _ = port_state()
    q = f["xq"]
    jd, ji = jscan.coarse_rank(f["idx"].arrays, jnp.asarray(q), JMetric.L2,
                               rank_k=12)
    td, ti = tscan.coarse_rank(arrays, torch.from_numpy(q), L2, rank_k=12)
    np.testing.assert_array_equal(tnp(ti), np.asarray(ji))
    _close(tnp(td), np.asarray(jd))
    for m, jm in ((L2, JMetric.L2), (Metric.IP, JMetric.IP)):
        np.testing.assert_allclose(
            compute_interdis(f["centers"], m, DEVICE),
            j_interdis(f["centers"], jm),
            rtol=1e-5, atol=1e-5)


def test_scan_probe_range_matches_jax():
    """Ragged per-query start and limit over the padded lists."""
    f = jax_fixture()
    _, arrays, _, _ = port_state()
    ja = f["idx"].arrays
    rng = np.random.RandomState(0)
    q = f["xq"][:24]
    B, k = q.shape[0], 12
    _, cids = tscan.coarse_rank(arrays, torch.from_numpy(q), L2)
    start = rng.randint(0, 6, B).astype(np.int32)
    limit = (start + rng.randint(0, 9, B)).astype(np.int32)
    vals, ids = init_topk((B,), k, L2, "cpu")
    tv, ti = tscan.scan_probe_range(
        arrays, torch.from_numpy(q), sqnorms(torch.from_numpy(q)), cids,
        vals, ids, torch.from_numpy(limit), torch.from_numpy(start), 7, L2,
        probe_chunk=3)
    jv, ji = jscan.init_topk((B,), k, JMetric.L2)
    jv, ji = jscan.scan_probe_range(
        ja, jnp.asarray(q), jnp.sum(jnp.asarray(q) ** 2, -1),
        jnp.asarray(tnp(cids)), jv, ji, jnp.asarray(limit),
        jnp.asarray(start), 7, JMetric.L2)
    np.testing.assert_array_equal(tnp(ti), np.asarray(ji))
    _close(tnp(tv), np.asarray(jv))


def test_build_multirow_copies_the_padded_layout_exactly():
    f = jax_fixture()
    _, arrays, _, _ = port_state()
    mr = tmr.build_multirow(arrays, ROW_CAP)
    want = as_numpy(f["idx"].multirow)
    for name in ("row_table", "rows_per_list", "row_base", "row_list"):
        np.testing.assert_array_equal(tnp(getattr(mr, name)), want[name])
    for name in ("db", "db_sq", "vec_ids", "list_sizes"):
        np.testing.assert_array_equal(tnp(getattr(mr.rows, name)),
                                      want["rows"][name])
    assert mr.max_rows > 1  # the fixture really has multi-row lists


def test_expand_probes_and_fixed_search_match():
    f = jax_fixture()
    _, _, mr, _ = port_state()
    jmrows = f["idx"].multirow
    q = f["xq"][:20]
    _, cids = tscan.coarse_rank(mr.rows, torch.from_numpy(q), L2)
    rpl = np.sort(tnp(mr.rows_per_list))[::-1]
    for nprobe in (1, NLIST):  # one list, and the whole expansion
        out_slots = int(rpl[:nprobe].sum())
        got = tmr.expand_probes(mr, cids, nprobe, out_slots)
        want = jmr.expand_probes(jmrows, jnp.asarray(tnp(cids)), nprobe,
                                 out_slots)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(tnp(g), np.asarray(w))
        tv, ti = tmr.multirow_search_fixed(mr, torch.from_numpy(q), 10,
                                           nprobe, out_slots, L2)
        jv, ji = jmr.multirow_search_fixed(jmrows, jnp.asarray(q), 10,
                                           nprobe, out_slots, JMetric.L2)
        np.testing.assert_array_equal(tnp(ti), np.asarray(ji))
        _close(tnp(tv), np.asarray(jv))


def test_exact_search_and_index_search_match():
    f = jax_fixture()
    index, _, _, _ = port_state()
    q = f["xq"]
    gv, gi = index.exact_search(q, 20, batch=64)
    np.testing.assert_array_equal(gi, f["gt_I"])
    _close(gv, f["gt_D"])
    # nprobe = nlist over the rows is exact too
    v, i = index.search(q, 10, nprobe=NLIST)
    np.testing.assert_array_equal(i, f["gt_I"][:, :10])
    _close(v, f["gt_D"][:, :10])


@pytest.mark.parametrize("cap_quantile", [1.0, 0.8])
def test_pack_matches_jax_layout(cap_quantile):
    """From the same centroids the port packs the same lists, slots and ids
    (with and without the quantile cap's spilling); stored norms within
    one rounding of the sum."""
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    f = jax_fixture()
    xb = f["xb"][:1500]
    ours = IVFFlatIndex(D, NLIST, cap_quantile=cap_quantile, device=DEVICE)
    ours.set_centroids(f["centers"])
    ours.add(xb)
    ref = JIVF(D, NLIST, cap_quantile=cap_quantile)
    ref.set_centroids(f["centers"])
    ref.add(xb)
    a, ja = ours.arrays, ref.arrays
    for name in ("vec_ids", "list_sizes", "db"):
        np.testing.assert_array_equal(tnp(getattr(a, name)),
                                      np.asarray(getattr(ja, name)))
    _close(tnp(a.db_sq), np.asarray(ja.db_sq))
    assert ours.ntotal == ref.ntotal


def test_storage_codecs_not_ported_raise():
    # the SQ and bf16 codecs (tests/test_torch_codecs.py) and PQ
    # (tests/test_torch_pq.py) are ported, and so is the IMI coarse
    # quantizer (tests/test_torch_imi.py); a storage name the JAX package
    # does not know, PQ whose M does not divide d, and a coarse quantizer
    # the port does not train raise
    assert IVFFlatIndex(D, NLIST, storage="pq8", device=DEVICE).storage \
        == "pq8"
    with pytest.raises(NotImplementedError):
        IVFFlatIndex(D, NLIST, storage="lsh8", device=DEVICE)
    with pytest.raises(ValueError):
        IVFFlatIndex(D, NLIST, storage="pq5", device=DEVICE)
    assert IVFFlatIndex(D, 64, coarse="imi", device=DEVICE).coarse == "imi"
    with pytest.raises(NotImplementedError):
        IVFFlatIndex(D, NLIST, coarse="hnsw", device=DEVICE)


def test_kmeans_steps_match_jax():
    f = jax_fixture()
    x = f["xb"][:1024]
    cents = f["centers"] + 0.1
    c_sq = (cents * cents).sum(1)
    ta, te = tkm._assign(torch.from_numpy(x), torch.from_numpy(cents),
                         torch.from_numpy(c_sq), 256)
    ja, je = jkm._assign(jnp.asarray(x), jnp.asarray(cents),
                         jnp.asarray(c_sq), 256)
    np.testing.assert_array_equal(tnp(ta), np.asarray(ja))
    _close(tnp(te), np.asarray(je))
    # a starving threshold exercises the donor split
    for thr in (0.0, 40.0):
        tc, tn = tkm._update(torch.from_numpy(x), ta, NLIST, False, thr)
        jc, jn = jkm._update(jnp.asarray(x), ja, NLIST, False,
                             jnp.float32(thr))
        np.testing.assert_array_equal(tnp(tn), np.asarray(jn))
        np.testing.assert_allclose(tnp(tc), np.asarray(jc), rtol=1e-5,
                                   atol=1e-5)


def test_kmeans_random_init_matches_jax():
    """Random init draws from numpy in both packages, so the whole Lloyd
    run (with balancing) lands on the same centroids."""
    f = jax_fixture()
    params = dict(niter=6, init="random", balance_iters=2, seed=5)
    t = tkm.kmeans(f["xb"][:2048], 16, tkm.KmeansParams(**params),
                   device=DEVICE)
    j = jkm.kmeans(f["xb"][:2048], 16, jkm.KmeansParams(**params))
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=1e-4,
                               atol=1e-4)
    assert abs(t.error - j.error) <= 1e-4 * j.error


def test_kmeanspp_trains_an_index():
    """k-means++ (torch.Generator draws) gives distinct data-point seeds and
    a usable quantizer: every vector is found by an exact-nprobe search."""
    f = jax_fixture()
    xb = f["xb"][:1500]
    gen = torch.Generator().manual_seed(0)
    seeds = tkm._kmeanspp_init(torch.from_numpy(xb), 16, gen)
    rows = {tuple(r) for r in xb.tolist()}
    assert all(tuple(s) in rows for s in tnp(seeds).tolist())
    assert len({tuple(s) for s in tnp(seeds).tolist()}) == 16
    idx = IVFFlatIndex(D, 16, kmeans_params=tkm.KmeansParams(niter=5),
                       device=DEVICE)
    idx.train(xb)
    idx.add(xb)
    sizes = tnp(idx.arrays.list_sizes)
    assert sizes.sum() == 1500 and (sizes > 0).all()
    _, i = idx.search(xb[:50], 1, nprobe=16)
    np.testing.assert_array_equal(i[:, 0], np.arange(50))
