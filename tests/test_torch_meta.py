"""Parity of the port's federations (``IndexShards``, ``IndexSplitVectors``
and ``IndexReplicas`` of ``index/meta.py``) with the JAX package on the
shared fixture: IVF shards, position-keyed Flat shards with tied values
across shards (the merge keeps the JAX package's tie order: earlier shard,
then better rank), dimension splits and round-robin replicas."""

import numpy as np
import pytest

from tests.torch_parity import D, DEVICE, K, NLIST, jax_fixture


def _ivf_pair():
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    j = JIVF(D, NLIST)
    p = IVFFlatIndex(D, NLIST, device=DEVICE)
    for x in (j, p):
        x.set_centroids(f["centers"])
        x.nprobe = 4
    return j, p


def test_ivf_shards_match_jax():
    from auncel_tpu.index.meta import IndexShards as JShards
    from auncel_tpu_torch.index.meta import IndexShards
    f = jax_fixture()
    js, ps = JShards(D), IndexShards(D)
    for _ in range(3):
        j, p = _ivf_pair()
        js.add_shard(j)
        ps.add_shard(p)
    for x in (js, ps):
        x.add(f["xb"][:2500])
        x.add(f["xb"][2500:], ids=np.arange(7000, 8500))
    assert ps.ntotal == js.ntotal and ps.is_trained
    q = f["xq"]
    jv, ji = js.search(q, K)
    pv, pi = ps.search(q, K)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=1e-5)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_flat_shards_with_ties_match_jax(metric):
    """Each vector twice, the copies in different shards: every result has
    a tie across shards, and uneven adds exercise the position maps."""
    from auncel_tpu.index.flat import FlatIndex as JFlat
    from auncel_tpu.index.meta import IndexShards as JShards
    from auncel_tpu_torch.index.flat import FlatIndex
    from auncel_tpu_torch.index.meta import IndexShards
    f = jax_fixture()
    x = np.concatenate([f["xb"][:301], f["xb"][:301]])
    js, ps = JShards(D, metric), IndexShards(D, metric)
    for _ in range(2):
        js.add_shard(JFlat(D, metric))
        ps.add_shard(FlatIndex(D, metric, device=DEVICE))
    for xx in (js, ps):
        xx.add(x[:333])
        xx.add(x[333:])
    q = f["xq"][:40]
    jv, ji = js.search(q, K)
    pv, pi = ps.search(q, K)
    assert (pv[:, 0] == pv[:, 1]).all()
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-6)


def test_merge_tie_order_matches_native():
    """The merge alone against the JAX package's native merge (C++ where
    its library loads, a numpy stable sort otherwise) on values with
    ties within and across shards, L2 and IP."""
    from auncel_tpu import native
    from auncel_tpu_torch.index.meta import kway_merge_topk
    rng = np.random.RandomState(3)
    S, B, k = 4, 50, 8
    vals = rng.randint(0, 6, (S, B, k)).astype(np.float32)
    ids = rng.randint(0, 1000, (S, B, k)).astype(np.int64)
    for lower in (True, False):
        v = np.sort(vals, -1) if lower else -np.sort(-vals, -1)
        want = native.kway_merge_topk(v, ids, lower)
        got = kway_merge_topk(v, ids, lower)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_split_vectors_match_jax():
    from auncel_tpu.index.flat import FlatIndex as JFlat
    from auncel_tpu.index.meta import IndexSplitVectors as JSplit
    from auncel_tpu_torch.index.flat import FlatIndex
    from auncel_tpu_torch.index.meta import IndexSplitVectors
    f = jax_fixture()
    js, ps = JSplit(D), IndexSplitVectors(D)
    for lo, hi, n in ((0, 6, 40), (6, 16, 25)):
        j, p = JFlat(hi - lo), FlatIndex(hi - lo, device=DEVICE)
        for x in (j, p):
            x.add(f["xb"][:n, lo:hi])
        js.add_sub_index(j)
        ps.add_sub_index(p)
    assert ps.ntotal == js.ntotal == 1000
    q = f["xq"]
    jv, ji = js.search(q, 1)
    pv, pi = ps.search(q, 1)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    with pytest.raises(NotImplementedError):
        ps.add(f["xb"])


def test_replicas_match_jax():
    from auncel_tpu.index.meta import IndexReplicas as JReplicas
    from auncel_tpu_torch.index.meta import IndexReplicas
    f = jax_fixture()
    jr, pr = JReplicas(D), IndexReplicas(D)
    for _ in range(2):
        j, p = _ivf_pair()
        jr.add_replica(j)
        pr.add_replica(p)
    for x in (jr, pr):
        x.add(f["xb"], ids=np.arange(len(f["xb"])) + 10)
    assert pr.ntotal == jr.ntotal == len(f["xb"])
    q = f["xq"][:30]
    for _ in range(3):      # round robin: replica 0, 1, 0
        jv, ji = jr.search(q, K)
        pv, pi = pr.search(q, K)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(pv, jv, rtol=1e-5)
    assert pr._next == 3
