"""The binary indexes (``index/binary.py``), port against the JAX package:
clustered 64-bit codes (1500, with every code stored twice in the tie
cases, so that equal Hamming distances are everywhere). ``BinaryFlatIndex``,
``BinaryIVFIndex`` on the JAX package's centroid bits (carried by
``convert.binary_from_numpy``) at several nprobes, including every list,
the batched candidate scan against a per-query loop of the JAX package's
algorithm, ``IndexBinaryFromFloat``, ``index_binary_factory``, the BFlat
and BIVF files in both directions, and ``IndexShards``/``IndexReplicas``
over binary indexes (packed uint8 queries, integer distances). Hamming
distances and ids exact."""

import functools

import numpy as np
import pytest

import auncel_tpu.index.binary as jbin
from auncel_tpu.index.flat import FlatIndex as JFlat
from auncel_tpu.index.meta import IndexReplicas as JReplicas
from auncel_tpu.index.meta import IndexShards as JShards
from torch_parity import DEVICE
import auncel_tpu_torch.index.binary as tbin
from auncel_tpu_torch import convert
from auncel_tpu_torch.index.flat import FlatIndex
from auncel_tpu_torch.index.meta import IndexReplicas, IndexShards

DB = 64          # bits
NLIST = 8
INT32_MAX = np.iinfo(np.int32).max


@functools.lru_cache(maxsize=None)
def _codes(twice: bool = False):
    """Clustered codes (8 centres with 6 bits flipped each), the first 20
    as queries; ``twice`` stores each code twice."""
    rng = np.random.RandomState(7)
    centers = rng.randint(0, 2, size=(8, DB))
    xb = np.empty((1500, DB), np.uint8)
    for i in range(1500):
        c = centers[i % 8].copy()
        c[rng.choice(DB, 6, replace=False)] ^= 1
        xb[i] = c
    codes = np.packbits(xb, axis=1, bitorder="little")
    if twice:
        codes = np.concatenate([codes, codes])
    return codes, codes[:20].copy()


@functools.lru_cache(maxsize=None)
def _ivf_pair(twice: bool):
    codes, _ = _codes(twice)
    j = jbin.BinaryIVFIndex(DB, nlist=NLIST)
    j.train(codes)
    j.add(codes)
    t = convert.binary_from_numpy(dict(d=DB, nlist=NLIST, codes=codes,
                                       centroid_bits=j.centroid_bits),
                                  device=DEVICE)
    return j, t


def test_pack_unpack_match_jax():
    rng = np.random.RandomState(3)
    bits = rng.randint(0, 2, (10, 72)).astype(np.uint8)
    packed = tbin.pack_bits(bits)
    np.testing.assert_array_equal(packed, jbin.pack_bits(bits))
    np.testing.assert_array_equal(tbin.unpack_bits(packed, 72), bits)
    np.testing.assert_array_equal(tbin.unpack_bits(packed, 72),
                                  jbin.unpack_bits(packed, 72))


@pytest.mark.parametrize("twice", [False, True])
def test_binary_flat_matches_jax(twice):
    """Exact Hamming top-k, ties to the lower id; k past ntotal pads with
    the int32 maximum and -1."""
    codes, q = _codes(twice)
    j = jbin.BinaryFlatIndex(DB)
    t = tbin.BinaryFlatIndex(DB, device=DEVICE)
    for x in (j, t):
        x.add(codes)
    for k in (1, 5, 40):
        tv, ti = t.search(q, k)
        jv, ji = j.search(q, k)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
        assert tv.dtype == np.int32 and ti.dtype == np.int64
    small = tbin.BinaryFlatIndex(DB, device=DEVICE)
    small.add(codes[:3])
    v, i = small.search(q[:2], 6)
    assert (v[:, 3:] == INT32_MAX).all() and (i[:, 3:] == -1).all()
    assert (v[:, :3] < INT32_MAX).all()


@pytest.mark.parametrize("twice", [False, True])
def test_binary_ivf_matches_jax(twice):
    """The lists, the exact Hamming coarse rank and the candidate scan at
    nprobe 1, 3 and every list: the JAX package's ids and distances, and
    at every list BinaryFlat's."""
    j, t = _ivf_pair(twice)
    codes, q = _codes(twice)
    flat = tbin.BinaryFlatIndex(DB, device=DEVICE)
    flat.add(codes)
    for nprobe in (1, 3, NLIST):
        for k in (5, 17):
            tv, ti = t.search(q, k, nprobe=nprobe)
            jv, ji = j.search(q, k, nprobe=nprobe)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tv, jv)
    fv, fi = flat.search(q, 17)
    np.testing.assert_array_equal(ti, fi)
    np.testing.assert_array_equal(tv, fv)
    t.nprobe = j.nprobe = 2
    np.testing.assert_array_equal(t.search(q, 5)[1], j.search(q, 5)[1])
    t.nprobe = j.nprobe = 1


def test_batched_ivf_scan_equals_a_per_query_loop():
    """The batched scan against the JAX package's per-query loop written
    in numpy (candidates by np.unique, so ascending ids; a stable sort of
    their Hamming distances), on the tie-heavy codes and a k past some
    queries' candidates."""
    j, t = _ivf_pair(True)
    codes, q = _codes(True)
    bits = tbin.unpack_bits(codes, DB)
    qbits = tbin.unpack_bits(q, DB)
    lists = np.argmin((bits[:, None, :] ^ j.centroid_bits[None]).sum(-1),
                      axis=1)
    cb = j.centroid_bits
    k = 200
    got_v, got_i = t.search(q, k, nprobe=1)
    for qi in range(q.shape[0]):
        probe = np.argsort((qbits[qi] ^ cb).sum(-1), kind="stable")[:1]
        cand = np.unique(np.concatenate([np.where(lists == l)[0]
                                         for l in probe]))
        ham = (bits[cand] ^ qbits[qi]).sum(-1)
        order = np.argsort(ham, kind="stable")[:k]
        n = order.size
        np.testing.assert_array_equal(got_i[qi, :n], cand[order])
        np.testing.assert_array_equal(got_v[qi, :n], ham[order])
        assert (got_i[qi, n:] == -1).all()
        assert (got_v[qi, n:] == INT32_MAX).all()


def test_binary_ivf_trains_and_serves():
    """The port's own training (binary k-means on the bit planes, rounded
    by majority) gives lists that serve every list exactly."""
    codes, q = _codes()
    t = tbin.index_binary_factory(DB, "BIVF8", device=DEVICE)
    t.train(codes)
    t.add(codes)
    assert t.centroid_bits.shape == (NLIST, DB)
    assert set(np.unique(t.centroid_bits)) <= {0, 1}
    flat = tbin.BinaryFlatIndex(DB, device=DEVICE)
    flat.add(codes)
    np.testing.assert_array_equal(t.search(q, 5, nprobe=NLIST)[0],
                                  flat.search(q, 5)[0])


def test_binary_from_float_matches_jax():
    """IndexBinaryFromFloat over a FlatIndex: Hamming distances from the
    L2 distances of ±1 vectors, pads at the int32 maximum."""
    codes, q = _codes()
    j = jbin.IndexBinaryFromFloat(JFlat(DB), DB)
    t = tbin.IndexBinaryFromFloat(FlatIndex(DB, device=DEVICE), DB)
    for x in (j, t):
        x.train(codes)
        x.add(codes[:300])
    tv, ti = t.search(q, 7)
    jv, ji = j.search(q, 7)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    pad = tbin.IndexBinaryFromFloat(FlatIndex(32, device=DEVICE), 32)
    pad.add(np.array([[0x0F, 0xF0, 0x00, 0xFF]], np.uint8))
    d, i = pad.search(np.array([[0x0F, 0xF0, 0x00, 0xFF]], np.uint8), 4)
    assert i[0, 0] == 0 and d[0, 0] == 0
    assert (d[0, 1:] == INT32_MAX).all()


def test_binary_factory():
    """BFlat, BIVFn and the graph cells BHNSWn and BIVFn_HNSWm (or
    _BHNSWm) are built as in the JAX package; anything else raises."""
    i1 = tbin.index_binary_factory(16, "BIVF10", device=DEVICE)
    assert isinstance(i1, tbin.BinaryIVFIndex) and i1.nlist == 10
    assert i1.d // 8 == 2
    assert isinstance(tbin.index_binary_factory(16, "BFlat", device=DEVICE),
                      tbin.BinaryFlatIndex)
    for desc in ("BHNSW32", "BHNSW", "BIVF1024_BHNSW32", "BIVF64_HNSW16"):
        t = tbin.index_binary_factory(256, desc, device=DEVICE)
        j = jbin.index_binary_factory(256, desc)
        assert type(t).__name__ == type(j).__name__, desc
        assert t.d == j.d == 256
        if isinstance(t, tbin.BinaryHNSWIndex):
            assert (t._g.M, t._g.ef_search) == (j._g.M, j._g.ef_search)
        else:
            assert (t.nlist, t.coarse_hnsw_m) == (j.nlist, j.coarse_hnsw_m)
    assert tbin.BinaryIVFIndex(64, 8, coarse_hnsw_m=16,
                               device=DEVICE).coarse_hnsw_m == 16
    with pytest.raises(NotImplementedError):
        tbin.index_binary_factory(16, "BWhatever", device=DEVICE)


@pytest.mark.parametrize("kind", ["BFlat", "BIVF"])
def test_binary_files_in_both_directions(tmp_path, kind):
    """Each package reads the other's BFlat and BIVF files (codes,
    centroid bits, nprobe) with the same results."""
    from auncel_tpu.index.io import load_index as jload, save_index as jsave
    from auncel_tpu_torch.index.io import load_index, save_index
    codes, q = _codes()
    if kind == "BFlat":
        j = jbin.BinaryFlatIndex(DB)
        j.add(codes)
        t = convert.binary_from_numpy(dict(d=DB, codes=codes),
                                      device=DEVICE)
    else:
        j, t = _ivf_pair(False)
        j.nprobe = t.nprobe = 3
    save_index(t, str(tmp_path / "t.npz"))
    jsave(j, str(tmp_path / "j.npz"))
    back_j = jload(str(tmp_path / "t.npz"))
    back_t = load_index(str(tmp_path / "j.npz"), device=DEVICE)
    assert type(back_t) is type(t)
    jv, ji = j.search(q, 5)
    for x in (back_j, back_t):
        v, i = x.search(q, 5)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(v, jv)
    if kind == "BIVF":
        assert back_t.nprobe == 3
        np.testing.assert_array_equal(back_t.centroid_bits, j.centroid_bits)
        j.nprobe = t.nprobe = 1
    empty = tbin.BinaryFlatIndex(DB, device=DEVICE)
    save_index(empty, str(tmp_path / "e.npz"))
    assert jload(str(tmp_path / "e.npz")).ntotal == 0


def test_binary_shards_and_replicas_match_jax():
    """IndexShards over three BinaryFlat shards (round-robin adds, ids
    translated back) and IndexReplicas over two: the JAX package's ids and
    integer distances (tests/test_binary_io_factory.py:112-147)."""
    codes, q = _codes(True)
    js, ts = JShards(DB), IndexShards(DB)
    for _ in range(3):
        js.add_shard(jbin.BinaryFlatIndex(DB))
        ts.add_shard(tbin.BinaryFlatIndex(DB, device=DEVICE))
    for x in (js, ts):
        x.add(codes)
    tv, ti = ts.search(q, 5)
    jv, ji = js.search(q, 5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, np.asarray(jv, tv.dtype))
    assert np.issubdtype(tv.dtype, np.integer)
    flat = tbin.BinaryFlatIndex(DB, device=DEVICE)
    flat.add(codes)
    np.testing.assert_array_equal(tv, flat.search(q, 5)[0])
    jr, tr = JReplicas(DB), IndexReplicas(DB)
    for _ in range(2):
        jr.add_replica(jbin.BinaryFlatIndex(DB))
        tr.add_replica(tbin.BinaryFlatIndex(DB, device=DEVICE))
    for x in (jr, tr):
        x.add(codes)
    for _ in range(2):   # each replica in turn
        tv, ti = tr.search(q, 5)
        jv, ji = jr.search(q, 5)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
