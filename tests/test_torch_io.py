"""Parity of the port's data files, exact kNN, the rest of IVFFlatIndex
(assign, the reconstruct family, update_vectors, reset, the dedup index),
index files and the search counters against the JAX package."""

import importlib
import os

import numpy as np
import pytest

from torch_parity import (
    D, DEVICE, NLIST, ROW_CAP, as_numpy, jax_fixture, port_state)

REL = 1e-5


def _port_index():
    """A port index on the fixture's carried state (a fresh object, so a
    test may change its knobs)."""
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    index, arrays, mr, _ = port_state()
    return IVFFlatIndex.from_state(jax_fixture()["centers"], arrays,
                                   multirow=mr)


def _tie_data(seed=3):
    """Small-integer vectors with many exact duplicates: every distance is
    exact in float32, so ties are exact in both packages."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 3, (400, 8)).astype(np.float32)
    corpus = np.concatenate([base, base[rng.randint(0, 400, 1600)]])
    q = rng.randint(0, 3, (37, 8)).astype(np.float32)
    return corpus, q


@pytest.mark.parametrize("kind", ["fvecs", "ivecs", "fbin", "ibin"])
def test_vector_files_cross_read(tmp_path, kind):
    import auncel_tpu.data.io as jio
    import auncel_tpu_torch.data.io as tio
    rng = np.random.RandomState(0)
    if kind[0] == "f":
        x = rng.randn(37, 9).astype(np.float32)
    else:
        x = rng.randint(-5, 1 << 20, (37, 9)).astype(np.int32)
    for writer, reader in ((jio, tio), (tio, jio)):
        path = str(tmp_path / f"x.{kind}")
        if kind.endswith("vecs"):
            getattr(writer, f"{kind}_write")(path, x)
        else:
            writer.bin_write(path, x)
        got = getattr(reader, f"{kind}_read")(path)
        assert got.dtype == x.dtype
        assert got.tobytes() == x.tobytes()
        part = getattr(reader, f"{kind}_read")(path, count=5, offset_rows=3)
        assert part.tobytes() == x[3:8].tobytes()


def test_data_package_exports():
    import auncel_tpu.data as jdata
    import auncel_tpu_torch.data as tdata
    assert set(jdata.__all__) == set(tdata.__all__)


def test_knn_ties_match_jax():
    from auncel_tpu.ops.knn import knn as jknn
    from auncel_tpu_torch.ops.knn import knn
    corpus, q = _tie_data()
    for metric in ("l2", "ip"):
        ref = jknn(q, corpus, 10, metric, q_block=16, db_block=512)
        got = knn(q, corpus, 10, metric, q_block=16, db_block=512,
                  device=DEVICE)
        np.testing.assert_array_equal(got.ids, ref.ids)
        np.testing.assert_allclose(got.vals, ref.vals, rtol=REL, atol=0)


def test_knn_by_idx_and_subset_match_jax():
    jk = importlib.import_module("auncel_tpu.ops.knn")
    tk = importlib.import_module("auncel_tpu_torch.ops.knn")
    corpus, q = _tie_data(5)
    rng = np.random.RandomState(1)
    labels = rng.randint(-2, corpus.shape[0], (q.shape[0], 12))
    for metric in ("l2", "ip"):
        np.testing.assert_allclose(
            tk.compute_distance_subset(q, corpus, labels, metric,
                                       device=DEVICE),
            jk.compute_distance_subset(q, corpus, labels, metric),
            rtol=REL, atol=0)
        for k in (5, 15):   # within and past the list's width
            ref = jk.knn_by_idx(q, corpus, labels, k, metric)
            got = tk.knn_by_idx(q, corpus, labels, k, metric, device=DEVICE)
            np.testing.assert_array_equal(got.ids, ref.ids)
            np.testing.assert_allclose(got.vals, ref.vals, rtol=REL, atol=0)
    shift = rng.randint(0, 4, corpus.shape[0]).astype(np.float32)
    ref = jk.knn_l2sqr_base_shift(q, corpus, 7, shift)
    got = tk.knn_l2sqr_base_shift(q, corpus, 7, shift, device=DEVICE)
    np.testing.assert_array_equal(got.ids, ref.ids)
    np.testing.assert_allclose(got.vals, ref.vals, rtol=REL, atol=0)


def test_assign_matches_jax_on_ties():
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    corpus, q = _tie_data(7)
    cents = np.concatenate([corpus[:6], corpus[:6], corpus[6:10]])  # dups
    jidx, idx = JIVF(8, 16), IVFFlatIndex(8, 16, device=DEVICE)
    jidx.set_centroids(cents)
    idx.set_centroids(cents)
    np.testing.assert_array_equal(idx.assign(corpus), jidx.assign(corpus))
    f = jax_fixture()
    np.testing.assert_array_equal(_port_index().assign(f["xq"]),
                                  f["idx"].assign(f["xq"]))
    jd, jc = f["idx"].coarse_rank_np(f["xq"])
    pd, pc = _port_index().coarse_rank_np(f["xq"])
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_allclose(pd, jd, rtol=REL, atol=1e-6)


def test_reconstruct_family_matches_jax():
    f = jax_fixture()
    jidx, idx = f["idx"], _port_index()
    keys = np.array([0, 5, 1234, 3999])
    np.testing.assert_array_equal(idx.reconstruct(17), jidx.reconstruct(17))
    np.testing.assert_array_equal(idx.reconstruct_n(10, 25),
                                  jidx.reconstruct_n(10, 25))
    np.testing.assert_array_equal(idx.reconstruct_batch([3, -1, 7]),
                                  jidx.reconstruct_batch([3, -1, 7]))
    np.testing.assert_array_equal(idx.reconstruct_batch(keys), f["xb"][keys])
    for l, o in ((0, 0), (5, 3), (NLIST - 1, 0)):
        np.testing.assert_array_equal(idx.reconstruct_from_offset(l, o),
                                      jidx.reconstruct_from_offset(l, o))
    with pytest.raises(KeyError):
        idx.reconstruct(10 ** 6)
    with pytest.raises(KeyError):
        idx.reconstruct_from_offset(0, 10 ** 6)


def _sq8_pair():
    """The fixture's vectors in fresh SQ8 indexes of both packages, the
    port's built from the JAX index's state."""
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.convert import ivf_arrays_from_numpy
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    jidx = JIVF(D, NLIST, storage="sq8")
    jidx.set_centroids(f["centers"])
    jidx.add(f["xb"])
    arrays = ivf_arrays_from_numpy(as_numpy(jidx.arrays), DEVICE)
    return jidx, IVFFlatIndex.from_state(f["centers"], arrays)


def test_update_vectors_sq8_matches_jax_and_keeps_codes():
    jidx, idx = _sq8_pair()
    f = jax_fixture()
    before = {int(i): c for i, c in zip(
        idx.arrays.vec_ids.numpy().ravel(),
        idx.arrays.db.numpy().reshape(-1, idx.arrays.db.shape[-1]))}
    upd = np.array([3, 17, 2500])
    newx = f["xb"][[40, 41, 42]] + 0.25
    jidx.update_vectors(upd, newx)
    idx.update_vectors(upd, newx)
    a, ja = idx.arrays, jidx.arrays
    np.testing.assert_array_equal(a.db.numpy(), np.asarray(ja.db))
    np.testing.assert_array_equal(a.vec_ids.numpy(), np.asarray(ja.vec_ids))
    np.testing.assert_array_equal(a.sq_scale.numpy(),
                                  np.asarray(ja.sq_scale))
    after = dict(zip(a.vec_ids.numpy().ravel(),
                     a.db.numpy().reshape(-1, a.db.shape[-1])))
    untouched = [i for i in before if i >= 0 and i not in set(upd.tolist())]
    assert all(np.array_equal(before[i], after[i]) for i in untouched)
    np.testing.assert_array_equal(idx.reconstruct_batch(upd),
                                  jidx.reconstruct_batch(upd))


def test_reset_then_add_matches_jax():
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    jidx, idx = JIVF(D, NLIST), IVFFlatIndex(D, NLIST, device=DEVICE)
    for i in (jidx, idx):
        i.set_centroids(f["centers"])
        i.add(f["xb"][:500])
        i.reset()
        assert i.ntotal == 0
        i.add(f["xb"][500:1500])
        i.enable_multirow(row_cap=ROW_CAP)
    D0, I0 = jidx.search(f["xq"], 10, nprobe=4)
    D1, I1 = idx.search(f["xq"], 10, nprobe=4)
    np.testing.assert_array_equal(I1, I0)
    np.testing.assert_allclose(D1, D0, rtol=REL, atol=1e-5)


def test_ivf_flat_dedup_matches_jax():
    from auncel_tpu.index.ivf import IVFFlatDedupIndex as JDedup
    from auncel_tpu_torch.index.ivf import IVFFlatDedupIndex
    rng = np.random.RandomState(4)
    base = rng.rand(500, 16).astype(np.float32)
    x = np.concatenate([base, base[:100]])      # 100 exact duplicates
    jidx = JDedup(16, 8)
    jidx.train(base)
    idx = IVFFlatDedupIndex(16, 8, device=DEVICE)
    idx.set_centroids(jidx.centroids)
    for i in (jidx, idx):
        i.add(x[:550])
        i.add(x[550:])                          # dedup across batches
    assert idx.ntotal == 500
    q = base[:5] + 1e-4
    vals, ids = idx.search(q, 4, nprobe=8)
    jv, ji = jidx.search(q, 4, nprobe=8)
    np.testing.assert_array_equal(ids, ji)
    np.testing.assert_allclose(vals, jv, rtol=REL, atol=1e-6)
    for r in range(5):
        assert r in ids[r] and (500 + r) in ids[r]
        a, b = np.where(ids[r] == r)[0][0], np.where(ids[r] == 500 + r)[0][0]
        assert vals[r, a] == vals[r, b]
    idx.reset()
    assert idx._dup == {} and idx.ntotal == 0


def _index_pair(storage):
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    jidx = JIVF(D, NLIST, storage=storage)
    idx = IVFFlatIndex(D, NLIST, device=DEVICE, storage=storage)
    for i in (jidx, idx):
        i.set_centroids(f["centers"])
        i.add(f["xb"])
    return jidx, idx


@pytest.mark.parametrize("storage", ["f32", "sq8"])
def test_index_files_cross_load(tmp_path, storage):
    from auncel_tpu.index.io import load_index as jload, save_index as jsave
    from auncel_tpu_torch.index.io import load_index, save_index
    f = jax_fixture()
    jidx, idx = _index_pair(storage)
    jsave(jidx, str(tmp_path / "j.npz"))
    save_index(idx, str(tmp_path / "p.npz"))
    from_j = load_index(str(tmp_path / "j.npz"), device=DEVICE)
    from_p = jload(str(tmp_path / "p.npz"))
    assert from_j.storage == from_p.storage == storage
    np.testing.assert_array_equal(from_j.arrays.db.numpy(),
                                  np.asarray(jidx.arrays.db))
    np.testing.assert_array_equal(np.asarray(from_p.arrays.db),
                                  idx.arrays.db.numpy())
    D0, I0 = jidx.search(f["xq"], 10, nprobe=3)
    for other in (from_j, from_p, idx):
        Dx, Ix = other.search(f["xq"], 10, nprobe=3)
        np.testing.assert_array_equal(Ix, I0)
        np.testing.assert_allclose(Dx, D0, rtol=REL, atol=1e-5)
    with np.load(str(tmp_path / "j.npz")) as zj, \
            np.load(str(tmp_path / "p.npz")) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        assert str(zj["header"]) == str(zp["header"])


def test_trained_only_file_cross_load(tmp_path):
    """A trained-but-empty file (centroids only, the harness's quantizer
    cache): the repository's sift1M one when present, else one the JAX
    package writes; and one the port writes, loaded by the JAX package."""
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu.index.io import load_index as jload, save_index as jsave
    from auncel_tpu_torch.index.io import load_index, save_index
    path = os.path.join(os.path.dirname(__file__), "..", "trained_index",
                        "sift1M_IVF64,Flat_trained.npz")
    if not os.path.exists(path):
        rng = np.random.RandomState(2)
        j = JIVF(32, 64)
        j.set_centroids(rng.randn(64, 32).astype(np.float32))
        path = str(tmp_path / "trained.npz")
        jsave(j, path)
    ref = jload(path)
    idx = load_index(path, device=DEVICE)
    assert idx.is_trained and idx.ntotal == 0 and idx.nlist == ref.nlist
    np.testing.assert_array_equal(idx.centroids, ref.centroids)
    rng = np.random.RandomState(8)
    # spread wide against the centroids' scale (norms near 1.7e3 in the
    # sift1M file), so neighbours' distances are far apart next to the
    # float32 rounding of the L2 expansion
    scale = float(np.linalg.norm(ref.centroids, axis=1).mean()) / 30
    x = (ref.centroids[rng.randint(0, ref.nlist, 700)]
         + scale * rng.randn(700, ref.d)).astype(np.float32)
    for i in (ref, idx):
        i.add(x)
    np.testing.assert_array_equal(idx.search(x[:20], 5, nprobe=4)[1],
                                  ref.search(x[:20], 5, nprobe=4)[1])
    empty = load_index(path, device=DEVICE)
    save_index(empty, str(tmp_path / "p.npz"))
    back = jload(str(tmp_path / "p.npz"))
    assert back.is_trained and back.ntotal == 0
    np.testing.assert_array_equal(back.centroids, ref.centroids)


def test_other_kinds_raise(tmp_path):
    """The binary HNSW kind loads in both directions (a three-code graph:
    the JAX package's file in the port, the port's in the JAX package),
    and an index the port cannot write raises."""
    from auncel_tpu.index.binary import BinaryHNSWIndex
    from auncel_tpu.index.io import load_index as jload
    from auncel_tpu.index.io import save_index as jsave
    from auncel_tpu_torch.index.binary import BinaryHNSWIndex as TBH
    from auncel_tpu_torch.index.io import load_index, save_index
    codes = np.arange(6, dtype=np.uint8).reshape(3, 2)
    bh = BinaryHNSWIndex(16, M=4)
    bh.add(codes)
    jsave(bh, str(tmp_path / "bhnsw.npz"))
    back = load_index(str(tmp_path / "bhnsw.npz"), device=DEVICE)
    assert isinstance(back, TBH) and back.ntotal == 3
    for l in range(bh._g.max_level + 1):
        np.testing.assert_array_equal(back._g.nb_tables[l],
                                      bh._g.nb_tables[l])
    np.testing.assert_array_equal(back.search(codes, 3, ef=8)[1],
                                  bh.search(codes, 3, ef=8)[1])
    save_index(back, str(tmp_path / "back.npz"))
    jback = jload(str(tmp_path / "back.npz"))
    assert isinstance(jback, BinaryHNSWIndex)
    np.testing.assert_array_equal(jback._g.levels, bh._g.levels)
    with pytest.raises(NotImplementedError):
        save_index(object(), str(tmp_path / "x.npz"))


def test_ivf_stats_counts_match_jax():
    """nq, nlist_scanned and ndis as the JAX package counts them on the
    padded lists and on the rows; on the rows' gathers ndis spans the
    exact row-slot sum where the JAX package counts its power-of-two
    bucket (ROADMAP.md §3)."""
    from auncel_tpu.index.aux import ivf_stats as jstats
    from auncel_tpu_torch.index.aux import ivf_stats
    f = jax_fixture()
    jidx, idx = _index_pair("f32")
    mr_j, mr_p = f["idx"], _port_index()
    B = f["xq"].shape[0]
    for stats in (jstats, ivf_stats):
        stats.reset()
    for nprobe in (1, 3):
        jidx.search(f["xq"], 5, nprobe=nprobe)
        idx.search(f["xq"], 5, nprobe=nprobe)
    assert (ivf_stats.nq, ivf_stats.nlist_scanned, ivf_stats.ndis) == \
        (jstats.nq, jstats.nlist_scanned, jstats.ndis)
    assert ivf_stats.nq == 2 * B and ivf_stats.search_time_ms > 0
    for stats in (jstats, ivf_stats):
        stats.reset()
    mr_j.search(f["xq"], 5, nprobe=3)
    mr_p.search(f["xq"], 5, nprobe=3)
    assert (ivf_stats.nq, ivf_stats.nlist_scanned) == \
        (jstats.nq, jstats.nlist_scanned)
    rpl = np.sort(mr_p.multirow.rows_per_list.numpy())[::-1]
    need = int(rpl[:3].sum())
    assert ivf_stats.ndis == B * need * ROW_CAP
    assert jstats.ndis == B * (1 << (need - 1).bit_length()) * ROW_CAP
