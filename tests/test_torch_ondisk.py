"""Parity of the port's on-disk serving (``index/ondisk.py``, the on-disk
directory of ``index/io.py`` and ``bounded_search_decide_ranked``) with
the JAX package, on the shared fixture's padded index: the directories
each package writes, fixed-nprobe and error-bounded search from disk, the
proofs that a search pages only the lists it probes, an IP index and the
residual-PQ directory. Ids and decisions equal, values within 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_parity import (ACC, D, DEVICE, K, MAX_TOPK, NLIST,
                                jax_fixture, padded_systems, pq_fixture,
                                tnp)


class _CountingMmap:
    """Wraps the mmap'd db: records which list rows get paged in."""

    def __init__(self, arr):
        self._arr = arr
        self.touched = set()
        self.shape = arr.shape

    def __getitem__(self, key):
        idx = key[0] if isinstance(key, tuple) else key
        self.touched.update(np.atleast_1d(np.asarray(idx)).tolist())
        return self._arr[key]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A directory written by each package from the same index state:
    {"jax": path, "port": path}."""
    from auncel_tpu.index.io import save_index_ondisk as jsave
    from auncel_tpu_torch.index.io import save_index_ondisk
    es, jes = padded_systems()
    tmp = tmp_path_factory.mktemp("ondisk")
    out = {"jax": str(tmp / "jax"), "port": str(tmp / "port")}
    jsave(jes.index, out["jax"])
    save_index_ondisk(es.index, out["port"])
    return out


def _both(path):
    """(JAX OnDiskIVFIndex, port OnDiskIVFIndex on the CPU) of one
    directory."""
    from auncel_tpu.index.ondisk import OnDiskIVFIndex as JOnDisk
    from auncel_tpu_torch.index.ondisk import OnDiskIVFIndex
    return JOnDisk(path), OnDiskIVFIndex(path, device=DEVICE)


def test_directories_are_interchangeable(dirs):
    for name in ("db", "vec_ids", "list_sizes", "centroids"):
        np.testing.assert_array_equal(np.load(f"{dirs['jax']}/{name}.npy"),
                                      np.load(f"{dirs['port']}/{name}.npy"))
    from auncel_tpu.index.io import load_index_ondisk as jload
    from auncel_tpu_torch.index.io import load_index_ondisk
    f = jax_fixture()
    q = f["xq"][:20]
    for path in dirs.values():
        jv, ji = jload(path).search(q, K, nprobe=4)
        pv, pi = load_index_ondisk(path, device=DEVICE).search(q, K, nprobe=4)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(pv, jv, rtol=1e-5)


@pytest.mark.parametrize("which", ["jax", "port"])
def test_fixed_search_matches_jax_and_resident(dirs, which):
    es, _ = padded_systems()
    q = jax_fixture()["xq"]
    jod, od = _both(dirs[which])
    assert (od.ntotal, od.nlist, od.metric.value) == (
        jod.ntotal, jod.nlist, jod.metric.value)
    for nprobe in (2, 8, NLIST):
        jv, ji = jod.search(q, K, nprobe=nprobe)
        pv, pi = od.search(q, K, nprobe=nprobe)
        rv, ri = es.index.search(q, K, nprobe=nprobe)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_allclose(pv, jv, rtol=1e-5)
        np.testing.assert_allclose(pv, rv, rtol=1e-5)


@pytest.mark.parametrize("multipler", [None, 8.0])
def test_bounded_matches_jax_and_resident(dirs, multipler):
    """Ids and n_scanned of bounded search from disk equal the JAX on-disk
    engine's and the port's resident single-phase engine's: at the
    profile's multipler every query stops within nlist/8 (phase A alone);
    at 8 queries go past it, so phase B pages and scans too."""
    from auncel_tpu_torch.profile.bounded import bounded_search
    es, jes = padded_systems()
    mult = es.multipler if multipler is None else multipler
    q = jax_fixture()["xq"]
    acc = np.full(len(q), ACC, np.float32)
    jod, od = _both(dirs["port"])
    for o, e in ((jod, jes), (od, es)):
        o.attach_profile(e.traces, multipler=mult, std_m=e.std_m,
                         max_topk=MAX_TOPK)
    jv, ji, jn = jod.search_bounded(q, acc, query_k=K)
    pv, pi, pn = od.search_bounded(q, acc, query_k=K)
    f32 = torch.float32
    rv, ri, _, rn, _ = bounded_search(
        es.index.arrays, es.traces, torch.as_tensor(q), torch.as_tensor(acc),
        torch.tensor(mult, dtype=f32), torch.tensor(es.std_m, dtype=f32),
        torch.zeros(len(q)), K, MAX_TOPK, es.index.metric)
    assert (pn > NLIST // 8).any() == (multipler is not None)
    np.testing.assert_array_equal(pn, np.asarray(jn))
    np.testing.assert_array_equal(pn, tnp(rn))
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pi, tnp(ri)[:, :K])
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    np.testing.assert_allclose(pv, tnp(rv)[:, :K], rtol=1e-5)


def test_decide_ranked_matches_jax(dirs):
    """Phase A over paged blocks alone: my_nprobe, decided_at, ids and
    values of the JAX package's bounded_search_decide_ranked."""
    from auncel_tpu.profile.bounded import (
        bounded_search_decide_ranked as jdecide)
    from auncel_tpu_torch.profile.bounded import bounded_search_decide_ranked
    es, jes = padded_systems()
    q = jax_fixture()["xq"][:40]
    acc = np.full(len(q), ACC, np.float32)
    _, od = _both(dirs["jax"])
    od.attach_profile(es.traces, es.multipler, es.std_m, MAX_TOPK)
    qd = torch.as_tensor(q)
    cdis, cids = od._coarse(qd, 24)
    cids_np = tnp(cids)
    blocks, block_ids, sizes, uniq = od._page_blocks(cids_np)
    slots = np.searchsorted(uniq, cids_np).astype(np.int32)
    f32 = torch.float32
    out = bounded_search_decide_ranked(
        od._compact(blocks, block_ids, sizes, od._interdis), es.traces, qd,
        torch.as_tensor(acc), torch.tensor(es.multipler, dtype=f32),
        torch.tensor(es.std_m, dtype=f32), cdis, cids,
        torch.as_tensor(slots), K, MAX_TOPK, od.metric)
    from auncel_tpu.index.scan import IVFArrays as JArrays
    from auncel_tpu.ops.distance import sqnorms as jsq
    jb = jnp.asarray(tnp(blocks))
    jids = jnp.asarray(tnp(block_ids))
    jcents = jnp.asarray(od.centroids)
    compact = JArrays(
        centroids=jcents, cent_sq=jsq(jcents), db=jb,
        db_sq=jnp.sum(jnp.square(jb), -1) * (jids >= 0), vec_ids=jids,
        list_sizes=jnp.zeros((jb.shape[0],), jnp.int32),
        interdis=jnp.asarray(tnp(od._interdis)))
    jout = jdecide(compact, jes.traces, jnp.asarray(q), jnp.asarray(acc),
                   jnp.float32(es.multipler), jnp.float32(es.std_m),
                   jnp.asarray(tnp(cdis)), jnp.asarray(cids_np),
                   jnp.asarray(slots), K, MAX_TOPK, jes.index.metric)
    vals, ids, my_np, decided = (tnp(t) for t in out[:4])
    np.testing.assert_array_equal(my_np, np.asarray(jout[2]))
    np.testing.assert_array_equal(decided, np.asarray(jout[3]))
    np.testing.assert_array_equal(ids, np.asarray(jout[1]))
    fin = np.isfinite(vals)
    np.testing.assert_allclose(vals[fin], np.asarray(jout[0])[fin],
                               rtol=1e-5)


def test_fixed_search_pages_only_probed_lists(dirs):
    _, od = _both(dirs["port"])
    counter = _CountingMmap(od.db)
    od.db = counter
    nprobe = 3
    od.search(jax_fixture()["xq"][:8], K, nprobe=nprobe)
    assert 0 < len(counter.touched) <= 8 * nprobe
    assert len(counter.touched) < od.nlist


def test_bounded_pages_only_needed_lists(dirs):
    """The bounded path pages at most the decision prefix of each query
    and each query's decided budget past it, never the whole corpus."""
    from auncel_tpu_torch.profile.geometry import n_boundaries
    es, _ = padded_systems()
    _, od = _both(dirs["port"])
    od.attach_profile(es.traces, multipler=2.0, std_m=1.0, max_topk=MAX_TOPK)
    counter = _CountingMmap(od.db)
    od.db = counter
    acc = np.full(2, ACC, np.float32)
    _, _, n_scanned = od.search_bounded(jax_fixture()["xq"][:2], acc,
                                        query_k=K)
    nlist = od.nlist
    rank_k = max(min(nlist, n_boundaries(nlist) + 1), nlist // 8)
    bound = 2 * rank_k + int(np.maximum(n_scanned - nlist // 8, 0).sum())
    assert len(counter.touched) <= bound
    assert len(counter.touched) < nlist


def test_paged_blocks_carry_the_stored_list_sizes(dirs):
    """K2 and its plain version read only slots below a list's size, so a
    block batch with zero sizes (the JAX package's on-disk arrays carry
    zeros, harmless to its scans) would return no result at all."""
    _, od = _both(dirs["port"])
    q = jax_fixture()["xq"][:10]
    _, cids = od._coarse(torch.as_tensor(q), 4)
    _, block_ids, sizes, uniq = od._page_blocks(tnp(cids))
    np.testing.assert_array_equal(tnp(sizes), od.list_sizes[uniq])
    np.testing.assert_array_equal(tnp(sizes), tnp((block_ids >= 0).sum(1)))
    _, ids = od.search(q, K, nprobe=4)
    assert (ids >= 0).all()
    od.list_sizes = np.zeros_like(od.list_sizes)
    _, ids = od.search(q, K, nprobe=4)
    assert (ids == -1).all()


def test_ip_metric(tmp_path):
    from auncel_tpu.index.io import save_index_ondisk as jsave
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.index.io import save_index_ondisk
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    jidx = JIVF(D, NLIST, "ip")
    jidx.set_centroids(f["centers"])
    jidx.add(f["xb"])
    idx = IVFFlatIndex(D, NLIST, "ip", device=DEVICE)
    idx.set_centroids(f["centers"])
    idx.add(f["xb"])
    jsave(jidx, str(tmp_path / "jax"))
    save_index_ondisk(idx, str(tmp_path / "port"))
    q = f["xq"][:30]
    for which in ("jax", "port"):
        jod, od = _both(str(tmp_path / which))
        jv, ji = jod.search(q, 5, nprobe=8)
        pv, pi = od.search(q, 5, nprobe=8)
        rv, ri = idx.search(q, 5, nprobe=8)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_allclose(pv, jv, rtol=1e-5, atol=1e-6)


def test_residual_pq_directory_holds_reconstructions(tmp_path):
    """The JAX package writes a residual-PQ index's decoded residuals
    (its fault, not copied); the port writes the reconstructions, so its
    db is the JAX db plus each list's centroid, and its directory
    reconstructs the stored vectors."""
    from auncel_tpu.index.io import save_index_ondisk as jsave
    from auncel_tpu_torch.index.io import (load_index_ondisk,
                                           save_index_ondisk)
    jidx, idx = pq_fixture(residual=True)
    jsave(jidx, str(tmp_path / "jax"))
    save_index_ondisk(idx, str(tmp_path / "port"))
    jdb = np.load(tmp_path / "jax" / "db.npy")
    pdb = np.load(tmp_path / "port" / "db.npy")
    cents = np.load(tmp_path / "port" / "centroids.npy")
    np.testing.assert_allclose(pdb - cents[:, None, :], jdb, atol=1e-6)
    ids = np.load(tmp_path / "port" / "vec_ids.npy")
    live = ids[ids >= 0]
    back = load_index_ondisk(str(tmp_path / "port"), device=DEVICE)
    np.testing.assert_array_equal(back.reconstruct_batch(live),
                                  idx.reconstruct_batch(live))
