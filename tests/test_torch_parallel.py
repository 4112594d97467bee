"""Parity of the port's scale-out layer (``auncel_tpu_torch/parallel``)
with the JAX package's ``ShardedIVF`` on the simulated CPU mesh.

The JAX package builds each sharded index (16000 x 32, 4 shards, as
``tests/test_parallel.py``); ``convert.sharded_from_numpy`` carries the same
shards, profiles and calibration into the port, and both packages then
search: equal ids and per-shard ``n_scanned``, distances within the
profile trainer's 1e-5 relative band. Directories saved by either package
load in the other. The JAX test's own checks then run on a ShardedIVF the
port built itself."""

import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import DEVICE, as_numpy

KSCALING_TOL = 1e-5
NQ, N_TRAIN_Q, MAX_TOPK, QUERY_K, ROW_CAP = 40, 20, 50, 10, 64


@functools.lru_cache(maxsize=None)
def ds():
    from auncel_tpu.data.synthetic import make_clustered_dataset
    return make_clustered_dataset(nb=16000, nq=NQ, d=32, n_clusters=64,
                                  seed=21)


def acc():
    return np.full(NQ, 0.9, np.float32)


def jax_meta(js) -> dict:
    """The JAX ShardedIVF's meta.json keys."""
    return dict(d=js.d, nlist=js.nlist, n_shards=js.n_shards,
                storage=js.storage, metric=js.metric.value,
                multipler=js.multipler, std_m=js.std_m,
                max_topk=getattr(js, "max_topk", None),
                multirow_row_cap=(int(js._mr_row_cap) if js.mr is not None
                                  else None))


def carry(js):
    """The JAX ShardedIVF's state as the port's, on the CPU."""
    from auncel_tpu_torch.convert import sharded_from_numpy
    return sharded_from_numpy(
        jax_meta(js), [as_numpy(sh.arrays) for sh in js.shards],
        as_numpy(jax.device_get(js.traces)), device=DEVICE)


@functools.lru_cache(maxsize=None)
def systems(storage: str):
    """(JAX ShardedIVF with the multi-row layout, the port's carried copy
    without it, the port's carried copy with it): 4 shards of nlist 32,
    profiles on the first 20 queries, multipler 8."""
    from auncel_tpu.parallel.sharded import ShardedIVF, make_mesh
    js = ShardedIVF(ds().d, nlist=32, n_shards=4, mesh=make_mesh(4),
                    storage=storage)
    js.build(ds().xb)
    js.train_profiles(ds().xq[:N_TRAIN_Q], max_topk=MAX_TOPK)
    js.multipler = 8.0
    padded = carry(js)
    js.enable_multirow(row_cap=ROW_CAP)
    return js, padded, carry(js)


def jax_padded(js, fn):
    """fn() with the JAX index on its padded engine."""
    mr, js.mr = js.mr, None
    try:
        return fn()
    finally:
        js.mr = mr


def assert_same(got, want):
    """Port results against the JAX package's: equal ids (and n_scanned),
    values within KSCALING_TOL relative."""
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=KSCALING_TOL)
    if len(want) > 2:
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))


STORAGES = ["f32", "sq8"]


@pytest.mark.parametrize("storage", STORAGES)
def test_fixed_search_matches_jax(storage):
    js, ps, _ = systems(storage)
    for nprobe in (1, 4, 32):
        want = jax_padded(js, lambda: js.search(ds().xq, QUERY_K, nprobe))
        assert_same(ps.search(ds().xq, QUERY_K, nprobe), want)


@pytest.mark.parametrize("storage", STORAGES)
def test_bounded_padded_matches_jax(storage):
    js, ps, _ = systems(storage)
    assert ps.mr is None
    want = jax_padded(js, lambda: js.search_bounded(ds().xq, acc(),
                                                    QUERY_K))
    got = ps.search_bounded(ds().xq, acc(), QUERY_K)
    assert got[2].shape == (4, NQ)
    assert_same(got, want)


@pytest.mark.parametrize("storage", STORAGES)
def test_bounded_multirow_matches_jax(storage):
    js, _, pm = systems(storage)
    assert pm._mr_row_cap == js._mr_row_cap == ROW_CAP
    assert pm._mr_plan == js._mr_plan
    assert_same(pm.search_bounded(ds().xq, acc(), QUERY_K),
                js.search_bounded(ds().xq, acc(), QUERY_K))


def test_drop_shard_matches_jax(tmp_path):
    """Both packages drop shard 1 of the same index (the JAX one reloaded
    from its own directory, so the cached system stays whole)."""
    from auncel_tpu.parallel.sharded import ShardedIVF as JSharded
    from auncel_tpu.parallel.sharded import make_mesh as jmesh
    js, _, _ = systems("f32")
    js.save(str(tmp_path / "j"))
    jd = JSharded.load(str(tmp_path / "j"), mesh=jmesh(4))
    pd = carry(js)
    for s in (jd, pd):
        s.drop_shard(1)
    assert pd.n_shards == 3 and pd.mesh.shape == {"shard": 3}
    assert pd._mr_plan == jd._mr_plan
    got = pd.search_bounded(ds().xq, acc(), QUERY_K)
    assert got[2].shape == (3, NQ) and not np.any(got[1] % 4 == 1)
    assert_same(got, jd.search_bounded(ds().xq, acc(), QUERY_K))
    assert_same(pd.search(ds().xq, QUERY_K, 8), jd.search(ds().xq, QUERY_K,
                                                          8))


@pytest.mark.parametrize("storage", STORAGES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_load_across_packages(tmp_path, storage, writer):
    """A directory either package writes loads in the other with the same
    codec, profiles, calibration and multi-row row cap: equal results."""
    from auncel_tpu.parallel.sharded import ShardedIVF as JSharded
    from auncel_tpu.parallel.sharded import make_mesh as jmesh
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh
    js, _, pm = systems(storage)
    p = str(tmp_path / "sharded")
    if writer == "jax":
        js.save(p)
        loaded = ShardedIVF.load(p, mesh=make_mesh(4, devices=[DEVICE]))
        want = js.search_bounded(ds().xq, acc(), QUERY_K)
    else:
        pm.save(p)
        with open(os.path.join(p, "meta.json")) as f:
            assert json.load(f) == jax_meta(js)
        loaded = JSharded.load(p, mesh=jmesh(4))
        want = pm.search_bounded(ds().xq, acc(), QUERY_K)
    assert loaded.storage == storage and loaded._mr_row_cap == ROW_CAP
    assert_same(loaded.search_bounded(ds().xq, acc(), QUERY_K), want)


# ---- the JAX test's own checks on a ShardedIVF the port built ----------


def port_build(nlist=32, storage="f32", dp=1, devices=(DEVICE,)):
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh
    s = ShardedIVF(ds().d, nlist=nlist, n_shards=4, storage=storage,
                   mesh=make_mesh(4, dp=dp, devices=list(devices)))
    s.build(ds().xb)
    return s


@functools.lru_cache(maxsize=None)
def port_sharded():
    s = port_build()
    s.train_profiles(ds().xq[:N_TRAIN_Q], max_topk=MAX_TOPK)
    s.multipler = 8.0
    return s


@functools.lru_cache(maxsize=None)
def flat_gt(k: int):
    from auncel_tpu_torch.index.flat import FlatIndex
    flat = FlatIndex(ds().d, device=DEVICE)
    flat.add(ds().xb)
    return flat.search(ds().xq, k)


def id_recall(ids, gt_ids, k=QUERY_K):
    return np.mean([len(set(a) & set(b)) / k
                    for a, b in zip(ids.tolist(), gt_ids.tolist())])


def test_full_scan_matches_flat():
    gt_vals, gt_ids = flat_gt(QUERY_K)
    vals, ids = port_sharded().search(ds().xq, QUERY_K, nprobe=32)
    assert id_recall(ids, gt_ids) > 0.999
    np.testing.assert_allclose(vals, gt_vals, rtol=1e-4, atol=1.0)


def test_partial_probe_recall_grows():
    _, gt_ids = flat_gt(QUERY_K)
    r = [id_recall(port_sharded().search(ds().xq, QUERY_K, nprobe)[1],
                   gt_ids) for nprobe in (1, 4, 32)]
    assert r == sorted(r) and r[-1] > 0.999


def test_bounded_search_bound_composes():
    """Each shard guarantees the bound on its partition; the merge then
    satisfies it globally."""
    from auncel_tpu_torch.autotune import recall_counts
    from auncel_tpu_torch.types import Metric
    gt_vals, _ = flat_gt(MAX_TOPK)
    vals, ids, n_scanned = port_sharded().search_bounded(ds().xq, acc(),
                                                         QUERY_K)
    cnt = recall_counts(vals, gt_vals, QUERY_K, Metric.L2)
    assert cnt.min() / QUERY_K >= 0.9
    assert n_scanned.shape == (4, NQ) and n_scanned.max() <= 32


def test_multirow_matches_padded(tmp_path):
    """The multi-row engine with the shared plan makes the padded engine's
    decisions, and save/load keeps the row cap and the layout."""
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh
    s = port_sharded()
    want = s.search_bounded(ds().xq, acc(), QUERY_K)
    s.enable_multirow(row_cap=ROW_CAP)
    try:
        got = s.search_bounded(ds().xq, acc(), QUERY_K)
        rpl = [m.rows_per_list.numpy() for m in s.mr]
        s.save(str(tmp_path / "mr"))
    finally:
        s.mr = None  # leave the cached index on the padded engine
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    loaded = ShardedIVF.load(str(tmp_path / "mr"),
                             mesh=make_mesh(4, devices=[DEVICE]))
    assert loaded._mr_row_cap == ROW_CAP
    for m, r in zip(loaded.mr, rpl):
        np.testing.assert_array_equal(m.rows_per_list.numpy(), r)
    for a, b in zip(loaded.search_bounded(ds().xq, acc(), QUERY_K), got):
        np.testing.assert_array_equal(a, b)


def test_global_ids_preserved():
    _, ids = port_sharded().search(ds().xb[:5], 1, nprobe=32)
    np.testing.assert_array_equal(ids[:, 0], np.arange(5))


def test_dp_mesh_matches_1d():
    """A [dp 2, shard 4] mesh (each group serves half the batch on its
    replica) gives the 1-D results: with both groups on one device they
    share each shard's tensors; with group 1 on another device ("cpu:0",
    as a second card would be) it is served from copies made there."""
    out = []
    for dp, devices in ((1, [DEVICE]), (2, [DEVICE]),
                        (2, [DEVICE] * 4 + ["cpu:0"] * 4)):
        s = port_build(nlist=16, dp=dp, devices=devices)
        assert s.dp == dp
        s.train_profiles(ds().xq, max_topk=16)
        s.enable_multirow(row_cap=16)
        s.multipler = 4.0
        out.append(s.search_bounded(ds().xq, acc(), 5)
                   + s.search(ds().xq, 5, nprobe=4))
        assert len(s._replicas) == (4 if len(devices) > 1 else 0)
        if dp == 2:
            assert s.mesh.shape == {"dp": 2, "shard": 4}
            with pytest.raises(AssertionError, match="dp axis"):
                s.search(ds().xq[:3], 5, nprobe=4)
    for got in out[1:]:
        for a, b in zip(got, out[0]):
            np.testing.assert_array_equal(a, b)


def test_drop_shard_equals_brute_force_on_survivors():
    from auncel_tpu_torch.parallel import split_round_robin
    s = port_build(nlist=16)
    s.train_profiles(ds().xq, max_topk=16)
    s.enable_multirow(row_cap=16)
    s.multipler = 4.0
    before = s.search_bounded(ds().xq, acc(), 5)[2]
    s.drop_shard(1)
    assert s.n_shards == 3 and len(s.traces) == 3
    _, i_b, ns = s.search_bounded(ds().xq, acc(), 5)
    assert ns.shape == (3, NQ) and not np.any(i_b % 4 == 1)
    np.testing.assert_array_equal(ns, np.delete(before, 1, axis=0))
    _, idf = s.search(ds().xq, 5, nprobe=16)
    parts = split_round_robin(ds().xb, 4)
    keep = np.concatenate([g for k, (r, g) in enumerate(parts) if k != 1])
    rows = np.concatenate([r for k, (r, g) in enumerate(parts) if k != 1])
    d2 = ((ds().xq[:, None, :] - rows[None]) ** 2).sum(-1)
    want = keep[np.argsort(d2, axis=1)[:, :5]]
    np.testing.assert_array_equal(np.sort(want, 1), np.sort(idf, 1))


def test_sq8_shards_make_their_own_engines_decisions(tmp_path):
    """Each SQ8 shard decides exactly as its own one-shot engine does with
    the shared plan; the merge satisfies the bound against the quantized
    corpus' exact scan; save/load keeps the codec."""
    from auncel_tpu_torch.autotune import recall_counts
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh
    from auncel_tpu_torch.profile.bounded_mr import bounded_oneshot_mr
    from auncel_tpu_torch.types import Metric
    s = port_build(storage="sq8")
    assert all(sh.storage == "sq8" for sh in s.shards)
    s.train_profiles(ds().xq[:N_TRAIN_Q], max_topk=MAX_TOPK)
    s.multipler = 8.0
    s.enable_multirow(row_cap=ROW_CAP)
    v, i, n_scanned = s.search_bounded(ds().xq, acc(), QUERY_K)
    for k, sh in enumerate(s.shards):
        out = bounded_oneshot_mr(
            sh.arrays, s.mr[k], s.traces[k], torch.as_tensor(ds().xq),
            torch.as_tensor(acc()), torch.tensor(8.0), torch.tensor(1.0),
            torch.zeros(NQ), QUERY_K, MAX_TOPK, Metric.L2, s._mr_plan)
        np.testing.assert_array_equal(n_scanned[k], out[3].numpy())
    gt_D = np.sort(np.concatenate(
        [sh.exact_search(ds().xq, QUERY_K)[0] for sh in s.shards], 1),
        1)[:, :QUERY_K]
    assert recall_counts(v, gt_D, QUERY_K, Metric.L2).min() / QUERY_K >= 0.9
    s.save(str(tmp_path / "sq8"))
    loaded = ShardedIVF.load(str(tmp_path / "sq8"),
                             mesh=make_mesh(4, devices=[DEVICE]))
    assert loaded.storage == "sq8"
    for a, b in zip(loaded.search_bounded(ds().xq, acc(), QUERY_K),
                    (v, i, n_scanned)):
        np.testing.assert_array_equal(a, b)


def test_undersized_shard_and_pq_storage_raise():
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh
    rng = np.random.RandomState(1)
    bad = ShardedIVF(16, 2048, n_shards=4,
                     mesh=make_mesh(4, devices=[DEVICE]))
    with pytest.raises(ValueError, match="k-means cannot train"):
        bad.build(rng.randn(4000, 16).astype(np.float32))
    with pytest.raises(ValueError):
        ShardedIVF(32, nlist=16, n_shards=4, storage="pq8")


def test_make_mesh_places_shards_round_robin(monkeypatch):
    """Cells take the devices round-robin; without a card the default
    devices (and so a ShardedIVF without a mesh) raise, never fall back."""
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh
    m = make_mesh(3, dp=2, devices=["cpu", "meta"])
    assert m.shape == {"dp": 2, "shard": 3}
    assert [d.type for d in m.devices.flat] == ["cpu", "meta"] * 3
    assert make_mesh(devices=["cpu", "meta"]).shape == {"shard": 2}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedIVF(32, nlist=16, n_shards=4)
