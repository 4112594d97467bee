"""ShardedIVF across processes (``auncel_tpu_torch/parallel/distributed.py``):
one gloo rank a shard on the CPU, against the one-process port and the JAX
package.

One world of 4 ranks (``spawn`` of ``serve``, a ``file://`` rendezvous)
runs every step once, in the module fixture, and writes each rank's
results; the tests read them. The JAX ``ShardedIVF`` of
``test_torch_parallel.py`` (16000 x 32, nlist 32, 4 shards, profiles on 20
queries, multipler 8, row cap 64, f32 and sq8) is saved by the JAX package
and loaded by the ranks: their bounded and fixed searches equal the
one-process port's bit for bit, and the JAX package's ids and n_scanned
with values within 1e-5 relative. Then save on the ranks, drop_shard(1)
on the ranks, dp_kmeans on 2 ranks, and a [dp 2, shard 2] rank mesh that
builds its own shards. The ranks and this process use one torch thread
each, so the CPU's matrix products round alike in both. The worlds of
``dryrun_multichip`` and of a failing rank run beside the JAX build, in
threads of this process.
"""

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import (MAX_TOPK, NQ, QUERY_K, assert_same,
                                       ds, systems)
from tests.torch_parity import DEVICE

STORAGES = ["f32", "sq8"]
NPROBES = (1, 4, 32)
KM_N, KM_K, KM_NITER = 8000, 32, 5


def acc():
    return np.full(NQ, 0.9, np.float32)


def failing_worlds(tmp) -> dict:
    """Rank 1 of 4 cannot read its shard while rank 0 waits for it in a
    collective; then a 2-rank world that outlives a 0.5 s deadline. Each
    spawn's error and seconds."""
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh
    from auncel_tpu_torch.parallel.distributed import serve, spawn
    s = ShardedIVF(ds().d, nlist=4, n_shards=4,
                   mesh=make_mesh(4, devices=[DEVICE]))
    s.build(ds().xb[:2000])
    s.enable_multirow(16)
    s.save(str(tmp / "broken"))
    os.remove(tmp / "broken" / "shard1.npz")
    out = {}
    for name, n, steps, deadline in (
            ("rank", 4, [dict(op="load", dir=str(tmp / "broken"),
                              mesh=(4, 1))], 120),
            ("deadline", 2, [], 0.5)):
        t0 = time.perf_counter()
        try:
            spawn(serve, n, (steps, str(tmp / "out"), ["cpu"]),
                  backend="gloo", timeout_s=60, join_timeout_s=deadline,
                  threads=1)
            out[name] = (None, time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001 - the test reads it
            out[name] = (e, time.perf_counter() - t0)
    return out


@pytest.fixture(scope="module")
def side_worlds(tmp_path_factory):
    """dryrun_multichip(4) and the failing worlds, started in threads."""
    from auncel_tpu_torch.parallel.distributed import dryrun_multichip
    pool = ThreadPoolExecutor(2)
    yield {"dryrun": pool.submit(dryrun_multichip, 4, device="cpu",
                                 threads=1),
           "failing": pool.submit(failing_worlds,
                                  tmp_path_factory.mktemp("failing"))}
    pool.shutdown()


@pytest.fixture(scope="module")
def world(tmp_path_factory, side_worlds):
    """The saved JAX systems, the arrays, and the 4-rank world's results
    (rank -> npz)."""
    from auncel_tpu_torch.parallel.distributed import serve, spawn
    tmp = tmp_path_factory.mktemp("ranks")
    paths = {}
    for name, a in (("xb", ds().xb), ("xq", ds().xq),
                    ("km", ds().xb[:KM_N])):
        paths[name] = str(tmp / f"{name}.npy")
        np.save(paths[name], a)
    steps = []
    for storage in STORAGES:
        js = systems(storage)[0]
        js.save(str(tmp / f"jax_{storage}"))
        steps += [dict(op="load", dir=str(tmp / f"jax_{storage}"),
                       mesh=(4, 1)),
                  dict(op="bounded", name=f"b_{storage}", q=paths["xq"],
                       acc=0.9, k=QUERY_K)]
        steps += [dict(op="fixed", name=f"f{p}_{storage}", q=paths["xq"],
                       k=QUERY_K, nprobe=p) for p in NPROBES]
    steps += [dict(op="save", dir=str(tmp / "ranks_sq8")),
              dict(op="drop", shard=1),
              dict(op="bounded", name="drop_b", q=paths["xq"], acc=0.9,
                   k=QUERY_K),
              dict(op="fixed", name="drop_f", q=paths["xq"], k=QUERY_K,
                   nprobe=8),
              dict(op="kmeans", name="km", x=paths["km"], k=KM_K,
                   niter=KM_NITER, shards=2),
              dict(op="build", xb=paths["xb"], mesh=(2, 2), nlist=16,
                   storage="f32", train_q=paths["xq"], max_topk=16,
                   multipler=4.0, row_cap=16),
              dict(op="bounded", name="dp_b", q=paths["xq"], acc=0.9, k=5),
              dict(op="fixed", name="dp_f", q=paths["xq"], k=5, nprobe=4)]
    t0 = time.perf_counter()
    spawn(serve, 4, (steps, str(tmp / "out"), ["cpu"]), backend="gloo",
          timeout_s=60, join_timeout_s=300, threads=1)
    ranks = {r: dict(np.load(tmp / "out" / f"rank{r}.npz"))
             for r in range(4)}
    return dict(tmp=tmp, ranks=ranks, seconds=time.perf_counter() - t0)


def result(world, name: str, rank: int = 0) -> tuple:
    z = world["ranks"][rank]
    return tuple(z[f"{name}/{k}"] for k in ("vals", "ids", "n_scanned")
                 if f"{name}/{k}" in z)


def assert_bitwise(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def one_process(world, storage: str):
    """The port's one-process ShardedIVF on the directory the ranks
    loaded."""
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh
    return ShardedIVF.load(str(world["tmp"] / f"jax_{storage}"),
                           mesh=make_mesh(4, devices=[DEVICE]))


def test_every_rank_returns_the_same_result(world):
    names = [n[:-5] for n in world["ranks"][0] if n.endswith("/vals")]
    assert len(names) == 2 * (1 + len(NPROBES)) + 4
    for name in names:
        for r in (1, 2, 3):
            if name.startswith("drop") and r == 1:
                continue
            assert_bitwise(result(world, name, r), result(world, name))


@pytest.mark.parametrize("storage", STORAGES)
def test_bounded_equals_one_process(world, storage):
    got = result(world, f"b_{storage}")
    assert got[2].shape == (4, NQ) and got[0].shape == (NQ, MAX_TOPK)
    assert_bitwise(got, one_process(world, storage).search_bounded(
        ds().xq, acc(), QUERY_K))


@pytest.mark.parametrize("storage", STORAGES)
def test_fixed_equals_one_process(world, storage):
    s = one_process(world, storage)
    for p in NPROBES:
        assert_bitwise(result(world, f"f{p}_{storage}"),
                       s.search(ds().xq, QUERY_K, p))


@pytest.mark.parametrize("storage", STORAGES)
def test_ranks_match_jax(world, storage):
    """Equal ids and n_scanned, values within 1e-5 relative, against the
    JAX ShardedIVF that saved the directory (fixed search at nprobe 4:
    each nprobe is a JAX compile)."""
    js = systems(storage)[0]
    assert_same(result(world, f"b_{storage}"),
                js.search_bounded(ds().xq, acc(), QUERY_K))
    assert_same(result(world, f"f4_{storage}"), js.search(ds().xq, QUERY_K,
                                                          4))


def test_save_on_ranks_loads_in_one_process(world):
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh
    p = world["tmp"] / "ranks_sq8"
    assert sorted(os.listdir(p)) == ["meta.json", "shard0.npz", "shard1.npz",
                                     "shard2.npz", "shard3.npz",
                                     "traces.npz"]
    s = ShardedIVF.load(str(p), mesh=make_mesh(4, devices=[DEVICE]))
    assert s.storage == "sq8" and s._mr_row_cap == 64
    assert_bitwise(s.search_bounded(ds().xq, acc(), QUERY_K),
                   result(world, "b_sq8"))


def test_drop_shard_on_ranks_equals_one_process(world):
    """Every rank drops shard 1: the survivors equal the one-process
    drop_shard, and the dropped rank's searches raise."""
    s = one_process(world, "sq8")
    s.drop_shard(1)
    got = result(world, "drop_b")
    assert got[2].shape == (3, NQ) and not np.any(got[1] % 4 == 1)
    assert_bitwise(got, s.search_bounded(ds().xq, acc(), QUERY_K))
    assert_bitwise(result(world, "drop_f"), s.search(ds().xq, QUERY_K, 8))
    dropped = world["ranks"][1]
    assert "drop_b/vals" not in dropped
    for name in ("drop_b", "drop_f"):
        assert "dropped" in str(dropped[f"{name}/refused"])


def test_dp_kmeans_on_two_ranks_is_bitwise_one_process(world):
    from auncel_tpu_torch.parallel import dp_kmeans, make_mesh
    c, err = dp_kmeans(ds().xb[:KM_N], KM_K,
                       make_mesh(2, devices=[DEVICE]), niter=KM_NITER)
    for r in (0, 1):
        z = world["ranks"][r]
        np.testing.assert_array_equal(z["km/centroids"], c)
        assert float(z["km/err"]) == err
    assert "km/centroids" not in world["ranks"][2]


def test_dp_rank_mesh_equals_the_1d_one_process(world):
    """A [dp 2, shard 2] rank mesh (each dp group serves half the batch,
    each rank builds its own shard) gives the one-process 1-D results."""
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh
    s = ShardedIVF(ds().d, nlist=16, n_shards=2,
                   mesh=make_mesh(2, devices=[DEVICE]))
    s.build(ds().xb)
    s.train_profiles(ds().xq, max_topk=16)
    s.multipler = 4.0
    s.enable_multirow(row_cap=16)
    got = result(world, "dp_b")
    assert got[2].shape == (2, NQ)
    assert_bitwise(got, s.search_bounded(ds().xq, acc(), 5))
    assert_bitwise(result(world, "dp_f"), s.search(ds().xq, 5, 4))


def test_dryrun_multichip_on_cpu_ranks(side_worlds):
    """The JAX package's dryrun_multichip steps on 4 gloo ranks run to
    their end (a rank that fails would raise here)."""
    assert side_worlds["dryrun"].result(timeout=300) is None


def test_a_failing_rank_fails_the_world_at_once(side_worlds):
    """The spawner raises with rank 1's error within seconds, long before
    the collective's 60 s timeout; a world past its deadline is ended and
    raises."""
    from torch.multiprocessing import ProcessRaisedException
    got = side_worlds["failing"].result(timeout=300)
    err, seconds = got["rank"]
    assert isinstance(err, ProcessRaisedException), err
    assert "shard1.npz" in str(err) and seconds < 30
    err, seconds = got["deadline"]
    assert isinstance(err, TimeoutError) and seconds < 30
