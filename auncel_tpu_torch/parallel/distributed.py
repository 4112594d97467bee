"""Scale-out across processes: one ``torch.distributed`` rank a cell of
``ShardedIVF``'s [dp, shard] mesh.

The reference's distributed mode runs one worker process a shard
(``dist/master.cpp``, ``dist/worker.cpp``); the JAX package runs its SPMD
program over a mesh that spans processes under ``jax.distributed``. Here
``make_mesh(..., ranks=True)`` lays the mesh over the ranks of an
initialised process group, cell (g, s) on rank g * S + s: each rank holds
only its own shard, every search ends in one all_gather of each cell's
result (``RankComm.all_gather``), and every rank merges the same cells in
shard order, so each returns the one-process result bit for bit.

The caller initialises the process group and names its backend, as the
JAX package's callers call ``jax.distributed.initialize``; nothing here
picks one. With gloo the gathered tensors go through the host, with NCCL
they stay on the card, and NCCL refuses two ranks on one card (the mesh
raises before any NCCL collective runs).

``spawn`` starts a local world of ranks (a ``file://`` rendezvous in a new
temporary directory) and fails, with the first failing rank's traceback,
as soon as any rank raises, or when the world outlives its deadline; each
collective is bounded by the process group's timeout. ``serve`` is a rank
of such a world serving a ``ShardedIVF`` as a list of steps says (load or
build, bounded and fixed search, save, drop_shard, dp k-means), writing
each rank's results to ``out/rank{r}.npz``.

    python -m auncel_tpu_torch.parallel.distributed

is the two-rank gloo smoke (the twin of the JAX package's
``scripts/multihost_smoke.py``): a row-sharded exact top-4 merged by the
all_gather equals a local exact search, and one global sum.
``dryrun_multichip(n_ranks, device)`` runs the JAX package's
``dryrun_multichip`` steps (dp k-means; build, profiles, multi-row bounded
and fixed search on SQ8 shards; a [dp 2, shard n/2] mesh) on n_ranks
spawned ranks.
"""

import datetime
import os
import socket
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from auncel_tpu_torch.data.synthetic import make_clustered_dataset
from auncel_tpu_torch.kernels.rowscan import rowscan_scores
from auncel_tpu_torch.kernels.scan_scores import scan_scores
from auncel_tpu_torch.kernels.topk_merge import topk_merge
from auncel_tpu_torch.parallel.kmeans_dp import dp_kmeans
from auncel_tpu_torch.parallel.sharded import ShardedIVF, make_mesh

TIMEOUT_S = 120          # each collective, init included
JOIN_TIMEOUT_S = 1800    # a spawned world, start to end

_T = {}   # this process's start and init times as a rank (time.time())


class RankComm:
    """The transport of a rank mesh: its world ranks in cell order, the
    group for tensors (the process group's backend) and a gloo group for
    host objects. Every rank of the world constructs it, since
    ``dist.new_group`` is collective; ``rank`` is this process's place in
    the mesh, -1 outside it."""

    def __init__(self, ranks):
        self.ranks = list(ranks)
        whole = self.ranks == list(range(dist.get_world_size()))
        self.backend = dist.get_backend()
        self.group = dist.group.WORLD if whole else dist.new_group(self.ranks)
        self.cpu_group = (self.group if self.backend == "gloo"
                          else dist.new_group(self.ranks, backend="gloo"))
        me = dist.get_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else -1

    def subset(self, cells: list) -> "RankComm":
        """The transport of the cells ``cells`` (indices into ``ranks``);
        every rank of the world calls it."""
        return RankComm([self.ranks[c] for c in cells])

    def all_gather(self, tensors: tuple) -> list:
        """Each rank's ``tensors`` (the same shapes and dtypes on every
        rank), in rank order, on the device of this rank's first tensor:
        one collective over their bytes, so every value comes back bit for
        bit. With gloo the bytes go through the host."""
        dev = tensors[0].device
        flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                          for t in tensors])
        if self.backend == "gloo":
            flat = flat.cpu()
        out = [torch.empty_like(flat) for _ in self.ranks]
        dist.all_gather(out, flat, group=self.group)
        res = []
        for buf in out:
            buf, at, parts = buf.to(dev), 0, []
            for t in tensors:
                n = t.numel() * t.element_size()
                parts.append(buf[at:at + n].clone().view(t.dtype)
                             .reshape(t.shape))
                at += n
            res.append(tuple(parts))
        return res

    def all_gather_object(self, obj) -> list:
        out = [None] * len(self.ranks)
        dist.all_gather_object(out, obj, group=self.cpu_group)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.cpu_group)

    def devices(self, own: torch.device) -> list:
        """Every rank's device, in rank order; with NCCL, two ranks on one
        card raise here on every rank (NCCL would refuse them later)."""
        where = self.all_gather_object((socket.gethostname(), str(own)))
        if self.backend != "gloo" and len(set(where)) < len(where):
            raise ValueError(
                f"NCCL needs a card a rank; ranks share one: {where} "
                "(use the gloo backend to put several ranks on one card)")
        return [torch.device(d) for _, d in where]


def own_device(devices=None) -> torch.device:
    """This rank's device: ``devices[rank % len(devices)]`` when given,
    else the card ``LOCAL_RANK % device_count`` (raises without one)."""
    if devices is not None:
        return torch.device(devices[dist.get_rank() % len(devices)])
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=[...] to run the "
                           "ranks elsewhere (e.g. ['cpu'])")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


# ------------------------------------------------------------------ spawn


def _rank_main(rank, world, backend, init_method, timeout_s, threads,
               target, args):
    _T["start"] = time.time()
    os.environ["LOCAL_RANK"] = str(rank)
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    _T["init"] = time.time()
    target(rank, world, *args)
    dist.destroy_process_group()


def spawn(target, n_ranks: int, args: tuple = (), *, backend: str,
          timeout_s: float = TIMEOUT_S,
          join_timeout_s: float = JOIN_TIMEOUT_S,
          threads: int | None = None) -> None:
    """Run ``target(rank, n_ranks, *args)`` (a module-level function) in
    ``n_ranks`` new processes, each a rank of a process group on
    ``backend`` whose collectives time out after ``timeout_s``; with
    ``threads``, each rank's torch uses that many CPU threads. Returns
    when every rank has ended well. The first rank that raises or exits
    non-zero ends the others and raises here with its traceback; a world
    still running after ``join_timeout_s`` is ended and raises
    ``TimeoutError``."""
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(n_ranks, backend, init, timeout_s, threads,
                              target, args),
            nprocs=n_ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + join_timeout_s
        try:
            while not ctx.join(timeout=1.0, grace_period=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks still running "
                                       f"after {join_timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()


# ------------------------------------------------------------ serve steps


def _array(a) -> np.ndarray:
    """An array step argument: the array, or the path of its ``.npy``."""
    return np.load(a) if isinstance(a, str) else np.asarray(a)


def _launches() -> dict:
    return {"rowscan_scores": rowscan_scores.launches,
            "scan_scores": scan_scores.launches,
            "topk_merge": topk_merge.launches}


def _launched(fn) -> tuple:
    """(fn(), each kernel's launches in this rank while it ran)."""
    before = _launches()
    out = fn()
    return out, {k: v - before[k] for k, v in _launches().items()}


def _refusal(call) -> str:
    """The message of the RuntimeError that ``call()`` must raise."""
    try:
        call()
    except RuntimeError as e:
        return str(e)
    raise AssertionError("a dropped rank served a search")


def serve(rank: int, world: int, steps: list, out: str,
          devices=None) -> None:
    """A rank serving ``ShardedIVF`` over rank meshes, step by step; each
    step is a dict (plain data and arrays, or paths of ``.npy`` files):

      {"op": "load", "dir", "mesh": (S, dp)}
      {"op": "build", "xb", "mesh", "nlist", "storage", "train_q",
       "max_topk", "multipler", "row_cap"}
      {"op": "bounded", "name", "q", "acc", "k", "reps", "latency"}
      {"op": "fixed", "name", "q", "k", "nprobe"}
      {"op": "save", "dir"}
      {"op": "drop", "shard"}
      {"op": "kmeans", "name", "x", "k", "niter", "shards"}

    ``bounded`` and ``fixed`` keep the merged result and this rank's
    kernel launches; with ``reps``, the seconds from a barrier to the
    merged result of that many more windows, and with ``latency``, each
    of the first that many queries alone. ``kmeans`` runs ``dp_kmeans``
    on the first ``shards`` ranks. On a rank whose shard was dropped each
    search must raise, and "{name}/refused" keeps its message. Writes
    ``out/rank{rank}.npz``: the results under "{name}/vals", ".../ids",
    ".../n_scanned", ".../launches" (rowscan_scores, scan_scores,
    topk_merge), ".../window_s", ".../latency_s", and "times" (start,
    init, then each step's end, time.time())."""
    res, times, s = {}, [_T.get("start", 0.0), _T.get("init", 0.0)], None
    for st in steps:
        op = st["op"]
        if op in ("load", "build"):
            S, dp = st["mesh"]
            mesh = make_mesh(S, dp, devices=devices, ranks=True)
            s = None
            if op == "load" and mesh is not None:
                s = ShardedIVF.load(st["dir"], mesh)
            elif mesh is not None:
                xb = _array(st["xb"])
                s = ShardedIVF(xb.shape[1], st["nlist"], S, mesh=mesh,
                               storage=st["storage"])
                s.build(xb)
                s.train_profiles(_array(st["train_q"]),
                                 st["max_topk"])
                s.multipler = st["multipler"]
                s.enable_multirow(st["row_cap"])
        elif op == "save":
            s.save(st["dir"])
        elif op == "drop":
            s.drop_shard(st["shard"])
        elif op == "kmeans":
            mesh = make_mesh(st["shards"], devices=devices, ranks=True)
            if mesh is not None:
                c, err = dp_kmeans(_array(st["x"]), st["k"],
                                   mesh, niter=st["niter"])
                res[st["name"] + "/centroids"] = c
                res[st["name"] + "/err"] = np.float64(err)
        elif s is None:
            pass
        elif op in ("bounded", "fixed"):
            q, k, name = _array(st["q"]), st["k"], st["name"]
            if op == "bounded":
                acc = np.full(q.shape[0], st["acc"], np.float32)

                def call(sl=slice(None)):
                    return s.search_bounded(q[sl], acc[sl], k)
            else:
                def call(sl=slice(None)):
                    return s.search(q[sl], k, st["nprobe"])
            if s.dropped:
                res[f"{name}/refused"] = np.array(_refusal(call))
                times.append(time.time())
                continue
            got, n = _launched(call)
            for key, a in zip(("vals", "ids", "n_scanned"), got):
                res[f"{name}/{key}"] = a
            res[f"{name}/launches"] = np.array(list(n.values()))
            window = []
            for _ in range(st.get("reps", 0)):
                s.mesh.comm.barrier()
                t0 = time.perf_counter()
                call()
                window.append(time.perf_counter() - t0)
            res[f"{name}/window_s"] = np.array(window)
            lat = []
            for i in range(st.get("latency", 0)):
                t0 = time.perf_counter()
                call(slice(i, i + 1))
                lat.append(time.perf_counter() - t0)
            res[f"{name}/latency_s"] = np.array(lat)
        else:
            raise ValueError(f"unknown step {op!r}")
        times.append(time.time())
    res["times"] = np.array(times)
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


# ------------------------------------------------------ dryrun and smoke


def _dryrun_rank(rank: int, world: int, device) -> None:
    devices = None if device is None else [device]
    mesh = make_mesh(world, devices=devices, ranks=True)
    # skewed clusters at nlist >> n_clusters: ragged lists on every shard
    ds = make_clustered_dataset(nb=512 * world * 8, nq=11, d=32,
                                n_clusters=12, seed=3)
    # 1. dp k-means over the ranks
    _, err = dp_kmeans(ds.xb, k=16, mesh=mesh, niter=2)
    assert np.isfinite(err)
    # 2. SQ8 shards: build, profiles, the multi-row bounded search, fixed
    s = ShardedIVF(ds.d, nlist=64, n_shards=world, mesh=mesh,
                   storage="sq8")
    s.build(ds.xb)
    s.train_profiles(ds.xq, max_topk=16)
    s.enable_multirow(row_cap=8)
    s.multipler = 4.0
    acc = np.full(ds.xq.shape[0], 0.9, np.float32)
    vals, _, n_scanned = s.search_bounded(ds.xq, acc, query_k=5)
    assert vals.shape == (ds.xq.shape[0], 16)
    assert n_scanned.shape == (world, ds.xq.shape[0])
    v2, _ = s.search(ds.xq, 5, nprobe=4)
    assert v2.shape == (ds.xq.shape[0], 5)
    # 3. a [dp 2, shard n/2] mesh: each dp group serves half the batch
    if world >= 4 and world % 2 == 0:
        s2 = ShardedIVF(ds.d, nlist=16, n_shards=world // 2, mesh=make_mesh(
            world // 2, dp=2, devices=devices, ranks=True))
        s2.build(ds.xb)
        s2.train_profiles(ds.xq, max_topk=16)
        s2.enable_multirow(row_cap=16)
        s2.multipler = 4.0
        nq2 = ds.xq.shape[0] - ds.xq.shape[0] % 2
        v3, _, ns3 = s2.search_bounded(ds.xq[:nq2], acc[:nq2], query_k=5)
        assert v3.shape == (nq2, 16)
        assert ns3.shape == (world // 2, nq2)
    if rank == 0:
        print(f"dryrun_multichip({world}): ok (kmeans err={err:.3g}, mean "
              f"scanned={n_scanned.mean():.1f})", flush=True)


def dryrun_multichip(n_ranks: int, device="cuda", backend: str = "gloo",
                     threads: int | None = None) -> None:
    """The JAX package's ``dryrun_multichip`` steps on ``n_ranks`` spawned
    ranks of a ``backend`` process group, each on ``device`` ("cuda": the
    rank's own card)."""
    spawn(_dryrun_rank, n_ranks, (None if device == "cuda" else device,),
          backend=backend, threads=threads)


def _smoke_rank(rank: int, world: int) -> None:
    rng = np.random.RandomState(0)
    xb = rng.rand(64, 8).astype(np.float32)
    q = rng.rand(4, 8).astype(np.float32)
    comm = RankComm(range(world))
    n = xb.shape[0] // world
    mine = torch.as_tensor(xb[rank * n:(rank + 1) * n])
    d = ((torch.as_tensor(q)[:, None, :] - mine[None]) ** 2).sum(-1)
    v, i = torch.topk(d, 4, largest=False)
    parts = comm.all_gather((v, i + rank * n))
    allv = torch.cat([p[0] for p in parts], 1)
    alli = torch.cat([p[1] for p in parts], 1)
    order = torch.sort(allv, dim=1, stable=True).indices[:, :4]
    got = torch.take_along_dim(allv, order, 1).numpy()
    want = np.sort(((q[:, None, :] - xb[None]) ** 2).sum(-1), 1)[:, :4]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ids = torch.take_along_dim(alli, order, 1).numpy()
    np.testing.assert_allclose(((q[:, None, :] - xb[ids]) ** 2).sum(-1),
                               got, rtol=1e-5)
    total = torch.tensor([float(rank + 1)])
    dist.all_reduce(total)
    assert total.item() == world * (world + 1) / 2, total
    print(f"rank {rank}: ok (world {world})", flush=True)


def main() -> None:
    # the ranks find the functions under the package's name, not __main__
    from auncel_tpu_torch.parallel import distributed as this
    this.spawn(this._smoke_rank, 2, backend="gloo", timeout_s=60,
               join_timeout_s=300, threads=1)
    print("multihost smoke: PASS", flush=True)


if __name__ == "__main__":
    main()
