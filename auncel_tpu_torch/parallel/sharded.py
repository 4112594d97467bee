"""Sharded (scale-out) search (port of ``auncel_tpu/parallel/sharded.py``).

The reference's distributed mode (``dist/``): the corpus is row-sharded
round-robin (``split.cpp``), each shard builds its own IVF index and its
own error profile on its partition (``worker.cpp:153-235``), every query
fans out to all shards, and the per-shard top-k results are merged by
distance (``reduce.cpp:98-133``). The per-query error bound composes
because each shard guarantees it on its partition and the merge keeps the
global top-k.

The JAX package runs the shards as one SPMD program over stacked ``[S,
...]`` state. Here each shard is an ``IVFFlatIndex`` on the device the mesh
gives it, and the merge moves each shard's ``[B, k]`` result to one device
and re-selects the top k with the stable sort of ``ops/topk.py``, so ties
go to the lower shard, as ``lax.top_k`` over the all-gather gives them. Each shard keeps its arrays,
row layout and profile at its own size: the JAX padding to common shapes
exists only for stacking, and no result depends on it. The one-shot plan of
``enable_multirow`` is the JAX one: built once from the dominating row
profile and shared by every shard.

The mesh is a ``[dp, shard]`` grid of torch devices (``make_mesh``). On
a one-process mesh, one process drives every shard: with fewer devices
than grid cells, cells take the devices round-robin, so one card can hold
every shard, and a shard whose cell names another device than the one its
index lives on is served from a copy made there once. On a rank mesh
(``make_mesh(..., ranks=True)``, ``parallel/distributed.py``) cell (g, s)
is the process of rank g * S + s, which holds only shard s: the values
that every shard contributes to shared state (the caps and rows per list
the one-shot plan is built from, the host mirror of the profiles) are
gathered, every search ends in one all_gather of the cells' results, and
every rank merges them as one process would, so all ranks return the
one-process result bit for bit.
"""

import json
import os

import numpy as np
import torch

from auncel_tpu_torch.types import Metric
from auncel_tpu_torch.index.io import load_index, save_index
from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.index.multirow import build_multirow
from auncel_tpu_torch.index.scan import ivf_search_fixed
from auncel_tpu_torch.ops.topk import topk_scores
from auncel_tpu_torch.profile.bounded import bounded_search
from auncel_tpu_torch.profile.bounded_mr import bounded_oneshot_mr, plan_oneshot
from auncel_tpu_torch.profile.trace import (
    TraceSet, load_trace_set, save_trace_set, traces_from_arrays)
from auncel_tpu_torch.profile.trainer import train_profile

AXIS = "shard"
DP = "dp"


class Mesh:
    """Shard (and query data-parallel) placement: ``devices`` is a [dp, S]
    grid of torch devices; ``shape`` is the JAX mesh's (``{"shard": S}``,
    or ``{"dp": dp, "shard": S}`` with a dp axis). ``comm`` is the
    transport of a rank mesh (``distributed.RankComm``), None when one
    process drives every cell."""

    def __init__(self, devices: np.ndarray, axis_names: tuple, comm=None):
        assert devices.ndim == 2, devices.shape
        self.devices = devices
        self.axis_names = axis_names
        self.comm = comm

    @property
    def cell(self) -> tuple | None:
        """This process's (g, s) on a rank mesh, else None."""
        if self.comm is None:
            return None
        return divmod(self.comm.rank, self.devices.shape[1])

    @property
    def shape(self) -> dict:
        dp, n = self.devices.shape
        return {AXIS: n} if self.axis_names == (AXIS,) else {DP: dp, AXIS: n}


def make_mesh(n_shards: int | None = None, dp: int = 1,
              devices=None, ranks: bool = False) -> Mesh | None:
    """Device mesh for sharded search. ``dp > 1`` adds a query
    data-parallel axis: each dp group holds a full replica of the sharded
    corpus and serves 1/dp of every query batch. ``devices`` defaults to
    every visible CUDA device (and raises when there is none); grid cells
    take them round-robin, so ``make_mesh(4)`` on one card places all
    four shards on it.

    With ``ranks`` (an initialised process group), the grid's cells are
    the world's first dp * S ranks, cell (g, s) rank g * S + s, each on
    its rank's device: ``devices[rank % len(devices)]``, by default the
    card ``LOCAL_RANK % device_count``. Every rank of the world calls it;
    a rank outside the grid gets None."""
    if ranks:
        return _rank_mesh(n_shards, dp, devices)
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device: pass devices=[...] to run "
                               "the shards elsewhere (e.g. ['cpu'])")
    devs = [torch.device(d) for d in devices]
    n = n_shards or max(len(devs) // dp, 1)
    grid = np.empty((dp, n), object)
    for i in range(dp * n):
        grid.flat[i] = devs[i % len(devs)]
    return Mesh(grid, (AXIS,) if dp == 1 else (DP, AXIS))


def _rank_mesh(n_shards: int | None, dp: int, devices) -> Mesh | None:
    import torch.distributed as dist
    from auncel_tpu_torch.parallel.distributed import RankComm, own_device
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh(ranks=True) needs an initialised "
                           "process group (torch.distributed."
                           "init_process_group)")
    world = dist.get_world_size()
    n = n_shards or world // dp
    if dp * n > world:
        raise ValueError(f"a [{dp}, {n}] mesh needs {dp * n} ranks; the "
                         f"world has {world}")
    comm = RankComm(range(dp * n))
    if comm.rank < 0:
        return None
    grid = np.empty((dp, n), object)
    for i, d in enumerate(comm.devices(own_device(devices))):
        grid.flat[i] = d
    return Mesh(grid, (AXIS,) if dp == 1 else (DP, AXIS), comm)


def split_round_robin(x: np.ndarray, n_shards: int):
    """Row round-robin corpus split (reference dist/split.cpp). Returns
    per-shard (rows, global_ids)."""
    n = x.shape[0]
    ids = np.arange(n, dtype=np.int64)
    return [(x[s::n_shards], ids[s::n_shards]) for s in range(n_shards)]


def _to(nt, dev):
    """A NamedTuple of tensors (nested NamedTuples too) on ``dev``."""
    if nt is None:
        return None
    return type(nt)(*[_to(v, dev) if hasattr(v, "_fields")
                      else v.to(dev) if torch.is_tensor(v) else v
                      for v in nt])


class ShardedIVF:
    """S independent per-shard IVF indexes behind one search call."""

    def __init__(self, d: int, nlist: int, n_shards: int,
                 metric: Metric = Metric.L2, mesh: Mesh | None = None,
                 storage: str = "f32"):
        self.d = d
        self.nlist = nlist
        self.n_shards = n_shards
        self.metric = Metric.parse(metric)
        # quantized shards are the production deployment (a shard of the
        # reference's DEEP1B split holds ~10M vectors); PQ is excluded only
        # because the multi-row engine needs per-list centroids
        if storage.startswith("pq"):
            raise ValueError(
                "ShardedIVF supports f32/bf16/sq* shard storage (PQ "
                "storage cannot ride the multirow bounded engine)")
        self.storage = storage
        self._configure_mesh(mesh or make_mesh(n_shards), n_shards)
        self.shards: list[IVFFlatIndex] = []
        self.mr: list | None = None        # per-shard MultiRowArrays
        self._mr_plan = None
        self._mr_row_cap = None
        self.traces: list[TraceSet] | None = None
        # host mirror of the stacked profiles ([S, T, max_bins], phi padded
        # by +inf): the traces.npz layout, and what drop_shard restages
        # from without reading a failed device
        self._host_traces: dict | None = None
        self._replicas: dict = {}
        self.multipler = 1.0
        self.std_m = 1.0
        self.dropped = False   # this rank's shard left the mesh

    def _configure_mesh(self, mesh: Mesh, n_shards: int) -> None:
        assert mesh.shape[AXIS] == n_shards, (mesh.shape, n_shards)
        self.mesh = mesh
        self.dp = int(mesh.shape.get(DP, 1))
        self._replicas = {}

    def _held(self) -> list:
        """The shards this process holds: all on a one-process mesh, its
        cell's on a rank mesh."""
        cell = self.mesh.cell
        return list(range(self.n_shards)) if cell is None else [cell[1]]

    def _device(self, s: int) -> torch.device:
        """The device shard s lives on in this process."""
        cell = self.mesh.cell
        return self.mesh.devices[cell if cell is not None else (0, s)]

    def _per_shard(self, fn) -> list:
        """fn(s) for every shard s, in shard order: on a rank mesh each
        rank computes its own shard's and the values are gathered."""
        if self.mesh.comm is None:
            return [fn(s) for s in range(self.n_shards)]
        got = self.mesh.comm.all_gather_object(fn(self.mesh.cell[1]))
        return got[:self.n_shards]   # dp group 0: cells (0, s)

    # ------------------------------------------------------------- build

    def build(self, xb: np.ndarray, train_frac: float = 0.5) -> None:
        """Per-shard k-means + pack on the shard's device (reference
        worker.cpp "train" command: each worker trains its own IVF on its
        shard); ids are global corpus row ids."""
        parts = split_round_robin(np.asarray(xb, np.float32), self.n_shards)
        small = min(rows.shape[0] for rows, _ in parts)
        if small < self.nlist:
            raise ValueError(
                f"shard holds {small} rows < nlist={self.nlist}: k-means "
                f"cannot train {self.nlist} centroids; lower nlist or "
                f"n_shards")
        self.shards = [None] * self.n_shards
        for s in self._held():
            rows, gids = parts[s]
            idx = IVFFlatIndex(self.d, self.nlist, self.metric,
                               device=self._device(s),
                               storage=self.storage)
            nt = max(int(rows.shape[0] * train_frac), self.nlist)
            idx.train(rows[:nt])
            # the profile engine's boundary geometry needs the real
            # inter-centroid matrix, also above INTERDIS_EAGER_MAX lists
            idx.ensure_interdis()
            idx.add(rows, ids=gids)
            _ = idx.arrays
            self.shards[s] = idx
        self.mr = None
        self._replicas = {}

    def enable_multirow(self, row_cap: int = 256) -> None:
        """Each shard's multi-row layout, and the one-shot plan every shard
        runs, built from a DOMINATING row profile (the elementwise max of
        the shards' descending rows-per-list), so its per-stage coverage
        guarantee holds on every shard."""
        rc = min([row_cap] + self._per_shard(
            lambda s: self.shards[s].arrays.cap))
        self._mr_row_cap = rc
        self.mr = [None] * self.n_shards
        for s in self._held():
            self.mr[s] = build_multirow(self.shards[s].arrays, rc)
        descs = np.stack(self._per_shard(lambda s: np.sort(
            self.mr[s].rows_per_list.cpu().numpy())[::-1]))
        self._mr_plan = plan_oneshot(np.max(descs, axis=0), self.nlist)
        self._replicas = {}

    # ----------------------------------------------------------- profiles

    def train_profiles(self, xq: np.ndarray, max_topk: int,
                       bs: int = 250) -> None:
        """Each shard trains its own phi->U profile against its own
        partition's ground truth (reference worker.cpp:153-235 +
        dist/gt.cpp per-shard GT)."""
        self.max_topk = max_topk
        traces = {}
        for s in self._held():
            idx = self.shards[s]
            gt_D, _ = idx.exact_search(xq, max_topk)
            t, _ = train_profile(idx.arrays, xq, gt_D, max_topk,
                                 self.metric, bs=bs)
            traces[s] = {f: getattr(t, f).cpu().numpy()
                         for f in ("phi", "u", "std", "n_bins")}
        traces = self._per_shard(traces.get)
        max_bins = max(t["phi"].shape[1] for t in traces)

        def stack(field, fill):
            return np.stack([np.pad(
                t[field], ((0, 0), (0, max_bins - t[field].shape[1])),
                constant_values=fill) for t in traces])
        self._set_traces(dict(
            phi=stack("phi", np.inf), u=stack("u", 0.0),
            std=stack("std", 0.0),
            n_bins=np.stack([t["n_bins"] for t in traces])))

    def _set_traces(self, host: dict | None) -> None:
        """Adopt stacked host profiles and stage shard i's slice on its
        device."""
        self._host_traces = host
        self.traces = None
        if host is not None:
            self.traces = [None] * self.n_shards
            for i in self._held():
                self.traces[i] = traces_from_arrays(
                    host["phi"][i], host["u"][i], host["std"][i],
                    host["n_bins"][i], self.shards[i].device)
        self._replicas = {}

    # -------------------------------------------------------- persistence

    def save(self, dirpath: str) -> None:
        """Per-shard index files + the stacked profiles, in the JAX
        package's layout (meta.json, shard{i}.npz, traces.npz). On a rank
        mesh each rank of dp group 0 writes its shard's file and rank 0
        the rest; every rank returns when the directory is whole."""
        os.makedirs(dirpath, exist_ok=True)
        cell = self.mesh.cell
        if cell is not None and cell[0] > 0:   # a dp replica: no file
            self.mesh.comm.barrier()
            return
        meta = dict(d=self.d, nlist=self.nlist, n_shards=self.n_shards,
                    storage=self.storage,
                    metric=self.metric.value, multipler=self.multipler,
                    std_m=self.std_m,
                    max_topk=getattr(self, "max_topk", None),
                    multirow_row_cap=(int(self._mr_row_cap)
                                      if self.mr is not None else None))
        for i in self._held():
            save_index(self.shards[i], os.path.join(dirpath, f"shard{i}.npz"))
        if cell is None or cell == (0, 0):
            with open(os.path.join(dirpath, "meta.json"), "w") as f:
                json.dump(meta, f)
            if self._host_traces is not None:
                save_trace_set(traces_from_arrays(
                    **self._host_traces, device="cpu"),
                    os.path.join(dirpath, "traces.npz"))
        if cell is not None:
            self.mesh.comm.barrier()

    @classmethod
    def load(cls, dirpath: str, mesh: Mesh | None = None) -> "ShardedIVF":
        """A directory either package saved, shard i on the mesh's device
        for it; on a rank mesh each rank reads the meta, the profiles and
        its own shard only."""
        with open(os.path.join(dirpath, "meta.json")) as f:
            meta = json.load(f)
        s = cls(meta["d"], meta["nlist"], meta["n_shards"],
                Metric.parse(meta["metric"]), mesh=mesh,
                storage=meta.get("storage", "f32"))
        s.multipler = meta["multipler"]
        s.std_m = meta["std_m"]
        if meta.get("max_topk"):
            s.max_topk = meta["max_topk"]
        s.shards = [None] * s.n_shards
        for i in s._held():
            s.shards[i] = load_index(os.path.join(dirpath, f"shard{i}.npz"),
                                     device=s._device(i))
        tp = os.path.join(dirpath, "traces.npz")
        if os.path.exists(tp):
            t = load_trace_set(tp, "cpu")
            s._set_traces({f: getattr(t, f).numpy() for f in t._fields})
        if meta.get("multirow_row_cap"):
            s.enable_multirow(meta["multirow_row_cap"])
        return s

    # --------------------------------------------------- failure handling

    def drop_shard(self, shard_id: int, mesh: Mesh | None = None) -> None:
        """Continue serving WITHOUT one shard (elastic degradation; the
        reference's master hangs on a dead worker, dist/master.cpp:91-99).
        The survivors keep their profiles, restaged from the host mirror
        so recovery never reads the failed device; global recall degrades
        by at most the dropped partition's share of the corpus. The
        default mesh is the old one minus the dropped shard's device
        column; the one-shot plan is rebuilt from the survivors.

        On a rank mesh every rank of the world calls it (without
        ``mesh``): the survivors' ranks form a new group, and on the
        dropped shard's ranks any later search raises."""
        assert self.n_shards > 1, "cannot drop the last shard"
        assert 0 <= shard_id < self.n_shards
        # build and validate the replacement mesh before mutating state
        old = self.mesh
        if old.comm is not None:
            assert mesh is None, "a rank mesh drops its own column"
            S = self.n_shards
            comm = old.comm.subset([c for c in range(len(old.comm.ranks))
                                    if c % S != shard_id])
            if old.cell[1] == shard_id:
                self.dropped = True
                self.shards = self.mr = self.traces = None
                return
            mesh = Mesh(np.delete(old.devices, shard_id, axis=1),
                        old.axis_names, comm)
        elif mesh is None:
            mesh = Mesh(np.delete(old.devices, shard_id, axis=1),
                        old.axis_names)
        assert mesh.shape[AXIS] == self.n_shards - 1, (
            mesh.shape, self.n_shards - 1)
        host = self._host_traces
        if host is not None:
            host = {k: np.delete(v, shard_id, axis=0)
                    for k, v in host.items()}
        mr_cap = self._mr_row_cap if self.mr is not None else None
        del self.shards[shard_id]
        self.n_shards -= 1
        self._configure_mesh(mesh, self.n_shards)
        self.mr = None
        self._set_traces(host)
        if mr_cap is not None:
            self.enable_multirow(mr_cap)

    # ------------------------------------------------------------- search

    def _state(self, s: int, dev: torch.device) -> tuple:
        """Shard s's (arrays, multi-row layout, profile) on ``dev``: the
        shard's own tensors on its device, else a copy made there once."""
        idx = self.shards[s]
        own = (idx.arrays, self.mr[s] if self.mr is not None else None,
               self.traces[s] if self.traces is not None else None)
        if dev == idx.device:
            return own
        key = (s, str(dev))
        if key not in self._replicas:
            self._replicas[key] = tuple(_to(x, dev) for x in own)
        return self._replicas[key]

    def _groups(self, q) -> tuple:
        """The queries as float32 numpy, and the slice of the batch each
        dp group serves."""
        if self.dropped:
            raise RuntimeError("this rank's shard was dropped "
                               "(drop_shard): it serves no more searches")
        q = np.asarray(q, np.float32)
        if q.ndim != 2 or q.shape[1] != self.d:
            raise ValueError(f"queries must be [n, {self.d}], got "
                             f"{q.shape}")
        assert q.shape[0] % self.dp == 0, (
            f"batch {q.shape[0]} must divide the dp axis ({self.dp}); "
            "pad the query window")
        n = q.shape[0] // self.dp
        return q, [slice(g * n, (g + 1) * n) for g in range(self.dp)]

    def _run_cells(self, fn) -> list:
        """fn(g, s, device) -> (vals, ids[, n_scanned]) tensors for every
        cell of the mesh, as [dp][S] lists: one process runs each cell; on
        a rank mesh each rank runs its own, and one all_gather brings
        every rank all cells' results, on its device."""
        S = self.n_shards
        cell = self.mesh.cell
        if cell is None:
            return [[fn(g, s, self.mesh.devices[g, s]) for s in range(S)]
                    for g in range(self.dp)]
        got = self.mesh.comm.all_gather(fn(*cell, self.mesh.devices[cell]))
        return [got[g * S:(g + 1) * S] for g in range(self.dp)]

    def search(self, q: np.ndarray, k: int, nprobe: int):
        """Fixed-nprobe sharded search: each shard's padded-list scan (K2),
        then the merge. With a dp axis, each dp group serves its slice of
        the batch."""
        q, groups = self._groups(q)

        def cell(g, s, dev):
            return ivf_search_fixed(
                self._state(s, dev)[0], torch.as_tensor(q[groups[g]],
                                                        device=dev),
                k, nprobe, self.metric)
        vals, ids = [], []
        for per in self._run_cells(cell):
            v, i = _merge_over_shards(per, k, self.metric)
            vals.append(v.cpu().numpy())
            ids.append(i.cpu().numpy())
        return np.concatenate(vals), np.concatenate(ids).astype(np.int64)

    def search_bounded(self, q: np.ndarray, require_acc: np.ndarray,
                       query_k: int, max_topk: int | None = None):
        """Error-bounded sharded search: each shard runs the one-shot
        engine (after ``enable_multirow``, with the shared plan) or the
        padded ``bounded_search`` on its own profile, then the global top
        ``max_topk`` is merged. Returns (vals, ids, per-shard n_scanned
        [S, B])."""
        q, groups = self._groups(q)
        assert self.traces is not None, "train_profiles first"
        max_topk = max_topk or self.max_topk
        acc = np.asarray(require_acc, np.float32)

        def cell(g, s, dev):
            arrays, mr, traces = self._state(s, dev)
            sl = groups[g]
            qt = torch.as_tensor(q[sl], device=dev)
            args = (traces, qt, torch.as_tensor(acc[sl], device=dev),
                    torch.tensor(self.multipler, dtype=torch.float32,
                                 device=dev),
                    torch.tensor(self.std_m, dtype=torch.float32,
                                 device=dev),
                    torch.zeros(qt.shape[0], dtype=torch.float32,
                                device=dev),
                    query_k, max_topk, self.metric)
            if mr is not None:
                out = bounded_oneshot_mr(arrays, mr, *args, self._mr_plan)
            else:
                out = bounded_search(arrays, *args)
            return out[0], out[1], out[3]
        vals, ids, n_scanned = [], [], []
        for per in self._run_cells(cell):
            v, i = _merge_over_shards(per, max_topk, self.metric)
            vals.append(v.cpu().numpy())
            ids.append(i.cpu().numpy())
            n_scanned.append(np.stack([p[2].cpu().numpy() for p in per]))
        return (np.concatenate(vals), np.concatenate(ids).astype(np.int64),
                np.concatenate(n_scanned, axis=1))


def _merge_over_shards(per, k: int, metric: Metric):
    """reduce.cpp's per-query merge: each shard's (vals [B, k], ids, ...)
    on the first shard's device, laid out [B, S * k] in shard order, then
    the stable top-k (ties to the lower shard)."""
    dev = per[0][0].device
    return topk_scores(torch.cat([p[0].to(dev) for p in per], dim=1),
                       torch.cat([p[1].to(dev) for p in per], dim=1),
                       k, metric)
