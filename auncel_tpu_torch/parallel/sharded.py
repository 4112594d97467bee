"""Sharded (scale-out) search (port of ``auncel_tpu/parallel/sharded.py``).

The reference's distributed mode (``dist/``): the corpus is row-sharded
round-robin (``split.cpp``), each shard builds its own IVF index and its
own error profile on its partition (``worker.cpp:153-235``), every query
fans out to all shards, and the per-shard top-k results are merged by
distance (``reduce.cpp:98-133``). The per-query error bound composes
because each shard guarantees it on its partition and the merge keeps the
global top-k.

The JAX package runs the shards as one SPMD program over stacked ``[S,
...]`` state. Here one process drives a list of per-shard ``IVFFlatIndex``es,
each on the device the mesh gives its shard; the merge moves each shard's
``[B, k]`` result to the first shard's device and re-selects the top k with
the stable sort of ``ops/topk.py``, so ties go to the lower shard, as
``lax.top_k`` over the all-gather gives them. Each shard keeps its arrays,
row layout and profile at its own size: the JAX padding to common shapes
exists only for stacking, and no result depends on it. The one-shot plan of
``enable_multirow`` is the JAX one: built once from the dominating row
profile and shared by every shard.

The mesh is a ``[dp, shard]`` grid of torch devices (``make_mesh``). With
fewer devices than grid cells, cells take the devices round-robin, so one
card can hold every shard; a shard whose cell names another device than
the one its index lives on is served from a copy made there once.
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
    or ``{"dp": dp, "shard": S}`` with a dp axis)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        assert devices.ndim == 2, devices.shape
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        dp, n = self.devices.shape
        return {AXIS: n} if self.axis_names == (AXIS,) else {DP: dp, AXIS: n}


def make_mesh(n_shards: int | None = None, dp: int = 1,
              devices=None) -> Mesh:
    """Device mesh for sharded search. ``dp > 1`` adds a query
    data-parallel axis: each dp group holds a full replica of the sharded
    corpus and serves 1/dp of every query batch. ``devices`` defaults to
    every visible CUDA device (and raises when there is none); grid cells
    take them round-robin, so ``make_mesh(4)`` on one card places all
    four shards on it."""
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

    def _configure_mesh(self, mesh: Mesh, n_shards: int) -> None:
        assert mesh.shape[AXIS] == n_shards, (mesh.shape, n_shards)
        self.mesh = mesh
        self.dp = int(mesh.shape.get(DP, 1))
        self._replicas = {}

    # ------------------------------------------------------------- build

    def build(self, xb: np.ndarray, train_frac: float = 0.5) -> None:
        """Per-shard k-means + pack on the shard's device (reference
        worker.cpp "train" command: each worker trains its own IVF on its
        shard); ids are global corpus row ids."""
        parts = split_round_robin(np.asarray(xb, np.float32), self.n_shards)
        self.shards = []
        for s, (rows, gids) in enumerate(parts):
            if rows.shape[0] < self.nlist:
                raise ValueError(
                    f"shard holds {rows.shape[0]} rows < nlist="
                    f"{self.nlist}: k-means cannot train {self.nlist} "
                    f"centroids; lower nlist or n_shards")
            idx = IVFFlatIndex(self.d, self.nlist, self.metric,
                               device=self.mesh.devices[0, s],
                               storage=self.storage)
            nt = max(int(rows.shape[0] * train_frac), self.nlist)
            idx.train(rows[:nt])
            # the profile engine's boundary geometry needs the real
            # inter-centroid matrix, also above INTERDIS_EAGER_MAX lists
            idx.ensure_interdis()
            idx.add(rows, ids=gids)
            _ = idx.arrays
            self.shards.append(idx)
        self.mr = None
        self._replicas = {}

    def enable_multirow(self, row_cap: int = 256) -> None:
        """Each shard's multi-row layout, and the one-shot plan every shard
        runs, built from a DOMINATING row profile (the elementwise max of
        the shards' descending rows-per-list), so its per-stage coverage
        guarantee holds on every shard."""
        rc = min([row_cap] + [s.arrays.cap for s in self.shards])
        self._mr_row_cap = rc
        self.mr = [build_multirow(s.arrays, rc) for s in self.shards]
        descs = np.stack([np.sort(m.rows_per_list.cpu().numpy())[::-1]
                          for m in self.mr])
        self._mr_plan = plan_oneshot(np.max(descs, axis=0), self.nlist)
        self._replicas = {}

    # ----------------------------------------------------------- profiles

    def train_profiles(self, xq: np.ndarray, max_topk: int,
                       bs: int = 250) -> None:
        """Each shard trains its own phi->U profile against its own
        partition's ground truth (reference worker.cpp:153-235 +
        dist/gt.cpp per-shard GT)."""
        self.max_topk = max_topk
        traces = []
        for idx in self.shards:
            gt_D, _ = idx.exact_search(xq, max_topk)
            t, _ = train_profile(idx.arrays, xq, gt_D, max_topk,
                                 self.metric, bs=bs)
            traces.append(t)
        max_bins = max(int(t.phi.shape[1]) for t in traces)

        def stack(field, fill):
            out = []
            for t in traces:
                a = getattr(t, field).cpu().numpy()
                out.append(np.pad(a, ((0, 0), (0, max_bins - a.shape[1])),
                                  constant_values=fill))
            return np.stack(out)
        self._set_traces(dict(
            phi=stack("phi", np.inf), u=stack("u", 0.0),
            std=stack("std", 0.0),
            n_bins=np.stack([t.n_bins.cpu().numpy() for t in traces])))

    def _set_traces(self, host: dict | None) -> None:
        """Adopt stacked host profiles and stage shard i's slice on its
        device."""
        self._host_traces = host
        self.traces = None if host is None else [
            traces_from_arrays(host["phi"][i], host["u"][i], host["std"][i],
                               host["n_bins"][i], idx.device)
            for i, idx in enumerate(self.shards)]
        self._replicas = {}

    # -------------------------------------------------------- persistence

    def save(self, dirpath: str) -> None:
        """Per-shard index files + the stacked profiles, in the JAX
        package's layout (meta.json, shard{i}.npz, traces.npz)."""
        os.makedirs(dirpath, exist_ok=True)
        meta = dict(d=self.d, nlist=self.nlist, n_shards=self.n_shards,
                    storage=self.storage,
                    metric=self.metric.value, multipler=self.multipler,
                    std_m=self.std_m,
                    max_topk=getattr(self, "max_topk", None),
                    multirow_row_cap=(int(self._mr_row_cap)
                                      if self.mr is not None else None))
        with open(os.path.join(dirpath, "meta.json"), "w") as f:
            json.dump(meta, f)
        for i, idx in enumerate(self.shards):
            save_index(idx, os.path.join(dirpath, f"shard{i}.npz"))
        if self._host_traces is not None:
            save_trace_set(traces_from_arrays(
                **self._host_traces, device="cpu"),
                os.path.join(dirpath, "traces.npz"))

    @classmethod
    def load(cls, dirpath: str, mesh: Mesh | None = None) -> "ShardedIVF":
        """A directory either package saved, shard i on the mesh's device
        for it."""
        with open(os.path.join(dirpath, "meta.json")) as f:
            meta = json.load(f)
        s = cls(meta["d"], meta["nlist"], meta["n_shards"],
                Metric.parse(meta["metric"]), mesh=mesh,
                storage=meta.get("storage", "f32"))
        s.multipler = meta["multipler"]
        s.std_m = meta["std_m"]
        if meta.get("max_topk"):
            s.max_topk = meta["max_topk"]
        s.shards = [load_index(os.path.join(dirpath, f"shard{i}.npz"),
                               device=s.mesh.devices[0, i])
                    for i in range(meta["n_shards"])]
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
        column; the one-shot plan is rebuilt from the survivors."""
        assert self.n_shards > 1, "cannot drop the last shard"
        assert 0 <= shard_id < self.n_shards
        # build and validate the replacement mesh before mutating state
        if mesh is None:
            mesh = Mesh(np.delete(self.mesh.devices, shard_id, axis=1),
                        self.mesh.axis_names)
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
        q = np.asarray(q, np.float32)
        if q.ndim != 2 or q.shape[1] != self.d:
            raise ValueError(f"queries must be [n, {self.d}], got "
                             f"{q.shape}")
        assert q.shape[0] % self.dp == 0, (
            f"batch {q.shape[0]} must divide the dp axis ({self.dp}); "
            "pad the query window")
        n = q.shape[0] // self.dp
        return q, [slice(g * n, (g + 1) * n) for g in range(self.dp)]

    def search(self, q: np.ndarray, k: int, nprobe: int):
        """Fixed-nprobe sharded search: each shard's padded-list scan (K2),
        then the merge. With a dp axis, each dp group serves its slice of
        the batch."""
        q, groups = self._groups(q)
        vals, ids = [], []
        for g, sl in enumerate(groups):
            per = []
            for s in range(self.n_shards):
                dev = self.mesh.devices[g, s]
                per.append(ivf_search_fixed(
                    self._state(s, dev)[0], torch.as_tensor(q[sl], device=dev),
                    k, nprobe, self.metric))
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
        assert self.traces is not None, "train_profiles first"
        max_topk = max_topk or self.max_topk
        q, groups = self._groups(q)
        acc = np.asarray(require_acc, np.float32)
        vals, ids, n_scanned = [], [], []
        for g, sl in enumerate(groups):
            per, nsc = [], []
            for s in range(self.n_shards):
                dev = self.mesh.devices[g, s]
                arrays, mr, traces = self._state(s, dev)
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
                per.append(out[:2])
                nsc.append(out[3].cpu().numpy())
            v, i = _merge_over_shards(per, max_topk, self.metric)
            vals.append(v.cpu().numpy())
            ids.append(i.cpu().numpy())
            n_scanned.append(np.stack(nsc))
        return (np.concatenate(vals), np.concatenate(ids).astype(np.int64),
                np.concatenate(n_scanned, axis=1))


def _merge_over_shards(per, k: int, metric: Metric):
    """reduce.cpp's per-query merge: each shard's (vals [B, k], ids) on
    the first shard's device, laid out [B, S * k] in shard order, then the
    stable top-k (ties to the lower shard)."""
    dev = per[0][0].device
    return topk_scores(torch.cat([v.to(dev) for v, _ in per], dim=1),
                       torch.cat([i.to(dev) for _, i in per], dim=1),
                       k, metric)
