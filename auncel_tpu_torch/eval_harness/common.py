"""Shared evaluation-harness plumbing (port of
``auncel_tpu/eval_harness/common.py``; reference
``eval/bound.cpp:137-295``): the dataset registry with file paths, the
index build with its trained-quantizer cache, the ground truth, and the
worst-case bound checker.

The registry, the synthetic parameters and every cache file name are the
JAX package's, so either package reads the caches the other wrote:
the corpus cache ``$BENCH_CACHE/evalds_<name><tag>.npz`` and the ground
truth cache ``$BENCH_CACHE/gt_<name><tag>_<storage>.npz`` (corpora of at
least ``BIG_CORPUS_ROWS`` rows; ``BENCH_CACHE`` defaults to
``.bench_cache``), and the trained quantizer
``trained_index/<name><tag>_IVF<nlist>,<Flat|SQ8|...>_trained.npz`` in the
``index/io.py`` format.
"""

import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from auncel_tpu_torch.data import (
    fvecs_read, ivecs_read, make_clustered_dataset)
from auncel_tpu_torch.index.io import load_index, save_index
from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.types import Metric

DATA_ROOT = os.environ.get("AUNCEL_DATA_ROOT", "/workspace/data")

# corpora of at least this many rows cache their generated vectors and
# exact ground truth on disk (both cost minutes per process at 10M)
BIG_CORPUS_ROWS = 5_000_000

# name -> (base fvecs, query fvecs, gt ivecs, gt-distance fvecs, metric),
# the reference's table (eval/bound.cpp:160-210)
FILE_DATASETS = {
    "sift1M": ("sift1M/sift_base.fvecs", "sift1M/sift_query.fvecs",
               "sift1M/sift_groundtruth.ivecs",
               "sift1M/sift_gtd.fvecs", Metric.L2),
    "sift10M": ("sift10M/sift10M.fvecs", "sift10M/query.fvecs",
                "sift10M/idx.ivecs", "sift10M/dis.fvecs", Metric.L2),
    "deep10M": ("deep10M/deep10M.fvecs", "deep10M/query.fvecs",
                "deep10M/idx.ivecs", "deep10M/dis.fvecs", Metric.L2),
    "gist": ("gist/gist_base.fvecs", "gist/gist_query.fvecs",
             "gist/gist_groundtruth.ivecs", "gist/gist_gtd.fvecs",
             Metric.L2),
    "text": ("text10M/text10M.fvecs", "text10M/query.fvecs",
             "text10M/idx.ivecs", "text10M/dis.fvecs", Metric.IP),
}

SYNTH_SIZES = {"synth1M": 1_000_000, "synth100K": 100_000,
               "synth10K": 10_000,
               # the DEEP10M-like proxy: 10M x 96, perturbed-corpus queries
               "synthDeep10M": 10_000_000,
               # near-uniform 10M x 96 (39k overlapping clusters): the
               # regime the dense crossover exists for
               "synthDeep10Mw": 10_000_000}
SYNTH_D = {"synthDeep10M": 96,          # per-dataset dim (else 128)
           "synthDeep10Mw": 96}
# per-dataset generation parameters; the "ver" tag is part of every cache
# name, so a changed parameterization never reuses a stale cache
SYNTH_PARAMS = {
    "synthDeep10M": dict(query_mode="perturb", cluster_std=0.13,
                         pert_easy=0.4, pert_hard=1.2, n_clusters=8192),
    "synthDeep10Mw": dict(query_mode="perturb", cluster_std=0.22,
                          n_clusters=39062),
}
SYNTH_VER = {"synthDeep10M": "p2", "synthDeep10Mw": "p1"}
# "hard" variants: a quarter of the queries drift far toward or past
# Voronoi boundaries, a heavy difficulty tail that a worst-case-tuned
# global nprobe pays on every query
SYNTH_HARD = {"synthHard100K": 100_000, "synthHard1M": 1_000_000}


@dataclass
class EvalData:
    name: str
    xb: np.ndarray
    xq: np.ndarray
    gt_I: np.ndarray | None
    gt_D: np.ndarray | None
    metric: Metric
    # tells apart corpora that share a registry name (another seed or
    # parameterization) in the cache names
    cache_tag: str = ""


def elapsed():
    return time.time()


def sync(device) -> None:
    """Wait for the card's queued work (a no-op on the CPU), so that a
    timer reads what the device did."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cache_dir() -> str:
    cdir = os.environ.get("BENCH_CACHE", ".bench_cache")
    os.makedirs(cdir, exist_ok=True)
    return cdir


def load_dataset(name: str, nq: int = 10000, max_topk: int = 100,
                 seed: int = 42) -> EvalData:
    if name in FILE_DATASETS:
        base, query, gti, gtd, metric = FILE_DATASETS[name]
        base = os.path.join(DATA_ROOT, base)
        if not os.path.exists(base):
            raise FileNotFoundError(
                f"{base} missing; set AUNCEL_DATA_ROOT or use a synth* "
                f"dataset")
        xb = fvecs_read(base)
        xq = fvecs_read(os.path.join(DATA_ROOT, query))
        gt_I = gt_D = None
        gtd_path = os.path.join(DATA_ROOT, gtd)
        gti_path = os.path.join(DATA_ROOT, gti)
        if os.path.exists(gti_path):
            gt_I = ivecs_read(gti_path).astype(np.int64)
        if os.path.exists(gtd_path):
            gt_D = fvecs_read(gtd_path)
        if metric is Metric.IP:
            # normalising changes the inner products, so file GT no longer
            # describes the searched data: ensure_gt recomputes it
            xb = xb / np.linalg.norm(xb, axis=1, keepdims=True)
            xq = xq / np.linalg.norm(xq, axis=1, keepdims=True)
            gt_I = gt_D = None
        return EvalData(name, xb, xq, gt_I, gt_D, metric)
    if name in SYNTH_SIZES or name in SYNTH_HARD:
        hard = name in SYNTH_HARD
        nb = (SYNTH_HARD if hard else SYNTH_SIZES)[name]
        metric = Metric.L2
        kw = dict(hard_frac=0.25, pert_easy=0.3, pert_hard=2.5) if hard \
            else {}
        kw.update(SYNTH_PARAMS.get(name, {}))
        n_clusters = kw.pop("n_clusters", max(nb // 256, 64))
        tag = "" if seed == 42 else f"_s{seed}"
        if name in SYNTH_VER:
            tag += f"_{SYNTH_VER[name]}"
        # one file per (name, tag): the generator draws xb before xq, so
        # xb does not depend on nq, and the queries are stored as a
        # superset (shuffled at generation) and sliced
        cache = None
        if nb >= BIG_CORPUS_ROWS:
            cache = os.path.join(_cache_dir(), f"evalds_{name}{tag}.npz")
            if os.path.exists(cache):
                with np.load(cache) as z:
                    if z["xq"].shape[0] >= nq:
                        return EvalData(name, z["xb"], z["xq"][:nq], None,
                                        None, metric, cache_tag=tag)
        nq_gen = max(nq, 10_000) if cache is not None else nq
        ds = make_clustered_dataset(nb=nb, nq=nq_gen,
                                    d=SYNTH_D.get(name, 128),
                                    n_clusters=n_clusters,
                                    seed=seed, metric=metric, **kw)
        if cache is not None:
            np.savez(cache, xb=ds.xb, xq=ds.xq)
        return EvalData(name, ds.xb, ds.xq[:nq], None, None, metric,
                        cache_tag=tag)
    raise KeyError(f"unknown dataset {name!r} "
                   f"(file: {sorted(FILE_DATASETS)}, "
                   f"synthetic: {sorted(SYNTH_SIZES) + sorted(SYNTH_HARD)})")


def build_or_load_index(data: EvalData, nlist: int = 1024,
                        cache_dir: str = "trained_index",
                        storage: str = "f32",
                        device="cuda") -> IVFFlatIndex:
    """IVF<nlist>,<storage> on ``device``, its trained coarse quantizer
    cached in ``cache_dir`` (eval/bound.cpp:265-268). k-means does not
    depend on the storage, so a cached Flat quantizer serves every
    codec."""
    os.makedirs(cache_dir, exist_ok=True)
    stag = "Flat" if storage == "f32" else storage.upper()
    cache = os.path.join(
        cache_dir,
        f"{data.name}{data.cache_tag}_IVF{nlist},{stag}_trained.npz")
    flat_cache = os.path.join(
        cache_dir,
        f"{data.name}{data.cache_tag}_IVF{nlist},Flat_trained.npz")
    if os.path.exists(cache):
        idx = load_index(cache, device=device)
        if idx.storage != storage:
            # a file whose header names another codec: keep its centroids
            donor = idx
            idx = IVFFlatIndex(data.xb.shape[1], nlist, data.metric,
                               device=device, storage=storage)
            idx.set_centroids(donor.centroids)
    else:
        idx = IVFFlatIndex(data.xb.shape[1], nlist, data.metric,
                           device=device, storage=storage)
        if storage != "f32" and os.path.exists(flat_cache):
            idx.set_centroids(load_index(flat_cache, device=device)
                              .centroids)
        else:
            nt = min(data.xb.shape[0], 400_000)
            idx.train(data.xb[:nt])
        save_index(idx, cache)
    idx.add(data.xb)
    return idx


def ensure_gt(data: EvalData, idx: IVFFlatIndex, max_topk: int = 100):
    """Ground truth from the index's own full scan, so that its distance
    values match the search paths' within the 1e-5 tolerance the profile
    trainer and the bound checker compare at; file distances are kept only
    as an id-overlap check. Corpora of at least BIG_CORPUS_ROWS rows cache
    it on disk, by storage (the scan reads the decoded vectors)."""
    file_I = data.gt_I
    if (data.gt_D is None or data.gt_D.shape[1] < max_topk
            or data.gt_I is None or not getattr(data, "_gt_exact", False)):
        gt_cache = None
        nq = data.xq.shape[0]
        if data.xb.shape[0] >= BIG_CORPUS_ROWS:
            gt_cache = os.path.join(
                _cache_dir(),
                f"gt_{data.name}{data.cache_tag}_{idx.storage}.npz")
            if os.path.exists(gt_cache):
                with np.load(gt_cache) as z:
                    if (z["D"].shape[0] >= nq
                            and z["D"].shape[1] >= max_topk):
                        data.gt_D = z["D"][:nq, :max_topk]
                        data.gt_I = z["I"][:nq, :max_topk]
                        data._gt_exact = True
                        return data.gt_D, data.gt_I
        data.gt_D, data.gt_I = idx.exact_search(data.xq, max_topk,
                                                batch=1000)
        data._gt_exact = True
        if gt_cache is not None:
            np.savez(gt_cache, D=data.gt_D, I=data.gt_I)
        if file_I is not None:
            k = min(10, file_I.shape[1])
            overlap = np.mean([len(set(a[:k].tolist())
                                   & set(b[:k].tolist())) / k
                               for a, b in zip(file_I, data.gt_I)])
            if overlap < 0.99:
                print(f"WARNING: file GT disagrees with exact scan "
                      f"(overlap@{k} = {overlap:.3f})")
    return data.gt_D, data.gt_I


def check_bound(D: np.ndarray, gt_D: np.ndarray, k: int, eps: float,
                metric: Metric) -> tuple[bool, float]:
    """Worst-case bound verification (eval/bound.cpp:400-414)."""
    from auncel_tpu_torch.autotune import worst_case_recall
    minf = worst_case_recall(D, gt_D, k, metric)
    return minf >= 1.0 - eps, minf


def write_log(path: str, rows) -> None:
    with open(path, "w") as f:
        for r in rows:
            if isinstance(r, (tuple, list, np.ndarray)):
                f.write(" ".join(str(x) for x in r) + "\n")
            else:
                f.write(f"{r}\n")


def stderr_log():
    """A logger that prefixes each message with the seconds since its
    creation, on stderr."""
    t0 = time.time()

    def log(m):
        print(f"[{time.time() - t0:8.3f} s] {m}", file=sys.stderr,
              flush=True)
    return log
