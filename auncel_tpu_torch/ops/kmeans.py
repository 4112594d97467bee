"""Batched Lloyd's k-means for the IVF coarse quantizer (port of
``auncel_tpu/ops/kmeans.py``): subsample to ``k * max_points_per_centroid``,
k-means++ seeding by Gumbel-max D^2 sampling, ``niter`` rounds of
{assign -> mean update -> empty/starved-cluster split}, ``nredo`` restarts.

Random draws come from an explicit ``torch.Generator`` seeded from
``params.seed``; they differ from ``jax.random``'s, so the same seed gives
other centroids than the JAX package (the subsample, drawn with numpy, is
the same).
"""

from typing import NamedTuple

import numpy as np
import torch

from auncel_tpu_torch.types import Metric
from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.ops.distance import pairwise_l2sqr, sqnorms


class KmeansParams(NamedTuple):
    niter: int = 25
    nredo: int = 1
    max_points_per_centroid: int = 256
    spherical: bool = False
    seed: int = 1234
    verbose: bool = False
    assign_block: int = 65536
    init: str = "kmeans++"               # "kmeans++" | "random"
    balance_iters: int = 6
    starve_frac: float = 0.25


class KmeansResult(NamedTuple):
    centroids: np.ndarray  # [k, d] float32
    error: float           # sum of squared distances to assigned centroid


def _assign(x: torch.Tensor, centroids: torch.Tensor, c_sq: torch.Tensor,
            block: int):
    """[n, d] points -> (assignment [n] int32, sqdist to it [n]); the
    argmin takes the first of equal distances."""
    a, e = [], []
    for i in range(0, x.shape[0], block):
        d = pairwise_l2sqr(x[i:i + block], centroids, y_sqnorms=c_sq)
        dmin, idx = torch.min(d, dim=-1)
        a.append(idx.to(torch.int32))
        e.append(dmin)
    return torch.cat(a), torch.cat(e)


def _update(x: torch.Tensor, assign: torch.Tensor, k: int, spherical: bool,
            starve_threshold: float = 0.0):
    """Mean update + deterministic empty/starved-cluster split: the i-th
    starved cluster takes a +eps copy of the i-th largest cluster's
    centroid and that donor the -eps copy (eps = 1/1024, sign alternating
    by dimension)."""
    d = x.shape[1]
    dev = x.device
    a = assign.long()
    counts = torch.zeros(k, dtype=torch.float32, device=dev).index_add_(
        0, a, torch.ones_like(a, dtype=torch.float32))
    sums = torch.zeros((k, d), dtype=torch.float32, device=dev).index_add_(
        0, a, x)
    centroids = sums / counts.clamp_min(1.0)[:, None]

    eps = 1.0 / 1024.0
    thr = torch.tensor(starve_threshold, dtype=torch.float32, device=dev)
    is_empty = counts <= thr
    donor_order = torch.argsort(-counts, stable=True)
    empty_rank = torch.cumsum(is_empty.int(), 0) - 1
    n_donors = (~is_empty).sum().clamp_min(1)
    donor = donor_order[empty_rank.clamp(0, k - 1) % n_donors]
    sign = torch.where(torch.arange(d, device=dev) % 2 == 0, 1.0, -1.0)[None]
    stolen = centroids[donor] * (1.0 + eps * sign)
    centroids = torch.where(is_empty[:, None], stolen, centroids)
    perturbed_donor = centroids * (1.0 - eps * sign)
    donor_hit = torch.zeros(k, dtype=torch.bool, device=dev)
    donor_hit[donor[is_empty]] = True
    centroids = torch.where(donor_hit[:, None], perturbed_donor, centroids)
    if spherical:
        centroids = centroids / sqnorms(centroids).clamp_min(1e-20).sqrt()[
            :, None]
    return centroids, counts


def _kmeanspp_init(x: torch.Tensor, k: int, gen: torch.Generator):
    """k-means++ seeding: each next centroid drawn with probability
    proportional to its squared distance to the nearest chosen one, as
    argmax(log w + Gumbel noise)."""
    n, d = x.shape
    first = torch.randint(0, n, (1,), generator=gen, device=x.device)
    cents = torch.zeros((k, d), dtype=x.dtype, device=x.device)
    cents[0] = x.index_select(0, first)[0]
    x_sq = sqnorms(x)
    dmin = torch.full((n,), float("inf"), device=x.device)
    for i in range(1, k):
        c = cents[i - 1]
        dist = x_sq + torch.sum(c * c) - 2.0 * (x @ c)
        dmin = torch.minimum(dmin, dist.clamp_min(0.0))
        u = torch.rand((n,), generator=gen, device=x.device)
        gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
        idx = torch.argmax(torch.log(dmin.clamp_min(1e-30)) + gumbel)
        cents[i] = x.index_select(0, idx.view(1))[0]  # no host sync
    return cents


def kmeans(x, k: int, params: KmeansParams = KmeansParams(),
           metric: Metric = Metric.L2, device="cuda") -> KmeansResult:
    """Train k centroids on x [n, d] (numpy in / numpy out) on ``device``."""
    dev = resolve(device)
    x = np.asarray(x, np.float32)
    n, d = x.shape
    rng = np.random.RandomState(params.seed)
    spherical = params.spherical or metric is Metric.IP

    max_n = k * params.max_points_per_centroid
    if n > max_n:
        x = x[rng.permutation(n)[:max_n]]
        n = max_n

    block = min(params.assign_block, n)
    n_fit = (n // block) * block
    if n_fit == 0:
        block, n_fit = n, n
    xd_full = torch.as_tensor(x, device=dev)
    xd = xd_full[:n_fit]

    best: KmeansResult | None = None
    for redo in range(params.nredo):
        if params.init == "kmeans++":
            gen = torch.Generator(device=dev)
            gen.manual_seed(params.seed + 7919 * redo)
            centroids = _kmeanspp_init(xd_full, k, gen)
        else:
            centroids = torch.as_tensor(x[rng.permutation(n)[:k]],
                                        device=dev)
        if spherical:
            centroids = centroids / sqnorms(centroids).clamp_min(
                1e-20).sqrt()[:, None]
        err_dev = None
        for it in range(params.niter):
            assign, dists = _assign(xd, centroids, sqnorms(centroids), block)
            err_dev = dists.sum()
            # balance in late-but-not-last rounds so every moved centroid
            # is still Lloyd-refined afterwards
            balancing = (params.niter - 1 - params.balance_iters <= it
                         < params.niter - 1)
            thr = (params.starve_frac * n_fit / k) if balancing else 0.0
            centroids, _ = _update(xd, assign, k, spherical, thr)
            if params.verbose:
                print(f"  kmeans redo {redo} iter {it}: "
                      f"err={float(err_dev):.4g}")
        err = float(err_dev) if err_dev is not None else np.inf
        if best is None or err < best.error:
            best = KmeansResult(centroids.cpu().numpy(), err)
    assert best is not None
    return best
