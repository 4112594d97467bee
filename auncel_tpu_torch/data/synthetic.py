"""Synthetic datasets for tests and self-contained benchmarks (a copy of
``auncel_tpu/data/synthetic.py``: the same seed gives the same arrays).

The reference validates on SIFT/DEEP/TEXT/GIST files the user must download;
its unit tests use synthetic Gaussians (``tests/common.py get_dataset_2``).
We provide a clustered Gaussian-mixture generator: cluster structure makes
IVF pruning meaningful (uniform data would make every list equidistant and
the error profile degenerate), which is what the bound experiments need.
"""

from typing import NamedTuple

import numpy as np

from auncel_tpu_torch.types import Metric


class Dataset(NamedTuple):
    xb: np.ndarray        # corpus [nb, d]
    xq: np.ndarray        # queries [nq, d]
    xt: np.ndarray        # train vectors for index construction [nt, d]
    metric: Metric

    @property
    def d(self) -> int:
        return self.xb.shape[1]


def make_clustered_dataset(
    nb: int,
    nq: int,
    d: int,
    n_clusters: int = 512,
    nt: int | None = None,
    seed: int = 0,
    metric: Metric = Metric.L2,
    cluster_std: float = 0.25,
    hard_frac: float = 0.5,
    query_mode: str = "mixture",
    pert_easy: float = 0.4,
    pert_hard: float = 1.0,
) -> Dataset:
    """Gaussian mixture in [0,1]^d, SIFT-like scale (x512).

    ``cluster_std=0.25`` is tuned (at d=128, nlist=nb/400) so the index
    behaves like real SIFT/DEEP: easy queries resolve in their home cell
    (recall@nprobe=1 ~ 0.9) while the hardest queries' true top-10 spread
    over up to ~20% of nlist coarse ranks — a real difficulty gradient with
    a bounded worst case. ``hard_frac`` of the queries are drawn wider
    (farther from cluster cores, nearer Voronoi boundaries); their variance
    is what Auncel's per-query bounded termination exploits.
    """
    rng = np.random.RandomState(seed)
    centers = rng.rand(n_clusters, d).astype(np.float32)
    scale = 512.0

    def draw(n, widen=1.0):
        which = rng.randint(0, n_clusters, size=n)
        pts = centers[which] + rng.randn(n, d).astype(np.float32) * (
            cluster_std * widen)
        return (pts * scale).astype(np.float32)

    xb = draw(nb)
    n_hard = int(nq * hard_frac)
    if query_mode == "perturb":
        # SIFT-like query model: queries are perturbed corpus points, so
        # every query provably has neighbors at data-typical distances.
        # Difficulty is graded by perturbation radius (hard queries drift
        # toward Voronoi boundaries).
        def pert(n, scale):
            seeds = xb[rng.randint(0, nb, n)]
            return seeds + rng.randn(n, d).astype(np.float32) * (
                cluster_std * scale * 512.0)
        xq = np.concatenate([pert(nq - n_hard, pert_easy),
                             pert(n_hard, pert_hard)])
    else:
        # Queries follow the corpus distribution (held-out mixture
        # samples): "hard" queries are drawn wider — farther from their
        # cluster core, hence nearer Voronoi boundaries. Note the Gaussian
        # tail occasionally produces queries whose true neighbors are
        # accidental tail points of far clusters (unbounded cell spread) —
        # real embedding datasets do not look like that, which is why the
        # benchmark uses query_mode="perturb".
        xq = np.concatenate([draw(nq - n_hard, widen=1.0),
                             draw(n_hard, widen=1.5)])
    rng.shuffle(xq)
    xt = draw(nt) if nt is not None else xb
    if metric is Metric.IP:
        # Reference TEXT10M is L2-normalized for IP search (bound.cpp:243-248).
        xb = xb / np.linalg.norm(xb, axis=1, keepdims=True)
        xq = xq / np.linalg.norm(xq, axis=1, keepdims=True)
        xt = xt / np.linalg.norm(xt, axis=1, keepdims=True)
    return Dataset(xb, xq, xt, metric)
