"""Learned adaptive early termination, baseline 2 (port of
``auncel_tpu/baselines/laet.py``; reference LAET, SIGMOD'20,
``LAET/IndexIVF.cpp:232-263,567-695``).

A per-query regressor predicts how many probes the query needs to capture
its true top-k, from features available after a cheap fixed prefix of the
search; online, each query runs a fixed-nprobe search at ``prediction *
multiplier``. The regressor is a small MLP (two hidden ReLU layers of 64,
He-scaled normal init from a ``torch.Generator`` seeded by ``seed``),
trained full batch with ``torch.optim.Adam`` on the MSE of log-labels.

  features: the query, its top coarse distances (ratios), and the
            intermediate top-1/mid/k distances after scanning PRED_PREFIX
            probes of the padded lists (K2 on the card);
  label:    log of the smallest nprobe whose probed lists hold the whole
            true top-k;
  online:   nprobe_q = clip(round(exp(pred) * multiplier), 1, nlist), then
            one exact per-query probe-count scan (``nprobe_search_mr`` on
            the multi-row layout, K1; else ``nprobe_search``, K2);
  tuning:   ``tune_multiplier`` binary-searches the multiplier for a recall
            target, by the mean (LAET's own criterion) or the worst query.
"""

import numpy as np
import torch
from torch import nn

from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.index.scan import coarse_rank, scan_probe_range
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.topk import init_topk
from auncel_tpu_torch.profile.bounded import nprobe_search
from auncel_tpu_torch.profile.bounded_mr import nprobe_search_mr, plan_oneshot

N_COARSE_FEAT = 10
PRED_PREFIX = 1  # probes scanned before predicting (LAET pred_thresh=1)


class MLP(nn.Module):
    """x -> relu(x W1 + b1) -> relu(. W2 + b2) -> (. W3 + b3)[:, 0]; the
    weights are [in, out], as the JAX package's ``_MLP`` holds them."""

    def __init__(self, d_in: int, hidden: int = 64):
        super().__init__()
        self.w1 = nn.Parameter(torch.zeros(d_in, hidden))
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.w2 = nn.Parameter(torch.zeros(hidden, hidden))
        self.b2 = nn.Parameter(torch.zeros(hidden))
        self.w3 = nn.Parameter(torch.zeros(hidden, 1))
        self.b3 = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ self.w1 + self.b1)
        h = torch.relu(h @ self.w2 + self.b2)
        return (h @ self.w3 + self.b3)[:, 0]


def mlp_init(d_in: int, hidden: int, seed: int, device) -> MLP:
    """He-scaled normal weights and zero biases, drawn on the host from a
    generator seeded by ``seed``."""
    g = torch.Generator().manual_seed(seed)
    s1 = (2.0 / d_in) ** 0.5
    s2 = (2.0 / hidden) ** 0.5
    mlp = MLP(d_in, hidden)
    with torch.no_grad():
        mlp.w1.copy_(torch.randn(d_in, hidden, generator=g) * s1)
        mlp.w2.copy_(torch.randn(hidden, hidden, generator=g) * s2)
        mlp.w3.copy_(torch.randn(hidden, 1, generator=g) * s2)
    return mlp.to(device)


def train_mlp(mlp: MLP, x: torch.Tensor, y: torch.Tensor, epochs: int,
              lr: float) -> float:
    """``epochs`` full-batch Adam steps on the mean squared error, from the
    module's current parameters; returns the loss of the last step (before
    its update, as the JAX package reports it)."""
    opt = torch.optim.Adam(mlp.parameters(), lr=lr)
    loss = torch.zeros(())
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((mlp(x) - y) ** 2)
        loss.backward()
        opt.step()
    return float(loss.detach())


class LearnedTermination:
    def __init__(self, index: IVFFlatIndex, query_k: int,
                 max_topk: int = 100, hidden: int = 64, seed: int = 0,
                 device="cuda"):
        self.device = resolve(device)
        if self.device.type != index.device.type:
            raise ValueError(f"the model's device {self.device} is not the "
                             f"index's ({index.device})")
        self.index = index
        self.query_k = query_k
        self.max_topk = max_topk
        self.hidden = hidden
        self.seed = seed
        self.multiplier = 1.0
        self._mr_plan = None
        self.params: MLP | None = None
        self._feat_mean = None
        self._feat_std = None

    def _q(self, q: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(q, np.float32),
                               device=self.index.device)

    # ---------------------------------------------------------- features

    def _features_dev(self, q: torch.Tensor) -> torch.Tensor:
        """[B, d + N_COARSE_FEAT + 3]: the query, its top coarse distance
        ratios, and the top-1/mid/k distance ratios after scanning
        PRED_PREFIX probes (LAET/IndexIVF.cpp:567-695 features)."""
        arrays, metric = self.index.arrays, self.index.metric
        B = q.shape[0]
        q_sq = sqnorms(q)
        cdis, cids = coarse_rank(arrays, q, metric, q_sq=q_sq)
        vals, ids = init_topk((B,), self.max_topk, metric, q.device)
        limit = torch.full((B,), arrays.nlist, dtype=torch.int32,
                           device=q.device)
        vals, _ = scan_probe_range(arrays, q, q_sq, cids, vals, ids, limit,
                                   0, PRED_PREFIX, metric)
        cd = cdis[:, :N_COARSE_FEAT]
        k = self.query_k
        inter = torch.stack([vals[:, 0], vals[:, max(k // 2 - 1, 0)],
                             vals[:, k - 1]], dim=1)
        inter = torch.nan_to_num(inter, posinf=0.0, neginf=0.0)
        # scale-free ratios stabilise training across datasets
        denom = cd[:, :1].abs().clamp_min(1e-6)
        return torch.cat([q, cd / denom, inter / denom], dim=1)

    def _features(self, q: np.ndarray) -> np.ndarray:
        return self._features_dev(self._q(q)).cpu().numpy()

    def _labels(self, xq: np.ndarray, gt_I: np.ndarray) -> np.ndarray:
        """The smallest nprobe whose probed lists hold the true top-k: the
        coarse rank of the farthest true neighbour's list, plus 1."""
        idx = self.index
        ids_np = idx.arrays.vec_ids.cpu().numpy()
        vec2list = np.zeros(int(ids_np.max()) + 1, np.int32)
        for l in range(ids_np.shape[0]):
            m = ids_np[l][ids_np[l] >= 0]
            vec2list[m] = l
        _, cids = idx.coarse_rank_np(xq)
        rank_of = np.argsort(cids, 1)
        labels = np.empty(xq.shape[0], np.float32)
        for i in range(xq.shape[0]):
            lists = vec2list[gt_I[i, : self.query_k]]
            labels[i] = rank_of[i][lists].max() + 1
        return labels

    # ------------------------------------------------------------- train

    def train(self, xq: np.ndarray, gt_I: np.ndarray, epochs: int = 300,
              lr: float = 1e-3, init: MLP | None = None) -> float:
        """Fit the MLP from ``init`` (by default drawn from ``seed``) and
        return the final loss."""
        feats = self._features(xq)
        labels = np.log(self._labels(xq, gt_I))
        self._feat_mean = feats.mean(0)
        self._feat_std = feats.std(0) + 1e-6
        x = torch.as_tensor((feats - self._feat_mean) / self._feat_std,
                            device=self.device)
        y = torch.as_tensor(labels, device=self.device)
        mlp = (mlp_init(x.shape[1], self.hidden, self.seed, self.device)
               if init is None else init.to(self.device))
        loss = train_mlp(mlp, x, y, epochs, lr)
        self.params = mlp
        return loss

    # ------------------------------------------------------------ online

    @torch.no_grad()
    def _predict_dev(self, q: torch.Tensor) -> torch.Tensor:
        """Per-query nprobe predictions [B] int32, on the device."""
        assert self.params is not None, "train first"
        dev = q.device
        feats = self._features_dev(q)
        x = ((feats - torch.as_tensor(self._feat_mean, device=dev))
             / torch.as_tensor(self._feat_std, device=dev))
        n = torch.exp(self.params(x)) * torch.tensor(
            self.multiplier, dtype=torch.float32, device=dev)
        return torch.round(n).clamp(1, self.index.nlist).to(torch.int32)

    def predict_nprobe(self, q: np.ndarray) -> np.ndarray:
        return self._predict_dev(self._q(q)).cpu().numpy().astype(np.int64)

    def search(self, q: np.ndarray, k: int):
        """Per-query predicted-nprobe search (LAET search_mode=2): the
        exact predicted probe count of each query. Returns numpy (D, I,
        nprobe)."""
        qt = self._q(q)
        nprobe_d = self._predict_dev(qt)
        arrays, metric = self.index.arrays, self.index.metric
        mr = getattr(self.index, "multirow", None)
        if mr is not None:
            if self._mr_plan is None:
                self._mr_plan = plan_oneshot(mr.rows_per_list.cpu().numpy(),
                                             self.index.nlist)
            vals, ids, nb = nprobe_search_mr(arrays, mr, qt, nprobe_d,
                                             self.max_topk, metric,
                                             self._mr_plan)
        else:
            vals, ids, nb = nprobe_search(arrays, qt, nprobe_d,
                                          self.max_topk, metric)
        return (vals[:, :k].cpu().numpy(),
                ids[:, :k].cpu().numpy().astype(np.int64),
                nb.cpu().numpy().astype(np.int64))

    def tune_multiplier(self, xq: np.ndarray, gt_D: np.ndarray,
                        target_recall: float, lo: float = 0.25,
                        hi: float = 64.0, iters: int = 8,
                        criterion: str = "mean") -> float:
        """Binary-search the multiplier for a recall target. ``criterion``
        "mean" is LAET's own average-recall objective; "worst" tunes the
        per-query minimum, the one to use against systems that pay for a
        worst-case bound."""
        from auncel_tpu_torch.autotune import recall_counts
        assert criterion in ("mean", "worst"), criterion
        k = self.query_k
        best = hi
        for _ in range(iters):
            mid = (lo * hi) ** 0.5
            self.multiplier = mid
            D, I, _ = self.search(xq, k)
            counts = recall_counts(D, gt_D, k, self.index.metric)
            rec = (counts.min() if criterion == "worst"
                   else counts.mean()) / k
            if rec >= target_recall:
                best = mid
                hi = mid
            else:
                lo = mid
        self.multiplier = best
        return best
