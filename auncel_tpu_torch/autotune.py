"""Worst-case auto-tuning baseline ("ELP") and recall criteria (port of
``auncel_tpu/autotune.py`` for the index the port serves).

A global parameter sweep that scores each operating point by the minimum
recall over queries (worst case, not mean; reference
``faiss/AutoTune.cpp:93-101``) and always includes the ``nprobe = nlist``
full-scan point (``:630-634``). The evaluation picks the cheapest point
whose worst-case recall meets ``1 - eps`` and runs every query at that
fixed nprobe: the "one global knob" that Auncel's per-query bounds beat.
``OperatingPoints`` keeps the Pareto frontier over (perf, cost);
``ParameterSpace.explore`` sweeps nprobe on the index's own device.
``MatrixStats`` reports dataset diagnostics.

The knobs: ``nprobe`` and ``max_codes`` of an ``IVFFlatIndex`` (swept over
2^8 ... 2^19 and unlimited on IMI cells), the polysemous ``ht`` of an
``IVFFlatIndex`` or ``IndexPQ``, and ``k_factor`` of an
``IndexRefineFlat`` (whose other knobs reach its base) or an
``IndexIVFPQR`` (swept over 1 ... 64), and ``efSearch`` of an HNSW graph
(swept over 16 ... 512); a knob the index does not have raises
``ValueError``.
"""

import time
from dataclasses import dataclass, field

import numpy as np

from auncel_tpu_torch.index.flat import IndexRefineFlat
from auncel_tpu_torch.index.hnsw import HNSWIndex
from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.index.ivfpqr import IndexIVFPQR
from auncel_tpu_torch.index.pq_index import IndexPQ
from auncel_tpu_torch.types import Metric


@dataclass
class OperatingPoint:
    key: str          # e.g. "nprobe=16"
    perf: float       # worst-case recall in [0, 1]
    cost: float       # mean seconds a query


@dataclass
class OperatingPoints:
    """Pareto frontier: the points not dominated in (perf up, cost down)
    (reference OperatingPoints, AutoTune.cpp:121-...)."""
    all_pts: list = field(default_factory=list)

    def add(self, pt: OperatingPoint):
        self.all_pts.append(pt)

    def optimal(self) -> list[OperatingPoint]:
        pts = sorted(self.all_pts, key=lambda p: (p.cost, -p.perf))
        frontier = []
        best = -1.0
        for p in pts:
            if p.perf > best:
                frontier.append(p)
                best = p.perf
        return frontier

    def cheapest_meeting(self, target_perf: float) -> OperatingPoint | None:
        for p in self.optimal():
            if p.perf >= target_perf:
                return p
        return None


def recall_counts(D: np.ndarray, gt_D: np.ndarray, k: int,
                  metric: Metric) -> np.ndarray:
    """Distance-threshold intersection count per query (reference
    ``inter_sec``, eval/bound.cpp:117-128). The slack is RELATIVE: an
    absolute 1e-6 fails at large distance scales when the k-th GT distance
    is hit by a vector whose distance a differently-shaped (equally exact)
    kernel computed."""
    thresh = gt_D[:, k - 1]
    slack = np.maximum(1e-6, 1e-5 * np.abs(thresh))
    if metric is Metric.L2:
        cnt = (D[:, :k] <= (thresh + slack)[:, None]).sum(1)
    else:
        cnt = (D[:, :k] >= (thresh - slack)[:, None]).sum(1)
    return np.minimum(cnt, k)


def worst_case_recall(D: np.ndarray, gt_D: np.ndarray, k: int,
                      metric: Metric) -> float:
    """min over queries of the distance-threshold intersection."""
    return float(recall_counts(D, gt_D, k, metric).min() / k)


def one_recall_at_r(I: np.ndarray, gt_I: np.ndarray, R: int) -> float:
    """Fraction of queries whose true nearest neighbour is among the first
    R results (reference OneRecallAtRCriterion, AutoTune.cpp:75-91)."""
    nn = gt_I[:, 0][:, None]
    return float(np.mean((I[:, :R] == nn).any(1)))


def intersection_at_r(I: np.ndarray, gt_I: np.ndarray, R: int) -> float:
    """Mean |top-R results ∩ top-R GT| / R by ids (reference
    IntersectionCriterion, AutoTune.cpp:93-113, the mean criterion)."""
    hits = 0
    for r, g in zip(I[:, :R], gt_I[:, :R]):
        hits += len(set(r.tolist()) & set(g.tolist()))
    return hits / (len(I) * R)


def set_index_parameter(index, name: str, value) -> None:
    """One knob (reference ParameterSpace::set_index_parameter,
    AutoTune.cpp:455-520): ``k_factor`` of an ``IndexRefineFlat`` (any
    other knob goes to its base) or an ``IndexIVFPQR``
    (AutoTune.cpp:534-538), ``nprobe`` and ``max_codes`` (infinity means
    unlimited, 0) of an ``IVFFlatIndex``, ``efSearch`` of an HNSW graph,
    and ``ht`` (or ``polysemous_ht``) of an ``IVFFlatIndex`` or
    ``IndexPQ``."""
    if isinstance(index, IndexRefineFlat):
        if name == "k_factor":
            index.k_factor = float(value)
            return
        return set_index_parameter(index.base, name, value)
    if name == "k_factor" and isinstance(index, IndexIVFPQR):
        index.k_factor = float(value)
    elif name == "nprobe" and isinstance(index, IVFFlatIndex):
        index.nprobe = int(value)
    elif name == "efSearch" and isinstance(index, HNSWIndex):
        index.ef_search = int(value)
    elif (name in ("ht", "polysemous_ht")
          and isinstance(index, (IndexPQ, IVFFlatIndex))):
        index.polysemous_ht = int(value)
    elif name == "max_codes" and isinstance(index, IVFFlatIndex):
        index.max_codes = 0 if not np.isfinite(value) else int(value)
    else:
        raise ValueError(
            f"parameter {name!r} not applicable to {type(index).__name__}")


def set_index_parameters(index, description: str) -> None:
    """Comma-separated "name=value" string (reference
    ParameterSpace::set_index_parameters, AutoTune.cpp:429-460)."""
    for part in description.split(","):
        if not part.strip():
            continue
        name, value = part.split("=")
        set_index_parameter(index, name.strip(), float(value))


def _ht_range(nbits: int) -> list[int]:
    """The polysemous thresholds swept over codes of ``nbits`` bits."""
    return sorted({nbits // 8, nbits // 4, nbits // 2, 3 * nbits // 4,
                   nbits})


class ParameterSpace:
    """Parameter sweep with the worst-case criterion over the knobs the
    index exposes (reference ParameterSpace::initialize,
    AutoTune.cpp:353-408): nprobe for IVF (with k_factor for IVFPQR and
    max_codes on IMI cells), efSearch for HNSW, ht for polysemous PQ (IVF
    or flat), k_factor for the refine wrapper, cartesian over the
    wrapper's knob and its base's."""

    def __init__(self, index):
        self.index = index
        self.ops = OperatingPoints()

    def candidate_nprobes(self) -> list[int]:
        nlist = self.index.nlist
        cands = []
        np_ = 1
        while np_ < nlist:
            cands.append(np_)
            np_ <<= 1
        cands.append(nlist)  # the forced full-scan point
        return cands

    def parameter_ranges(self, index=None) -> list[tuple[str, list]]:
        index = index if index is not None else self.index
        if isinstance(index, IndexRefineFlat):
            return ([("k_factor", [1, 2, 4, 8])]
                    + self.parameter_ranges(index.base))
        if isinstance(index, IVFFlatIndex):
            dims = [("nprobe", self.candidate_nprobes())]
            if isinstance(index, IndexIVFPQR):
                # AutoTune.cpp:401-406: powers of two up to 64
                dims.append(("k_factor", [1 << i for i in range(7)]))
            if index.coarse == "imi":
                # the reference ranges max_codes only over a
                # MultiIndexQuantizer (AutoTune.cpp:388-399)
                dims.append(("max_codes",
                             [1 << i for i in range(8, 20)] + [np.inf]))
            if index.polysemous:
                # the reference sweeps ht on IVFPQ too
                dims.append(("ht", _ht_range(8 * int(index.storage[2:]))))
            return dims
        if isinstance(index, HNSWIndex):
            return [("efSearch", [16, 32, 64, 128, 256, 512])]
        if isinstance(index, IndexPQ) and index.polysemous:
            return [("ht", _ht_range(8 * index.M))]
        return []

    def explore(self, xq: np.ndarray, gt_D: np.ndarray, k: int,
                reps: int = 2) -> OperatingPoints:
        """Time every combination on ``xq``: a warm call first (the dense
        and gather routes allocate differently), then timed calls until
        the mean's standard error is within 10 % (at least ``reps``, at
        most 8; ``search`` returns host arrays, so each timed call has
        waited for the device)."""
        dims = self.parameter_ranges()
        if not dims:
            return self.ops
        combos = [[]]
        for name, values in dims:
            combos = [c + [(name, v)] for c in combos for v in values]
        for combo in combos:
            for name, v in combo:
                set_index_parameter(self.index, name, v)
            key = ",".join(f"{n}={v}" for n, v in combo)
            D, _ = self.index.search(xq, k)  # warm
            times = []
            for rep in range(max(reps, 8)):
                t0 = time.perf_counter()
                D, _ = self.index.search(xq, k)
                times.append(time.perf_counter() - t0)
                if rep + 1 >= reps:
                    m = np.mean(times)
                    stderr = np.std(times) / np.sqrt(len(times))
                    if m <= 0 or stderr / m < 0.1:
                        break
            dt = float(np.mean(times)) / xq.shape[0]
            perf = worst_case_recall(D, gt_D, k, self.index.metric)
            self.ops.add(OperatingPoint(key, perf, dt))
        return self.ops

    def tune_for_bound(self, xq, gt_D, k: int, eps: float,
                       headroom: float = 0.0) -> int:
        """The smallest nprobe whose worst-case recall >= 1 - eps (+
        ``headroom``: extra train-set recall beyond the promise, the margin
        ErrorSys.calibrate applies). The index is left at the chosen
        point's knobs (full scan when none meets the target), which
        ``best_combo`` records."""
        nlist = getattr(self.index, "nlist", None)
        if nlist is None:
            raise TypeError(
                f"tune_for_bound needs an index family with an nprobe "
                f"knob (IVF); got {type(self.index).__name__}")
        self.explore(xq, gt_D, k)
        pt = self.ops.cheapest_meeting(min(1.0 - eps + headroom, 1.0))
        if pt is None:
            set_index_parameter(self.index, "nprobe", nlist)
            self.best_combo = {"nprobe": nlist}
            return nlist
        combo = {name: float(val) for name, val in
                 (p.split("=") for p in pt.key.split(","))}
        for name, val in combo.items():
            set_index_parameter(self.index, name, val)
        self.best_combo = combo
        return int(combo.get("nprobe", nlist))


class MatrixStats:
    """Dataset diagnostics with the reference's comments (``MatrixStats``,
    AutoTune.h:218 / AutoTune.cpp:1010-1190): per-dimension mean, std and
    range, NaN/Inf counts, duplicates, the norm range."""

    def __init__(self, x: np.ndarray):
        x = np.asarray(x, np.float32)
        self.n, self.d = x.shape
        lines = [f"analyzing {self.n} vectors of size {self.d}"]
        if self.d > 1024:
            lines.append(
                "indexing this many dimensions is hard, please consider "
                "dimensionality reduction (with PCAMatrix)")
        nan = np.isnan(x)
        inf = np.isinf(x)
        valid = ~(nan | inf)
        self.per_dim = dict(
            n_nan=nan.sum(0), n_inf=inf.sum(0),
            n0=((x == 0) & valid).sum(0),
            min=np.where(valid, x, np.inf).min(0),
            max=np.where(valid, x, -np.inf).max(0),
            mean=np.nanmean(np.where(inf, np.nan, x), axis=0),
            stddev=np.nanstd(np.where(inf, np.nan, x), axis=0),
        )
        sum2 = np.einsum("ij,ij->i", x.astype(np.float64),
                         x.astype(np.float64))
        finite = np.isfinite(sum2)
        self.n_valid = int(finite.sum())
        nz = finite & (sum2 > 0)
        self.n0 = int((finite & (sum2 == 0)).sum())
        self.min_norm2 = float(np.sqrt(sum2[nz].min())) if nz.any() else 0.0
        self.max_norm2 = float(np.sqrt(sum2[nz].max())) if nz.any() else 0.0
        if self.n_valid == self.n:
            lines.append("no NaN or Infs in data")
        else:
            lines.append(
                f"{self.n - self.n_valid} vectors contain NaN or Inf, "
                "expect bad results with indexing!")
        _, first, counts = np.unique(x, axis=0, return_index=True,
                                     return_counts=True)
        self.n_distinct = int(counts.size)
        if self.n_distinct == self.n:
            lines.append("all vectors are distinct")
        else:
            lines.append(f"{self.n_distinct} vectors are distinct "
                         f"({100.0 * self.n_distinct / self.n:.2f}%)")
            top = int(np.argmax(counts))
            lines.append(f"vector {int(first[top])} has "
                         f"{int(counts[top])} copies")
        lines.append(f"range of L2 norms=[{self.min_norm2:g}, "
                     f"{self.max_norm2:g}] ({self.n0} null vectors)")
        if self.max_norm2 < self.min_norm2 * 1.0001:
            lines.append("vectors are normalized, inner product and L2 "
                         "search are equivalent")
        if self.max_norm2 > self.min_norm2 * 100:
            lines.append("vectors have very large differences in norms, "
                         "is this normal?")
        rng0 = (self.per_dim["max"] == self.per_dim["min"]).sum()
        if rng0:
            lines.append(f"{int(rng0)} dimensions have constant values")
        self.comments = "\n".join(lines) + "\n"

    def __str__(self):
        return self.comments
