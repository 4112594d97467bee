"""Figure reproduction from eval logs (the port's copy of
``auncel_tpu/figures/plots.py``; numpy and matplotlib only).

Parity with the reference's ``figures/`` scripts (SURVEY.md §2 #34), reading
the same log formats our eval harness writes:

  * latency_cdf / latency_slowdown   <- figures/overall (figs 10-12):
    per-query latency CDFs and per-query slowdown ratios of a baseline
    vs Auncel, from ``*_Latency_<db>_<k>_<eps>.log`` files;
  * bound_satisfaction               <- figures/effect (fig 13): required
    vs achieved recall scatter from ``Effective_error_<db>.log``;
  * time_budget                      <- figures/effect (fig 14): budget vs
    actual latency scatter from ``Effective_time_<db>.log``;
  * validation_map                   <- figures/validation (fig 15): the
    learned phi->U staircase against raw bs=1 trace points;
  * dist_scaling                     <- figures/dist (fig 16): latency vs
    shard count.

All functions take/return data and write a PNG; they do not hardcode
results (the reference's figure16.py hardcodes its numbers). The port's
profiles are torch tensors, on the card or the CPU; ``validation_map``
reads them through ``_np``.
"""

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _np(a) -> np.ndarray:
    """A torch tensor (on any device) or array as numpy."""
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def _load_latency(path: str) -> np.ndarray:
    return np.loadtxt(path, ndmin=1)


def latency_cdf(log_paths: dict, out_png: str, title: str = ""):
    """log_paths: {label: path-to-latency-log}."""
    fig, ax = plt.subplots(figsize=(5, 3.2))
    for label, path in log_paths.items():
        lat = np.sort(_load_latency(path)) * 1e3
        ax.plot(lat, np.linspace(0, 1, lat.size), label=label)
    ax.set_xlabel("per-query latency (ms)")
    ax.set_ylabel("CDF")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)


def latency_slowdown(baseline_log: str, auncel_log: str, out_png: str,
                     label: str = "baseline/Auncel"):
    """Per-query slowdown ratio CDF (figures/overall/figure10-1.py:36-80
    computes baseline_latency[i] / auncel_latency[i] per query)."""
    base = _load_latency(baseline_log)
    ours = _load_latency(auncel_log)
    n = min(base.size, ours.size)
    ratio = np.sort(base[:n] / np.maximum(ours[:n], 1e-12))
    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.plot(ratio, np.linspace(0, 1, n), label=label)
    ax.axvline(1.0, color="gray", ls=":")
    ax.set_xlabel("per-query slowdown vs Auncel")
    ax.set_ylabel("CDF")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return float(np.mean(base[:n]) / np.mean(ours[:n]))


def bound_satisfaction(effect_log: str, out_png: str):
    """Required vs achieved recall (fig 13)."""
    pairs = np.loadtxt(effect_log, ndmin=2)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.scatter(pairs[:, 0], np.minimum(pairs[:, 1], 1.0), s=6, alpha=0.4)
    lims = [0.0, 1.05]
    ax.plot(lims, lims, "r--", lw=1, label="y = x (bound)")
    ax.set_xlabel("required recall")
    ax.set_ylabel("achieved recall")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return float(np.mean(pairs[:, 1] >= pairs[:, 0] - 1e-6))


def time_budget(effect_log: str, out_png: str):
    """Budget vs actual latency (fig 14)."""
    pairs = np.loadtxt(effect_log, ndmin=2)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.scatter(pairs[:, 0], pairs[:, 1], s=6, alpha=0.4)
    m = pairs.max() * 1.05
    ax.plot([0, m], [0, m], "r--", lw=1, label="y = x (budget)")
    ax.set_xlabel("budget (ms)")
    ax.set_ylabel("actual (ms)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return float(np.mean(pairs[:, 1] <= pairs[:, 0] + 1e-9))


def validation_map(error_sys, stage_idx: int, out_png: str):
    """Learned phi->U staircase vs raw trace points (fig 15; the reference
    dumps Validation_<d>_<np>.log with bs=1 and overlays the bs=250 map)."""
    traces = error_sys.traces
    nb = int(_np(traces.n_bins)[stage_idx])
    phi = _np(traces.phi)[stage_idx, :nb]
    u = _np(traces.u)[stage_idx, :nb]
    fig, ax = plt.subplots(figsize=(5, 3.2))
    if error_sys.raw_pairs is not None:
        rp, ru = error_sys.raw_pairs[stage_idx]
        ax.scatter(rp, ru, s=2, alpha=0.15, label="raw (phi, U) pairs")
    ax.step(phi, u, where="post", color="r", label="learned map (bs=250)")
    ax.set_xlabel(r"$\varphi$ (sum of boundary angles)")
    ax.set_ylabel("U (rank scaling)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)


def dist_scaling(shards: list, latencies_ms: list, out_png: str):
    """Latency vs shard count (fig 16) from measured values."""
    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.plot(shards, latencies_ms, "o-")
    ax.set_xscale("log", base=2)
    ax.set_xlabel("# shards")
    ax.set_ylabel("avg latency (ms)")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)


def calib_margin(log_path: str, out_png: str, target: float = 0.9):
    """Calibration-margin study heatmap-ish scatter: held-out worst-case
    recall and mean scan cost per (sample size, safety margin) cell
    (Calib_margin_<db>.log rows: samples safety multipler min_recall
    mean_scan). The reference's hyperparameter.txt hand-tuning is the
    manual version of this sweep."""
    rows = np.loadtxt(log_path, ndmin=2)
    fig, ax = plt.subplots(1, 2, figsize=(9, 3.2))
    for s in np.unique(rows[:, 0]):
        sel = rows[rows[:, 0] == s]
        ax[0].plot(sel[:, 1], sel[:, 3], marker="o",
                   label=f"{int(s)} cal queries")
        ax[1].plot(sel[:, 1], sel[:, 4], marker="o")
    ax[0].axhline(target, color="k", ls="--", lw=0.8)
    ax[0].set_xlabel("safety margin")
    ax[0].set_ylabel("held-out min recall")
    ax[0].legend(fontsize=7)
    ax[1].set_xlabel("safety margin")
    ax[1].set_ylabel("mean lists scanned")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
