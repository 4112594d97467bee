"""Geometric model of IVF search progress (port of
``auncel_tpu/profile/geometry.py``).

``boundary_distances`` is the query's distance to the Voronoi bisector
between its home centroid and each next-ranked centroid (reference
``cosine_theorem``, IVF_pro.cpp:41-51, with its squared-distance inputs kept
deliberately: offline and online use the same quantities). ``sum_angle``
sums arccos(dtb / kdis) over a window of 15 upcoming boundaries
(IVF_pro.cpp:162-177). For IP, distances are mapped to angles first.
"""

import torch

from auncel_tpu_torch.types import Metric

ANGLE_WINDOW = 15      # boundaries summed into phi (IVF_pro.cpp:263,276)
BOUNDARY_MARGIN = 20   # boundary-count margin beyond nlist/8 (IVF_pro.cpp:202)


def n_boundaries(nlist: int) -> int:
    """Number of per-query boundary distances: nlist/8 + 20 - 1."""
    return nlist // 8 + BOUNDARY_MARGIN - 1


def safe_arccos(x: torch.Tensor) -> torch.Tensor:
    return torch.arccos(x.clamp(-1.0, 1.0))


def boundary_distances(cdis: torch.Tensor, cids: torch.Tensor,
                       interdis: torch.Tensor, metric: Metric
                       ) -> torch.Tensor:
    """dtb [B, n_boundaries]: dtb[:, j] is the distance to the bisector
    between the home (rank 0) and the rank-(j+1) centroid; +inf past the
    ranked centroids that exist (those contribute no angle)."""
    nlist = interdis.shape[0]
    m = n_boundaries(nlist)
    m_eff = min(m, nlist - 1, cdis.shape[1] - 1)
    cd = cdis[:, :m_eff + 1]
    if metric is Metric.IP:
        cd = safe_arccos(cd)
    home = cids[:, 0].long()
    others = cids[:, 1:m_eff + 1].long()
    cen2cen = interdis[home[:, None], others]
    a = cd[:, :1]
    b = cd[:, 1:m_eff + 1]
    c = cen2cen.clamp_min(1e-20)
    dtb = c / 2.0 - (a * a + c * c - b * b) / (2.0 * c)
    if m_eff < m:
        dtb = torch.nn.functional.pad(dtb, (0, m - m_eff),
                                      value=float("inf"))
    return dtb


def sum_angle(kdis: torch.Tensor, dtb: torch.Tensor, start: int
              ) -> torch.Tensor:
    """phi [B, K] over the 15-boundary window from ``start``: a boundary
    with dtb >= kdis contributes 0, else arccos(dtb / kdis)."""
    w = dtb[:, start:start + ANGLE_WINDOW][:, None, :]   # [B, 1, 15]
    k3 = kdis[:, :, None]                                # [B, K, 1]
    denom = torch.where(k3.abs() > 1e-30, k3, 1e-30)
    contrib = torch.where(w >= k3, 0.0, safe_arccos(w / denom))
    return contrib.sum(dim=-1)
