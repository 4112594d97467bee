"""Multi-row inverted-list layout (port of ``auncel_tpu/index/multirow.py``).

Each list is re-packed into ceil(size / row_cap) rows of a
[n_rows, row_cap, d] tensor, so a probed list is scanned as its tight rows
instead of one block padded to the largest list. The row tensor is a
``RowArrays``, an ``IVFArrays`` whose "lists" are rows and which the scan
scores with K1; ``expand_probes`` maps each query's ranked list slots to
ranked row slots.
"""

from typing import NamedTuple

import numpy as np
import torch

from auncel_tpu_torch.types import Metric
from auncel_tpu_torch.index.scan import (
    IVFArrays, RowArrays, check_f32_storage, coarse_rank, scan_probe_range)
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.topk import init_topk


class MultiRowArrays(NamedTuple):
    rows: RowArrays              # row-granular index state ("lists" == rows)
    row_table: torch.Tensor      # [nlist, max_rows] int32 row ids, -1 padded
    rows_per_list: torch.Tensor  # [nlist] int32
    row_base: torch.Tensor       # [nlist] int32 first row of each list
    row_list: torch.Tensor       # [n_rows] int32 owning list, -1 at pad rows

    @property
    def max_rows(self) -> int:
        return self.row_table.shape[1]


def build_multirow(arrays: IVFArrays, row_cap: int | None = None
                   ) -> MultiRowArrays:
    """Re-pack a padded IVFArrays into rows. The host computes only the
    addressing tables; ``db``, ``db_sq`` and ``vec_ids`` are COPIED on the
    device with one flat gather each (never recomputed), so every distance
    term is bitwise the padded layout's."""
    check_f32_storage(arrays)
    dev = arrays.db.device
    sizes = arrays.list_sizes.cpu().numpy().astype(np.int64)
    nlist, cap = arrays.vec_ids.shape
    row_cap = min(row_cap or 256, cap)
    rows_per = np.maximum(1, -(-sizes // row_cap)).astype(np.int64)
    n_rows = int(rows_per.sum())
    n_rows_pad = ((n_rows + 7) // 8) * 8
    max_rows = int(rows_per.max())

    src_list = np.full(n_rows_pad, -1, np.int32)
    src_list[:n_rows] = np.repeat(np.arange(nlist), rows_per)
    row_base = np.concatenate([[0], np.cumsum(rows_per)[:-1]])
    within = np.arange(n_rows) - np.repeat(row_base, rows_per)
    src_off = np.zeros(n_rows_pad, np.int32)
    src_off[:n_rows] = within * row_cap
    row_table = np.full((nlist, max_rows), -1, np.int32)
    row_table[src_list[:n_rows], within] = np.arange(n_rows)

    sl = torch.as_tensor(src_list, device=dev).long()
    so = torch.as_tensor(src_off, device=dev).long()
    slot = torch.arange(row_cap, device=dev)[None, :]
    idx = sl[:, None] * cap + so[:, None] + slot      # [n_rows_pad, row_cap]
    in_list = ((so[:, None] + slot) < cap) & (sl[:, None] >= 0)
    idx = idx.clamp(0, nlist * cap - 1)
    db = arrays.db.reshape(nlist * cap, -1)[idx]
    db_sq = torch.where(in_list, arrays.db_sq.reshape(-1)[idx], 0.0)
    vec_ids = torch.where(in_list, arrays.vec_ids.reshape(-1)[idx], -1)

    row_sizes = np.zeros(n_rows_pad, np.int64)
    real = src_list >= 0
    row_sizes[real] = np.minimum(
        np.maximum(sizes[src_list[real]] - src_off[real], 0), row_cap)
    rows = RowArrays(
        centroids=arrays.centroids, cent_sq=arrays.cent_sq, db=db,
        db_sq=db_sq, vec_ids=vec_ids,
        list_sizes=torch.as_tensor(row_sizes.astype(np.int32), device=dev),
        interdis=arrays.interdis)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)

    return MultiRowArrays(rows, t(row_table), t(rows_per), t(row_table[:, 0]),
                          t(src_list))


def expand_probes(mr: MultiRowArrays, cids: torch.Tensor, n_slots: int,
                  out_slots: int):
    """Map ranked LIST slots [B, n_slots] to ranked ROW slots
    [B, out_slots], plus per-query cumulative row counts per list prefix
    (``offsets`` [B, n_slots]). Row slots past a query's expansion are -1.

    A list's rows are consecutive ids, so row slot p belongs to ranked list
    s = #(offsets <= p) at within-list row p - starts[s]; the count is a
    scatter of one mark at each list's END offset plus a prefix sum."""
    B = cids.shape[0]
    dev = cids.device
    sel = cids[:, :n_slots].long()
    rpl = mr.rows_per_list[sel]                                   # [B, S]
    offsets = torch.cumsum(rpl, dim=1, dtype=torch.int32)
    p = torch.arange(out_slots, dtype=torch.int32, device=dev)[None, :]
    marks = torch.zeros((B, out_slots + 1), dtype=torch.int32, device=dev)
    marks.scatter_add_(1, offsets.clamp(0, out_slots).long(),
                       torch.ones_like(offsets))
    s = torch.cumsum(marks[:, :out_slots], dim=1, dtype=torch.int32)
    in_range = s < n_slots
    s_c = s.clamp_max(n_slots - 1).long()
    starts = offsets - rpl
    j = p - torch.gather(starts, 1, s_c)
    base = mr.row_base[torch.gather(sel, 1, s_c)]
    out = torch.where(in_range, base + j, -1).to(torch.int32)
    return out, offsets


def multirow_search_fixed(mr: MultiRowArrays, q: torch.Tensor, k: int,
                          nprobe: int, out_slots: int, metric: Metric):
    """Fixed-nprobe search over the rows: the same candidates as a padded
    fixed-nprobe scan. ``out_slots`` must cover every query's expansion
    (the sum of the ``nprobe`` largest per-list row counts does)."""
    B = q.shape[0]
    q_sq = sqnorms(q)
    _, cids = coarse_rank(mr.rows, q, metric, q_sq=q_sq)
    row_slots, offsets = expand_probes(mr, cids, nprobe, out_slots)
    row_limit = offsets[:, nprobe - 1]
    # -1 padding clamps to row 0; those slots sit past row_limit and are
    # masked, so row 0 is never double-counted
    safe_rows = row_slots.clamp_min(0)
    vals, ids = init_topk((B,), k, metric, q.device)
    return scan_probe_range(mr.rows, q, q_sq, safe_rows, vals, ids,
                            row_limit, 0, out_slots, metric)
