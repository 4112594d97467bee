"""K1's main-path scan, ``rowscan_scores``: its plain version against the
JAX package's route (the Pallas ``rowscan_dots`` kernel in interpret mode,
then the score assembly and masks of ``auncel_tpu/index/scan.py``), with
equal ids and scores within rtol = atol = 1e-5; the multi-row scan's
candidates bitwise equal to those of the dots route it replaced, on the
shared fixture; the wrapper's contract; and the build's key. The CUDA
kernel itself is tested on a card in tests/test_torch_cuda.py."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import jax_fixture, port_state, tnp
from auncel_tpu.pallas_kernels.rowscan import TCHUNK
from auncel_tpu.pallas_kernels.rowscan import rowscan_dots as jax_rowscan
from auncel_tpu.types import Metric as JMetric
from auncel_tpu.types import worst_value as jax_worst
from auncel_tpu_torch.index.multirow import expand_probes
from auncel_tpu_torch.index import scan
from auncel_tpu_torch.index.scan import coarse_rank, scan_probe_range
from auncel_tpu_torch.kernels import build
from auncel_tpu_torch.kernels.rowscan import (
    rowscan_dots, rowscan_scores, rowscan_scores_ref)
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.topk import init_topk
from auncel_tpu_torch.types import Metric, worst_value

# one shape for every Pallas call below (B * C a multiple of TCHUNK), so
# the interpreted kernel compiles once
N_ROWS, ROW_CAP, DIM, B, C = 7, 8, 16, 4, 8
assert B * C % TCHUNK == 0


@functools.cache
def _layout():
    """Rows as build_multirow lays them out: full rows, partial last rows
    (id -1 and zero vectors past row_sizes), an empty pad row and a dead id
    inside a row; entries ~ N(0, 1/d), so every score is O(1) and fp32 sum
    order stays far inside 1e-5. The norms are stored once, for both
    packages."""
    rng = np.random.RandomState(12)
    sizes = np.asarray([8, 8, 3, 0, 8, 5, 6], np.int32)
    live = np.arange(ROW_CAP)[None, :] < sizes[:, None]
    ids = np.where(live, np.arange(N_ROWS * ROW_CAP).reshape(N_ROWS, ROW_CAP),
                   -1).astype(np.int32)
    ids[0, 4] = -1
    db = (rng.randn(N_ROWS, ROW_CAP, DIM) / np.sqrt(DIM)).astype(np.float32)
    db[~live] = 0.0
    q = (rng.randn(B, DIM) / np.sqrt(DIM)).astype(np.float32)
    return db, (db * db).sum(-1), ids, sizes, q, (q * q).sum(-1)


# (row slots [B, C] as expand_probes gives them, -1 past a query's
# expansion; per-query limits): the scan's edge cases
CASES = {
    "ragged limits, -1 slots and a partial last row": (
        [[0, 1, 2, 4, 5, 6, -1, -1], [4, 5, 0, 1, 2, -1, -1, -1],
         [6, 2, 1, 0, -1, -1, -1, -1], [5, 4, 3, 2, 1, 0, 6, -1]],
        [6, 3, 0, 7]),
    "every entry inactive": ([[0] * C] * B, [0] * B),
    "duplicate entries and one row for every query": (
        [[2, 2, 1, 1, 0, 0, 2, 2], [2] * C, [1, 2, 1, 2, 1, 2, 1, 2],
         [2, 5, 2, 5, 2, 5, 2, 5]], [8, 8, 5, 8]),
    "out-of-range row ids clamp": (
        [[9, 7, 6, 0, 1, 2, 4, 5], [7, 7, 7, 7, 7, 7, 7, 7],
         [12, 0, 3, 3, 3, 3, 3, 3], [0, 1, 2, 3, 4, 5, 6, 30]],
        [8, 4, 2, 8]),
}


def _jax_route(slots, limits, jmetric):
    """The JAX package's multi-row scan of these row slots: the Pallas
    kernel's dots (row ids clamped first, as XLA clamps a gather), then the
    assembly and masks of auncel_tpu/index/scan.py:249-268."""
    db, db_sq, ids, _, q, q_sq = _layout()
    safe = np.maximum(slots, 0)                     # the callers' clamp
    work = np.minimum(safe, N_ROWS - 1).reshape(-1)
    dots = jax_rowscan(jnp.asarray(db), jnp.asarray(work, jnp.int32),
                       jnp.repeat(jnp.asarray(q), C, axis=0),
                       interpret=True).reshape(B, C, ROW_CAP)
    sub_sq = jnp.asarray(db_sq)[jnp.asarray(safe)]
    sub_ids = jnp.asarray(ids)[jnp.asarray(safe)]
    if jmetric is JMetric.L2:
        scores = jnp.maximum(
            jnp.asarray(q_sq)[:, None, None] + sub_sq - 2.0 * dots, 0.0)
    else:
        scores = dots
    in_limit = np.arange(C)[None, :] < np.asarray(limits)[:, None]
    active = jnp.asarray(in_limit)[:, :, None] & (sub_ids >= 0)
    scores = jnp.where(active, scores, jax_worst(jmetric))
    sub_ids = jnp.where(active, sub_ids, -1)
    return (np.asarray(scores).reshape(B, C * ROW_CAP),
            np.asarray(sub_ids).reshape(B, C * ROW_CAP))


def _port(rows, metric, fn=rowscan_scores):
    db, db_sq, ids, sizes, q, q_sq = (torch.from_numpy(a) for a in _layout())
    return fn(db, db_sq, ids, sizes, q, q_sq,
              torch.as_tensor(np.asarray(rows, np.int32)), metric)


@pytest.mark.parametrize("metric,jmetric", [(Metric.L2, JMetric.L2),
                                            (Metric.IP, JMetric.IP)])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_the_jax_route(case, metric, jmetric):
    slots, limits = (np.asarray(a) for a in CASES[case])
    in_limit = np.arange(C)[None, :] < limits[:, None]
    # the caller's contract: a slot past its query's limit is row -1
    rows = np.where(in_limit, np.maximum(slots, 0), -1)
    scores, ids = _port(rows, metric)
    want_s, want_i = _jax_route(slots, limits, jmetric)
    np.testing.assert_array_equal(tnp(ids), want_i)
    np.testing.assert_allclose(tnp(scores), want_s, rtol=1e-5, atol=1e-5)


def _dots_route(rows, q, q_sq, row_ids, in_limit, metric):
    """The multi-row scan's candidates as the dots route computed them
    before its kernel took the assembly and masks in: rowscan_dots over
    every entry, masked or not, then separate gathers and wheres."""
    n_b, n_c = row_ids.shape
    cap = rows.cap
    row_ids = row_ids.clamp_min(0)
    dots = rowscan_dots(rows.db, row_ids.reshape(-1).to(torch.int32),
                        q.repeat_interleave(n_c, dim=0)).reshape(n_b, n_c,
                                                                 cap)
    row_ids = row_ids.long()
    sub_sq = rows.db_sq[row_ids]
    sub_ids = rows.vec_ids[row_ids]
    if metric is Metric.L2:
        scores = (q_sq[:, None, None] + sub_sq - 2.0 * dots).clamp_min(0.0)
    else:
        scores = dots
    active = in_limit[:, :, None] & (sub_ids >= 0)
    scores = torch.where(active, scores, worst_value(metric))
    sub_ids = torch.where(active, sub_ids, -1)
    return scores.reshape(n_b, n_c * cap), sub_ids.reshape(n_b, n_c * cap)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
def test_row_scan_bitwise_as_the_dots_route(metric, monkeypatch):
    """On the shared fixture's rows, with each query's own probe count:
    the candidates, and scan_probe_range's merged top-k over chunks of
    them, bit for bit as the dots route gave them before the fusion."""
    _, arrays, mr, _ = port_state()
    q = torch.from_numpy(jax_fixture()["xq"][:12])
    q_sq = sqnorms(q)
    _, cids = coarse_rank(arrays, q, metric, q_sq=q_sq)
    n_probe = 6
    out_slots = int(mr.rows_per_list.sort(descending=True).values[
        :n_probe].sum())
    row_slots, offsets = expand_probes(mr, cids, n_probe, out_slots)
    probes = torch.arange(q.shape[0]) % n_probe          # 0 .. 5 lists
    limit = torch.where(probes > 0, torch.gather(
        offsets, 1, (probes - 1).clamp_min(0)[:, None])[:, 0], 0)
    in_limit = torch.arange(out_slots)[None, :] < limit[:, None]
    safe = row_slots.clamp_min(0)
    assert (~in_limit).any() and in_limit.any()
    rows = mr.rows
    got = rowscan_scores(rows.db, rows.db_sq, rows.vec_ids, rows.list_sizes,
                         q, q_sq, torch.where(in_limit, safe, -1).int(),
                         metric)
    want = _dots_route(rows, q, q_sq, safe, in_limit, metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    def scan_rows():
        vals, ids = init_topk((q.shape[0],), 10, metric, q.device)
        return scan_probe_range(rows, q, q_sq, safe, vals, ids, limit, 0,
                                out_slots, metric, probe_chunk=3)

    got = scan_rows()
    monkeypatch.setattr(scan, "rowscan_scores", lambda *a: _dots_route(
        rows, a[4], a[5], a[6], a[6] >= 0, a[7]))
    want = scan_rows()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrapper_contract():
    args = [torch.zeros(4, 3, 8), torch.zeros(4, 3),
            torch.zeros(4, 3, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), torch.zeros(5, 8),
            torch.zeros(5), torch.zeros(5, 2, dtype=torch.int32)]

    def call(i, value, metric=Metric.L2):
        a = list(args)
        a[i] = value
        return rowscan_scores(*a, metric)

    before = rowscan_scores.launches
    assert call(0, args[0])[0].shape == (5, 6)
    assert rowscan_scores.launches == before   # the CPU runs the plain one
    with pytest.raises(TypeError):
        call(0, args[0].double())
    with pytest.raises(TypeError):
        call(6, args[6].long())
    with pytest.raises(TypeError):
        call(0, args[0], metric="l2")
    with pytest.raises(ValueError):
        call(5, torch.zeros(4))
    with pytest.raises(ValueError):
        call(1, torch.zeros(4, 2))
    with pytest.raises(ValueError):
        call(6, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError):
        call(0, args[0][:0])
    # a tensor off the CPU never takes the plain version
    with pytest.raises(ValueError):
        rowscan_scores(*[a.to("meta") for a in args], Metric.L2)


@pytest.mark.parametrize("b,c", [(0, 3), (2, 0), (1, 1)])
def test_empty_and_single_entries(b, c):
    """T = 0 gives empty outputs; T = 1 the one entry's row."""
    rows = np.full((b, c), 4, np.int32)
    db, db_sq, ids, sizes, q, q_sq = (torch.from_numpy(a) for a in _layout())
    scores, got = rowscan_scores(db, db_sq, ids, sizes, q[:b], q_sq[:b],
                                 torch.from_numpy(rows), Metric.L2)
    assert scores.shape == got.shape == (b, c * ROW_CAP)
    if b * c:
        np.testing.assert_array_equal(tnp(got)[0], tnp(ids)[4])


def test_rowscan_scores_ref_is_the_padded_contract_over_rows():
    rows = np.asarray(CASES["out-of-range row ids clamp"][0], np.int32)
    for a, b in zip(_port(rows, Metric.L2, rowscan_scores_ref),
                    _port(rows, Metric.L2)):
        assert torch.equal(a, b)


def test_build_is_keyed_by_the_shared_headers(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text('#include "w.cuh"\n')
    (tmp_path / "w.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "SRC_DIR", tmp_path)
    first = build.library_path("k")
    assert first == build.library_path("k") and first.parent == build.BUILD_DIR
    (tmp_path / "w.cuh").write_text("// two\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "v.cuh").write_text("// a new header\n")
    assert build.library_path("k") not in (first, second)
