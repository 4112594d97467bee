"""The padded-layout engines, port against the JAX package on identical
index state and profile: single-phase ``bounded_search``, the two-phase
``bounded_search_decide`` + ``finish_scan``, and ``ErrorSys.search`` on an
index without the multi-row layout (a two-phase window and batch-1
windows). Equal ids, my_nprobe, n_scanned and decided_at, values within
rtol 1e-5, with the k+1 exact-top-k decide margin on and off.

The JAX engines compile once per batch shape and flag. To keep to a few
programs, the single-phase engine is held to JAX at batch 1 query by query
(the shape of ErrorSys's batch-1 windows; every query's decisions are its
own, so the port runs the whole batch at once), and the two-phase path at
WINDOW queries, a batch bucket of the JAX ErrorSys, which therefore pads
nothing and reuses both programs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (K, MAX_TOPK, N_TEST, N_TRAIN, NLIST, jax_fixture,
                          padded_systems, port_state, tnp)
from auncel_tpu.profile import bounded as jb
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.profile import bounded as tb
from auncel_tpu_torch.types import Metric

WINDOW = 16
MULTIPLER = 5.0  # budgets past nlist/8 in both width buckets of phase B


def _window():
    f = jax_fixture()
    q = f["xq"][N_TRAIN:N_TRAIN + WINDOW]
    acc = np.full(WINDOW, 0.9, np.float32)
    acc[::3] = 0.95   # ceil(0.95 * 10) == 10: exact top-k, margin on
    acc[1::7] = 0.5
    return q, acc


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _same(got, want):
    """(vals, ids, then int vectors) of both packages."""
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("margin", [True, False])
def test_bounded_search_matches_jax(margin):
    f = jax_fixture()
    _, arrays, _, traces = port_state()
    q, acc = _window()
    got = [tnp(x) for x in tb.bounded_search(
        arrays, traces, torch.from_numpy(q), torch.from_numpy(acc),
        _f32(2.0), _f32(1.0), K, MAX_TOPK, Metric.L2,
        decide_margin=margin)]
    for b in range(WINDOW):
        want = jb.bounded_search(
            f["idx"].arrays, f["es"].traces, jnp.asarray(q[b:b + 1]),
            jnp.asarray(acc[b:b + 1]), jnp.float32(2.0), jnp.float32(1.0),
            jnp.zeros(1, jnp.float32), K, MAX_TOPK, JMetric.L2,
            decide_margin=margin)
        _same([x[b:b + 1] for x in got], [np.asarray(x) for x in want[:4]])
    ns = got[3]
    # the decisions really vary: the engine did not just scan everything
    assert len(set(ns.tolist())) > 1 and ns.min() < NLIST


@pytest.mark.parametrize("margin", [True, False])
def test_two_phase_matches_jax(margin):
    f = jax_fixture()
    _, arrays, _, traces = port_state()
    q, acc = _window()
    jarrays = f["idx"].arrays
    got = tb.bounded_search_decide(
        arrays, traces, torch.from_numpy(q), torch.from_numpy(acc),
        _f32(MULTIPLER), _f32(1.0), K, MAX_TOPK, Metric.L2,
        decide_margin=margin)
    want = jb.bounded_search_decide(
        jarrays, f["es"].traces, jnp.asarray(q), jnp.asarray(acc),
        jnp.float32(MULTIPLER), jnp.float32(1.0), K, MAX_TOPK, JMetric.L2,
        decide_margin=margin)
    # vals, ids, my_nprobe, decided_at and the ranking prefix
    _same([tnp(x) for x in got[:5]], [np.asarray(x) for x in want[:5]])
    vals, ids, my_np, decided, _, q_sq = got
    cap_stage = NLIST // 8
    target = tnp(torch.maximum(my_np, decided).clamp_max(NLIST))
    need = np.where(target > cap_stage)[0]
    buckets = list(padded_systems()[0]._width_buckets(need, target,
                                                      cap_stage, NLIST))
    assert len(buckets) == 2   # both width buckets below nlist run
    for w, rows in buckets:
        sel = torch.from_numpy(rows)
        fv, fi = tb.finish_scan(arrays, torch.from_numpy(q)[sel], q_sq[sel],
                                vals[sel], ids[sel], my_np[sel], cap_stage,
                                w - cap_stage, Metric.L2)
        jv, ji = jb.finish_scan(jarrays, jnp.asarray(q), want[5], want[0],
                                want[1], want[2], cap_stage, w - cap_stage,
                                JMetric.L2)
        _same([tnp(fv), tnp(fi)], [np.asarray(jv)[rows], np.asarray(ji)[rows]])


@pytest.mark.parametrize("margin", [True, False])
def test_two_phase_equals_single_phase(margin):
    """The two-phase path changes how many scans run, not their results: on
    a window whose stragglers take phase B it gives single-phase
    ``bounded_search``'s values, ids, my_nprobe and n_scanned exactly."""
    es = padded_systems()[0]
    es.set_topk(K)
    q, acc = _window()
    q, acc = torch.from_numpy(q), torch.from_numpy(acc)
    m, s = _f32(MULTIPLER), _f32(1.0)
    two = es._two_phase(q, acc, m, s, margin)
    one = tb.bounded_search(es.index.arrays, es.traces, q, acc, m, s, K,
                            MAX_TOPK, Metric.L2, decide_margin=margin)
    assert (tnp(two[3]) > NLIST // 8).any()   # phase B ran
    for got, want in zip(two, one):
        np.testing.assert_array_equal(tnp(got), tnp(want))


def test_errorsys_without_multirow_matches_jax():
    """ErrorSys.search on an index without the multi-row layout: one
    two-phase window and batch-1 windows (single phase) in both packages,
    the decide margin on for the bounds that demand the exact top-k."""
    f = jax_fixture()
    es, jes = padded_systems()
    assert es.index.multirow is None and jes.index.multirow is None
    _, acc = _window()
    bounds = np.full(N_TRAIN + N_TEST, 0.9, np.float32)
    bounds[N_TRAIN:N_TRAIN + WINDOW] = acc
    for e in (es, jes):
        e.set_topk(K)
        e.set_queries(N_TEST, f["xq"], bounds)
        e.set_hyper(MULTIPLER, 1.0)
    assert es._decide_margin_flag() and jes._decide_margin_flag()
    for start, size in ((N_TRAIN, WINDOW), (N_TRAIN, 1), (N_TRAIN + 1, 1),
                        (N_TRAIN + 3, 1)):
        D, I = es.search(start, size)
        jD, jI = jes.search(start, size)
        sl = slice(start, start + size)
        _same([D, I, es.my_nprobe[sl], es.n_scanned[sl]],
              [jD, jI, jes.my_nprobe[sl], jes.n_scanned[sl]])
        assert D.shape == (size, K)
    assert es.n_scanned[N_TRAIN:N_TRAIN + WINDOW].max() > NLIST // 8
