"""Parity of the port's distance and top-k ops with the JAX package.

Top-k values are copies of inputs (compared exactly), ids exactly; computed
distances at rtol 1e-6 (fp32 matrix products summed in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity  # noqa: F401  (single-threaded torch)
from auncel_tpu.ops import distance as jd
from auncel_tpu.ops import topk as jt
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.ops import distance as td
from auncel_tpu_torch.ops import topk as tt
from auncel_tpu_torch.types import Metric, worst_value

METRICS = [(Metric.L2, JMetric.L2), (Metric.IP, JMetric.IP)]


def test_distances_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(37, 16).astype(np.float32)
    y = rng.randn(53, 16).astype(np.float32)
    y_sq = (y * y).sum(1)
    np.testing.assert_allclose(td.sqnorms(torch.from_numpy(x)).numpy(),
                               np.asarray(jd.sqnorms(jnp.asarray(x))),
                               rtol=1e-6)
    for m, jm in METRICS:
        got = td.pairwise_scores(torch.from_numpy(x), torch.from_numpy(y), m,
                                 y_sqnorms=torch.from_numpy(y_sq)).numpy()
        want = np.asarray(jd.pairwise_scores(jnp.asarray(x), jnp.asarray(y),
                                             jm, y_sqnorms=jnp.asarray(y_sq)))
        # IP values cross zero: an absolute floor of 1e-6 at O(1) products
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # identical vectors: the expansion is clamped at 0, never negative
    d = td.pairwise_l2sqr(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    assert (d >= 0).all()


def _check_topk(scores, ids, k, m, jm):
    v, i = tt.topk_scores(torch.from_numpy(scores), torch.from_numpy(ids), k,
                          m)
    jv, ji = jt.topk_scores(jnp.asarray(scores), jnp.asarray(ids), k, jm)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
@pytest.mark.parametrize("case", ["random", "ties", "all_tied", "short",
                                  "masked"])
def test_topk_scores_matches_lax_top_k(metric, case):
    """First-occurrence ties, padding when n < k, and worst-value pads all
    as ``lax.top_k`` gives them (the tie-heavy cases of
    tests/test_topk_verified.py)."""
    m, jm = metric
    rng = np.random.RandomState(1)
    B, W, k = 6, 300, 10
    if case == "random":
        s = rng.rand(B, W).astype(np.float32) * 100
    elif case == "ties":
        s = rng.randint(0, 5, (B, W)).astype(np.float32)
    elif case == "all_tied":
        s = np.ones((B, W), np.float32)
    elif case == "short":
        W = 4
        s = rng.rand(B, W).astype(np.float32)
    else:  # mostly worst-value (masked) slots, fewer real than k for row 0
        s = np.full((B, W), worst_value(m), np.float32)
        for b, n_real in enumerate([3, 10, 50, 0, 200, 7]):
            pos = rng.choice(W, n_real, replace=False)
            s[b, pos] = rng.rand(n_real)
    ids = rng.randint(0, 1 << 20, (B, W)).astype(np.int32)
    if case == "masked":
        ids[np.isinf(s)] = -1
    _check_topk(s, ids, k, m, jm)


@pytest.mark.parametrize("metric", METRICS, ids=["l2", "ip"])
def test_merge_init_sort_match_jax(metric):
    m, jm = metric
    rng = np.random.RandomState(2)
    B, k = 5, 8
    rv, ri = tt.init_topk((B,), k, m, "cpu")
    jrv, jri = jt.init_topk((B,), k, jm)
    np.testing.assert_array_equal(rv.numpy(), np.asarray(jrv))
    np.testing.assert_array_equal(ri.numpy(), np.asarray(jri))
    for it in range(4):
        s = rng.randint(0, 30, (B, 64)).astype(np.float32)  # tie-heavy
        si = (it * 64 + np.arange(64, dtype=np.int32))[None].repeat(B, 0)
        rv, ri = tt.merge_topk(rv, ri, torch.from_numpy(s),
                               torch.from_numpy(si), k, m)
        jrv, jri = jt.merge_topk(jrv, jri, jnp.asarray(s), jnp.asarray(si),
                                 k, jm)
        np.testing.assert_array_equal(rv.numpy(), np.asarray(jrv))
        np.testing.assert_array_equal(ri.numpy(), np.asarray(jri))
    s = rng.randint(0, 9, (B, 40)).astype(np.float32)
    si = rng.randint(0, 999, (B, 40)).astype(np.int32)
    v, i = tt.sort_scores(torch.from_numpy(s), torch.from_numpy(si), m)
    jv, ji = jt.sort_scores(jnp.asarray(s), jnp.asarray(si), jm)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_incremental_merge_equals_one_shot_top_k():
    """Folding windows through the exact merge equals one top-k over the
    whole candidate stream, ties included: chunking a scan never changes
    its result."""
    rng = np.random.RandomState(3)
    B, k, W, n_win = 4, 10, 500, 5
    rv, ri = tt.init_topk((B,), k, Metric.L2, "cpu")
    all_s, all_i = [], []
    for win in range(n_win):
        s = rng.randint(0, 50, (B, W)).astype(np.float32)
        si = (win * W + np.arange(W, dtype=np.int32))[None].repeat(B, 0)
        all_s.append(s)
        all_i.append(si)
        rv, ri = tt.merge_topk(rv, ri, torch.from_numpy(s),
                               torch.from_numpy(si), k, Metric.L2)
    ev, ei = tt.topk_scores(torch.from_numpy(np.concatenate(all_s, -1)),
                            torch.from_numpy(np.concatenate(all_i, -1)), k,
                            Metric.L2)
    np.testing.assert_array_equal(rv.numpy(), ev.numpy())
    np.testing.assert_array_equal(ri.numpy(), ei.numpy())
