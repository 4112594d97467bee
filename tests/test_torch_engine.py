"""The bounded wave engine over rows, port against the JAX package on
identical index state and profile: equal my_nprobe, n_scanned and ids,
values within rtol 1e-5, under the batched plan (``plan_mr_waves``) and the
batch-1 plan (``plan_latency``), with mixed bounds that switch the k+1
exact-top-k margin on for some queries."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (K, MAX_TOPK, N_TEST, N_TRAIN, NLIST, jax_fixture,
                          port_state, tnp)
from auncel_tpu.profile import bounded_mr as jbm
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.profile import bounded_mr as tbm
from auncel_tpu_torch.types import Metric


def _bounds(n):
    acc = np.full(n, 0.9, np.float32)
    acc[::3] = 0.95   # ceil(0.95 * 10) == 10: exact top-k, margin on
    acc[1::7] = 0.5
    return acc


def _run_both(plan_name, q, acc, multipler, std_m):
    f = jax_fixture()
    _, arrays, mr, traces = port_state()
    rpl = tnp(mr.rows_per_list)
    if plan_name == "waves":
        tplan = tbm.plan_mr_waves(rpl, NLIST, decide_only=False)
        jplan = jbm.plan_mr_waves(rpl, NLIST, decide_only=False)
    else:
        tplan = tbm.plan_latency(rpl, NLIST, decide_stages=(2,),
                                 serve_base=8)
        jplan = jbm.plan_latency(rpl, NLIST, decide_stages=(2,),
                                 serve_base=8)
    assert tuple(tplan) == tuple(jplan)
    B = q.shape[0]
    got = tbm.bounded_search_mr(
        arrays, mr, traces, torch.from_numpy(q), torch.from_numpy(acc),
        torch.tensor(multipler, dtype=torch.float32),
        torch.tensor(std_m, dtype=torch.float32), torch.zeros(B), K,
        MAX_TOPK, Metric.L2, tplan, decide_margin=True)
    want = jbm.bounded_search_mr(
        f["idx"].arrays, f["idx"].multirow, f["es"].traces, jnp.asarray(q),
        jnp.asarray(acc), jnp.float32(multipler), jnp.float32(std_m),
        jnp.zeros(B, jnp.float32), K, MAX_TOPK, JMetric.L2, jplan,
        decide_margin=True)
    return [tnp(x) for x in got[:4]], [np.asarray(x) for x in want[:4]]


@pytest.mark.parametrize("plan_name", ["waves", "latency"])
def test_bounded_search_mr_matches_jax(plan_name):
    f = jax_fixture()
    q = f["xq"][N_TRAIN - 20:N_TRAIN + N_TEST]   # 40 queries
    acc = _bounds(q.shape[0])
    (v, i, np_, ns), (jv, ji, jnp_, jns) = _run_both(
        plan_name, q, acc, 2.0, 1.0)
    np.testing.assert_array_equal(np_, jnp_)
    np.testing.assert_array_equal(ns, jns)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(v, jv, rtol=1e-5)
    assert (np_ > 0).all()
    # the decisions really vary: the engine did not just scan everything
    assert len(set(ns.tolist())) > 1 and ns.min() < NLIST


def test_tiny_multipler_forces_full_scan():
    """floor(stage * multipler) == 0 everywhere: the forced decision floors
    to a full scan, in both packages."""
    f = jax_fixture()
    q = f["xq"][N_TRAIN - 20:N_TRAIN + N_TEST]   # the shape compiled above
    acc = np.full(q.shape[0], 0.999999, np.float32)
    (v, i, np_, ns), (jv, ji, jnp_, jns) = _run_both(
        "waves", q, acc, 1e-4, 1.0)
    assert (ns == NLIST).all()
    np.testing.assert_array_equal(np_, jnp_)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(
        i[:, :K], f["gt_I"][N_TRAIN - 20:N_TRAIN + N_TEST, :K])
