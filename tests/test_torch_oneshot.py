"""The one-shot engine and the resumable multi-row phases, port against the
JAX package on identical index state and profile: the planners,
``bounded_oneshot_mr`` under the default and a starved plan (with the
profile-mode true-recall count), ``ErrorSys.search`` at window sizes the
JAX package pads (1, 5, 20) in profile mode, streaming, and the compaction
loops' guards. Ids, my_nprobe, n_scanned and decided_at equal, values
within rtol 1e-5. The resumable phases are held to JAX in
tests/test_torch_dense.py and profile mode on the padded layout in
tests/test_torch_timemode.py, which keeps each file under a minute.

The JAX engines compile once per batch shape and plan, so every engine call
here runs the same WINDOW queries.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (K, MAX_TOPK, N_TEST, N_TRAIN, NLIST, jax_fixture,
                          port_state, tnp)
import auncel_tpu_torch as att
from auncel_tpu.profile import bounded_mr as jbm
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.profile import bounded_mr as tbm
from auncel_tpu_torch.types import Metric

WINDOW = 40
MULTIPLER = 5.0   # budgets past nlist/8: the tail runs
STARVED = dict(split=1, a2_cap=4, tail_cap=4, tail_waves=3)


def _window(strict: bool = False):
    """40 queries with mixed bounds: the k+1 margin on for a third, loose
    bounds that decide at the first stage for another share; ``strict``:
    every bound demands the exact top-k."""
    f = jax_fixture()
    q = f["xq"][N_TRAIN - 20:N_TRAIN + N_TEST]
    acc = np.full(WINDOW, 0.9, np.float32)
    acc[::3] = 0.95   # ceil(0.95 * 10) == 10: exact top-k, margin on
    acc[1::4] = 0.3
    if strict:
        acc[:] = 0.95
    gt_kth = f["gt_D"][N_TRAIN - 20:N_TRAIN + N_TEST, K - 1].copy()
    return q, acc, gt_kth


def _rpl():
    return tnp(port_state()[2].rows_per_list)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _same(got, want):
    """(vals, ids, then int vectors) of both packages."""
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kwargs", [
    dict(), STARVED, dict(min_decide_stage=4), dict(split=2, a2_cap=8),
    dict(dense_cut=0.25), dict(dense_cut=0.0, dense_decide=True),
    dict(dense_cut=0.5, dense_cap=8, dense_block=16, dense_merge=2,
         decide_block=32, tail_cap=16)])
def test_plan_oneshot_matches_jax(kwargs):
    rpl = _rpl()
    got = tbm.plan_oneshot(rpl, NLIST, **kwargs)
    want = jbm.plan_oneshot(rpl, NLIST, **kwargs)
    assert got._fields == want._fields
    for name in got._fields:
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("w, n_waves, base_stage", [
    (16, 8, None), (NLIST, 3, None), (8, 4, 2), (NLIST, 1, 1)])
def test_plan_finish_waves_matches_jax(w, n_waves, base_stage):
    rpl = _rpl()
    assert tbm.plan_finish_waves(rpl, NLIST, w, n_waves, base_stage) == \
        jbm.plan_finish_waves(rpl, NLIST, w, n_waves, base_stage)


def _oneshot_port(plan, q, acc, gt_kth, multipler=MULTIPLER,
                  with_true_recall=True):
    _, arrays, mr, traces = port_state()
    return [tnp(x) for x in tbm.bounded_oneshot_mr(
        arrays, mr, traces, torch.from_numpy(q), torch.from_numpy(acc),
        _f32(multipler), _f32(1.0), torch.from_numpy(gt_kth), K, MAX_TOPK,
        Metric.L2, plan, with_true_recall, decide_margin=True)]


@pytest.mark.parametrize("kwargs, strict", [
    (dict(), False), (STARVED, False), (STARVED, True)],
    ids=["default", "starved", "starved-strict"])
def test_oneshot_matches_jax(kwargs, strict):
    """Default plan (A1 to nlist/8, then the tail) and the starved plan of
    the JAX tests (A1 at stage 1 only, sub-batches of 4, equal tail
    widths): many A2 and tail rounds; with strict bounds most of the window
    is undecided after A1, so A2 first runs on the full batch."""
    f = jax_fixture()
    q, acc, gt_kth = _window(strict)
    rpl = _rpl()
    got = _oneshot_port(tbm.plan_oneshot(rpl, NLIST, **kwargs), q, acc,
                        gt_kth)
    want = jbm.bounded_oneshot_mr(
        f["idx"].arrays, f["idx"].multirow, f["es"].traces, jnp.asarray(q),
        jnp.asarray(acc), jnp.float32(MULTIPLER), jnp.float32(1.0),
        jnp.asarray(gt_kth), K, MAX_TOPK, JMetric.L2,
        jbm.plan_oneshot(rpl, NLIST, **kwargs), True, True)
    _same(got, [np.asarray(x) for x in want])
    ns = got[3]
    assert ns.max() > NLIST // 8 and len(set(ns.tolist())) > 2
    assert 0.0 < got[4].min() and got[4].max() <= 1.0


def test_oneshot_equals_wave_engine():
    """The one-shot engine changes how the window is batched, not its
    results: the single-phase wave engine's values, ids, my_nprobe and
    n_scanned exactly, under both plans."""
    _, arrays, mr, traces = port_state()
    q, acc, gt_kth = _window()
    rpl = _rpl()
    wave = [tnp(x) for x in tbm.bounded_search_mr(
        arrays, mr, traces, torch.from_numpy(q), torch.from_numpy(acc),
        _f32(MULTIPLER), _f32(1.0), torch.from_numpy(gt_kth), K, MAX_TOPK,
        Metric.L2, tbm.plan_mr_waves(rpl, NLIST, decide_only=False), True,
        decide_margin=True)]
    for kwargs in (dict(), STARVED):
        one = _oneshot_port(tbm.plan_oneshot(rpl, NLIST, **kwargs), q, acc,
                            gt_kth)
        for got, want in zip(one, wave):
            np.testing.assert_array_equal(got, want)


def _systems():
    """(port ErrorSys, JAX ErrorSys) on the fixture's multi-row index and
    profile."""
    import auncel_tpu as at
    f = jax_fixture()
    index, _, _, traces = port_state()
    es = att.ErrorSys(index, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    jes = at.ErrorSys(f["idx"], train_num=N_TRAIN + N_TEST,
                      max_topk=MAX_TOPK)
    es.traces, es.is_trained = traces, True
    jes.traces, jes.is_trained = f["es"].traces, True
    acc = np.full(N_TRAIN + N_TEST, 0.9, np.float32)
    acc[N_TRAIN::3] = 0.95
    for e in (es, jes):
        e.set_gt(f["gt_D"], f["gt_I"])
        e.set_topk(K)
        e.set_queries(N_TEST, f["xq"], acc)
        e.set_hyper(MULTIPLER, 1.0)
    return es, jes


def test_errorsys_search_matches_jax_at_padded_sizes():
    """Windows of 1 (the latency plan), 5 and 20 queries (the one-shot
    engine; the JAX package pads them to its 16 and 128 buckets, the port
    runs them as they are), in profile mode: equal ids, decisions and
    t_recalls."""
    es, jes = _systems()
    for e in (es, jes):
        e.profile = True
    for start, size in ((N_TRAIN, N_TEST), (N_TRAIN + 3, 5), (N_TRAIN + 2, 1)):
        D, I = es.search(start, size)
        jD, jI = jes.search(start, size)
        sl = slice(start, start + size)
        _same([D, I, es.my_nprobe[sl], es.n_scanned[sl], es.t_recalls[sl]],
              [jD, jI, jes.my_nprobe[sl], jes.n_scanned[sl],
               jes.t_recalls[sl]])
        assert D.shape == (size, K)
    assert es.n_scanned[N_TRAIN:].max() > NLIST // 8
    assert es.t_recalls[N_TRAIN:].mean() >= 0.9


def test_search_stream_equals_search():
    """search_stream over windows of 8 equals looping search over the same
    windows (bookkeeping included), and on the gather route the whole
    window's search too."""
    es, _ = _systems()
    es.profile = True
    w = 8
    outs = [es.search(N_TRAIN + o, min(w, N_TEST - o))
            for o in range(0, N_TEST, w)]
    ns = es.n_scanned[N_TRAIN:].copy()
    tr = es.t_recalls[N_TRAIN:].copy()
    es.n_scanned[:] = 0
    D, I = es.search_stream(N_TRAIN, N_TEST, window=w)
    np.testing.assert_array_equal(D, np.concatenate([o[0] for o in outs]))
    np.testing.assert_array_equal(I, np.concatenate([o[1] for o in outs]))
    np.testing.assert_array_equal(es.n_scanned[N_TRAIN:], ns)
    np.testing.assert_array_equal(es.t_recalls[N_TRAIN:], tr)
    D1, I1 = es.search(N_TRAIN, N_TEST)
    np.testing.assert_array_equal(I1, I)
    np.testing.assert_array_equal(D1, D)


def test_compaction_loops_raise_instead_of_spinning():
    """A2 on a state whose undecided queries claim a frontier past every
    goal (their waves are skipped, so nothing decides them), and the tail
    under a plan with no room per round: both raise RuntimeError."""
    _, arrays, mr, traces = port_state()
    q, acc, gt_kth = _window()
    rpl = _rpl()
    plan = tbm.plan_oneshot(rpl, NLIST, **STARVED)
    qt, acct = torch.from_numpy(q), torch.from_numpy(acc)
    m, s = _f32(MULTIPLER), _f32(1.0)
    state, _ = tbm._mr_impl(arrays, mr, traces, qt, acct, m, s,
                            torch.zeros(WINDOW), K, MAX_TOPK, Metric.L2,
                            plan.a1, False, decide_only=True)
    undecided = state[2] == 0
    assert undecided.any()
    bad = state[:7] + (torch.where(undecided, 10 ** 6, state[7]),)
    with pytest.raises(RuntimeError, match="A2 rounds"):
        tbm._a2_rounds(arrays, mr, traces, qt, acct, m, s, bad, K, MAX_TOPK,
                       Metric.L2, plan)
    with pytest.raises(RuntimeError, match="tail rounds"):
        _oneshot_port(plan._replace(tail_cap=0), q, acc, gt_kth)
