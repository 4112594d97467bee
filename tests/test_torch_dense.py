"""The dense paths over the multi-row layout, port against the JAX package
and against the port's own gather route: the shared masked corpus pass
(``masked_full_scan``), the per-stage snapshots of the dense decide phase
(``dense_stage_snapshots``, L2 and IP), ``nprobe_search_mr`` and
``bounded_oneshot_mr`` with every query dense and with the dense decide
phase, per-query mixed routing, and ``ErrorSys._mr_oneshot_plan``'s
routing (the 2048-row floor and the window-size flip). Also the resumable
gather phases the one-shot engine is built from (decide -> resume ->
finish, state by state against JAX).

The dense product is a plain fp32 matmul in both packages (the JAX package
computes it with an XLA einsum, not a Pallas kernel), so its values differ
from the gather kernel's, and from each other, by rounding: within 1e-5,
with ids equal except where two candidates' distances tie within that
rounding. Decisions and n_scanned are equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity as tp
from torch_parity import (K, MAX_TOPK, N_TEST, N_TRAIN, NLIST, jax_fixture,
                          port_state, tnp)
import auncel_tpu_torch as att
from auncel_tpu.index import scan as jscan
from auncel_tpu.ops.distance import sqnorms as jsqnorms
from auncel_tpu.profile import bounded_mr as jbm
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.index import scan as tscan
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.profile import bounded_mr as tbm
from auncel_tpu_torch.types import Metric

WINDOW = 40
MULTIPLER = 5.0


def _queries():
    f = jax_fixture()
    return f["xq"][N_TRAIN - 20:N_TRAIN + N_TEST]


def _rpl():
    return tnp(port_state()[2].rows_per_list)


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _same_results(vg, ig, vd, idn, k=K):
    """Top-k of two routes: values within 1e-5; ids equal except where the
    two distances tie within that rounding."""
    np.testing.assert_allclose(vd[:, :k], vg[:, :k], rtol=1e-5, atol=1e-5)
    b, j = np.nonzero(idn[:, :k] != ig[:, :k])
    np.testing.assert_allclose(vd[b, j], vg[b, j], rtol=1e-5, atol=1e-5)
    return b.size


def _inv_rank_prefix(q, prefix):
    """Both packages' inverse coarse rank over the first ``prefix`` ranked
    lists (rank nlist outside), from the port's ranking."""
    _, arrays, _, _ = port_state()
    qt = torch.from_numpy(q)
    _, cids = tscan.coarse_rank(arrays, qt, Metric.L2, q_sq=sqnorms(qt))
    return tscan.inverse_rank(cids[:, :prefix], NLIST)


def test_masked_full_scan_matches_jax():
    """Random budgets in [1, nlist], small blocks merged in pairs (the
    clamped last block of the JAX pass, the merge skip)."""
    f = jax_fixture()
    _, _, mr, _ = port_state()
    q = _queries()
    target = np.random.RandomState(5).randint(1, NLIST + 1, WINDOW).astype(
        np.int32)
    inv = _inv_rank_prefix(q, NLIST)
    qt = torch.from_numpy(q)
    v, i = tscan.masked_full_scan(mr.rows, mr.row_list, inv,
                                  torch.from_numpy(target), qt, sqnorms(qt),
                                  MAX_TOPK, Metric.L2, 24, 2)
    jmr = f["idx"].multirow
    jq = jnp.asarray(q)
    jv, ji = jscan.masked_full_scan(
        jmr.rows, jmr.row_list, jnp.asarray(tnp(inv)), jnp.asarray(target),
        jq, jsqnorms(jq), MAX_TOPK, JMetric.L2, 24, 2)
    _same_results(np.asarray(jv), np.asarray(ji), tnp(v), tnp(i), MAX_TOPK)
    # and the exact top-k of each budget's lists, as the gather route has it
    gv, gi, _ = tbm.nprobe_search_mr(
        port_state()[1], mr, qt, torch.from_numpy(target), MAX_TOPK,
        Metric.L2, tbm.plan_oneshot(_rpl(), NLIST))
    _same_results(tnp(gv), tnp(gi), tnp(v), tnp(i), MAX_TOPK)


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_dense_stage_snapshots_matches_jax(metric):
    """The per-stage value snapshots over the decide window's ranks (lists
    ranked past nlist/8 sit outside every stage), odd block size."""
    f = jax_fixture()
    _, _, mr, _ = port_state()
    q = _queries()
    if metric == "IP":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    stages = (1, 2, 4)
    inv = _inv_rank_prefix(q, stages[-1])
    qt = torch.from_numpy(q)
    got = tscan.dense_stage_snapshots(mr.rows, mr.row_list, inv, qt,
                                      sqnorms(qt), stages, MAX_TOPK,
                                      getattr(Metric, metric), 7)
    jmr = f["idx"].multirow
    jq = jnp.asarray(q)
    want = jscan.dense_stage_snapshots(
        jmr.rows, jmr.row_list, jnp.asarray(tnp(inv)), jq, jsqnorms(jq),
        stages, MAX_TOPK, getattr(JMetric, metric), 7)
    np.testing.assert_allclose(tnp(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if metric == "L2":
        # the stage-4 snapshot is the exact top-k of the first 4 lists (the
        # ranks above are L2's, so only L2 has a gather route to match)
        v, _, _ = tbm.nprobe_search_mr(
            port_state()[1], mr, qt, torch.full((WINDOW,), 4), MAX_TOPK,
            Metric.L2, tbm.plan_oneshot(_rpl(), NLIST))
        np.testing.assert_allclose(tnp(got)[:, 2], tnp(v), rtol=1e-5,
                                   atol=1e-5)


def test_nprobe_dense_matches_gather():
    """Every query dense (dense_cut 0.0) against the gather rounds, and
    against the JAX package's dense route."""
    f = jax_fixture()
    _, arrays, mr, _ = port_state()
    q = _queries()
    probes = np.random.RandomState(0).randint(1, NLIST + 1, WINDOW).astype(
        np.int32)
    rpl = _rpl()
    qt, pt = torch.from_numpy(q), torch.from_numpy(probes)
    vg, ig, ng = tbm.nprobe_search_mr(arrays, mr, qt, pt, MAX_TOPK,
                                      Metric.L2, tbm.plan_oneshot(rpl, NLIST))
    dense = tbm.plan_oneshot(rpl, NLIST, dense_cut=0.0, dense_cap=16)
    vd, idn, nd = tbm.nprobe_search_mr(arrays, mr, qt, pt, MAX_TOPK,
                                       Metric.L2, dense)
    np.testing.assert_array_equal(tnp(ng), tnp(nd))
    _same_results(tnp(vg), tnp(ig), tnp(vd), tnp(idn))
    jv, ji, _ = jbm.nprobe_search_mr(
        f["idx"].arrays, f["idx"].multirow, jnp.asarray(q),
        jnp.asarray(probes), MAX_TOPK, JMetric.L2, dense)
    _same_results(np.asarray(jv), np.asarray(ji), tnp(vd), tnp(idn),
                  MAX_TOPK)


def test_mixed_routing_matches_gather():
    """Only the queries whose budget crosses the cut go dense: the rest are
    bitwise the gather plan's, the dense ones within the rounding."""
    _, arrays, mr, _ = port_state()
    q = _queries()
    probes = np.where(np.arange(WINDOW) % 3 == 0, NLIST, 2).astype(np.int32)
    rpl = _rpl()
    qt, pt = torch.from_numpy(q), torch.from_numpy(probes)
    vg, ig, _ = tbm.nprobe_search_mr(arrays, mr, qt, pt, K, Metric.L2,
                                     tbm.plan_oneshot(rpl, NLIST))
    vm, im, _ = tbm.nprobe_search_mr(arrays, mr, qt, pt, K, Metric.L2,
                                     tbm.plan_oneshot(rpl, NLIST,
                                                      dense_cut=0.5))
    small = probes == 2
    np.testing.assert_array_equal(tnp(vm)[small], tnp(vg)[small])
    np.testing.assert_array_equal(tnp(im)[small], tnp(ig)[small])
    _same_results(tnp(vg)[~small], tnp(ig)[~small], tnp(vm)[~small],
                  tnp(im)[~small])


@pytest.mark.parametrize("dense_decide", [False, True],
                         ids=["dense-tail", "dense-decide"])
def test_oneshot_dense_matches_jax(dense_decide):
    """bounded_oneshot_mr with every query's tail dense, and with the
    decisions replayed from one shared pass: equal decisions to the JAX
    package's (and to the port's gather route), results within the
    rounding."""
    f = jax_fixture()
    _, arrays, mr, traces = port_state()
    q = _queries()
    acc = np.full(WINDOW, 0.9, np.float32)
    acc[::3] = 0.95
    rpl = _rpl()
    plan = tbm.plan_oneshot(rpl, NLIST, dense_cut=0.0,
                            dense_decide=dense_decide)
    args = (torch.from_numpy(q), torch.from_numpy(acc), _f32(MULTIPLER),
            _f32(1.0), torch.zeros(WINDOW), K, MAX_TOPK, Metric.L2)
    got = [tnp(x) for x in tbm.bounded_oneshot_mr(
        arrays, mr, traces, *args, plan, decide_margin=True)]
    want = [np.asarray(x) for x in jbm.bounded_oneshot_mr(
        f["idx"].arrays, f["idx"].multirow, f["es"].traces, jnp.asarray(q),
        jnp.asarray(acc), jnp.float32(MULTIPLER), jnp.float32(1.0),
        jnp.zeros(WINDOW, jnp.float32), K, MAX_TOPK, JMetric.L2,
        jbm.plan_oneshot(rpl, NLIST, dense_cut=0.0,
                         dense_decide=dense_decide),
        decide_margin=True)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    _same_results(want[0], want[1], got[0], got[1], MAX_TOPK)
    gather = [tnp(x) for x in tbm.bounded_oneshot_mr(
        arrays, mr, traces, *args, tbm.plan_oneshot(rpl, NLIST),
        decide_margin=True)]
    np.testing.assert_array_equal(got[3], gather[3])
    _same_results(gather[0], gather[1], got[0], got[1], MAX_TOPK)
    assert got[3].max() > NLIST // 8


def _same_state(got, want):
    """Resumable state (or finish output) of both packages: the running
    top-k values and pre_val (8-tuple index 5) within rtol 1e-5, ids,
    decisions, counters and frontiers equal."""
    for j, (g, w) in enumerate(zip(got, want)):
        if j == 0 or (len(got) == 8 and j == 5):
            np.testing.assert_allclose(g, w, rtol=1e-5)
        else:
            np.testing.assert_array_equal(g, w)


def test_decide_resume_finish_matches_jax():
    """The resumable phases, state by state: decide on stages <= 2 for the
    window, resume the undecided subset on (2, nlist/8], then finish the
    stragglers' budgets past nlist/8 over plan_finish_waves' widths."""
    f = jax_fixture()
    _, arrays, mr, traces = port_state()
    jarr, jmr, jtr = f["idx"].arrays, f["idx"].multirow, f["es"].traces
    q = _queries()
    acc = np.full(WINDOW, 0.9, np.float32)
    acc[::3] = 0.95   # ceil(0.95 * 10) == 10: exact top-k, margin on
    acc[1::4] = 0.3
    rpl = _rpl()
    cap_stage = NLIST // 8
    windows = (dict(max_stage=2), dict(min_stage=2, max_stage=cap_stage))
    plan_a, plan_b = (tbm.plan_mr_waves(rpl, NLIST, True, exact_cover=True,
                                        **kw) for kw in windows)
    for p, kw in zip((plan_a, plan_b), windows):
        assert p == jbm.plan_mr_waves(rpl, NLIST, True, exact_cover=True,
                                      **kw)
    m, s = _f32(MULTIPLER), _f32(1.0)
    st, q_sq = tbm.bounded_search_decide_mr(
        arrays, mr, traces, torch.from_numpy(q), torch.from_numpy(acc), m, s,
        K, MAX_TOPK, Metric.L2, plan_a, decide_margin=True)
    jst, jq_sq = jbm.bounded_search_decide_mr(
        jarr, jmr, jtr, jnp.asarray(q), jnp.asarray(acc),
        jnp.float32(MULTIPLER), jnp.float32(1.0), K, MAX_TOPK, JMetric.L2,
        plan_a, decide_margin=True)
    jst = [np.asarray(x) for x in jst]
    _same_state([tnp(x) for x in st], jst)
    und = np.where(tnp(st[2]) == 0)[0]
    assert 0 < und.size < WINDOW
    sel = torch.from_numpy(und)
    st2, _ = tbm.bounded_resume_mr(
        arrays, mr, traces, torch.from_numpy(q)[sel],
        torch.from_numpy(acc)[sel], m, s, tuple(x[sel] for x in st), K,
        MAX_TOPK, Metric.L2, plan_b, decide_margin=True)
    jst2, _ = jbm.bounded_resume_mr(
        jarr, jmr, jtr, jnp.asarray(q[und]), jnp.asarray(acc[und]),
        jnp.float32(MULTIPLER), jnp.float32(1.0),
        tuple(jnp.asarray(x[und]) for x in jst), K, MAX_TOPK, JMetric.L2,
        plan_b, decide_margin=True)
    _same_state([tnp(x) for x in st2], [np.asarray(x) for x in jst2])
    assert (tnp(st2[2]) > 0).all()
    # the stragglers: budgets past nlist/8, from the resumed state
    vals, ids, my_np, decided, _, _, _, frontier = st2
    need = np.where(tnp(my_np) > cap_stage)[0]
    assert need.size
    w = NLIST
    widths = tbm.plan_finish_waves(rpl, NLIST, w, 4)
    out_slots = int(np.sort(rpl)[::-1][:w].sum())
    nd = torch.from_numpy(need)
    got = tbm.finish_scan_mr(arrays, mr, torch.from_numpy(q[und])[nd],
                             q_sq[sel][nd], vals[nd], ids[nd], my_np[nd],
                             frontier[nd], w, out_slots, widths, Metric.L2)
    jsel = und[need]
    want = jbm.finish_scan_mr(
        jarr, jmr, jnp.asarray(q[jsel]), jq_sq[jnp.asarray(jsel)],
        jst2[0][need], jst2[1][need], jst2[2][need], jst2[7][need], w,
        out_slots, widths, JMetric.L2)
    _same_state([tnp(x) for x in got], [np.asarray(x) for x in want])


def _systems_on(index):
    """A port ErrorSys on ``index`` with the fixture's profile and bounds."""
    f = jax_fixture()
    es = att.ErrorSys(index, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.traces, es.is_trained = port_state()[3], True
    es.set_gt(f["gt_D"], f["gt_I"])
    es.set_topk(K)
    es.set_queries(N_TEST, f["xq"], np.full(N_TRAIN + N_TEST, 0.9,
                                            np.float32))
    return es


def test_oneshot_plan_floor_on_the_fixture():
    """Fewer than 2048 rows: no dense program, whatever the crossover says,
    in both packages; dense_cut 0.0 bypasses the floor."""
    import auncel_tpu as at
    f = jax_fixture()
    es = _systems_on(port_state()[0])
    jes = at.ErrorSys(f["idx"], train_num=N_TRAIN + N_TEST,
                      max_topk=MAX_TOPK)
    assert port_state()[2].rows.db.shape[0] < 2048
    for e in (es, jes):
        e.dense_auto, e._dense_min_bsz = True, 1
    for bsz in (None, 1, 20, 1024):
        assert es._mr_oneshot_plan(bsz) == jes._mr_oneshot_plan(bsz)
        assert es._mr_oneshot_plan(bsz).dense_cut_rows < 0
    for e in (es, jes):
        e.dense_cut = 0.0
    assert es._mr_oneshot_plan(5) == jes._mr_oneshot_plan(5)
    assert es._mr_oneshot_plan(5).dense_cut_rows == 0


def test_oneshot_plan_window_size_flip():
    """On a layout of at least 2048 rows (the fixture's vectors at row_cap
    2), a window at least as large as the measured crossover goes dense as
    a whole, a smaller one keeps per-query routing, the time-budget plan
    (no window) never flips, and dense_auto off or no measured crossover
    keeps per-query routing. search gives the same ids and decisions either
    way."""
    f = jax_fixture()
    idx = att.IVFFlatIndex(tp.D, NLIST, device=tp.DEVICE)
    idx.set_centroids(f["centers"])
    idx.add(f["xb"])
    idx.enable_multirow(row_cap=1)
    assert idx.multirow.rows.db.shape[0] >= 2048
    es = _systems_on(idx)
    es.set_hyper(MULTIPLER, 1.0)
    rpl = idx.multirow.rows_per_list.numpy()
    per_query = tbm.plan_oneshot(rpl, NLIST, dense_cut=0.25).dense_cut_rows
    assert per_query > 0
    es._dense_min_bsz = 8
    assert es._mr_oneshot_plan(8).dense_cut_rows == 0
    assert es._mr_oneshot_plan(7).dense_cut_rows == per_query
    assert es._mr_oneshot_plan().dense_cut_rows == per_query
    es.dense_auto = False
    assert es._mr_oneshot_plan(1024).dense_cut_rows == per_query
    es.dense_auto, es._dense_min_bsz = True, None
    assert es._mr_oneshot_plan(1024).dense_cut_rows == per_query
    D0, I0 = es.search(N_TRAIN, 12)
    ns0 = es.n_scanned[N_TRAIN:N_TRAIN + 12].copy()
    es._dense_min_bsz = 8
    D1, I1 = es.search(N_TRAIN, 12)
    np.testing.assert_array_equal(ns0, es.n_scanned[N_TRAIN:N_TRAIN + 12])
    _same_results(D0, I0, D1, I1)
