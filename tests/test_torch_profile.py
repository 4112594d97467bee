"""Parity of the port's decision core and profile trainer with the JAX
package: boundary geometry, trace lookup, the cur_num replay, the recall
estimate, the wave planners, profile training (bins within the 1e-5
kscaling band) and the shared .npz profile format."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (DEVICE, MAX_TOPK, N_TRAIN, NLIST, as_numpy,
                          jax_fixture, port_state, tnp)
from auncel_tpu.profile import bounded as jb
from auncel_tpu.profile import bounded_mr as jbm
from auncel_tpu.profile import geometry as jg
from auncel_tpu.profile import trace as jtr
from auncel_tpu.profile import trainer as jtrain
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.profile import bounded as tb
from auncel_tpu_torch.profile import bounded_mr as tbm
from auncel_tpu_torch.profile import geometry as tg
from auncel_tpu_torch.profile import trace as ttr
from auncel_tpu_torch.profile import trainer as ttrain
from auncel_tpu_torch.convert import traces_from_numpy
from auncel_tpu_torch.index.scan import coarse_rank
from auncel_tpu_torch.types import Metric

L2 = Metric.L2


def _geometry():
    f = jax_fixture()
    _, arrays, _, _ = port_state()
    q = torch.from_numpy(f["xq"])
    cdis, cids = coarse_rank(arrays, q, L2)
    dtb = tg.boundary_distances(cdis, cids, arrays.interdis, L2)
    jdtb = jg.boundary_distances(jnp.asarray(tnp(cdis)),
                                 jnp.asarray(tnp(cids)),
                                 f["idx"].arrays.interdis, JMetric.L2)
    return f, cdis, cids, dtb, np.asarray(jdtb)


def test_boundary_distances_and_sum_angle_match():
    f, cdis, cids, dtb, jdtb = _geometry()
    assert dtb.shape == jdtb.shape == (f["xq"].shape[0],
                                       tg.n_boundaries(NLIST))
    np.testing.assert_allclose(tnp(dtb), jdtb, rtol=1e-5, atol=1e-5)
    kdis = f["gt_D"][:, :10]
    for start in (0, 1, 3):
        got = tg.sum_angle(torch.from_numpy(kdis), dtb, start)
        want = jg.sum_angle(jnp.asarray(kdis), jnp.asarray(jdtb), start)
        np.testing.assert_allclose(tnp(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_trace_lookup_matches_including_degenerate_trace():
    rng = np.random.RandomState(0)
    bins = [jtr.build_trace(rng.rand(400) * 3, rng.rand(400) * 2 + 1,
                            rng.rand(400) > 0.1, bs=50),
            jtr.build_trace(np.zeros(0), np.zeros(0), np.zeros(0, bool))]
    jts = jtr.make_trace_set(bins)
    tts = ttr.make_trace_set(bins, "cpu")
    phi = np.concatenate([rng.rand(5, 30) * 4, np.zeros((5, 2))],
                         1).astype(np.float32)
    for t in range(2):
        got = ttr.trace_lookup(tts, t, torch.from_numpy(phi),
                               torch.tensor(1.5))
        want = jtr.trace_lookup(jts, t, jnp.asarray(phi), jnp.float32(1.5))
        np.testing.assert_allclose(tnp(got), np.asarray(want), rtol=1e-6)
    # an untrained stage never lets the predicate fire
    assert (tnp(got) >= ttr.EMPTY_TRACE_U * 0.99).all()


def test_simulate_cur_num_replays_the_binary_search():
    rng = np.random.RandomState(1)
    for k in (1, 2, 10, 21):
        p = rng.rand(64, k) > 0.4          # not monotone on purpose
        first_ok = rng.rand(64) > 0.8
        got = tb._simulate_cur_num(torch.from_numpy(p),
                                   torch.from_numpy(first_ok), k)
        want = jb._simulate_cur_num(jnp.asarray(p), jnp.asarray(first_ok),
                                    k)
        np.testing.assert_array_equal(tnp(got), np.asarray(want))


def test_recall_estimate_matches():
    f, cdis, cids, dtb, jdtb = _geometry()
    _, _, _, traces = port_state()
    jtraces = f["es"].traces
    for ind in (0, traces.n_traces - 1):  # first and forced-stage traces
        for k in (10, 11):
            got = tb._recall_estimate(traces, dtb,
                                      torch.from_numpy(f["gt_D"]), ind, k,
                                      torch.tensor(1.0))
            want = jb._recall_estimate(jtraces, jnp.asarray(jdtb),
                                       jnp.asarray(f["gt_D"]), ind, k,
                                       jnp.float32(1.0))
            np.testing.assert_array_equal(tnp(got), np.asarray(want))
    acc = np.asarray([0.9, 0.95, 1.0, 0.5], np.float32)
    np.testing.assert_array_equal(
        tnp(tb.exact_topk_mask(torch.from_numpy(acc), 10)),
        np.asarray(jb.exact_topk_mask(jnp.asarray(acc), 10)))


@pytest.mark.parametrize("nlist", [8, 32, 100, 1024])
def test_wave_planners_match(nlist):
    rng = np.random.RandomState(nlist)
    rpl = rng.randint(1, 9, nlist)
    assert tb.wave_boundaries(nlist) == jb.wave_boundaries(nlist)
    assert [tb.stage_to_trace(s, nlist) for s in range(1, nlist + 1)] == \
        [jb.stage_to_trace(s, nlist) for s in range(1, nlist + 1)]
    for kw in (dict(decide_only=False), dict(decide_only=True),
               dict(decide_only=False, min_decide_stage=4),
               dict(decide_only=True, exact_cover=True, max_stage=8)):
        assert tuple(tbm.plan_mr_waves(rpl, nlist, **kw)) == \
            tuple(jbm.plan_mr_waves(rpl, nlist, **kw))
    if nlist >= 32:
        assert tuple(tbm.plan_latency(rpl, nlist, (2,), 8)) == \
            tuple(jbm.plan_latency(rpl, nlist, (2,), 8))


def test_collect_pairs_and_train_profile_match():
    f = jax_fixture()
    _, arrays, _, _ = port_state()
    ja = f["idx"].arrays
    q, g = f["xq"][:N_TRAIN], f["gt_D"][:N_TRAIN]
    tp, tu, tv, _, _ = ttrain._collect_pairs(
        arrays, torch.from_numpy(q[:40]), torch.from_numpy(g[:40]),
        MAX_TOPK, L2)
    jp, ju, jv, _, _ = jtrain._collect_pairs(
        ja, jnp.asarray(q[:40]), jnp.asarray(g[:40]), MAX_TOPK, JMetric.L2)
    np.testing.assert_array_equal(tnp(tv), np.asarray(jv))
    np.testing.assert_array_equal(tnp(tu), np.asarray(ju))
    # a raw phi sums arccos terms, and arccos'(x) -> inf as x -> 1: one ulp
    # of difference in a coarse distance moves a term by up to
    # sqrt(2 * 2**-23) ~ 5e-4. The bins (means over the pairs) are held to
    # the 1e-5 kscaling band below.
    np.testing.assert_allclose(tnp(tp), np.asarray(jp), atol=1e-3)
    assert tnp(tv).any()
    traces, raw = ttrain.train_profile(arrays, q, g, MAX_TOPK, L2)
    want = as_numpy(f["es"].traces)
    np.testing.assert_array_equal(tnp(traces.n_bins), want["n_bins"])
    for name in ("phi", "u", "std"):
        np.testing.assert_allclose(tnp(getattr(traces, name)), want[name],
                                   rtol=1e-5, atol=1e-5)


def test_profile_npz_loads_across_packages(tmp_path):
    f = jax_fixture()
    jpath = str(tmp_path / "jax_profile.npz")
    jtr.save_trace_set(f["es"].traces, jpath)
    ours = ttr.load_trace_set(jpath, DEVICE)
    ref = traces_from_numpy(as_numpy(f["es"].traces), DEVICE)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(tnp(a), tnp(b))
    tpath = str(tmp_path / "port_profile.npz")
    ttr.save_trace_set(ours, tpath)
    back = jtr.load_trace_set(tpath)
    for a, b in zip(back, f["es"].traces):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
