"""The port's running top-k merge, ``ops/topk.py::merge_topk_verified``, on
the CPU (its plain route: the stable sort of the concatenation), against
the JAX package: bit for bit the JAX ``topk_scores`` over the
concatenation, and, as ``tests/test_topk_verified.py`` holds the JAX merge,
equal values to the JAX ``merge_topk_verified`` with equal ids wherever a
value is untied. The card's kernel (``csrc/topk_merge.cu``) is modelled in
plain torch (``torch_parity.topk_merge_model``: the running result's
bound, segments streamed in steps, the radix select over (key, position)
keys, the row's shared threshold, the pool and its merge) and the model is
held bit for bit to the sort over 1-8 segments, at k segments and more,
and with the candidate buffers of a large k; the card tests hold the
kernel to its plain version. Last, ``scan_probe_range`` on the shared
fixture gives the results it gave with the sort merge inline, on both
layouts.

One difference from the JAX package is pinned here: ``lax.top_k`` orders
-0.0 before +0.0, where the port (``torch.sort``, and the kernel) takes
them as one key and keeps the earlier position. Values agree as numbers.
No scan emits -0.0 (every dot sums from +0.0), which
``test_scans_emit_no_negative_zero`` shows on both packages, so the
difference never reaches a search.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (DEVICE, K, as_numpy, jax_fixture, port_state, tnp,
                          topk_merge_model)
from auncel_tpu.index import scan as jscan
from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
from auncel_tpu.ops import topk as jtopk
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.convert import ivf_arrays_from_numpy, multirow_from_numpy
from auncel_tpu_torch.index import scan as tscan
from auncel_tpu_torch.kernels.topk_merge import (
    BLOCKS_PER_SM, SEGMENT_MIN, segments, topk_merge, topk_merge_ref)
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.topk import init_topk, merge_topk_verified
from auncel_tpu_torch.types import Metric, worst_value

METRICS = [(Metric.L2, JMetric.L2), (Metric.IP, JMetric.IP)]


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, dtype))


def _bits(v) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(v, np.float32)).view(np.int32)


def _check(rv, ri, s, si, k, metric, jmetric, bitwise_jax: bool = True):
    """The port's merge against the JAX exact merge (bitwise) and the JAX
    verified merge (values, ids where untied); returns the port's."""
    tv, ti = merge_topk_verified(_t(rv, np.float32), _t(ri, np.int32),
                                 _t(s, np.float32), _t(si, np.int32), k,
                                 metric)
    tv, ti = tnp(tv), tnp(ti)
    ev, ei = jtopk.topk_scores(jnp.concatenate([rv, s], axis=-1),
                               jnp.concatenate([ri, si], axis=-1), k,
                               jmetric)
    ev, ei = np.asarray(ev), np.asarray(ei)
    if bitwise_jax:
        np.testing.assert_array_equal(_bits(tv), _bits(ev))
        np.testing.assert_array_equal(ti, ei)
    vv, vi = jtopk.merge_topk_verified(jnp.asarray(rv), jnp.asarray(ri),
                                       jnp.asarray(s), jnp.asarray(si), k,
                                       jmetric)
    vv, vi = np.asarray(vv), np.asarray(vi)
    np.testing.assert_array_equal(tv, vv)
    for b in range(vv.shape[0]):
        vals, cnt = np.unique(vv[b], return_counts=True)
        untied = np.isin(vv[b], vals[cnt == 1])
        np.testing.assert_array_equal(ti[b][untied], vi[b][untied])
    return tv, ti


def _init(B, k, metric):
    return (np.full((B, k), worst_value(metric), np.float32),
            np.full((B, k), -1, np.int32))


@pytest.mark.parametrize("metric,jmetric", METRICS)
def test_random_wide_windows(metric, jmetric):
    rng = np.random.RandomState(0)
    B, k, W = 16, 10, 4096
    rv, ri = _init(B, k, metric)
    for _ in range(3):
        s = rng.rand(B, W).astype(np.float32) * 100
        si = rng.randint(0, 1 << 20, (B, W)).astype(np.int32)
        rv, ri = _check(rv, ri, s, si, k, metric, jmetric)


@pytest.mark.parametrize("metric,jmetric", METRICS)
def test_mostly_masked_window_and_not_full_running_result(metric, jmetric):
    rng = np.random.RandomState(1)
    B, k, W = 8, 10, 4096
    rv, ri = _init(B, k, metric)
    s = np.full((B, W), worst_value(metric), np.float32)
    si = np.full((B, W), -1, np.int32)
    for b, n_real in enumerate([3, 10] + [200] * (B - 2)):
        pos = rng.choice(W, n_real, replace=False)
        s[b, pos] = rng.rand(n_real) * 10
        si[b, pos] = pos
    tv, ti = _check(rv, ri, s, si, k, metric, jmetric)
    assert (ti[0, 3:] == -1).all() and np.isinf(tv[0, 3:]).all()


@pytest.mark.parametrize("metric,jmetric", METRICS)
def test_tie_heavy_values(metric, jmetric):
    """Every value tied, then values of four levels: the first positions
    win, in both packages."""
    rng = np.random.RandomState(4)
    B, k, W = 4, 10, 4096
    rv, ri = _init(B, k, metric)
    si = np.arange(W, dtype=np.int32)[None].repeat(B, 0)
    _check(rv, ri, np.ones((B, W), np.float32), si, k, metric, jmetric)
    s = np.round(rng.rand(B, W) * 3).astype(np.float32)
    rv, ri = _check(rv, ri, s, si, k, metric, jmetric)
    _check(rv, ri, s, si + W, k, metric, jmetric)  # ties with the running


def test_narrow_window():
    rng = np.random.RandomState(2)
    B, k = 4, 10
    rv, ri = _init(B, k, Metric.L2)
    _check(rv, ri, rng.rand(B, 32).astype(np.float32),
           rng.randint(0, 100, (B, 32)).astype(np.int32), k, Metric.L2,
           JMetric.L2)
    # fewer candidates than k, with no running result: pads
    tv, ti = _check(np.zeros((B, 0), np.float32), np.zeros((B, 0), np.int32),
                    rng.rand(B, 3).astype(np.float32),
                    rng.randint(0, 100, (B, 3)).astype(np.int32), k,
                    Metric.L2, JMetric.L2)
    assert np.isinf(tv[:, 3:]).all() and (ti[:, 3:] == -1).all()


def test_incremental_equals_oneshot():
    rng = np.random.RandomState(3)
    B, k, W, n_win = 8, 10, 4096, 6
    rv, ri = _init(B, k, Metric.L2)
    all_s, all_i = [], []
    for win in range(n_win):
        s = rng.rand(B, W).astype(np.float32) * 100
        si = (win * W + np.arange(W, dtype=np.int32))[None].repeat(B, 0)
        all_s.append(s)
        all_i.append(si)
        rv, ri = _check(rv, ri, s, si, k, Metric.L2, JMetric.L2)
    ev, ei = jtopk.topk_scores(jnp.asarray(np.concatenate(all_s, -1)),
                               jnp.asarray(np.concatenate(all_i, -1)), k,
                               JMetric.L2)
    np.testing.assert_array_equal(_bits(rv), _bits(ev))
    np.testing.assert_array_equal(ri, np.asarray(ei))


@pytest.mark.parametrize("metric,jmetric", METRICS)
def test_signed_zero_ties(metric, jmetric):
    """-0.0 and +0.0 are one key to the port: the earlier position wins,
    keeping its own bits. lax.top_k ranks -0.0 first; values agree as
    numbers, ids wherever a value is untied."""
    rng = np.random.RandomState(5)
    B, k, W = 4, 10, 300
    sign = 1.0 if metric is Metric.L2 else -1.0
    s = np.where(rng.rand(B, W) < 0.5, 0.0, -0.0).astype(np.float32)
    s[rng.rand(B, W) < 0.9] = sign  # a few zeros among worse values
    si = np.arange(W, dtype=np.int32)[None].repeat(B, 0)
    rv, ri = _init(B, k, metric)
    tv, ti = _check(rv, ri, s, si, k, metric, jmetric, bitwise_jax=False)
    for b in range(B):
        zeros = np.flatnonzero(s[b] == 0.0)[:k]
        np.testing.assert_array_equal(ti[b, :zeros.size], zeros)
        np.testing.assert_array_equal(_bits(tv[b, :zeros.size]),
                                      _bits(s[b, zeros]))
    ev, ei = jtopk.topk_scores(jnp.asarray(s), jnp.asarray(si), k, jmetric)
    assert (np.asarray(ei) != ti).any()  # the pinned difference


@pytest.mark.parametrize("metric,jmetric", METRICS)
def test_scans_emit_no_negative_zero(metric, jmetric):
    """Zero queries (+0.0 and -0.0 components) against zero, all-negative
    and sign-mixed vectors, through both packages' scan_probe_range on
    padded lists and on rows: every score that is zero is +0.0 (each dot
    sums from +0.0, and the L2 assembly cancels to +0.0), so -0.0 never
    meets +0.0 at the k-th place, and the ids are equal."""
    rng = np.random.RandomState(10)
    d, nb, k = 8, 64, 12
    xb = rng.randn(nb, d).astype(np.float32)
    xb[::3] = -np.abs(xb[::3])
    xb[1::7] = 0.0
    centers = np.stack([np.ones(d), -np.ones(d)]).astype(np.float32)
    j = JIVF(d, 2, metric=metric.name.lower())
    j.set_centroids(centers)
    j.add(xb)
    j.enable_multirow(row_cap=16)
    q = np.zeros((2, d), np.float32)
    q[1] = -0.0
    for rows in (False, True):
        if rows:
            target = multirow_from_numpy(as_numpy(j.multirow), DEVICE).rows
            jtarget = j.multirow.rows
            live = np.flatnonzero(np.asarray(j.multirow.row_list) >= 0)
            probes = np.stack([live, live]).astype(np.int32)
        else:
            target = ivf_arrays_from_numpy(as_numpy(j.arrays), DEVICE)
            jtarget = j.arrays
            probes = np.array([[0, 1], [0, 1]], np.int32)
        w = probes.shape[1]
        limit = np.full(2, w, np.int32)
        jv, ji = jtopk.init_topk((2,), k, jmetric)
        jv, ji = jscan.scan_probe_range(
            jtarget, jnp.asarray(q), jnp.zeros(2), jnp.asarray(probes), jv,
            ji, jnp.asarray(limit), 0, w, jmetric)
        tq = torch.from_numpy(q)
        tv, ti = init_topk((2,), k, metric, DEVICE)
        tv, ti = tscan.scan_probe_range(
            target, tq, sqnorms(tq), torch.from_numpy(probes), tv, ti,
            torch.from_numpy(limit), 0, w, metric)
        for v in (np.asarray(jv), tnp(tv)):
            assert (v == 0).sum() >= k and not np.signbit(v[v == 0]).any()
        np.testing.assert_array_equal(_bits(tnp(tv)), _bits(jv))
        np.testing.assert_array_equal(tnp(ti), np.asarray(ji))


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("metric,jmetric", METRICS)
def test_all_worst_rows(k, metric, jmetric):
    """A chunk of nothing but worst values (inactive row slots) into a
    running result that is empty, then half full: worst values keep id
    -1."""
    B, W = 3, 700
    w = worst_value(metric)
    s = np.full((B, W), w, np.float32)
    si = np.arange(W, dtype=np.int32)[None].repeat(B, 0)  # ids ignored
    rv, ri = _init(B, k, metric)
    tv, ti = _check(rv, ri, s, si, k, metric, jmetric)
    assert (ti == -1).all() and (tv == w).all()
    half = (k + 1) // 2
    rv[:, :half] = np.arange(half, dtype=np.float32) * (1 if w > 0 else -1)
    ri[:, :half] = np.arange(half, dtype=np.int32) + 7
    tv, ti = _check(rv, ri, s, si, k, metric, jmetric)
    np.testing.assert_array_equal(ti[:, :half], ri[:, :half])
    assert (ti[:, half:] == -1).all()


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
def test_nan_ranks_as_the_largest_value(metric):
    """No scan emits NaN; the rule is torch.sort's: last for L2, first for
    IP, in position order."""
    s = torch.tensor([[1.0, float("nan"), 0.5, float("nan"), 2.0]])
    si = torch.arange(5, dtype=torch.int32)[None]
    rv, ri = init_topk((1,), 0, metric, DEVICE)
    v, i = merge_topk_verified(rv, ri, s, si, 5, metric)
    want = [2, 0, 4, 1, 3] if metric is Metric.L2 else [1, 3, 4, 0, 2]
    assert tnp(i)[0].tolist() == want
    mv, mi = topk_merge_model(rv, ri, s, si, 5, metric, n_seg=2)
    assert torch.equal(mi, i) and torch.equal(mv.view(torch.int32),
                                              v.view(torch.int32))


def _model_cases():
    """(name, rvals, rids, scores, ids, k, metric) of every kind above."""
    rng = np.random.RandomState(6)
    out = []
    B, W = 3, 3000
    for metric in (Metric.L2, Metric.IP):
        w = worst_value(metric)
        sgn = 1.0 if metric is Metric.L2 else -1.0
        for k in (1, 10, 100):
            rv = np.full((B, k), w, np.float32)
            ri = np.full((B, k), -1, np.int32)
            ids = np.arange(B * W, dtype=np.int32).reshape(B, W)
            full = np.sort(rng.rand(B, k), 1).astype(np.float32) * sgn
            masked = np.full((B, W), w, np.float32)
            for b, n_real in enumerate([3, k, 200]):
                p = rng.choice(W, n_real, replace=False)
                masked[b, p] = rng.rand(n_real)
            zeros = np.where(rng.rand(B, W) < 0.5, 0.0, -0.0)
            zeros[rng.rand(B, W) < 0.3] = sgn
            nan = rng.rand(B, W)
            nan[rng.rand(B, W) < 0.1] = np.nan
            for name, r_v, s in (
                    ("random", rv, rng.rand(B, W) * 100),
                    ("full running", full, rng.rand(B, W)),
                    ("ties", rv, np.round(rng.rand(B, W) * 4)),
                    ("signed zeros", rv, zeros),
                    ("nan", rv, nan),
                    ("all worst", rv, np.full((B, W), w)),
                    ("masked", rv, masked),
                    ("worst first", rv, np.sort(rng.rand(B, W), 1)[:, ::-1]
                     * sgn),
                    ("narrow", rv, rng.rand(B, 7))):
                s = np.ascontiguousarray(s, np.float32)
                out.append((f"{name} k{k} {metric.name}", _t(r_v, np.float32),
                            _t(ri, np.int32), _t(s, np.float32),
                            _t(ids[:, :s.shape[1]], np.int32), k, metric))
    return out


# (step, buffer, largest k kept in shared memory, unaligned head, the most
# final keys ranked without a select): the kernel's, and small ones that
# make every segment stream and select many times, the last with the
# large-k buffers for every k above 16
MODEL_SHAPES = ((2048, 4096, 1024, 0, 256), (256, 384, 128, 1, 64),
                (64, 96, 16, 3, 8))


def _model_equal(cases, n_seg):
    for name, rv, ri, s, si, k, metric in cases:
        want = topk_merge_ref(rv, ri, s, si, k, metric)
        for step, cap, max_smem_k, head, whole in MODEL_SHAPES:
            got = topk_merge_model(rv, ri, s, si, k, metric, n_seg,
                                   step=step, cap=cap, max_smem_k=max_smem_k,
                                   head=head, rank_max=whole)
            assert torch.equal(got[0].view(torch.int32),
                               want[0].view(torch.int32)), (name, step)
            assert torch.equal(got[1], want[1]), (name, step)


@pytest.mark.parametrize("n_seg", range(1, 9))
def test_kernel_model_matches_the_sort(n_seg):
    """The kernel's selection (the running bound, segments, the radix
    select, the shared threshold, the pool's merge) bit for bit the stable
    sort, at the kernel's step and buffer and at small ones."""
    _model_equal(_model_cases(), n_seg)


@pytest.mark.parametrize("n_seg", [3, 12])
def test_kernel_model_at_k_segments_and_more(n_seg):
    """A row's segments also bound its k-th by the largest of their j-th
    best keys (j = ceil(k / segments): each segment's best key at k
    segments and more); the running result out of order still bounds it
    by its first k keys' largest."""
    rng = np.random.RandomState(9)
    B, W, k = 2, 900, 3
    cases = []
    for metric in (Metric.L2, Metric.IP):
        sgn = 1.0 if metric is Metric.L2 else -1.0
        ids = _t(np.arange(B * W).reshape(B, W), np.int32)
        rv = _t(rng.rand(B, k + 2) * sgn, np.float32)  # not sorted
        ri = _t(np.arange(B * (k + 2)).reshape(B, -1) + 10**6, np.int32)
        for name, s in (("random", rng.rand(B, W) * sgn),
                        ("ties", np.round(rng.rand(B, W) * 2) * sgn)):
            cases.append((name, rv, ri, _t(s, np.float32), ids, k, metric))
    _model_equal(cases, n_seg)


def test_segments_and_the_cpu_route():
    """Segments fill the card's resident blocks with B rows, each of
    SEGMENT_MIN positions at least, one once the batch fills half; on the
    CPU the wrapper is its plain version and takes any k."""
    fill = BLOCKS_PER_SM * 132
    assert segments(fill, 19836, 132) == 1
    assert segments(fill // 2 + 1, 1 << 20, 132) == 1
    assert segments(256, 65636, 132) == fill // 256
    assert segments(1, 16484, 132) == -(-16484 // SEGMENT_MIN)
    assert segments(1, 1 << 24, 132) == fill
    assert segments(1, 50, 132) == 1
    rng = np.random.RandomState(7)
    s = _t(rng.rand(2, 400), np.float32)
    si = _t(rng.randint(0, 99, (2, 400)), np.int32)
    rv, ri = init_topk((2,), 200, Metric.L2, DEVICE)
    v, i = topk_merge(rv, ri, s, si, 200, Metric.L2)
    wv, wi = topk_merge_ref(rv, ri, s, si, 200, Metric.L2)
    assert torch.equal(v, wv) and torch.equal(i, wi)
    with pytest.raises(TypeError):
        topk_merge(rv.double(), ri, s, si, 10, Metric.L2)
    with pytest.raises(ValueError):
        topk_merge(rv, ri, s[:1], si[:1], 10, Metric.L2)


@pytest.mark.parametrize("rows", [False, True])
def test_scan_probe_range_unchanged(rows, monkeypatch):
    """On the shared fixture, padded lists (K2's plain version) and rows
    (K1's), ragged starts and limits over several chunks: the same bits
    with the merge inline as before, and with the kernel's model as the
    merge."""
    f = jax_fixture()
    _, arrays, mr, _ = port_state()
    target = mr.rows if rows else arrays
    rng = np.random.RandomState(8)
    q = torch.from_numpy(f["xq"][:24])
    B, k = q.shape[0], K
    _, cids = tscan.coarse_rank(arrays, q, Metric.L2)
    probes = mr.row_table[cids.long()].reshape(B, -1) if rows else cids
    probes = probes.clamp_min(0).to(torch.int32).contiguous()
    start = torch.from_numpy(rng.randint(0, 6, B).astype(np.int32))
    limit = start + torch.from_numpy(rng.randint(0, 9, B).astype(np.int32))

    def run():
        vals, ids = init_topk((B,), k, Metric.L2, DEVICE)
        return tscan.scan_probe_range(target, q, sqnorms(q), probes, vals,
                                      ids, limit, start, 7, Metric.L2,
                                      probe_chunk=3)

    got = run()
    for merge in (topk_merge_ref,
                  lambda *a: topk_merge_model(*a, n_seg=3)):
        monkeypatch.setattr(tscan, "merge_topk_verified", merge)
        want = run()
        assert torch.equal(got[0].view(torch.int32),
                           want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
    assert (got[1] >= 0).any()
