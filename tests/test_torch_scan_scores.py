"""K2, the padded-layout probe scan: the port's plain version against the
Pallas kernel in interpret mode (rtol = atol = 1e-5, as
tests/test_pallas_kernels.py runs it), the one place where the two differ
on purpose (an exact-zero stored vector), the list_sizes invariant the
kernel relies on, and the wrapper's contract. The CUDA kernel itself is
tested on a card in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import D, DEVICE, NLIST, jax_fixture, port_state, tnp
from auncel_tpu.pallas_kernels.scan_scores import CHUNK, scan_scores_pallas
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.kernels.scan_scores import scan_scores, scan_scores_ref
from auncel_tpu_torch.types import Metric

# one shape for every Pallas call below, so each metric compiles once
N_LISTS, CAP, DIM, B, N_SLOTS = 6, 16, 8, 3, CHUNK


def _layout(rng):
    """Padded lists as _pack lays them out: live slots are a ragged prefix
    (ids >= 0), padding is zero with id -1; entries ~ N(0, 1/d), so every
    score is O(1) and fp32 sum order stays far inside 1e-5."""
    sizes = rng.randint(1, CAP + 1, N_LISTS).astype(np.int32)
    sizes[0] = CAP
    live = np.arange(CAP)[None, :] < sizes[:, None]
    ids = np.where(live, np.arange(N_LISTS * CAP).reshape(N_LISTS, CAP), -1)
    db = (rng.randn(N_LISTS, CAP, DIM) / np.sqrt(DIM)).astype(np.float32)
    db[~live] = 0.0
    q = (rng.randn(B, DIM) / np.sqrt(DIM)).astype(np.float32)
    return db, ids.astype(np.int32), sizes, q


def _port(db, ids, sizes, q, lists, metric):
    t = torch.from_numpy
    q_t = t(q)
    db_t = t(db)
    return scan_scores(db_t, (db_t * db_t).sum(-1), t(ids), t(sizes), q_t,
                       (q_t * q_t).sum(-1), t(lists), metric)


def _pallas(db, q, lists, metric):
    return np.asarray(scan_scores_pallas(
        jnp.asarray(db), jnp.asarray(q), jnp.asarray(lists), N_SLOTS, metric,
        interpret=True))


@pytest.mark.parametrize("metric,jmetric", [(Metric.L2, JMetric.L2),
                                            (Metric.IP, JMetric.IP)])
def test_plain_version_matches_pallas_interpret(metric, jmetric):
    rng = np.random.RandomState(7)
    db, ids, sizes, q = _layout(rng)
    lists = rng.randint(0, N_LISTS, (B, N_SLOTS)).astype(np.int32)
    scores, got_ids = _port(db, ids, sizes, q, lists, metric)
    want = _pallas(db, q, lists, jmetric)
    np.testing.assert_allclose(tnp(scores), want, rtol=1e-5, atol=1e-5)
    want_ids = ids[lists].reshape(B, N_SLOTS * CAP)
    np.testing.assert_array_equal(tnp(got_ids), want_ids)
    assert (np.isinf(want) == (want_ids < 0)).all()


def test_exact_zero_vector_is_a_result_in_the_port_only():
    """The deliberate difference: the Pallas kernel takes zero norm for
    padding, so an exact-zero stored vector scores +inf there; the port
    follows the JAX package's XLA scan (padding by id), where it scores
    q_sq like any other vector at distance ||q||."""
    rng = np.random.RandomState(7)
    db, ids, sizes, q = _layout(rng)
    db[0, 3] = 0.0                      # live slot (list 0 is full), id 3
    lists = np.zeros((B, N_SLOTS), np.int32)
    scores, got_ids = _port(db, ids, sizes, q, lists, Metric.L2)
    want = _pallas(db, q, lists, JMetric.L2)
    assert np.isposinf(want[:, 3]).all()
    q_t = torch.from_numpy(q)
    np.testing.assert_array_equal(tnp(scores)[:, 3], tnp((q_t * q_t).sum(-1)))
    assert (tnp(got_ids)[:, 3] == ids[0, 3]).all()
    other = np.ones(N_SLOTS * CAP, bool)
    other[3::CAP] = False
    np.testing.assert_allclose(tnp(scores)[:, other], want[:, other],
                               rtol=1e-5, atol=1e-5)


def test_padded_layout_ids_end_at_list_sizes():
    """K2 skips every slot at or past list_sizes[l] without reading its id;
    that is right only because those slots all carry id -1, in the JAX
    package's packing (carried into the port) and in the port's own."""
    f = jax_fixture()
    ours = IVFFlatIndex(D, NLIST, device=DEVICE)
    ours.set_centroids(f["centers"])
    ours.add(f["xb"])
    for a in (port_state()[1], ours.arrays):
        ids, sizes = tnp(a.vec_ids), tnp(a.list_sizes)
        past = np.arange(ids.shape[1])[None, :] >= sizes[:, None]
        assert (ids[past] == -1).all()
        assert (ids[~past] >= 0).all()
        assert sizes.sum() == f["xb"].shape[0]


def _numpy_scan(db, ids, sizes, q, lists, metric):
    """Slot-by-slot statement of the contract."""
    nlist, cap, _ = db.shape
    worst = np.inf if metric is Metric.L2 else -np.inf
    n_b, n_s = lists.shape
    scores = np.full((n_b, n_s, cap), worst, np.float32)
    out_ids = np.full((n_b, n_s, cap), -1, np.int32)
    for b in range(n_b):
        for s in range(n_s):
            if lists[b, s] < 0:
                continue
            l = min(lists[b, s], nlist - 1)
            for c in range(min(sizes[l], cap)):
                if ids[l, c] < 0:
                    continue
                dot = float(db[l, c] @ q[b])
                scores[b, s, c] = (max(float(q[b] @ q[b])
                                       + float(db[l, c] @ db[l, c])
                                       - 2.0 * dot, 0.0)
                                   if metric is Metric.L2 else dot)
                out_ids[b, s, c] = ids[l, c]
    return scores.reshape(n_b, -1), out_ids.reshape(n_b, -1)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
def test_inactive_slots_ragged_lists_and_clamped_ids(metric):
    """List id -1 is an inactive slot, ids >= nlist clamp, a dead id inside
    a list is masked, and n_slots need not be a multiple of 8."""
    rng = np.random.RandomState(8)
    db, ids, sizes, q = _layout(rng)
    ids[2, 0] = -1
    lists = np.asarray([[0, -1, 2, 5, 9], [-1, -1, -1, -1, -1],
                        [3, 3, 1, -7, 4]], np.int32)
    scores, got_ids = _port(db, ids, sizes, q, lists, metric)
    want, want_ids = _numpy_scan(db, ids, sizes, q, lists, metric)
    np.testing.assert_allclose(tnp(scores), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tnp(got_ids), want_ids)
    assert scores.shape == (B, 5 * CAP)


def test_cpu_runs_plain_version_without_counting():
    rng = np.random.RandomState(9)
    db, ids, sizes, q = _layout(rng)
    lists = rng.randint(-1, N_LISTS, (B, 5)).astype(np.int32)
    before = scan_scores.launches
    got = _port(db, ids, sizes, q, lists, Metric.L2)
    assert scan_scores.launches == before
    t = torch.from_numpy
    db_t, q_t = t(db), t(q)
    want = scan_scores_ref(db_t, (db_t * db_t).sum(-1), t(ids), t(sizes), q_t,
                           (q_t * q_t).sum(-1), t(lists), Metric.L2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_rejects_bad_inputs():
    db = torch.zeros(4, 3, 8)
    args = [db, torch.zeros(4, 3), torch.zeros(4, 3, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32), torch.zeros(5, 8),
            torch.zeros(5), torch.zeros(5, 2, dtype=torch.int32)]

    def call(i, value, metric=Metric.L2):
        a = list(args)
        a[i] = value
        return scan_scores(*a, metric)

    assert call(0, db)[0].shape == (5, 6)
    with pytest.raises(TypeError):
        call(0, db.double())
    with pytest.raises(TypeError):
        call(6, args[6].long())
    with pytest.raises(TypeError):
        call(0, db, metric="l2")
    with pytest.raises(ValueError):
        call(5, torch.zeros(4))
    with pytest.raises(ValueError):
        call(1, torch.zeros(4, 2))
    with pytest.raises(ValueError):
        call(0, db[:0])
    # a tensor off the CPU never takes the plain version
    with pytest.raises(ValueError):
        scan_scores(*[a.to("meta") for a in args], Metric.L2)
