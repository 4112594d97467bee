"""The storage codecs (SQ8, SQ4, SQ6, SQ8u, SQ8-direct, bf16), port against
the JAX package on the shared fixture's data: the SQ helpers, the decode,
the packing of the port's own ``_pack``, ``build_multirow`` on codes, and
``scan_probe_range`` on the same carried-over state on both layouts and
both metrics (ids equal, values within 1e-5 of q_sq + db_sq). PQ storage
is in tests/test_torch_pq.py; the multi-row layout still refuses it.
ErrorSys on SQ8 is in tests/test_torch_sq_engine.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_parity import (D, DEVICE, NLIST, as_numpy, codec_fixture,
                          jax_fixture, tnp)
from auncel_tpu.index import flat as jflat
from auncel_tpu.index import multirow as jmr
from auncel_tpu.index import scan as jscan
from auncel_tpu.ops.topk import init_topk as j_init_topk
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch import IVFFlatIndex, convert
from auncel_tpu_torch.index import flat as tflat
from auncel_tpu_torch.index import scan as tscan
from auncel_tpu_torch.index.multirow import build_multirow
from auncel_tpu_torch.ops.sq import sq_decode_dev
from auncel_tpu_torch.ops.topk import init_topk
from auncel_tpu_torch.types import Metric

STORAGES = ("sq8", "sq4", "sq6", "sq8u", "sq8d", "bf16")
QTYPES = ("sq8", "sq4", "sq6", "sq8u", "sq4u", "sq8d")
NPROBE, K, B = 6, 10, 20


def test_sq_helpers_match_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(500, D) * 7 + 2).astype(np.float32)
    for qt in QTYPES:
        assert tflat.sq_levels(qt) == jflat.sq_levels(qt)
        assert tflat.sq_code_width(D, qt) == jflat.sq_code_width(D, qt)
        codes = rng.randint(0, int(tflat.sq_levels(qt)) + 1,
                            (50, D)).astype(np.uint8)
        np.testing.assert_array_equal(tflat.sq_pack(codes, qt),
                                      jflat.sq_pack(codes, qt))
        for stat, arg in (("minmax", 0.0), ("minmax", 0.1),
                          ("meanstd", 0.0), ("meanstd", 2.5),
                          ("quantiles", 0.0), ("quantiles", 0.05)):
            for a, b in zip(tflat.sq_train_range(x, qt, stat, arg),
                            jflat.sq_train_range(x, qt, stat, arg)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("qt", ["sq8", "sq4", "sq6"])
def test_sq_decode_bitwise_as_jax(qt):
    """The port's decode (a multiply, then an add) equals the JAX package's
    sq_decode_dev run eagerly bit for bit. Under jit, XLA:CPU contracts
    the two into one FMA, which can differ by an ulp of the product."""
    rng = np.random.RandomState(5)
    scale = (rng.rand(D) * 0.37 + 0.01).astype(np.float32)
    bias = (rng.randn(D) * 10).astype(np.float32)
    codes = rng.randint(0, int(tflat.sq_levels(qt)) + 1,
                        (300, D)).astype(np.uint8)
    packed = tflat.sq_pack(codes, qt)
    want = np.asarray(jscan.sq_decode_dev(jnp.asarray(packed), D,
                                          jnp.asarray(scale),
                                          jnp.asarray(bias)))
    got = tnp(sq_decode_dev(torch.from_numpy(packed), D,
                            torch.from_numpy(scale), torch.from_numpy(bias)))
    assert got.shape == (300, D)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _bits(a: np.ndarray) -> np.ndarray:
    """A stored tensor's bytes as integers (bf16 by its bits)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("storage", STORAGES)
def test_pack_and_multirow_match_jax(storage):
    """The port's own build on the same centroids and vectors stores the
    JAX package's codes (or bf16 values), ids and list sizes exactly and
    decoded norms within 1e-6; build_multirow on the carried state equals
    the JAX layout field by field."""
    f = jax_fixture()
    jidx = codec_fixture(storage)
    ja = as_numpy(jidx.arrays)
    idx = IVFFlatIndex(D, NLIST, storage=storage, device=DEVICE)
    idx.set_centroids(f["centers"])
    idx.add(f["xb"])
    a = idx.arrays
    assert a.db.dtype == {"bf16": torch.bfloat16}.get(storage, torch.uint8)
    db = a.db.view(torch.int16) if storage == "bf16" else a.db
    np.testing.assert_array_equal(tnp(db), _bits(ja["db"]).view(
        np.int16 if storage == "bf16" else np.uint8))
    np.testing.assert_array_equal(tnp(a.vec_ids), ja["vec_ids"])
    np.testing.assert_array_equal(tnp(a.list_sizes), ja["list_sizes"])
    np.testing.assert_allclose(tnp(a.db_sq), ja["db_sq"], rtol=1e-6)
    if storage != "bf16":
        np.testing.assert_array_equal(tnp(a.sq_scale), ja["sq_scale"])
        np.testing.assert_array_equal(tnp(a.sq_bias), ja["sq_bias"])

    carried = convert.ivf_arrays_from_numpy(ja, DEVICE)
    mr = build_multirow(carried, 64)
    jm = as_numpy(jidx.multirow)
    for name in ("row_table", "rows_per_list", "row_base", "row_list"):
        np.testing.assert_array_equal(tnp(getattr(mr, name)), jm[name])
    rows, jrows = mr.rows, jm["rows"]
    rdb = rows.db.view(torch.int16) if storage == "bf16" else rows.db
    np.testing.assert_array_equal(tnp(rdb), _bits(jrows["db"]).view(
        np.int16 if storage == "bf16" else np.uint8))
    for name in ("db_sq", "vec_ids", "list_sizes"):
        np.testing.assert_array_equal(tnp(getattr(rows, name)),
                                      jrows[name])
    assert (rows.sq_scale is None) == (jrows["sq_scale"] is None)


def _probes(jidx, q, rows: bool):
    """Both packages' scan inputs for one batch: ranked probe lists (row
    slots on the multi-row layout) with per-query limits from a seeded
    draw, as numpy arrays."""
    rng = np.random.RandomState(9)
    a = jidx.arrays
    _, cids = jscan.coarse_rank(a, jnp.asarray(q), JMetric.L2)
    nprobe = rng.randint(1, NPROBE + 1, size=q.shape[0]).astype(np.int32)
    if not rows:
        return np.array(cids), nprobe, NPROBE
    mr = jidx.multirow
    out_slots = int(np.sort(np.asarray(mr.rows_per_list))[::-1][
        :NPROBE].sum())
    slots, offsets = jmr.expand_probes(mr, cids, NPROBE, out_slots)
    limit = np.take_along_axis(np.asarray(offsets), nprobe[:, None] - 1,
                               axis=1)[:, 0].astype(np.int32)
    return np.maximum(np.array(slots), 0), limit, out_slots


@pytest.mark.parametrize("storage", STORAGES)
def test_scan_probe_range_matches_jax(storage):
    f = jax_fixture()
    jidx = codec_fixture(storage)
    q = f["xq"][:B]
    q_sq = (q * q).sum(1)
    for rows in (False, True):
        jarr = jidx.multirow.rows if rows else jidx.arrays
        state = as_numpy(jidx.multirow if rows else jidx.arrays)
        tarr = (convert.multirow_from_numpy(state, DEVICE).rows if rows
                else convert.ivf_arrays_from_numpy(state, DEVICE))
        assert isinstance(tarr, tscan.RowArrays) == rows
        probes, limit, width = _probes(jidx, q, rows)
        for metric, jmetric in ((Metric.L2, JMetric.L2),
                                (Metric.IP, JMetric.IP)):
            jv, ji = j_init_topk((B,), K, jmetric)
            jv, ji = jscan.scan_probe_range(
                jarr, jnp.asarray(q), jnp.asarray(q_sq),
                jnp.asarray(probes), jv, ji, jnp.asarray(limit), 0, width,
                jmetric)
            tv, ti = init_topk((B,), K, metric, DEVICE)
            tv, ti = tscan.scan_probe_range(
                tarr, torch.from_numpy(q), torch.from_numpy(q_sq),
                torch.from_numpy(probes), tv, ti, torch.from_numpy(limit),
                0, width, metric)
            ji = np.asarray(ji)
            np.testing.assert_array_equal(tnp(ti), ji)
            norms = np.zeros(f["xb"].shape[0] + 1, np.float32)
            live = state["vec_ids"] >= 0 if not rows else \
                state["rows"]["vec_ids"] >= 0
            src = state if not rows else state["rows"]
            norms[src["vec_ids"][live]] = src["db_sq"][live]
            terms = q_sq[:, None] + norms[ji]
            assert (np.abs(tnp(tv) - np.asarray(jv)) <= 1e-5 * terms).all()


def test_pq_storage_still_raises():
    """PQ storage is ported on the padded layout (tests/test_torch_pq.py);
    what still raises: the multi-row layout and K1 on PQ codes, and uint8
    codes that come with neither an SQ range nor PQ codebooks."""
    state = as_numpy(codec_fixture("sq8").arrays)
    a = convert.ivf_arrays_from_numpy(state, DEVICE)
    books = torch.zeros((4, 256, D // 4))
    pq = a._replace(db=a.db[:, :, :4].contiguous(), sq_scale=None,
                    sq_bias=None, pq_codebooks=books, pq_residual=True)
    tscan.check_storage(pq)
    with pytest.raises(AssertionError):
        build_multirow(pq, 64)
    from auncel_tpu_torch.kernels.rowscan import rowscan_scores
    with pytest.raises(ValueError):
        rowscan_scores(pq.db, pq.db_sq, pq.vec_ids, pq.list_sizes,
                       torch.ones(2, D), torch.ones(2),
                       torch.zeros(2, 1, dtype=torch.int32), Metric.L2,
                       pq_codebooks=books)
    with pytest.raises(NotImplementedError):
        tscan.check_storage(a._replace(sq_scale=None, sq_bias=None))


@pytest.mark.parametrize("storage", ["sq8", "sq6", "bf16"])
def test_from_state_keeps_the_codes(storage):
    """An index built on carried coded state serves it as it is, with the
    storage its arrays hold; on SQ storage a later add re-encodes the same
    codes (the SQ range is kept, and the decoded vectors are assigned as
    before)."""
    f = jax_fixture()
    state = as_numpy(codec_fixture(storage).arrays)
    arrays = convert.ivf_arrays_from_numpy(state, DEVICE)
    idx = IVFFlatIndex.from_state(f["centers"], arrays)
    assert idx.storage == storage
    assert idx.arrays is arrays
    if storage == "bf16":
        return
    idx.add(np.zeros((0, D), np.float32))
    repacked = idx.arrays
    assert repacked is not arrays
    np.testing.assert_array_equal(tnp(repacked.vec_ids), state["vec_ids"])
    assert torch.equal(repacked.db, arrays.db)
    assert torch.equal(repacked.sq_scale, arrays.sq_scale)
    assert torch.equal(repacked.sq_bias, arrays.sq_bias)


def test_scan_wrappers_take_the_codecs():
    """Both kernel wrappers take f32, bf16 and uint8 storage (with the SQ
    range) on the CPU through their plain version, and refuse what the
    kernels do not take."""
    from auncel_tpu_torch.kernels.rowscan import rowscan_scores
    from auncel_tpu_torch.kernels.scan_scores import scan_scores
    rng = np.random.RandomState(2)
    n, cap, d, B = 4, 8, 12, 3
    db = torch.from_numpy(rng.randint(0, 256, (n, cap, d)).astype(np.uint8))
    sq = dict(sq_scale=torch.full((d,), 0.01), sq_bias=torch.zeros(d))
    rest = (torch.ones(n, cap), torch.arange(n * cap, dtype=torch.int32)
            .reshape(n, cap), torch.full((n,), cap, dtype=torch.int32),
            torch.ones(B, d), torch.ones(B) * d,
            torch.zeros(B, 2, dtype=torch.int32))
    for fn in (scan_scores, rowscan_scores):
        s, i = fn(db, *rest, Metric.L2, **sq)
        assert s.shape == i.shape == (B, 2 * cap)
        for stored in (db.float(), db.float().to(torch.bfloat16)):
            fn(stored, *rest, Metric.IP)
        with pytest.raises(ValueError):      # codes without their range
            fn(db, *rest, Metric.L2)
        with pytest.raises(ValueError):      # a range with f32 vectors
            fn(db.float(), *rest, Metric.L2, **sq)
        with pytest.raises(ValueError):      # no SQ packing of d = 12
            fn(db[:, :, :5].contiguous(), *rest, Metric.L2, **sq)
        with pytest.raises(TypeError):
            fn(db.to(torch.int16), *rest, Metric.L2)
