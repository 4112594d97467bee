"""The polysemous Hamming filter inside K2, and the order in which K2 sums
PQ dots, on the CPU. K2's plain version with ``qcodes``/``ht``
(``scan_scores_ref``) against the JAX package's masked scan
(``auncel_tpu/index/scan.py``'s ``scan_probe_range`` with ``qcodes``), on
residual and plain PQ codes, both metrics, at M 16 and M 3 (d 48) and at
Hamming thresholds 0, 4M and 8M; the wrapper's refusals of the filter's
arguments and its limit on M; and a numpy model of the kernel's ADC sums
(the lookup table of each (query, list), then the M lookups added in
order of subspace) within the card tests' band of the JAX scores.

The state is made from a seed with numpy: random codes, codebooks and
centroids, ragged lists, and query codes that lie 0 to 4M bits from one
stored code of each probed list, so that every threshold keeps some codes
and drops others."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from auncel_tpu.index import scan as jscan
from auncel_tpu.ops.topk import init_topk as j_init_topk
from auncel_tpu.types import Metric as JMetric
from auncel_tpu_torch.convert import ivf_arrays_from_numpy
from auncel_tpu_torch.index import scan as tscan
from auncel_tpu_torch.kernels.scan_scores import (
    check_pq_fits, max_pq_m, pq_shared_bytes, scan_scores, scan_scores_ref)
from auncel_tpu_torch.types import Metric
from torch_parity import tnp

D, NLIST, CAP, B, S = 48, 6, 40, 10, 3
CASES = [(M, res, metric) for M in (16, 3) for res in (True, False)
         for metric in ("l2", "ip")]


@functools.lru_cache(maxsize=None)
def _state(M: int, residual: bool) -> dict:
    """Numpy IVF-PQ state (the JAX IVFArrays fields), queries, probes
    (distinct lists a query, some inactive) and per-probe query codes."""
    rng = np.random.RandomState(7 * M + residual)
    centroids = rng.randn(NLIST, D).astype(np.float32)
    books = (0.5 * rng.randn(M, 256, D // M)).astype(np.float32)
    codes = rng.randint(0, 256, (NLIST, CAP, M)).astype(np.uint8)
    sizes = rng.randint(CAP // 2, CAP + 1, NLIST).astype(np.int32)
    live = np.arange(CAP)[None, :] < sizes[:, None]
    ids = np.where(live, np.arange(NLIST * CAP).reshape(NLIST, CAP),
                   -1).astype(np.int32)
    ids[1, 2] = -1   # a dead id inside a list
    dec = books[np.arange(M)[None, None, :], codes].reshape(NLIST, CAP, D)
    db_sq = np.where(ids >= 0, (dec * dec).sum(-1), 0.0).astype(np.float32)
    q = (centroids[rng.randint(0, NLIST, B)]
         + 0.7 * rng.randn(B, D)).astype(np.float32)
    lists = np.stack([rng.permutation(NLIST)[:S] for _ in range(B)])
    lists = np.where(rng.rand(B, S) < 0.2, -1, lists).astype(np.int32)
    # each probe's query code: a stored code of its list with 0 to 4M bits
    # flipped (none on each query's first probe)
    qcodes = codes[np.maximum(lists, 0), rng.randint(0, CAP // 2, (B, S))]
    flips = np.zeros((B, S, 8 * M), np.uint8)
    n_flip = rng.randint(0, 4 * M + 1, (B, S))
    n_flip[:, 0] = 0
    for b in range(B):
        for s in range(S):
            flips[b, s, rng.permutation(8 * M)[:n_flip[b, s]]] = 1
    qcodes = qcodes ^ np.packbits(flips, axis=-1)
    state = dict(centroids=centroids,
                 cent_sq=(centroids * centroids).sum(1),
                 db=codes, db_sq=db_sq, vec_ids=ids, list_sizes=sizes,
                 interdis=np.zeros((NLIST, NLIST), np.float32),
                 pq_codebooks=books, pq_residual=() if residual else None)
    return dict(state=state, q=q, lists=lists, qcodes=qcodes)


def _jax_arrays(state: dict) -> jscan.IVFArrays:
    return jscan.IVFArrays(**{k: (v if k == "pq_residual" else
                                  jnp.asarray(v)) for k, v in state.items()})


def _port_args(st: dict):
    a = ivf_arrays_from_numpy(st["state"], "cpu")
    q = torch.from_numpy(st["q"])
    args = (a.db, a.db_sq, a.vec_ids, a.list_sizes, q, (q * q).sum(1),
            torch.from_numpy(st["lists"]))
    return a, args


def _jax_scores(st: dict, metric: str, ht=None) -> list:
    """The JAX scan of every query's active probes, unfiltered or with the
    filter at ``ht``, with a top-k as wide as the probes' slots: per query
    {id: score} of its live candidates."""
    lists, q = st["lists"], st["q"]
    # the JAX scan takes a query's active probes as its first slots
    order = np.argsort(lists < 0, axis=1, kind="stable")
    sorted_lists = np.take_along_axis(lists, order, 1)
    kw = {}
    if ht is not None:
        kw = dict(qcodes=jnp.asarray(np.take_along_axis(
            st["qcodes"], order[:, :, None], 1)), ht=jnp.int32(ht))
    jm = JMetric.parse(metric)
    jv, ji = jscan.scan_probe_range(
        _jax_arrays(st["state"]), jnp.asarray(q),
        jnp.asarray((q * q).sum(1)), jnp.asarray(np.maximum(sorted_lists, 0)),
        *j_init_topk((B,), S * CAP, jm),
        jnp.asarray((lists >= 0).sum(1).astype(np.int32)), 0, S, jm, **kw)
    jv, ji = np.asarray(jv), np.asarray(ji)
    return [{int(i): float(v) for i, v in zip(ji[b], jv[b]) if i >= 0}
            for b in range(B)]


def _terms(st: dict, b: int, keys: np.ndarray, metric: str) -> np.ndarray:
    """Magnitudes of the score terms of query b's candidates ``keys``:
    ||q - c_l||^2 + db_sq (L2) or |<c_l, q>| + ||q|| ||r|| (IP), c_l zero
    for plain PQ (ids are l * CAP + slot)."""
    s = st["state"]
    l, c = keys // CAP, keys % CAP
    cl = (s["centroids"][l] if s["pq_residual"] is not None
          else np.zeros((len(keys), D), np.float32))
    q = st["q"][b]
    norms = s["db_sq"][l, c]
    if metric == "l2":
        return ((q - cl) ** 2).sum(-1) + norms
    return np.abs(cl @ q) + np.sqrt(q @ q) * np.sqrt(norms)


def _by_id(scores, ids) -> list:
    sc, si = tnp(scores), tnp(ids)
    return [{int(i): float(v) for i, v in zip(si[b], sc[b]) if i >= 0}
            for b in range(B)]


def _close(st: dict, mine: list, ref: list, metric: str) -> None:
    for b in range(B):
        assert mine[b].keys() == ref[b].keys()
        keys = np.fromiter(ref[b], np.int64)
        diff = np.abs(np.array([mine[b][k] for k in keys])
                      - np.array([ref[b][k] for k in keys]))
        assert (diff <= 1e-5 * _terms(st, b, keys, metric) + 1e-6).all()


@pytest.mark.parametrize("M, residual, metric", CASES)
def test_filtered_plain_version_matches_jax(M, residual, metric):
    """scan_scores_ref with qcodes/ht keeps exactly the candidates the JAX
    scan keeps at ht 0, 4M and 8M, with scores within 1e-5 of their
    terms; the thresholds keep some codes and drop others."""
    st = _state(M, residual)
    a, args = _port_args(st)
    kept = []
    for ht in (0, 4 * M, 8 * M):
        scores, ids = scan_scores_ref(
            *args, Metric.parse(metric), **a.codec_kwargs(),
            qcodes=torch.from_numpy(st["qcodes"]), ht=ht)
        mine = _by_id(scores, ids)
        _close(st, mine, _jax_scores(st, metric, ht), metric)
        kept.append(sum(map(len, mine)))
    assert 0 < kept[0] < kept[1] < kept[2]


@pytest.mark.parametrize("M, residual, metric", CASES)
def test_filter_at_every_bit_is_the_unfiltered_scan(M, residual, metric):
    """At ht 8M no code is dropped: scores and ids equal the unfiltered
    plain version's bit for bit."""
    st = _state(M, residual)
    a, args = _port_args(st)
    tm = Metric.parse(metric)
    want = scan_scores_ref(*args, tm, **a.codec_kwargs())
    got = scan_scores_ref(*args, tm, **a.codec_kwargs(),
                          qcodes=torch.from_numpy(st["qcodes"]), ht=8 * M)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_wrapper_refuses_bad_filter_arguments():
    """qcodes of another dtype or shape, qcodes without ht or ht without
    qcodes, and the filter on a codec other than PQ raise, on the CPU as on
    the card."""
    st = _state(16, True)
    a, args = _port_args(st)
    kw = a.codec_kwargs()
    qc = torch.from_numpy(st["qcodes"])
    with pytest.raises(ValueError, match="uint8 qcodes"):
        scan_scores(*args, Metric.L2, **kw, qcodes=qc.to(torch.int32), ht=8)
    with pytest.raises(ValueError, match="uint8 qcodes"):
        scan_scores(*args, Metric.L2, **kw, qcodes=qc[:, :2], ht=8)
    with pytest.raises(ValueError, match="uint8 qcodes"):
        scan_scores(*args, Metric.L2, **kw, qcodes=qc[..., :15], ht=8)
    with pytest.raises(TypeError, match="int ht"):
        scan_scores(*args, Metric.L2, **kw, qcodes=qc)
    with pytest.raises(ValueError, match="ht goes with qcodes"):
        scan_scores(*args, Metric.L2, **kw, ht=8)
    x = torch.zeros((NLIST, CAP, D))
    flat = (x, args[1], args[2], args[3], args[4], args[5], args[6])
    with pytest.raises(ValueError, match="PQ codes only"):
        scan_scores(*flat, Metric.L2, qcodes=qc, ht=8)


def test_scan_probe_range_refuses_the_filter_on_rows():
    """The multi-row layout holds no PQ codes, so the filter on its rows
    raises rather than reaching K1."""
    a, _ = _port_args(_state(16, True))
    q = torch.zeros((2, D))
    vals = torch.full((2, 3), float("inf"))
    ids = torch.full((2, 3), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="polysemous filter"):
        tscan.scan_probe_range(
            tscan.RowArrays(*a), q, q.sum(1),
            torch.zeros((2, 4), dtype=torch.int32), vals, ids,
            torch.full((2,), 4, dtype=torch.int32), 0, 4, Metric.L2,
            qcodes=torch.zeros((2, 4, 16), dtype=torch.uint8), ht=3)


def test_the_m_limit_of_the_card():
    """K2 on the card holds one query's table (M KB) and two tiles of 256
    slots' codes in a block's shared memory: M <= 147 at d 96 to 256, so d
    256 / M 32 and d 192 / M 64 fit and M = d = 256 is refused with the
    limit in the message."""
    for d in (96, 128, 192, 256):
        assert max_pq_m(d) == 147
        assert pq_shared_bytes(147, d) <= 232448 - 1024
        assert pq_shared_bytes(148, d) > 232448 - 1024
    check_pq_fits("scan_scores", 32, 256)
    check_pq_fits("scan_scores", 64, 192)
    with pytest.raises(ValueError, match=r"M <= 147 at d=256, got M=256"):
        check_pq_fits("scan_scores", 256, 256)


def _adc_model(st: dict, metric: str) -> list:
    """A numpy model of K2's PQ sums: per active (query, probe) the table
    T[m][c] = sum_j r[m * dsub + j] * books[m][c][j] (each step one fp32
    fused multiply-add: the product and sum in float64, rounded once),
    then each slot's dot as the M lookups added in float32 in order of m,
    and the score assembled in float32 as the kernel does."""
    s = st["state"]
    books, codes = s["pq_codebooks"], s["db"]
    M, _, dsub = books.shape
    residual = s["pq_residual"] is not None
    out = [dict() for _ in range(B)]
    for b in range(B):
        q = st["q"][b]
        for l in st["lists"][b]:
            if l < 0:
                continue
            cl = s["centroids"][l]
            if residual and metric == "l2":
                r = q - cl
                head = np.float32((r * r).sum(dtype=np.float32))
            else:
                r = q
                head = (np.float32((cl * q).sum(dtype=np.float32))
                        if residual else np.float32((q * q).sum()))
            tab = np.zeros((M, 256), np.float32)
            for j in range(dsub):
                tab = (r[np.arange(M) * dsub + j, None].astype(np.float64)
                       * books[:, :, j] + tab).astype(np.float32)
            looked = tab[np.arange(M)[None, :], codes[l]]   # [CAP, M]
            dot = np.zeros(CAP, np.float32)
            for m in range(M):
                dot = dot + looked[:, m]
            if metric == "l2":
                sc = np.maximum((head + s["db_sq"][l]) - np.float32(2) * dot,
                                np.float32(0))
            else:
                sc = head + dot if residual else dot
            live = (np.arange(CAP) < s["list_sizes"][l]) & (
                s["vec_ids"][l] >= 0)
            out[b].update({int(i): float(v) for i, v in
                           zip(s["vec_ids"][l][live], sc[live])})
    return out


@pytest.mark.parametrize("M, residual, metric", CASES)
def test_adc_sum_order_stays_in_the_band(M, residual, metric):
    """The kernel's order of summation (tables, then M lookups) keeps every
    score within 1e-5 of its terms + 1e-6 of the JAX scan's, the band of
    the card tests."""
    st = _state(M, residual)
    _close(st, _adc_model(st, metric), _jax_scores(st, metric), metric)
