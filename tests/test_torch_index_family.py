"""The index layer a user reaches through ``index_factory``, port against
the JAX package on the same data: ``FlatIndex`` (search, range search,
distance subsets), ``IndexRefineFlat``, ``IndexFlatL2BaseShift``,
``IndexFlat1D``, ``IndexScalarQuantizer`` on every qtype, ``IndexPQ`` on
the JAX package's codebooks (ADC with and without the polysemous filter,
and the HE, GHE and SDC search types), every transform (``apply`` and
``reverse`` within 1e-5), ``IndexPreTransform``, ``IndexIDMap`` and
``IndexIDMap2``, ``index_factory`` over every description the port
builds (the same class with the same parameters) and the ones it does not
(``NotImplementedError``), and the ``ht`` and ``k_factor`` knobs of
``ParameterSpace``. Ids equal; values within 1e-5 of their terms."""

import numpy as np
import pytest
import torch

import auncel_tpu.autotune as jat
import auncel_tpu.index.factory as jfac
import auncel_tpu.index.flat as jflat
import auncel_tpu.index.meta as jmeta
import auncel_tpu.index.pq_index as jpqi
import auncel_tpu.index.transform as jtr
from auncel_tpu.index.aux import IDSelectorBatch
from torch_parity import D, DEVICE, jax_fixture
import auncel_tpu_torch.autotune as tat
import auncel_tpu_torch.index.factory as tfac
import auncel_tpu_torch.index.flat as tflat
import auncel_tpu_torch.index.meta as tmeta
import auncel_tpu_torch.index.pq_index as tpqi
import auncel_tpu_torch.index.transform as ttr
from auncel_tpu_torch.ops.pq import PQCodebooks

K = 10
METRICS = ("l2", "ip")


def _data():
    f = jax_fixture()
    return f["xb"][:1500], f["xq"][:30]


def _close_ids(got, want, terms=None):
    """Equal ids; values within 1e-5 of ``terms`` (default: of 1 + the
    value itself)."""
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    scale = (1.0 + np.abs(wv)) if terms is None else terms
    assert (np.abs(gv[fin] - wv[fin]) <= 1e-5 * scale[fin]).all()


def _l2_terms(q, x, ids):
    """||q||^2 + ||x||^2 of each result, the scale of an L2 score's
    rounding."""
    return (q * q).sum(1)[:, None] + (x * x).sum(1)[np.maximum(ids, 0)]


@pytest.mark.parametrize("metric", METRICS)
def test_flat_index_matches_jax(metric):
    xb, xq = _data()
    ours, ref = tflat.FlatIndex(D, metric, device=DEVICE), jflat.FlatIndex(
        D, metric)
    for idx in (ours, ref):
        idx.add(xb)
    want = ref.search(xq, K)
    terms = _l2_terms(xq, xb, want[1]) if metric == "l2" else None
    _close_ids(ours.search(xq, K), want, terms)
    labels = np.random.RandomState(0).randint(-1, len(xb), (len(xq), 7))
    np.testing.assert_allclose(ours.compute_distance_subset(xq, labels),
                               ref.compute_distance_subset(xq, labels),
                               rtol=1e-5, atol=1e-4)
    radius = float(np.median(want[0][:, K - 1]))
    got, exp = ours.range_search(xq, radius), ref.range_search(xq, radius)
    np.testing.assert_array_equal(got.lims, exp.lims)
    np.testing.assert_array_equal(got.labels, exp.labels)
    np.testing.assert_allclose(got.distances, exp.distances, rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(ours.reconstruct(5), ref.reconstruct(5))
    keys = np.array([3, -1, 7])
    np.testing.assert_array_equal(ours.reconstruct_batch(keys),
                                  ref.reconstruct_batch(keys))
    with pytest.raises(KeyError):
        ours.reconstruct(len(xb))


def test_base_shift_and_flat1d_match_jax():
    xb, xq = _data()
    shift = np.random.RandomState(1).rand(len(xb)).astype(np.float32)
    ours = tflat.IndexFlatL2BaseShift(D, device=DEVICE)
    ref = jflat.IndexFlatL2BaseShift(D)
    for idx in (ours, ref):
        idx.add(xb, shift=shift)
    want = ref.search(xq, K)
    _close_ids(ours.search(xq, K), want, _l2_terms(xq, xb, want[1]))
    o1, r1 = tflat.IndexFlat1D(), jflat.IndexFlat1D()
    for idx in (o1, r1):
        idx.add(xb[:, 0])
    for k in (5, 2000):
        got, exp = o1.search(xq[:, 0], k), r1.search(xq[:, 0], k)
        np.testing.assert_array_equal(got[1], exp[1])
        np.testing.assert_array_equal(got[0], exp[0])


@pytest.mark.parametrize("qtype", ["sq8", "sq4", "sq6", "sq8u", "sq8d",
                                   "bf16"])
def test_scalar_quantizer_index_matches_jax(qtype):
    xb, xq = _data()
    x = xb * 3.0 if qtype == "sq8d" else xb    # direct codes: the values
    ours = tflat.IndexScalarQuantizer(D, qtype, device=DEVICE)
    ref = jflat.IndexScalarQuantizer(D, qtype)
    for idx in (ours, ref):
        idx.train(x)
        idx.add(x)
    dec = np.stack([ref.reconstruct(i) for i in range(len(x))])
    np.testing.assert_array_equal(
        np.stack([ours.reconstruct(i) for i in (0, 5, 99)]), dec[[0, 5, 99]])
    want = ref.search(xq, K)
    _close_ids(ours.search(xq, K), want, _l2_terms(xq, dec, want[1]))


@pytest.mark.parametrize("metric", METRICS)
def test_refine_flat_matches_jax(metric):
    """Exact re-ranking of an SQ4 shortlist (the base indexes hold the same
    codes), at two k_factors."""
    xb, xq = _data()
    ours = tflat.IndexRefineFlat(
        tflat.IndexScalarQuantizer(D, "sq4", metric, device=DEVICE))
    ref = jflat.IndexRefineFlat(jflat.IndexScalarQuantizer(D, "sq4",
                                                           metric))
    for idx in (ours, ref):
        idx.train(xb)
        idx.add(xb)
    for kf in (1.0, 3.0):
        want = ref.search(xq, K, k_factor=kf)
        _close_ids(ours.search(xq, K, k_factor=kf), want)
    np.testing.assert_array_equal(ours.reconstruct_n(3, 4),
                                  ref.reconstruct_n(3, 4))


def _pq_pair(metric="l2", polysemous=False):
    """(port IndexPQ, JAX IndexPQ) with M = 4 on the JAX package's trained
    codebooks (k-means++ draws differ between the frameworks), holding the
    same codes."""
    xb, _ = _data()
    ref = jpqi.IndexPQ(D, M=4, metric=metric, polysemous=polysemous)
    ref.train(xb, sa_iters=3000)
    ours = tpqi.IndexPQ(D, M=4, metric=metric, polysemous=polysemous,
                        device=DEVICE)
    ours.pq = PQCodebooks(torch.as_tensor(np.asarray(ref.pq.codebooks)))
    ours.is_trained = True
    for idx in (ours, ref):
        idx.add(xb)
    np.testing.assert_array_equal(ours._codes, ref._codes)
    return ours, ref


@pytest.mark.parametrize("metric", METRICS)
def test_index_pq_matches_jax(metric):
    """ADC with the Hamming filter off and at two thresholds (polysemous
    codebooks), and the code-domain search types."""
    _, xq = _data()
    ours, ref = _pq_pair(metric, polysemous=True)
    for ht in (0, 10, 14):
        want = ref.search(xq, K, ht=ht)
        _close_ids(ours.search(xq, K, ht=ht), want)
    types = ("he", "ghe", "sdc") if metric == "l2" else ("he", "ghe")
    for st in types:
        want = ref.search(xq, K, search_type=st)
        _close_ids(ours.search(xq, K, search_type=st), want)
    if metric == "ip":
        with pytest.raises(ValueError):
            ours.search(xq, K, search_type="sdc")


def test_index_pq_trains_and_filters():
    """The port's own training: reconstruction far better than the mean,
    and the polysemous order makes the Hamming filter keep near codes."""
    xb, xq = _data()
    idx = tpqi.IndexPQ(D, M=4, polysemous=True, device=DEVICE)
    idx.train(xb, sa_iters=3000)
    idx.add(xb)
    rec = tpqi.decode_pq(idx.pq, torch.as_tensor(idx._codes)).numpy()
    base = ((xb - xb.mean(0)) ** 2).sum(-1).mean()
    assert ((rec - xb) ** 2).sum(-1).mean() < 0.5 * base
    _, full = idx.search(xq, K)
    _, filt = idx.search(xq, K, ht=12)
    assert np.mean([len(set(a) & set(b)) for a, b in zip(full, filt)]) > 3


def _transforms(x):
    """(name, port transform, JAX transform), trained on x."""
    out = []
    pairs = (
        ("pca", lambda m: m.PCAMatrix(D, 8, **_dev(m))),
        ("pcar", lambda m: m.PCAMatrix(D, 8, random_rotation=True,
                                       **_dev(m))),
        ("pca_white", lambda m: m.PCAMatrix(D, 8, eigen_power=-0.5,
                                            **_dev(m))),
        ("rr", lambda m: m.RandomRotationMatrix(D, seed=3)),
        ("l2norm", lambda m: m.NormalizationTransform(D)),
        ("center", lambda m: m.CenteringTransform(D)),
        ("remap", lambda m: m.RemapDimensionsTransform(D, 20)),
        ("remap_nonuniform", lambda m: m.RemapDimensionsTransform(
            D, 20, uniform=False)),
    )
    for name, make in pairs:
        t, j = make(ttr), make(jtr)
        for tr in (t, j):
            tr.train(x)
        out.append((name, t, j))
    return out


def _dev(module):
    return {"device": DEVICE} if module is ttr else {}


def test_transforms_match_jax():
    xb, xq = _data()
    for name, t, j in _transforms(xb):
        y = t.apply(xq)
        np.testing.assert_allclose(y, j.apply(xq), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        if name == "pca_white":
            for tr in (t, j):
                with pytest.raises(NotImplementedError):
                    tr.reverse(y)
            continue
        np.testing.assert_allclose(t.reverse(y), j.reverse(y), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_opq_matches_jax_on_a_shared_rotation():
    """OPQ trains through k-means++ (each framework's own draws), so apply
    and reverse are held on a shared rotation; the port's own training
    lowers the PQ distortion of dimension-correlated data, as the JAX
    package's test asks."""
    rng = np.random.RandomState(4)
    z = rng.randn(3000, D // 2).astype(np.float32)
    x = np.concatenate([z, z * 0.9 + 0.1 * rng.randn(3000, D // 2)],
                       1).astype(np.float32)
    t, j = ttr.OPQMatrix(D, 4, niter=3, device=DEVICE), jtr.OPQMatrix(D, 4)
    t.train(x)
    j.rot, j.is_trained = t.rot, True
    np.testing.assert_allclose(t.apply(x[:50]), j.apply(x[:50]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(t.reverse(x[:50]), j.reverse(x[:50]),
                               rtol=1e-5, atol=1e-5)
    from auncel_tpu_torch.ops.pq import decode_pq, encode_pq, train_pq

    def pq_err(y):
        pq = train_pq(y[:2000], 4, niter=6, device=DEVICE)
        rec = decode_pq(pq, encode_pq(pq, torch.as_tensor(y))).numpy()
        return ((rec - y) ** 2).sum(-1).mean()
    assert pq_err(t.apply(x)) < pq_err(x)


def test_pretransform_and_idmap_match_jax():
    """A PCA + IDMap + Flat chain and IndexIDMap2: search, user ids,
    reconstruction through the reversed chain, and remove_ids."""
    xb, xq = _data()
    ids = np.arange(len(xb), dtype=np.int64) * 7 + 100
    t = ttr.IndexPreTransform(
        tmeta.IndexIDMap(tflat.FlatIndex(8, device=DEVICE)),
        [ttr.PCAMatrix(D, 8, device=DEVICE)])
    j = jtr.IndexPreTransform(jmeta.IndexIDMap(jflat.FlatIndex(8)),
                              [jtr.PCAMatrix(D, 8)])
    for idx in (t, j):
        idx.train(xb)
        idx.add(xb, ids=ids)
    _close_ids(t.search(xq, K), j.search(xq, K))
    m2, r2 = (tmeta.IndexIDMap2(tflat.FlatIndex(D, device=DEVICE)),
              jmeta.IndexIDMap2(jflat.FlatIndex(D)))
    for idx in (m2, r2):
        idx.add(xb, ids=ids)
    np.testing.assert_array_equal(m2.reconstruct(107), r2.reconstruct(107))
    D2, I2, R2 = m2.search_and_reconstruct(xq, K)
    jD2, jI2, jR2 = r2.search_and_reconstruct(xq, K)
    np.testing.assert_array_equal(I2, jI2)
    np.testing.assert_array_equal(R2, jR2)
    sel = IDSelectorBatch(ids[::3])
    assert m2.remove_ids(sel) == r2.remove_ids(sel)
    _close_ids(m2.search(xq, K), r2.search(xq, K))
    with pytest.raises(KeyError):
        m2.reconstruct(100)


# every description the port builds; (class name, the attributes held)
FACTORY = (
    "Flat", "PQ4", "SQ8", "SQ4", "SQ6", "SQfp16", "SQbf16", "IVF8,Flat",
    "IVF8,SQ8", "IVF8,SQ4", "IVF8,SQ6", "IVF8,SQbf16", "IVF8,PQ4",
    "IVF8,PQ8,RFlat", "PCA8,IVF8,PQ2", "PCAR8,Flat", "OPQ4,IVF8,PQ4",
    "RR,L2norm,IVF8,Flat", "IDMap,Flat", "IVF8,Flat,RFlat",
    "IMI2x2,Flat", "IMI2x3,SQ8", "IMI2x2,PQ4", "LSH", "LSH32rt", "LSH8t",
    "IVF8,SH8", "IVF8,SH",
)


def _shape(idx):
    """A description of an index's construction: class, dims and knobs,
    wrappers and transforms, compared between the packages."""
    out = [type(idx).__name__]
    for attr in ("d", "nlist", "storage", "M", "qtype", "pq_residual",
                 "k_factor", "d_in", "d_out", "random_rotation", "coarse",
                 "M_refine", "nbits", "nbit", "rotate_data",
                 "train_thresholds", "threshold_type", "period"):
        if hasattr(idx, attr):
            v = getattr(idx, attr)
            out.append((attr, getattr(v, "value", v)))
    if hasattr(idx, "metric"):
        out.append(("metric", idx.metric.value))
    for attr in ("sub", "base"):
        if hasattr(idx, attr):
            out.append(_shape(getattr(idx, attr)))
    for tr in getattr(idx, "transforms", ()):
        out.append(_shape(tr))
    return out


@pytest.mark.parametrize("metric", METRICS)
def test_factory_matches_jax(metric):
    for desc in FACTORY:
        assert _shape(tfac.index_factory(D, desc, metric, device=DEVICE)) \
            == _shape(jfac.index_factory(D, desc, metric)), desc
    # IVFPQR is L2 only in both (AutoTune.cpp:858)
    if metric == "l2":
        assert _shape(tfac.index_factory(D, "IVF8,PQ4+8", device=DEVICE)) \
            == _shape(jfac.index_factory(D, "IVF8,PQ4+8"))
    else:
        for module, kw in ((tfac, dict(device=DEVICE)), (jfac, {})):
            with pytest.raises(AssertionError):
                module.index_factory(D, "IVF8,PQ4+8", metric, **kw)
    # the graph cells and the HNSW coarse quantizer build as in JAX
    for desc in ("HNSW32", "HNSW16_SQ8", "IVF8_HNSW4,Flat"):
        t = tfac.index_factory(D, desc, metric, device=DEVICE)
        j = jfac.index_factory(D, desc, metric)
        assert _shape(t) == _shape(j), desc
        assert getattr(t, "coarse_hnsw_m", None) == \
            getattr(j, "coarse_hnsw_m", None)
    for desc in ("IVF8,Bogus", "NotAnIndex"):
        with pytest.raises(NotImplementedError):
            tfac.index_factory(D, desc, metric, device=DEVICE)
    for module in (tfac, jfac):
        with pytest.raises(ValueError):
            module.index_factory(D, "IVF8,PQ5", metric)


def test_factory_chain_serves():
    """An OPQ + IVFPQ + re-rank chain built by the factory trains, adds and
    answers, and the exact re-rank puts the true neighbour first."""
    xb, xq = _data()
    idx = tfac.index_factory(D, "OPQ4,IVF8,PQ4,RFlat", device=DEVICE)
    idx.train(xb)
    idx.add(xb)
    v, i = idx.search(xq[:5], 3)
    assert v.shape == (5, 3) and (i >= 0).all()
    exact = tflat.FlatIndex(D, device=DEVICE)
    exact.add(xb)
    _, gt = exact.search(xq[:5], 1)
    assert (i[:, 0] == gt[:, 0]).mean() >= 0.6


def test_parameter_space_ht_and_k_factor_match_jax():
    """The polysemous ``ht`` dimension of an IVFPQ and an IndexPQ, and the
    refine wrapper's ``k_factor``, as the JAX package ranges them; the
    knobs reach the index."""
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    pairs = (
        (IVFFlatIndex(D, 8, storage="pq4", polysemous=True, device=DEVICE),
         JIVF(D, 8, storage="pq4", polysemous=True)),
        (tpqi.IndexPQ(D, 4, polysemous=True, device=DEVICE),
         jpqi.IndexPQ(D, 4, polysemous=True)),
        (tflat.IndexRefineFlat(tpqi.IndexPQ(D, 4, polysemous=True,
                                            device=DEVICE)),
         jflat.IndexRefineFlat(jpqi.IndexPQ(D, 4, polysemous=True))),
        (tpqi.IndexPQ(D, 4, device=DEVICE), jpqi.IndexPQ(D, 4)),
    )
    for ours, ref in pairs:
        assert (tat.ParameterSpace(ours).parameter_ranges(ours)
                == jat.ParameterSpace(ref).parameter_ranges(ref))
    ivf, pq, refine = pairs[0][0], pairs[1][0], pairs[2][0]
    tat.set_index_parameters(ivf, "nprobe=4,ht=16")
    assert (ivf.nprobe, ivf.polysemous_ht) == (4, 16)
    tat.set_index_parameter(pq, "polysemous_ht", 8)
    assert pq.polysemous_ht == 8
    tat.set_index_parameters(refine, "k_factor=4,ht=12")
    assert (refine.k_factor, refine.base.polysemous_ht) == (4.0, 12)
