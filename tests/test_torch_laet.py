"""Parity of the port's LAET baseline (``baselines/laet.py``) with the JAX
package's: features, labels, the MLP carried across by ``convert``, Adam
training from the same initial parameters, predictions and search; and
the JAX package's own LAET invariants on the port alone."""

import numpy as np
import pytest
import torch

from torch_parity import (
    DEVICE, K, MAX_TOPK, N_TRAIN, jax_fixture, port_state)

EPOCHS = 50


def _systems():
    """(port LAET, JAX LAET) on the fixture's index, multi-row layout."""
    from auncel_tpu.baselines.laet import LearnedTermination as JLT
    from auncel_tpu_torch.baselines.laet import LearnedTermination
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    _, arrays, mr, _ = port_state()
    idx = IVFFlatIndex.from_state(f["centers"], arrays, multirow=mr)
    return (LearnedTermination(idx, query_k=K, max_topk=MAX_TOPK,
                               device=DEVICE),
            JLT(f["idx"], query_k=K, max_topk=MAX_TOPK))


def _fields(p) -> dict:
    return {n: np.asarray(getattr(p, n))
            for n in ("w1", "b1", "w2", "b2", "w3", "b3")}


def _jax_init(d_in: int):
    import jax
    from auncel_tpu.baselines.laet import _mlp_init
    return _mlp_init(jax.random.PRNGKey(3), d_in, 64)


def test_features_and_labels_match_jax():
    f = jax_fixture()
    lt, jlt = _systems()
    np.testing.assert_allclose(lt._features(f["xq"]), jlt._features(f["xq"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(lt._labels(f["xq"], f["gt_I"]),
                                  jlt._labels(f["xq"], f["gt_I"]))


def test_converted_mlp_matches_jax():
    from auncel_tpu.baselines.laet import _mlp_apply
    from auncel_tpu_torch.convert import mlp_from_numpy
    p = _jax_init(29)
    x = np.random.RandomState(0).randn(64, 29).astype(np.float32)
    mlp = mlp_from_numpy(_fields(p), DEVICE)
    with torch.no_grad():
        got = mlp(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(_mlp_apply(p, x)),
                               rtol=1e-5, atol=1e-6)


def test_adam_training_from_shared_init_matches_jax(monkeypatch):
    import auncel_tpu.baselines.laet as jlaet
    from auncel_tpu_torch.convert import mlp_from_numpy
    f = jax_fixture()
    lt, jlt = _systems()
    xq, gt_I = f["xq"][:N_TRAIN], f["gt_I"][:N_TRAIN]
    init = _jax_init(lt._features(xq[:1]).shape[1])
    monkeypatch.setattr(jlaet, "_mlp_init", lambda key, d_in, hidden: init)
    jloss = jlt.train(xq, gt_I, epochs=EPOCHS)
    loss = lt.train(xq, gt_I, epochs=EPOCHS,
                    init=mlp_from_numpy(_fields(init), DEVICE))
    # the parameters agree within 6e-7; the loss, 0.021 against residuals
    # of 0.15 on predictions near 3, differs by 1.45e-5 relative: fp32
    # contraction order in the forward and backward passes, which an
    # optax-order Adam written by hand reproduces too (ROADMAP.md §3)
    assert loss == pytest.approx(jloss, rel=2e-5)
    ref = _fields(jlt.params)
    for name, v in lt.params.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), ref[name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def _trained_pair(mult: float):
    """Both systems with the JAX package's trained model carried across."""
    from auncel_tpu_torch.convert import mlp_from_numpy
    f = jax_fixture()
    lt, jlt = _systems()
    jlt.train(f["xq"][:N_TRAIN], f["gt_I"][:N_TRAIN], epochs=EPOCHS)
    lt.params = mlp_from_numpy(_fields(jlt.params), DEVICE)
    lt._feat_mean, lt._feat_std = jlt._feat_mean, jlt._feat_std
    lt.multiplier = jlt.multiplier = mult
    return lt, jlt


@pytest.mark.parametrize("mult", [0.7, 3.0, 11.0])
def test_predict_nprobe_matches_jax(mult):
    from auncel_tpu.baselines.laet import _mlp_apply
    f = jax_fixture()
    lt, jlt = _trained_pair(mult)
    q = f["xq"]
    x = (jlt._features(q) - jlt._feat_mean) / jlt._feat_std
    n = np.exp(np.asarray(_mlp_apply(jlt.params, x))) * np.float32(mult)
    # a value within 1e-4 of a rounding boundary may round either way
    clear = np.abs(n - np.floor(n) - 0.5) > 1e-4
    got, ref = lt.predict_nprobe(q), jlt.predict_nprobe(q)
    np.testing.assert_array_equal(got[clear], ref[clear])
    assert clear.mean() > 0.9


def test_search_at_given_nprobes_matches_jax(monkeypatch):
    import jax.numpy as jnp
    f = jax_fixture()
    lt, jlt = _trained_pair(1.0)
    q = f["xq"][N_TRAIN:]
    n = np.random.RandomState(5).randint(1, lt.index.nlist + 1, q.shape[0])
    monkeypatch.setattr(jlt, "_predict_dev",
                        lambda q: jnp.asarray(n.astype(np.int32)))
    monkeypatch.setattr(lt, "_predict_dev", lambda q: torch.as_tensor(
        n.astype(np.int32)))
    D0, I0, n0 = jlt.search(q, K)
    D1, I1, n1 = lt.search(q, K)
    np.testing.assert_array_equal(n1, n0)
    np.testing.assert_array_equal(I1, I0)
    np.testing.assert_allclose(D1, D0, rtol=1e-5, atol=1e-5)


def test_padded_search_matches_jax(monkeypatch):
    """Without the multi-row layout both search the padded lists."""
    import jax.numpy as jnp
    from auncel_tpu.baselines.laet import LearnedTermination as JLT
    from auncel_tpu_torch.baselines.laet import LearnedTermination
    from torch_parity import padded_systems
    f = jax_fixture()
    es, jes = padded_systems()
    lt = LearnedTermination(es.index, query_k=K, max_topk=MAX_TOPK,
                            device=DEVICE)
    jlt = JLT(jes.index, query_k=K, max_topk=MAX_TOPK)
    q = f["xq"][N_TRAIN:]
    n = np.random.RandomState(6).randint(1, lt.index.nlist + 1, q.shape[0])
    monkeypatch.setattr(jlt, "_predict_dev",
                        lambda q: jnp.asarray(n.astype(np.int32)))
    monkeypatch.setattr(lt, "_predict_dev", lambda q: torch.as_tensor(
        n.astype(np.int32)))
    D0, I0, _ = jlt.search(q, K)
    D1, I1, _ = lt.search(q, K)
    np.testing.assert_array_equal(I1, I0)
    np.testing.assert_allclose(D1, D0, rtol=1e-5, atol=1e-5)


def test_default_init_is_seeded():
    from auncel_tpu_torch.baselines.laet import mlp_init
    a, b = mlp_init(20, 64, 7, DEVICE), mlp_init(20, 64, 7, DEVICE)
    c = mlp_init(20, 64, 8, DEVICE)
    assert torch.equal(a.w1, b.w1) and not torch.equal(a.w1, c.w1)
    assert float(a.w1.detach().std()) == pytest.approx((2.0 / 20) ** 0.5,
                                                       rel=0.15)
    assert float(a.b1.detach().abs().sum()) == 0.0


@pytest.fixture(scope="module")
def setup():
    """The JAX package's tests/test_laet.py set-up, on the port alone."""
    from auncel_tpu_torch.data import make_clustered_dataset
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    ds = make_clustered_dataset(nb=20000, nq=300, d=32, n_clusters=64,
                                seed=13)
    idx = IVFFlatIndex(ds.d, nlist=64, device=DEVICE)
    idx.train(ds.xt[:10000])
    idx.add(ds.xb)
    gt_D, gt_I = idx.exact_search(ds.xq, 50)
    return ds, idx, gt_D, gt_I


def test_laet_learns_and_terminates(setup):
    from auncel_tpu_torch.autotune import recall_counts
    from auncel_tpu_torch.baselines.laet import LearnedTermination
    ds, idx, gt_D, gt_I = setup
    lt = LearnedTermination(idx, query_k=10, max_topk=50, device=DEVICE)
    loss = lt.train(ds.xq[:200], gt_I[:200], epochs=200)
    assert np.isfinite(loss)
    lt.tune_multiplier(ds.xq[200:250], gt_D[200:250], target_recall=0.95)
    D, I, nprobe = lt.search(ds.xq[250:300], 10)
    rec = recall_counts(D, gt_D[250:300], 10, idx.metric).mean() / 10
    assert rec >= 0.85
    assert nprobe.mean() < 64
    assert nprobe.std() > 0


def test_laet_prediction_tracks_difficulty(setup):
    from auncel_tpu_torch.baselines.laet import LearnedTermination
    ds, idx, gt_D, gt_I = setup
    lt = LearnedTermination(idx, query_k=10, max_topk=50, device=DEVICE)
    lt.train(ds.xq[:200], gt_I[:200], epochs=200)
    labels = lt._labels(ds.xq[200:300], gt_I[200:300])
    lt.multiplier = 1.0
    pred = lt.predict_nprobe(ds.xq[200:300])
    hard = labels > np.median(labels)
    assert hard.any() and (~hard).any()
    assert pred[hard].mean() > pred[~hard].mean()
