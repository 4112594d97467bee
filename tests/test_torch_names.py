"""The port's public names: every name the JAX package's ``__init__``s
export imports from the same path of ``auncel_tpu_torch``; ``Kmeans`` and
``imbalance_factor`` on the JAX tests' own cases and against the JAX
``Kmeans``; ``clone_index`` gives a copy that owns its tensors."""

import importlib

import numpy as np
import pytest

from tests.torch_parity import DEVICE, check_clone

PACKAGES = ["", ".index", ".ops", ".profile", ".baselines", ".eval_harness",
            ".parallel", ".data"]


@pytest.mark.parametrize("sub", PACKAGES)
def test_jax_exports_import_from_the_port(sub):
    jax_mod = importlib.import_module("auncel_tpu" + sub)
    port = importlib.import_module("auncel_tpu_torch" + sub)
    missing = [n for n in jax_mod.__all__ if not hasattr(port, n)]
    assert not missing, missing
    assert set(jax_mod.__all__) <= set(port.__all__)


def test_elapsed_is_wall_time():
    import time
    from auncel_tpu_torch.eval_harness.common import elapsed
    t = time.time()
    assert t <= elapsed() <= time.time()


def test_kmeans_convenience_class(rng):
    """The JAX test's case (tests/test_ops.py)."""
    from auncel_tpu_torch.ops.kmeans import Kmeans
    x = rng.randn(2000, 8).astype(np.float32)
    km = Kmeans(8, 16, niter=5, device=DEVICE)
    err = km.train(x)
    assert np.isfinite(err) and km.centroids.shape == (16, 8)
    assert km.obj == err
    a = km.assign(x[:100])
    assert a.shape == (100,) and a.max() < 16
    d = ((x[:100, None, :] - km.centroids[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(a, d.argmin(1))


def test_imbalance_factor():
    """The JAX test's case (tests/test_ops.py), and the JAX value."""
    from auncel_tpu.ops.kmeans import imbalance_factor as jax_imbalance
    from auncel_tpu_torch.ops.kmeans import imbalance_factor
    assert imbalance_factor(np.repeat(np.arange(8), 10), 8) == 1.0
    assert imbalance_factor(np.zeros(100, np.int64), 8) == 8.0
    skew = imbalance_factor(np.repeat([0, 1], [90, 10]), 2)
    assert 1.0 < skew < 2.0
    assert imbalance_factor(np.zeros(0, np.int64), 4) == 0.0
    a = np.random.RandomState(3).randint(0, 13, 500)
    assert imbalance_factor(a, 16) == jax_imbalance(a, 16)


def test_kmeans_class_matches_jax(rng):
    """The same numpy-drawn initial centroids in both packages: centroids
    and objective within the port's k-means parity tolerance."""
    from auncel_tpu.ops.kmeans import Kmeans as JKmeans
    from auncel_tpu_torch.ops.kmeans import Kmeans
    x = rng.randn(3000, 16).astype(np.float32)
    t, j = Kmeans(16, 24, niter=6, seed=5, device=DEVICE), JKmeans(16, 24,
                                                                 niter=6,
                                                                 seed=5)
    for km in (t, j):
        km.params = km.params._replace(init="random")
        km.train(x)
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=1e-4,
                               atol=1e-4)
    assert abs(t.obj - j.obj) <= 1e-4 * j.obj
    np.testing.assert_array_equal(t.assign(x[:200]), j.assign(x[:200]))


def test_clone_index_owns_its_tensors():
    check_clone(DEVICE)


def test_clone_index_shares_the_ondisk_lists(tmp_path):
    """An OnDiskIVFIndex's lists are read-only memmaps of its directory:
    the copy reads the same files, and searches the same."""
    from auncel_tpu_torch.index.io import clone_index, save_index_ondisk
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    from auncel_tpu_torch.index.ondisk import OnDiskIVFIndex
    x = np.random.RandomState(1).randn(2000, 16).astype(np.float32)
    idx = IVFFlatIndex(16, 16, device=DEVICE)
    idx.train(x)
    idx.add(x)
    save_index_ondisk(idx, str(tmp_path))
    od = OnDiskIVFIndex(str(tmp_path), device=DEVICE)
    copy = clone_index(od)
    assert copy.db is od.db and copy._cents is not od._cents
    for a, b in zip(copy.search(x[:10], 5, 4), od.search(x[:10], 5, 4)):
        np.testing.assert_array_equal(a, b)
