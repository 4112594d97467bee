"""Parity of the port's data-parallel k-means
(``auncel_tpu_torch/parallel/kmeans_dp.py``) with the JAX package's on the
simulated CPU mesh: one step from the same centroids, the full run's
error, its quality check (``tests/test_parallel.py``), and a run repeated
bit for bit."""

import functools

import jax
import numpy as np
import pytest
import torch

from tests.torch_parity import DEVICE


@functools.lru_cache(maxsize=None)
def ds():
    from auncel_tpu.data.synthetic import make_clustered_dataset
    return make_clustered_dataset(nb=16000, nq=40, d=32, n_clusters=64,
                                  seed=21)


def meshes(S: int):
    from auncel_tpu.parallel.sharded import make_mesh as jmesh
    from auncel_tpu_torch.parallel import make_mesh
    return jmesh(S), make_mesh(S, devices=[DEVICE])


@pytest.mark.parametrize("S,n", [(4, 8000), (8, 8003)])
def test_one_step_matches_jax(S, n):
    """The same points and centroids through one step of each package:
    centroids within 1e-5, errors within 1e-5 relative (the last n % S
    points are left out by both)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from auncel_tpu.parallel.kmeans_dp import make_dp_kmeans_step as jstep
    from auncel_tpu_torch.parallel import make_dp_kmeans_step
    from auncel_tpu_torch.parallel.kmeans_dp import shard_points
    jm, pm = meshes(S)
    x = ds().xb[:n]
    c0 = x[np.random.RandomState(5).permutation(n)[:32]]
    n_fit = (n // S) * S
    xs = jax.device_put(jnp.asarray(x[:n_fit]),
                        NamedSharding(jm, P("shard")))
    jc, jerr = jstep(jm, 32)(xs, jnp.asarray(c0))
    parts = shard_points(x, pm)
    assert sum(p.shape[0] for p in parts) == n_fit
    pc, perr = make_dp_kmeans_step(pm, 32)(parts, torch.as_tensor(c0))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(perr), float(jerr), rtol=1e-5)


def test_empty_cluster_keeps_its_centroid():
    from auncel_tpu_torch.parallel import make_dp_kmeans_step
    from auncel_tpu_torch.parallel.kmeans_dp import shard_points
    _, pm = meshes(4)
    x = ds().xb[:4000]
    c0 = np.concatenate([x[:7], np.full((1, x.shape[1]), 1e6, np.float32)])
    c, _ = make_dp_kmeans_step(pm, 8)(shard_points(x, pm),
                                      torch.as_tensor(c0))
    np.testing.assert_array_equal(c[7].numpy(), c0[7])


def test_dp_kmeans_matches_jax_and_quality():
    """The full run over 8 shards: error within 1e-4 of the JAX package's,
    and the JAX test's quality check (beats a random-centroid baseline by
    a wide margin)."""
    from auncel_tpu.parallel.kmeans_dp import dp_kmeans as jdp
    from auncel_tpu_torch.parallel import dp_kmeans
    jm, pm = meshes(8)
    x = ds().xb[:8000]
    jc, jerr = jdp(x, 32, jm, niter=10)
    cents, err = dp_kmeans(x, 32, pm, niter=10)
    assert cents.shape == (32, 32)
    np.testing.assert_allclose(err, jerr, rtol=1e-4)
    np.testing.assert_allclose(cents, jc, rtol=1e-4, atol=1e-4)
    rng = np.random.RandomState(0)
    rand_c = x[rng.permutation(8000)[:32]]
    d_rand = ((x[:, None, :] - rand_c[None]) ** 2).sum(-1).min(1).sum()
    assert err < 0.9 * d_rand


def test_dp_kmeans_repeats_bit_for_bit():
    from auncel_tpu_torch.parallel import dp_kmeans
    _, pm = meshes(4)
    a = dp_kmeans(ds().xb, 64, pm, niter=5)
    b = dp_kmeans(ds().xb, 64, pm, niter=5)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]
