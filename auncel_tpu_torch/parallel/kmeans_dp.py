"""Data-parallel k-means over a mesh's shards (port of
``auncel_tpu/parallel/kmeans_dp.py``).

The points are split over the shards; each shard assigns its points and
sums them per cluster on its device, and the partial sums, counts and
errors are added in shard order on the first shard's device (the JAX
package's ``psum``). Each partial sum goes through ``ops/kmeans.py``'s
``segment_sum``, in a fixed order, so a run on the card repeats bit for
bit.
"""

import numpy as np
import torch

from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.kmeans import KmeansParams, _assign, segment_sum
from auncel_tpu_torch.parallel.sharded import AXIS, Mesh


def shard_points(x: np.ndarray, mesh: Mesh) -> list:
    """x split into the mesh's S shards as contiguous blocks, each on its
    shard's device. The last ``n % S`` points (at most S - 1) are left
    out so the split is even, as the JAX package's sharding is."""
    S = mesh.shape[AXIS]
    n_fit = (x.shape[0] // S) * S
    return [torch.as_tensor(np.ascontiguousarray(part, np.float32),
                            device=dev)
            for part, dev in zip(np.split(x[:n_fit], S), mesh.devices[0])]


def make_dp_kmeans_step(mesh: Mesh, k: int):
    """One k-means step: (the shards' points, as ``shard_points`` gives
    them, centroids [k, d]) -> (new centroids [k, d], err), on the
    centroids' device. Empty clusters keep their centroid (single-device
    k-means splits them; this step is the scale-out inner loop)."""
    block = KmeansParams().assign_block

    def step(x_shards: list, centroids: torch.Tensor):
        dev = centroids.device
        sums = counts = err = None
        for x in x_shards:
            c = centroids.to(x.device)
            assign, dmin = _assign(x, c, sqnorms(c), block)
            a = assign.long()
            sizes = torch.bincount(a, minlength=k)
            part = (segment_sum(x, a, sizes).to(dev),
                    sizes.to(torch.float32).to(dev), dmin.sum().to(dev))
            if sums is None:
                sums, counts, err = part
            else:
                sums, counts, err = (sums + part[0], counts + part[1],
                                     err + part[2])
        new_c = sums / counts.clamp_min(1.0)[:, None]
        return torch.where((counts > 0)[:, None], new_c, centroids), err

    return step


def dp_kmeans(x: np.ndarray, k: int, mesh: Mesh, niter: int = 25,
              seed: int = 1234):
    """Full DP k-means: shard the points once, iterate the step.
    The initial centroids are ``x[RandomState(seed).permutation(n)[:k]]``.
    Returns numpy centroids [k, d] and the last step's error. The points
    left out to even the split make it differ from a one-device run on
    the same data."""
    xs = shard_points(x, mesh)
    rng = np.random.RandomState(seed)
    centroids = torch.as_tensor(
        np.ascontiguousarray(x[rng.permutation(x.shape[0])[:k]], np.float32),
        device=mesh.devices[0, 0])
    step = make_dp_kmeans_step(mesh, k)
    err = None
    for _ in range(niter):
        centroids, err = step(xs, centroids)
    return centroids.cpu().numpy(), float(err)
