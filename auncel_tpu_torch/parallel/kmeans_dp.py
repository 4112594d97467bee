"""Data-parallel k-means over a mesh's shards (port of
``auncel_tpu/parallel/kmeans_dp.py``).

The points are split over the shards; each shard assigns its points and
sums them per cluster on its device, and the partial sums, counts and
errors are added in shard order on the first shard's device (the JAX
package's ``psum``). Each partial sum goes through ``ops/kmeans.py``'s
``segment_sum``, in a fixed order, so a run on the card repeats bit for
bit. On a rank mesh (``make_mesh(..., ranks=True)``) each rank takes its
own block, and the partials are all-gathered and added in shard order on
every rank, not all-reduced (which adds in the backend's order): every
rank gets the one-process result bit for bit.
"""

import numpy as np
import torch

from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.kmeans import KmeansParams, _assign, segment_sum
from auncel_tpu_torch.parallel.sharded import AXIS, Mesh


def shard_points(x: np.ndarray, mesh: Mesh) -> list:
    """x split into the mesh's S shards as contiguous blocks, each on its
    shard's device (on a rank mesh only this rank's block, the others
    None). The last ``n % S`` points (at most S - 1) are left out so the
    split is even, as the JAX package's sharding is."""
    S = mesh.shape[AXIS]
    n_fit = (x.shape[0] // S) * S
    cell = mesh.cell
    return [None if cell is not None and s != cell[1] else torch.as_tensor(
        np.ascontiguousarray(part, np.float32),
        device=mesh.devices[cell or (0, s)])
        for s, part in enumerate(np.split(x[:n_fit], S))]


def make_dp_kmeans_step(mesh: Mesh, k: int):
    """One k-means step: (the shards' points, as ``shard_points`` gives
    them, centroids [k, d]) -> (new centroids [k, d], err), on the
    centroids' device. Empty clusters keep their centroid (single-device
    k-means splits them; this step is the scale-out inner loop)."""
    block = KmeansParams().assign_block
    S = mesh.shape[AXIS]

    def partial(x, centroids):
        c = centroids.to(x.device)
        assign, dmin = _assign(x, c, sqnorms(c), block)
        a = assign.long()
        sizes = torch.bincount(a, minlength=k)
        return (segment_sum(x, a, sizes), sizes.to(torch.float32),
                dmin.sum())

    def step(x_shards: list, centroids: torch.Tensor):
        dev = centroids.device
        if mesh.cell is None:
            parts = [tuple(t.to(dev) for t in partial(x, centroids))
                     for x in x_shards]
        else:   # dp group 0's cells (0, s), in shard order
            parts = mesh.comm.all_gather(
                partial(x_shards[mesh.cell[1]], centroids))[:S]
        sums, counts, err = parts[0]
        for p in parts[1:]:
            sums, counts, err = sums + p[0], counts + p[1], err + p[2]
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
        device=mesh.devices[mesh.cell or (0, 0)])
    step = make_dp_kmeans_step(mesh, k)
    err = None
    for _ in range(niter):
        centroids, err = step(xs, centroids)
    return centroids.cpu().numpy(), float(err)
