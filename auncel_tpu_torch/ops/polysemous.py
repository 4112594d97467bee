"""Polysemous codebook reordering (a copy of
``auncel_tpu/ops/polysemous.py``; the port cannot import it without
importing jax). Numpy code, run on the host.

Each subquantizer's 256 codebook entries are permuted so that the Hamming
distance between code words tracks the L2 distance between their
centroids (the reference's ``PolysemousTraining``); a Hamming filter on the
codes then discards most candidates before the exact distance
(``IndexPQ.h:24`` ``polysemous_ht``). Simulated annealing over pair swaps
with the same seeds as the JAX package, so the same permutation.
"""

import numpy as np

POPCOUNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.int32)


def _hamming_table(nbits: int = 8) -> np.ndarray:
    """[256, 256] Hamming distances between byte codes."""
    codes = np.arange(256, dtype=np.uint8)
    return POPCOUNT8[codes[:, None] ^ codes[None, :]].astype(np.float64)


def reorder_codebook(centroids: np.ndarray, n_iter: int = 30_000,
                     t0: float = 0.7, seed: int = 123) -> np.ndarray:
    """Return a permutation ``perm`` such that placing centroid i at code
    ``perm[i]`` makes Hamming(code_i, code_j) approximate the (affinely
    scaled) centroid distance d(i, j). Minimizes
    sum_ij (a*d(i,j) + b - H(perm[i], perm[j]))^2 by SA over pair swaps.
    """
    K = centroids.shape[0]
    assert K == 256, "polysemous codes are 8-bit (256 entries)"
    d = ((centroids[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    H = _hamming_table()
    # affine match d -> Hamming scale (mean/std of the off-diagonals)
    off = ~np.eye(K, dtype=bool)
    a = H[off].std() / max(d[off].std(), 1e-12)
    b = H[off].mean() - a * d[off].mean()
    tgt = a * d + b                       # target Hamming distances

    rng = np.random.RandomState(seed)
    perm = rng.permutation(K)
    # cost uses H[perm[i], perm[j]]: track permuted rows incrementally
    Hp = H[perm][:, perm]
    err = Hp - tgt
    cost = float((err * err).sum())
    temp = t0 * cost / (K * K)
    for it in range(n_iter):
        i, j = rng.randint(0, K, 2)
        if i == j:
            continue
        # delta of swapping perm[i] and perm[j]: rows/cols i and j change
        pi, pj = perm[i], perm[j]
        new_i = H[pj][perm]               # row i after swap (before fixup)
        new_j = H[pi][perm]
        new_i[i], new_i[j] = H[pj, pj], H[pj, pi]
        new_j[i], new_j[j] = H[pi, pj], H[pi, pi]
        old = (err[i] ** 2).sum() + (err[j] ** 2).sum()
        di = new_i - tgt[i]
        dj = new_j - tgt[j]
        new = (di ** 2).sum() + (dj ** 2).sum()
        # row/col symmetric: off-row terms change identically (H, tgt sym)
        delta = 2.0 * (new - old) \
            - ((di[i] ** 2 - err[i, i] ** 2) + (di[j] ** 2 - err[i, j] ** 2)
               + (dj[i] ** 2 - err[j, i] ** 2) + (dj[j] ** 2 - err[j, j] ** 2))
        tcur = temp * (1.0 - it / n_iter)
        if delta < 0 or rng.rand() < np.exp(-delta / max(tcur, 1e-9)):
            perm[i], perm[j] = pj, pi
            err[i], err[j] = di, dj
            err[:, i], err[:, j] = di, dj  # symmetry
            cost += delta
    return perm


def hamming_fit(centroids: np.ndarray, perm: np.ndarray) -> float:
    """Correlation between centroid distances and permuted-code Hamming
    distances (quality metric for tests/monitoring)."""
    K = centroids.shape[0]
    d = ((centroids[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
    H = _hamming_table()[perm][:, perm]
    off = ~np.eye(K, dtype=bool)
    return float(np.corrcoef(d[off].ravel(), H[off].ravel())[0, 1])
