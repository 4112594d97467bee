"""Vector transforms and the pre-transform index (port of
``auncel_tpu/index/transform.py``; reference ``VectorTransform``: PCA,
OPQ, random rotation, L2 normalisation, centring, dimension remap, applied
by an ``IndexPreTransform`` before the wrapped index).

Host numpy code, as in the JAX package, except PCA's covariance (one fp32
product on ``device``) and OPQ's PQ training and encoding (``ops/pq.py``
on ``device``); the eigen- and singular-value solves are [d, d] host
solves, as the reference's LAPACK calls are.
"""

import numpy as np
import torch

from auncel_tpu_torch.device import resolve
from auncel_tpu_torch.index.base import Index


class VectorTransform:
    d_in: int
    d_out: int
    is_trained: bool = True

    def train(self, x: np.ndarray) -> None:
        pass

    def apply(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def reverse(self, xt: np.ndarray) -> np.ndarray:
        """Inverse map (reference ``VectorTransform::reverse_transform``,
        VectorTransform.cpp — defined only where the forward map is
        invertible; orthonormal linear transforms invert by the
        transpose)."""
        raise NotImplementedError(
            f"{type(self).__name__} is not reversible")


def _is_orthonormal(mat: np.ndarray, tol: float = 1e-3) -> bool:
    """Columns orthonormal (reference LinearTransform::set_is_orthonormal
    checks A A^T == I the same way, VectorTransform.cpp)."""
    g = mat.T.astype(np.float64) @ mat.astype(np.float64)
    return bool(np.abs(g - np.eye(mat.shape[1])).max() < tol)


class PCAMatrix(VectorTransform):
    """PCA projection d_in -> d_out, optional whitening and random rotation
    inside the PCA basis (reference PCAMatrix, VectorTransform.h)."""

    def __init__(self, d_in: int, d_out: int, eigen_power: float = 0.0,
                 random_rotation: bool = False, seed: int = 1234,
                 device="cuda"):
        assert d_out <= d_in
        self.device = resolve(device)
        self.d_in, self.d_out = d_in, d_out
        self.eigen_power = eigen_power
        self.random_rotation = random_rotation
        self.seed = seed
        self.is_trained = False
        self.mean: np.ndarray | None = None
        self.proj: np.ndarray | None = None  # [d_in, d_out]

    def train(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float32)
        self.mean = x.mean(axis=0)
        xc = torch.as_tensor(x - self.mean, device=self.device)
        cov = (xc.T @ xc).cpu().numpy() / max(x.shape[0] - 1, 1)
        w, v = np.linalg.eigh(cov.astype(np.float64))
        order = np.argsort(-w)
        w, v = w[order][: self.d_out], v[:, order][:, : self.d_out]
        if self.eigen_power != 0.0:
            v = v * (np.maximum(w, 1e-10) ** self.eigen_power)[None, :]
        if self.random_rotation:
            rng = np.random.RandomState(self.seed)
            q, _ = np.linalg.qr(rng.randn(self.d_out, self.d_out))
            v = v @ q
        self.proj = v.astype(np.float32)
        self.is_trained = True

    def apply(self, x: np.ndarray) -> np.ndarray:
        assert self.is_trained
        return (np.asarray(x, np.float32) - self.mean) @ self.proj

    def reverse(self, xt: np.ndarray) -> np.ndarray:
        """x ~= xt @ proj^T + mean. Valid only while the projection
        columns are orthonormal (eigen_power == 0; whitening rescales the
        basis) — the reference raises through ``reverse_transform`` on a
        non-orthonormal LinearTransform the same way
        (tests/test_build_blocks.py:239 contract). For d_out < d_in this
        is the minimum-norm preimage, exactly like the reference's
        transposed multiply."""
        assert self.is_trained
        if not _is_orthonormal(self.proj):
            raise NotImplementedError(
                "PCAMatrix with eigen_power != 0 is not orthonormal; "
                "reverse is undefined")
        return np.asarray(xt, np.float32) @ self.proj.T + self.mean


class OPQMatrix(VectorTransform):
    """OPQ rotation (reference OPQMatrix, VectorTransform.h): learn an
    orthonormal R minimizing the PQ reconstruction error of R x, by
    alternating PQ training on the rotated data with the orthogonal
    Procrustes update R = U V^T from SVD(X^T X_hat) (OPQ-NP). The SVD is a
    tiny [d, d] host solve; the PQ inner loop runs on ``device``."""

    def __init__(self, d: int, M: int, niter: int = 8, seed: int = 1234,
                 device="cuda"):
        assert d % M == 0
        self.device = resolve(device)
        self.d_in = self.d_out = d
        self.M = M
        self.niter = niter
        self.seed = seed
        self.is_trained = False
        self.rot: np.ndarray | None = None

    def train(self, x: np.ndarray) -> None:
        from auncel_tpu_torch.ops.pq import decode_pq, encode_pq, train_pq
        x = np.asarray(x, np.float32)[:100_000]
        rng = np.random.RandomState(self.seed)
        q, _ = np.linalg.qr(rng.randn(self.d_in, self.d_in))
        R = q.astype(np.float32)
        for _ in range(self.niter):
            y = x @ R
            pq = train_pq(y, self.M, niter=6, seed=self.seed,
                          device=self.device)
            yd = torch.as_tensor(y, device=self.device)
            rec = decode_pq(pq, encode_pq(pq, yd)).cpu().numpy()
            u, _, vt = np.linalg.svd(x.T.astype(np.float64)
                                     @ rec.astype(np.float64))
            R = (u @ vt).astype(np.float32)
        self.rot = R
        self.is_trained = True

    def apply(self, x: np.ndarray) -> np.ndarray:
        assert self.is_trained
        return np.asarray(x, np.float32) @ self.rot

    def reverse(self, xt: np.ndarray) -> np.ndarray:
        assert self.is_trained
        return np.asarray(xt, np.float32) @ self.rot.T


class RandomRotationMatrix(VectorTransform):
    """Dense random orthonormal rotation (reference RandomRotationMatrix)."""

    def __init__(self, d: int, seed: int = 1234):
        self.d_in = self.d_out = d
        rng = np.random.RandomState(seed)
        q, _ = np.linalg.qr(rng.randn(d, d))
        self.rot = q.astype(np.float32)

    def apply(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x, np.float32) @ self.rot

    def reverse(self, xt: np.ndarray) -> np.ndarray:
        return np.asarray(xt, np.float32) @ self.rot.T


class NormalizationTransform(VectorTransform):
    """L2 normalization (reference NormalizationTransform; the IP datasets
    are normalized exactly like this, eval/bound.cpp:243-248)."""

    def __init__(self, d: int, norm: float = 2.0):
        assert norm == 2.0, "reference supports L2 only"
        self.d_in = self.d_out = d

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        n = np.linalg.norm(x, axis=1, keepdims=True)
        return x / np.maximum(n, 1e-20)

    def reverse(self, xt: np.ndarray) -> np.ndarray:
        """Identity — normalization cannot be undone, and the reference
        returns the stored normalized vector unchanged
        (NormalizationTransform::reverse_transform is a memcpy,
        VectorTransform.cpp:796-800). Keeps factory "L2norm,..." chains
        reconstructible."""
        return np.asarray(xt, np.float32).copy()


class CenteringTransform(VectorTransform):
    """Subtract the training mean (reference CenteringTransform,
    VectorTransform.h:249-266)."""

    def __init__(self, d: int):
        self.d_in = self.d_out = d
        self.mean: np.ndarray | None = None
        self.is_trained = False   # needs the mean before apply

    def train(self, x: np.ndarray) -> None:
        self.mean = np.asarray(x, np.float32).mean(0)
        self.is_trained = True

    def apply(self, x: np.ndarray) -> np.ndarray:
        assert self.mean is not None, "train before apply"
        return np.asarray(x, np.float32) - self.mean

    def reverse(self, xt: np.ndarray) -> np.ndarray:
        return np.asarray(xt, np.float32) + self.mean


class RemapDimensionsTransform(VectorTransform):
    """Dimension remap / pad (reference RemapDimensionsTransform,
    VectorTransform.h:213-232: map[out] = in index or -1 for a zero
    output; the uniform constructor spreads kept dimensions evenly)."""

    def __init__(self, d_in: int, d_out: int,
                 dim_map: np.ndarray | None = None, uniform: bool = True):
        self.d_in, self.d_out = d_in, d_out
        if dim_map is not None:
            dim_map = np.asarray(dim_map, np.int64)
            assert dim_map.shape == (d_out,)
            assert np.all(dim_map < d_in)
        elif uniform:
            # VectorTransform.cpp uniform spread: i * d_in / d_out
            dim_map = (np.arange(d_out) * d_in // d_out).astype(np.int64)
        else:
            # first d_out dims kept, -1 (zero) beyond d_in
            dim_map = np.arange(d_out, dtype=np.int64)
            dim_map[dim_map >= d_in] = -1
        self.dim_map = dim_map

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float32)
        out = x[:, np.maximum(self.dim_map, 0)]
        out[:, self.dim_map < 0] = 0.0
        return out

    def reverse(self, xt: np.ndarray) -> np.ndarray:
        """Correct only for permutation maps (VectorTransform.h:228-229)."""
        xt = np.asarray(xt, np.float32)
        out = np.zeros((xt.shape[0], self.d_in), np.float32)
        keep = self.dim_map >= 0
        out[:, self.dim_map[keep]] = xt[:, keep]
        return out


class IndexPreTransform(Index):
    """Apply a chain of transforms before the wrapped index
    (reference IndexPreTransform)."""

    def __init__(self, sub: Index, transforms: list[VectorTransform]):
        self.sub = sub
        self.transforms = transforms
        self.metric = sub.metric
        self.d = transforms[0].d_in if transforms else sub.d

    @property
    def is_trained(self):
        return (all(t.is_trained for t in self.transforms)
                and self.sub.is_trained)

    @is_trained.setter
    def is_trained(self, v):  # pragma: no cover
        pass

    @property
    def ntotal(self):
        return self.sub.ntotal

    def _apply_chain(self, x):
        for t in self.transforms:
            x = t.apply(x)
        return x

    def train(self, x):
        for t in self.transforms:
            if not t.is_trained:
                t.train(x)
            x = t.apply(x)
        self.sub.train(x)

    def add(self, x, ids=None):
        xt = self._apply_chain(x)
        if ids is not None:
            self.sub.add(xt, ids=ids)
        else:
            self.sub.add(xt)

    def search(self, q, k):
        return self.sub.search(self._apply_chain(q), k)

    def _reverse_chain(self, xt):
        """Undo the chain back to input space (reference
        IndexPreTransform::reverse_chain, used by its reconstruct)."""
        for t in reversed(self.transforms):
            xt = t.reverse(xt)
        return xt

    def reconstruct(self, key: int) -> np.ndarray:
        return self._reverse_chain(self.sub.reconstruct(key)[None])[0]

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        return self._reverse_chain(self.sub.reconstruct_n(i0, n))

    def reconstruct_batch(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.int64).reshape(-1)
        out = self._reverse_chain(self.sub.reconstruct_batch(keys))
        out[keys < 0] = 0.0   # reversing can move the zero fill
        return out.astype(np.float32)

    def search_and_reconstruct(self, q, k, **kwargs):
        D, I, R = self.sub.search_and_reconstruct(
            self._apply_chain(q), k, **kwargs)
        flat = R.reshape(-1, R.shape[-1])
        rev = self._reverse_chain(flat)
        rev[np.asarray(I).reshape(-1) < 0] = 0.0
        return D, I, rev.reshape(I.shape[0], I.shape[1], -1)

    def reset(self):
        self.sub.reset()
