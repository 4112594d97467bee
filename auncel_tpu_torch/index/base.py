"""Abstract index interface (port of ``auncel_tpu/index/base.py``).

The reference's ``Index`` surface (``Index.h:66``: d, ntotal, metric,
train, add, search, reset) with reconstruction helpers. Bounded search is
a separate entry point on ``ErrorSys``, not a mode of the index.
"""

import abc

import numpy as np

from auncel_tpu_torch.types import Metric


class Index(abc.ABC):
    d: int
    metric: Metric
    ntotal: int
    is_trained: bool

    @abc.abstractmethod
    def train(self, x: np.ndarray) -> None:
        ...

    @abc.abstractmethod
    def add(self, x: np.ndarray, ids: np.ndarray | None = None) -> None:
        ...

    @abc.abstractmethod
    def search(self, q: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Returns (vals [nq, k], ids [nq, k]) best-first."""
        ...

    @abc.abstractmethod
    def reset(self) -> None:
        ...

    def reconstruct(self, key: int) -> np.ndarray:
        raise NotImplementedError(
            f"{type(self).__name__} does not support reconstruction")

    def reconstruct_n(self, i0: int, n: int) -> np.ndarray:
        return np.stack([self.reconstruct(i) for i in range(i0, i0 + n)])

    def reconstruct_batch(self, keys: np.ndarray) -> np.ndarray:
        """Vectors of an id array (negative keys give zeros); families with
        a packed id layout override this with one gather."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        out = np.zeros((keys.size, self.d), np.float32)
        lut = {int(i): self.reconstruct(int(i))
               for i in np.unique(keys[keys >= 0])}
        for j, kk in enumerate(keys):
            if kk >= 0:
                out[j] = lut[int(kk)]
        return out

    def compute_residual(self, x: np.ndarray, key: int) -> np.ndarray:
        """x - reconstruct(key) (reference Index::compute_residual)."""
        return np.asarray(x, np.float32) - self.reconstruct(key)

    def search_and_reconstruct(self, q: np.ndarray, k: int, **kwargs
                               ) -> tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
        """Search plus the stored (decoded) vector of every result
        (reference ``Index::search_and_reconstruct``): D and I as
        ``search`` gives them, R[i, j] = reconstruct(I[i, j]), zeros where
        the id is -1."""
        D, I = self.search(q, k, **kwargs)
        R = self.reconstruct_batch(np.asarray(I).reshape(-1))
        return D, I, R.reshape(I.shape[0], I.shape[1], -1)
