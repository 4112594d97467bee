"""Vector dataset file formats (a copy of ``auncel_tpu/data/io.py``'s
numpy readers and writers; the byte layouts are the same, so a file either
package writes reads back bit for bit in the other).

  * ``.fvecs`` / ``.ivecs``: per row [int32 dim][dim x (float32|int32)]
    (the TexMex SIFT/GIST format),
  * ``.fbin`` / ``.ibin``: [int32 n][int32 dim][n*dim payload]
    (the big-ANN-benchmarks format, used for DEEP1B slices).

The JAX package strips the row headers with its native C++ reader when it
is built; the port keeps the numpy path only.
"""

import numpy as np


def _vecs_read(fname: str, dtype, count: int = -1, offset_rows: int = 0):
    head = np.fromfile(fname, count=1, dtype=np.int32)
    if head.size == 0:
        return np.zeros((0, 0), dtype)
    d = int(head[0])
    row_items = d + 1
    offset_bytes = offset_rows * row_items * 4
    items = -1 if count < 0 else count * row_items
    a = np.fromfile(fname, count=items, dtype=np.int32, offset=offset_bytes)
    n = a.size // row_items
    a = a[: n * row_items].reshape(n, row_items)
    assert np.all(a[:, 0] == d), f"inconsistent dims in {fname}"
    return a[:, 1:].copy().view(dtype)


def fvecs_read(fname: str, count: int = -1,
               offset_rows: int = 0) -> np.ndarray:
    return _vecs_read(fname, np.float32, count, offset_rows)


def ivecs_read(fname: str, count: int = -1,
               offset_rows: int = 0) -> np.ndarray:
    return _vecs_read(fname, np.int32, count, offset_rows)


def _vecs_write(fname: str, x: np.ndarray, dtype):
    x = np.ascontiguousarray(x, dtype)
    n, d = x.shape
    out = np.empty((n, d + 1), np.int32)
    out[:, 0] = d
    out[:, 1:] = x.view(np.int32)
    out.tofile(fname)


def fvecs_write(fname: str, x: np.ndarray):
    _vecs_write(fname, x, np.float32)


def ivecs_write(fname: str, x: np.ndarray):
    _vecs_write(fname, x, np.int32)


def _bin_read(fname: str, dtype, count: int = -1, offset_rows: int = 0):
    hdr = np.fromfile(fname, count=2, dtype=np.int32)
    n, d = int(hdr[0]), int(hdr[1])
    if count >= 0:
        n = min(count, n - offset_rows)
    else:
        n = n - offset_rows
    a = np.fromfile(fname, dtype=dtype, count=n * d,
                    offset=8 + offset_rows * d * np.dtype(dtype).itemsize)
    return a.reshape(n, d)


def fbin_read(fname: str, count: int = -1, offset_rows: int = 0) -> np.ndarray:
    return _bin_read(fname, np.float32, count, offset_rows)


def ibin_read(fname: str, count: int = -1, offset_rows: int = 0) -> np.ndarray:
    return _bin_read(fname, np.int32, count, offset_rows)


def bin_write(fname: str, x: np.ndarray):
    x = np.ascontiguousarray(x)
    n, d = x.shape
    with open(fname, "wb") as f:
        np.asarray([n, d], np.int32).tofile(f)
        x.tofile(f)
