"""IVF utility functions (port of ``auncel_tpu/index/ivflib.py``).

Capability parity with the reference's ``IVFlib`` (``IVFlib.{h,cpp}``):
centroid-level probes, index merging, subset extraction, list ranges and
the sliding window over a streaming corpus. All are host-level
compositions over the padded layout: they move vectors between indexes,
and the indexes' own searches do the scanning.
"""

import numpy as np

from auncel_tpu_torch.index.ivf import IVFFlatIndex


def extract_index_ivf(index) -> IVFFlatIndex:
    """Unwrap meta and transform wrappers down to the embedded IVF index
    (reference IVFlib::extract_index_ivf, IVFlib.h:35-36; walks every
    wrapper with a ``sub``). Raises TypeError when there is no IVF
    inside."""
    seen = index
    while not isinstance(index, IVFFlatIndex):
        sub = getattr(index, "sub", None)
        if sub is None:
            raise TypeError(
                f"no IVF index inside {type(seen).__name__} "
                f"(stopped at {type(index).__name__})")
        index = sub
    return index


def check_compatible_for_merge(index0, index1) -> None:
    """Raise ValueError unless the two indexes share dimensionality,
    metric, quantizer (same centroids) and storage codec (reference
    IVFlib::check_compatible_for_merge, IVFlib.h:27-28)."""
    a = extract_index_ivf(index0)
    b = extract_index_ivf(index1)
    if a.d != b.d:
        raise ValueError(f"dimension mismatch: {a.d} vs {b.d}")
    if a.metric is not b.metric:
        raise ValueError(f"metric mismatch: {a.metric} vs {b.metric}")
    if a.nlist != b.nlist:
        raise ValueError(f"nlist mismatch: {a.nlist} vs {b.nlist}")
    if a.storage != b.storage:
        raise ValueError(f"storage codec mismatch: "
                         f"{a.storage} vs {b.storage}")
    if not (a.is_trained and b.is_trained):
        raise ValueError("both indexes must be trained")
    if not np.array_equal(a.centroids, b.centroids):
        raise ValueError("indexes are trained with different quantizers "
                         "(centroids differ)")


def search_with_parameters(index, q: np.ndarray, k: int, nprobe: int,
                           max_codes: int = 0):
    """One search under explicit (nprobe, max_codes) without changing the
    index's own settings (reference IVFlib::search_with_parameters,
    IVFlib.h:121-126), through any wrapper."""
    ivf = extract_index_ivf(index)
    saved = (ivf.nprobe, ivf.max_codes)
    ivf.nprobe, ivf.max_codes = int(nprobe), int(max_codes)
    try:
        return index.search(q, k)
    finally:
        ivf.nprobe, ivf.max_codes = saved


def get_invlist_range(index, i0: int, i1: int):
    """Lists [i0, i1) as a standalone ``IVFArrays`` carrying the source
    codec (reference IVFlib::get_invlist_range, IVFlib.h:111-113)."""
    from auncel_tpu_torch.index.invlists import slice_invlists
    return slice_invlists(extract_index_ivf(index).arrays, i0, i1)


def set_invlist_range(index, i0: int, i1: int, src) -> None:
    """Replace lists [i0, i1) with ``src``, a ``get_invlist_range`` slice
    of an index on the same quantizer (reference
    IVFlib::set_invlist_range, IVFlib.h:115-117). The layout is rebuilt
    by assignment through the shared quantizer, so the splice is exact
    for quantizer-consistent slices; it takes the default packing
    (cap_quantile 1.0), no dedup index and no PQ storage (re-adding would
    retrain the codebooks and shift untouched lists), as the JAX package
    does."""
    from auncel_tpu_torch.index.ivf import (IVFFlatDedupIndex, decoded_db,
                                            preserve_sq_range)
    ivf = extract_index_ivf(index)
    if ivf.cap_quantile < 1.0:
        raise ValueError("set_invlist_range requires cap_quantile == 1.0 "
                         "(list spilling re-homes boundary vectors)")
    if isinstance(ivf, IVFFlatDedupIndex):
        raise TypeError("set_invlist_range does not support "
                        "IVFFlatDedupIndex")
    if ivf.storage.startswith("pq"):
        raise ValueError("set_invlist_range does not support pq storage "
                         "(codebooks would retrain; distances of "
                         "untouched lists would shift)")
    a = ivf.arrays
    n_src = src.db.shape[0]
    if not (0 <= i0 < i1 <= a.nlist and n_src == i1 - i0):
        raise ValueError(f"range [{i0}, {i1}) does not match src nlist "
                         f"{n_src}")
    if not np.allclose(src.centroids.cpu().numpy(),
                       a.centroids.cpu().numpy()[i0:i1]):
        raise ValueError("src slice was built under a different quantizer "
                         "(centroid rows differ)")
    dst_dec, dst_ids = decoded_db(a), a.vec_ids.cpu().numpy()
    src_dec, src_ids = decoded_db(src), src.vec_ids.cpu().numpy()
    keep = dst_ids >= 0
    keep[i0:i1] = False                      # dropped: the replaced range
    take = src_ids >= 0                      # inserted: src's contents
    x = np.concatenate([dst_dec[keep], src_dec[take]], 0)
    ids = np.concatenate([dst_ids[keep], src_ids[take]], 0).astype(np.int64)
    preserve_sq_range(ivf)                   # SQ codes stay bit for bit
    ivf.reset()
    if x.shape[0]:
        ivf.add(x, ids=ids)


def search_centroid(index: IVFFlatIndex, x: np.ndarray) -> np.ndarray:
    """Nearest-centroid id per row (reference IVFlib::search_centroid)."""
    return index.assign(x)


def search_and_return_centroids(index: IVFFlatIndex, q: np.ndarray, k: int,
                                nprobe: int):
    """Search and also report which list each result came from (reference
    IVFlib::search_and_return_centroids): (vals, ids, result_centroids
    [nq, k])."""
    vals, ids = index.search(q, k, nprobe=nprobe)
    ids_np = index.arrays.vec_ids.cpu().numpy()
    max_id = int(ids_np.max()) if ids_np.size else 0
    vec2list = np.full(max_id + 2, -1, np.int32)
    for l in range(ids_np.shape[0]):
        vec2list[ids_np[l][ids_np[l] >= 0]] = l
    cent = np.where(ids >= 0, vec2list[np.maximum(ids, 0)], -1)
    return vals, ids, cent


def extract_vectors(index: IVFFlatIndex):
    """All stored vectors, decoded (with the list's centroid for residual
    PQ), and their ids, from the padded layout."""
    from auncel_tpu_torch.index.ivf import decoded_db
    a = index.arrays
    ids = a.vec_ids.cpu().numpy()
    keep = ids >= 0
    return (decoded_db(a)[keep].astype(np.float32),
            ids[keep].astype(np.int64))


def merge_into(dst: IVFFlatIndex, src: IVFFlatIndex) -> None:
    """Move src's vectors into dst (reference IVFlib::merge_into: there an
    inverted-list splice, here a re-add under dst's quantizer)."""
    assert dst.d == src.d and dst.metric is src.metric
    x, ids = extract_vectors(src)
    if x.shape[0]:
        dst.add(x, ids=ids)
    src.reset()


def copy_subset_to(src: IVFFlatIndex, dst: IVFFlatIndex,
                   id_min: int, id_max: int) -> int:
    """Copy the vectors with ids in [id_min, id_max) (reference
    IndexIVF::copy_subset_to, subset_type 0). Returns the count copied."""
    x, ids = extract_vectors(src)
    sel = (ids >= id_min) & (ids < id_max)
    if sel.any():
        dst.add(x[sel], ids=ids[sel])
    return int(sel.sum())


class SlidingIndexWindow:
    """Streaming corpus window (reference IVFlib::SlidingIndexWindow): the
    most recent ``nw`` batches stay searchable; a batch beyond the window
    drops the oldest. The layout is repacked each step."""

    def __init__(self, index: IVFFlatIndex, nw: int):
        self.index = index
        self.nw = nw
        self._batches: list[tuple[np.ndarray, np.ndarray]] = []

    def step(self, x: np.ndarray, ids: np.ndarray) -> None:
        self._batches.append((np.asarray(x, np.float32),
                              np.asarray(ids, np.int64)))
        if len(self._batches) > self.nw:
            self._batches.pop(0)
        self.index.reset()
        for bx, bids in self._batches:
            self.index.add(bx, ids=bids)
