"""Composite inverted-list views (port of ``auncel_tpu/index/invlists.py``).

Capability parity with the reference's stacked, sliced and masked
``InvertedLists`` adapters (``InvertedLists.h:211-325``: HStack, VStack,
Slice, Masked). The reference composes lists lazily through virtual
``get_codes``/``get_ids`` per probed list; here each composition
materialises a new padded ``IVFArrays`` once, on the host, on the first
source's device, after which every search path scans the combined layout
as it scans any index's.

All sources must share the storage codec (dtype, SQ range, PQ codebooks,
residual or not), so the combined lists stay value-consistent.
"""

import numpy as np
import torch

from auncel_tpu_torch.index.scan import IVFArrays
from auncel_tpu_torch.ops.distance import sqnorms


def _codec_key(a: IVFArrays):
    def fp(x):
        return None if x is None else x.cpu().numpy().tobytes()
    return (a.db.dtype, fp(a.sq_scale), fp(a.sq_bias), fp(a.pq_codebooks),
            bool(a.pq_residual))


def _lists_of(a: IVFArrays):
    """Host views: per-list (codes [sz, width], ids [sz]) without pad."""
    db = a.db.cpu()
    ids = a.vec_ids.cpu().numpy()
    sizes = a.list_sizes.cpu().numpy()
    return [(db[l, : sizes[l]], ids[l, : sizes[l]])
            for l in range(db.shape[0])]


def _build(centroids: np.ndarray, lists, proto: IVFArrays) -> IVFArrays:
    """Padded re-pack of per-list (codes, ids) under proto's codec."""
    nlist = len(lists)
    sizes = np.array([len(ids) for _, ids in lists], np.int32)
    cap = max(int(sizes.max()) if nlist else 1, 1)
    dev = proto.db.device
    db = torch.zeros((nlist, cap, proto.db.shape[-1]), dtype=proto.db.dtype)
    vec_ids = np.full((nlist, cap), -1, np.int32)
    for l, (codes, ids) in enumerate(lists):
        db[l, : len(ids)] = codes
        vec_ids[l, : len(ids)] = ids
    db = db.to(dev)
    cents = torch.as_tensor(np.asarray(centroids, np.float32), device=dev)
    vec_ids = torch.as_tensor(vec_ids, device=dev)
    out = IVFArrays(
        centroids=cents, cent_sq=sqnorms(cents), db=db, db_sq=None,
        vec_ids=vec_ids, list_sizes=torch.as_tensor(sizes, device=dev),
        # interdis feeds the error-profile engines; composed views serve
        # fixed-nprobe search, like the reference's read-only views
        interdis=torch.zeros((1, 1), dtype=torch.float32, device=dev),
        sq_scale=proto.sq_scale, sq_bias=proto.sq_bias,
        pq_codebooks=proto.pq_codebooks, pq_residual=proto.pq_residual)
    # the float32 norms of the decoded stored values (the residual r for
    # residual PQ; the scan adds the centroid terms), zero at padding
    return out._replace(db_sq=torch.where(
        vec_ids >= 0, sqnorms(out.decode_block(db)), 0.0))


def hstack_invlists(arrays: list[IVFArrays]) -> IVFArrays:
    """Concatenate entries list by list (reference HStackInvertedLists,
    InvertedLists.h:229: same nlist, list i of the result is every
    source's list i in turn). Sources share the quantizer and codec."""
    assert arrays, "need at least one source"
    a0 = arrays[0]
    c0 = a0.centroids.cpu().numpy()
    for a in arrays[1:]:
        assert _codec_key(a) == _codec_key(a0), "codec mismatch"
        assert np.array_equal(a.centroids.cpu().numpy(), c0), \
            "HStack requires a shared quantizer"
    per = [_lists_of(a) for a in arrays]
    lists = [(torch.cat([p[l][0] for p in per], 0),
              np.concatenate([p[l][1] for p in per], 0))
             for l in range(len(per[0]))]
    return _build(c0, lists, a0)


def vstack_invlists(arrays: list[IVFArrays]) -> IVFArrays:
    """Concatenate the list axis (reference VStackInvertedLists,
    InvertedLists.h:278: nlist is the sum of the sources'; list numbers
    are offset by the lists before). Centroids concatenate the same way."""
    assert arrays, "need at least one source"
    a0 = arrays[0]
    for a in arrays[1:]:
        assert _codec_key(a) == _codec_key(a0), "codec mismatch"
    cents = np.concatenate([a.centroids.cpu().numpy() for a in arrays], 0)
    lists = []
    for a in arrays:
        lists.extend(_lists_of(a))
    return _build(cents, lists, a0)


def slice_invlists(a: IVFArrays, i0: int, i1: int) -> IVFArrays:
    """Lists [i0, i1) as a standalone layout of i1 - i0 lists (reference
    SliceInvertedLists, InvertedLists.h:256)."""
    assert 0 <= i0 < i1 <= a.db.shape[0]
    return _build(a.centroids.cpu().numpy()[i0:i1], _lists_of(a)[i0:i1], a)


def masked_invlists(il0: IVFArrays, il1: IVFArrays) -> IVFArrays:
    """il1's non-empty lists override il0's (reference
    MaskedInvertedLists, InvertedLists.h:307: patch a subset of lists over
    a large base)."""
    assert _codec_key(il0) == _codec_key(il1), "codec mismatch"
    assert il0.db.shape[0] == il1.db.shape[0]
    l0, l1 = _lists_of(il0), _lists_of(il1)
    lists = [l1[i] if len(l1[i][1]) else l0[i] for i in range(len(l0))]
    return _build(il0.centroids.cpu().numpy(), lists, il0)
