"""Index files (port of ``auncel_tpu/index/io.py``).

The layout is the JAX package's: one ``.npz`` holding a JSON ``header``
(version, kind, d, metric, and for the IVF kinds nlist, trained, ntotal,
storage, and for the dedup kind the ``dup`` map) and the payload: ``xb``
for the ``Flat`` kind; for the IVF kinds ``centroids`` (when trained) and,
when vectors are stored, ``db`` (the stored vectors decoded to float32,
[nlist, cap, d]), ``vec_ids``, ``list_sizes`` and, for SQ storage,
``sq_scale``/``sq_bias``. A file either package writes loads in the other:
an SQ index reloads with its saved range and so re-encodes to the same
codes, a PQ index is written as its decoded vectors with storage "f32" (a
retrained codebook would not reproduce the codes), and a trained-but-empty
file (centroids only) is the trained-quantizer cache of the evaluation
harness. The port writes a residual-PQ index's reconstructions, each
list's centroid added back; the JAX package writes the decoded residuals
(``ROADMAP.md`` section 3).

An IMI index is written as kind ``IVFFlat`` (the header carries no
coarse quantizer, as in the JAX package). The exact kinds keep their
codes: ``IVFPQR`` (header M, M_refine, k_factor, nlist, ntotal; payload
the centroids, the first-stage codes ``db`` with ``vec_ids``,
``list_sizes`` and ``pq_books``, and the refine state ``refine_books``,
``refine_codes``, ``refine_sorted_ids``, ``refine_pos``; it loads as
residual PQ, and a loaded index refuses ``add``, since the raw vectors
are gone), ``2Layer`` (``centroids``, ``books``, ``list_ids``,
``codes``), ``BFlat`` (the packed ``codes``), ``BIVF`` (``codes``,
``centroid_bits``, nprobe, coarse_hnsw_m) and ``BHNSW`` (header M,
ef_search, entry, max_level; payload the packed ``codes``, ``levels`` and
each level's ``table{l}`` and ``g2u{l}``). The float HNSW family has its
own ``.npz`` (``HNSWIndex.save``/``load``, ``index/hnsw.py``).

The on-disk directory (``save_index_ondisk``; served list by list by
``index/ondisk.py::OnDiskIVFIndex``, or loaded whole by
``load_index_ondisk``) is the JAX package's too: ``header.json`` (version,
kind "IVFFlatOnDisk", d, metric, nlist, ntotal), ``db.npy`` (the stored
vectors decoded to float32, [nlist, cap, d]), ``vec_ids.npy``,
``list_sizes.npy`` and ``centroids.npy``. Each package reads the other's
directory. As with ``save_index``, the port writes a residual-PQ index's
reconstructions; the JAX package writes the residuals.
"""

import copy
import json
import os

import numpy as np

import torch

from auncel_tpu_torch.index.binary import (
    BinaryFlatIndex, BinaryHNSWIndex, BinaryIVFIndex, pack_bits, unpack_bits)
from auncel_tpu_torch.index.flat import FlatIndex
from auncel_tpu_torch.index.ivf import (IVFFlatDedupIndex, IVFFlatIndex,
                                        _decoded_norms, decoded_db)
from auncel_tpu_torch.index.ivfpqr import IndexIVFPQR
from auncel_tpu_torch.index.scan import IVFArrays
from auncel_tpu_torch.index.twolayer import Index2Layer
from auncel_tpu_torch.ops.distance import sqnorms
from auncel_tpu_torch.ops.pq import PQCodebooks
from auncel_tpu_torch.types import Metric

_FORMAT_VERSION = 1


def save_index(index, path: str) -> None:
    """Write a flat, IVF-Flat (or dedup, or IMI), IVFPQR, two-layer or
    binary (flat, IVF, HNSW) index, trained or not, empty or not."""
    if isinstance(index, FlatIndex):
        header = dict(version=_FORMAT_VERSION, kind="Flat", d=index.d,
                      metric=index.metric.value)
        np.savez(path, header=json.dumps(header), xb=index.xb)
        return
    if isinstance(index, IndexIVFPQR):
        _save_ivfpqr(index, path)
        return
    if isinstance(index, Index2Layer):
        header = dict(version=_FORMAT_VERSION, kind="2Layer", d=index.d,
                      metric=index.metric.value, nlist=index.nlist,
                      M=index.M, trained=index.is_trained)
        payload = dict(header=json.dumps(header))
        if index.is_trained:
            payload["centroids"] = index.centroids
            payload["books"] = index._pq.codebooks.cpu().numpy()
        payload["list_ids"] = index.list_ids
        payload["codes"] = index.codes
        np.savez(path, **payload)
        return
    if isinstance(index, BinaryFlatIndex):
        header = dict(version=_FORMAT_VERSION, kind="BFlat", d=index.d,
                      metric=index.metric.value)
        np.savez(path, header=json.dumps(header), codes=index.codes)
        return
    if isinstance(index, BinaryIVFIndex):
        header = dict(version=_FORMAT_VERSION, kind="BIVF", d=index.d,
                      metric=index.metric.value, nlist=index.nlist,
                      nprobe=index.nprobe, trained=index.is_trained,
                      coarse_hnsw_m=index.coarse_hnsw_m)
        payload = dict(header=json.dumps(header), codes=index._codes)
        if index.is_trained:
            payload["centroid_bits"] = index.centroid_bits
        np.savez(path, **payload)
        return
    if isinstance(index, BinaryHNSWIndex):
        _save_bhnsw(index, path)
        return
    if not isinstance(index, IVFFlatIndex):
        raise NotImplementedError(
            f"cannot serialize {type(index).__name__}: the port writes the "
            "Flat, IVFFlat, IVFFlatDedup, IVFPQR, 2Layer, BFlat, BIVF and "
            "BHNSW kinds (the float HNSW family: HNSWIndex.save)")
    dedup = isinstance(index, IVFFlatDedupIndex)
    storage = "f32" if index.storage.startswith("pq") else index.storage
    header = dict(version=_FORMAT_VERSION,
                  kind="IVFFlatDedup" if dedup else "IVFFlat", d=index.d,
                  metric=index.metric.value, nlist=index.nlist,
                  trained=index.is_trained, ntotal=index.ntotal,
                  storage=storage)
    if dedup:
        header["dup"] = {str(k): v for k, v in index._dup.items()}
    payload = dict(header=json.dumps(header))
    if index.is_trained:
        payload["centroids"] = index.centroids
    if index.ntotal:
        a = index.arrays
        payload["db"] = decoded_db(a).astype(np.float32)
        payload["vec_ids"] = a.vec_ids.cpu().numpy()
        payload["list_sizes"] = a.list_sizes.cpu().numpy()
        if a.sq_scale is not None:
            payload["sq_scale"] = a.sq_scale.cpu().numpy()
            payload["sq_bias"] = a.sq_bias.cpu().numpy()
    np.savez(path, **payload)


def load_index(path: str, device="cuda"):
    """Read an index file of either package onto ``device``."""
    with np.load(path, allow_pickle=False) as z:
        header = json.loads(str(z["header"]))
        kind = header["kind"]
        if kind == "Flat":
            idx = FlatIndex(header["d"], Metric.parse(header["metric"]),
                            device=device)
            idx.add(z["xb"])
            return idx
        if kind in _LOADERS:
            return _LOADERS[kind](z, header, device)
        if kind not in ("IVFFlat", "IVFFlatDedup"):
            raise ValueError(f"unrecognized index file {path}")
        dedup = kind == "IVFFlatDedup"
        cls = IVFFlatDedupIndex if dedup else IVFFlatIndex
        idx = cls(header["d"], header["nlist"],
                  Metric.parse(header["metric"]), device=device,
                  storage=header.get("storage", "f32"))
        if header["trained"]:
            idx.set_centroids(z["centroids"])
        if "sq_scale" in z:
            # the saved range: the codes re-encode bit for bit
            idx._sq_range_override = (np.asarray(z["sq_bias"], np.float32),
                                      np.asarray(z["sq_scale"], np.float32))
        if header["ntotal"]:
            vec_ids = z["vec_ids"]
            mask = vec_ids >= 0
            flat_x = z["db"][mask]
            flat_ids = vec_ids[mask].astype(np.int64)
            if dedup:
                # the stored rows are unique already
                IVFFlatIndex.add(idx, flat_x, flat_ids)
                idx._sig = {flat_x[r].tobytes(): int(flat_ids[r])
                            for r in range(len(flat_ids))}
            else:
                idx.add(flat_x, flat_ids)
        if dedup:
            idx._dup = {int(k): list(v)
                        for k, v in header.get("dup", {}).items()}
        return idx


def _save_bhnsw(index: BinaryHNSWIndex, path: str) -> None:
    """The packed codes and the graph's tables (the reference's
    write_index_binary keeps the HNSW structure too); a graph not built
    yet is built first."""
    g = index._g
    if g.ntotal and not g._built:
        g.build()
    header = dict(version=_FORMAT_VERSION, kind="BHNSW", d=index.d,
                  metric=index.metric.value, M=g.M, ef_search=g.ef_search,
                  entry=int(g.entry_point), max_level=int(g.max_level))
    codes = pack_bits(g._xb > 0.5) if g.ntotal else \
        np.zeros((0, index.d // 8), np.uint8)
    payload = dict(header=json.dumps(header), codes=codes,
                   levels=(g.levels if g.levels is not None
                           else np.zeros((0,), np.int32)))
    for l, t in enumerate(g.nb_tables):
        payload[f"table{l}"] = t
    for l, gg in enumerate(g.g2u):
        payload[f"g2u{l}"] = gg
    np.savez(path, **payload)


def bhnsw_from_state(z, header: dict, device="cuda") -> BinaryHNSWIndex:
    """A BinaryHNSWIndex on ``device`` from a ``BHNSW`` file's header
    (d, M, ef_search, entry, max_level) and payload (codes, levels,
    table{l}, g2u{l}): the graph as it was built."""
    idx = BinaryHNSWIndex(header["d"], M=header["M"],
                          ef_search=header["ef_search"], device=device)
    g = idx._g
    codes = np.asarray(z["codes"], np.uint8)
    if codes.shape[0]:
        g._xb = unpack_bits(codes, header["d"]).astype(np.float32)
        g.levels = np.asarray(z["levels"])
        g.entry_point = int(header["entry"])
        g.max_level = int(header["max_level"])
        g.nb_tables = [np.array(z[f"table{l}"], np.int32)
                       for l in range(g.max_level + 1)]
        g.g2u = [np.array(z[f"g2u{l}"], np.int32)
                 for l in range(g.max_level + 1)]
        g._push_dev()
        g._built = True
    return idx


def _save_ivfpqr(index: IndexIVFPQR, path: str) -> None:
    """Both PQ stages' codes as they are (the reference's write_index for
    IndexIVFPQR keeps them too, index_io.cpp)."""
    sorted_ids, pos, codes, books = index._ensure_refine()
    a = index.arrays
    header = dict(version=_FORMAT_VERSION, kind="IVFPQR", d=index.d,
                  metric=index.metric.value, nlist=index.nlist,
                  M=int(index.storage[2:]), M_refine=index.M_refine,
                  k_factor=index.k_factor, ntotal=index.ntotal)
    np.savez(path, header=json.dumps(header), centroids=index.centroids,
             db=a.db.cpu().numpy(), vec_ids=a.vec_ids.cpu().numpy(),
             list_sizes=a.list_sizes.cpu().numpy(),
             pq_books=a.pq_codebooks.cpu().numpy(),
             refine_books=books.cpu().numpy(),
             refine_codes=codes.cpu().numpy(),
             refine_sorted_ids=np.asarray(sorted_ids),
             refine_pos=pos.cpu().numpy())


def ivfpqr_from_codes(state, header: dict, device="cuda") -> IndexIVFPQR:
    """An IndexIVFPQR on ``device`` holding given codes exactly (an
    ``IVFPQR`` file's payload, or the JAX package's state by
    ``convert.ivfpqr_from_numpy``): residual PQ, as the JAX package loads
    it, the norms of the decoded residuals, and ``add`` refused."""
    idx = IndexIVFPQR(header["d"], header["nlist"], M=header["M"],
                      M_refine=header["M_refine"],
                      k_factor=header["k_factor"],
                      metric=Metric.parse(header["metric"]), device=device)
    idx.set_centroids(np.asarray(state["centroids"], np.float32))
    dev = idx.device

    def t(name, dtype):
        return torch.as_tensor(np.ascontiguousarray(
            np.asarray(state[name]).astype(dtype)), device=dev)
    cents = torch.as_tensor(idx.centroids, device=dev)
    arrays = IVFArrays(
        centroids=cents, cent_sq=sqnorms(cents), db=t("db", np.uint8),
        db_sq=None, vec_ids=t("vec_ids", np.int32),
        list_sizes=t("list_sizes", np.int32),
        interdis=torch.as_tensor(
            idx.interdis if idx.interdis is not None
            else np.zeros((1, 1), np.float32), device=dev),
        pq_codebooks=t("pq_books", np.float32), pq_residual=True)
    idx._arrays = arrays._replace(db_sq=_decoded_norms(arrays))
    idx._ntotal = int(header["ntotal"])
    idx._refine = (np.asarray(state["refine_sorted_ids"]).astype(np.int64),
                   t("refine_pos", np.int32), t("refine_codes", np.uint8),
                   t("refine_books", np.float32))
    idx._refine_of = idx._arrays
    idx._frozen_codes = True
    return idx


def _load_2layer(z, header: dict, device) -> Index2Layer:
    idx = Index2Layer(header["d"], header["nlist"], M=header["M"],
                      metric=Metric.parse(header["metric"]), device=device)
    if header["trained"]:
        idx.centroids = np.asarray(z["centroids"], np.float32)
        idx._pq = PQCodebooks(torch.as_tensor(
            np.asarray(z["books"], np.float32), device=idx.device))
        idx.is_trained = True
    idx.list_ids = np.asarray(z["list_ids"], np.int32)
    idx.codes = np.asarray(z["codes"], np.uint8)
    return idx


def _load_bflat(z, header: dict, device) -> BinaryFlatIndex:
    idx = BinaryFlatIndex(header["d"], device=device)
    if z["codes"].shape[0]:
        idx.add(np.asarray(z["codes"], np.uint8))
    return idx


def _load_bivf(z, header: dict, device) -> BinaryIVFIndex:
    idx = BinaryIVFIndex(header["d"], header["nlist"],
                         coarse_hnsw_m=header.get("coarse_hnsw_m"),
                         device=device)
    idx.nprobe = header.get("nprobe", 1)
    if header["trained"]:
        idx.centroid_bits = np.asarray(z["centroid_bits"], np.uint8)
        idx.is_trained = True
    codes = np.asarray(z["codes"], np.uint8)
    if codes.shape[0]:
        idx.add(codes)
    return idx


_LOADERS = {
    "IVFPQR": ivfpqr_from_codes,
    "2Layer": _load_2layer,
    "BFlat": _load_bflat,
    "BIVF": _load_bivf,
    "BHNSW": bhnsw_from_state,
}


def save_index_ondisk(index: IVFFlatIndex, dirpath: str) -> None:
    """Write an IVF index as an on-disk directory (the reference's
    OnDiskInvertedLists capability): the padded list tensor as a raw
    ``.npy`` that ``OnDiskIVFIndex`` serves without loading it whole."""
    os.makedirs(dirpath, exist_ok=True)
    a = index.arrays
    np.save(os.path.join(dirpath, "db.npy"),
            np.ascontiguousarray(decoded_db(a), np.float32))
    np.save(os.path.join(dirpath, "vec_ids.npy"), a.vec_ids.cpu().numpy())
    np.save(os.path.join(dirpath, "list_sizes.npy"),
            a.list_sizes.cpu().numpy())
    np.save(os.path.join(dirpath, "centroids.npy"), index.centroids)
    header = dict(version=_FORMAT_VERSION, kind="IVFFlatOnDisk", d=index.d,
                  metric=index.metric.value, nlist=index.nlist,
                  ntotal=index.ntotal)
    with open(os.path.join(dirpath, "header.json"), "w") as f:
        json.dump(header, f)


def load_index_ondisk(dirpath: str, device="cuda") -> IVFFlatIndex:
    """A resident float32 IVFFlatIndex on ``device`` from an on-disk
    directory: this reads the whole corpus (for a corpus larger than the
    card, serve the directory with ``OnDiskIVFIndex``)."""
    with open(os.path.join(dirpath, "header.json")) as f:
        header = json.load(f)
    if header["kind"] != "IVFFlatOnDisk":
        raise ValueError(f"{dirpath} holds kind {header['kind']!r}, not an "
                         "on-disk IVF directory")
    idx = IVFFlatIndex(header["d"], header["nlist"],
                       Metric.parse(header["metric"]), device=device)
    idx.set_centroids(np.load(os.path.join(dirpath, "centroids.npy")))
    db = np.load(os.path.join(dirpath, "db.npy"), mmap_mode="r")
    vec_ids = np.load(os.path.join(dirpath, "vec_ids.npy"), mmap_mode="r")
    mask = vec_ids >= 0
    idx.add(np.asarray(db[mask]), ids=np.asarray(vec_ids[mask], np.int64))
    return idx


def clone_index(index):
    """Deep, independent copy (reference ``clone_index``/``Cloner``,
    index_io.h:73). Torch tensors are mutable, so the copy owns every
    tensor (each cloned on its own device), and ``add``/``train``/
    ``reset`` on either copy leave the other as it was. The lists of an
    ``OnDiskIVFIndex`` stay shared: read-only memmaps of its directory.
    The kernels' libraries are module state, not the index's."""
    memo = {id(a): a for a in vars(index).values()
            if isinstance(a, np.memmap)}
    return copy.deepcopy(index, memo)
