"""Index files (port of the Flat and IVF-Flat parts of
``auncel_tpu/index/io.py``).

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

The ``Flat``, ``IVFFlat`` and ``IVFFlatDedup`` kinds are ported; every
other kind raises ``NotImplementedError``.

The on-disk directory (``save_index_ondisk``; served list by list by
``index/ondisk.py::OnDiskIVFIndex``, or loaded whole by
``load_index_ondisk``) is the JAX package's too: ``header.json`` (version,
kind "IVFFlatOnDisk", d, metric, nlist, ntotal), ``db.npy`` (the stored
vectors decoded to float32, [nlist, cap, d]), ``vec_ids.npy``,
``list_sizes.npy`` and ``centroids.npy``. Each package reads the other's
directory. As with ``save_index``, the port writes a residual-PQ index's
reconstructions; the JAX package writes the residuals.
"""

import json
import os

import numpy as np

from auncel_tpu_torch.index.flat import FlatIndex
from auncel_tpu_torch.index.ivf import (IVFFlatDedupIndex, IVFFlatIndex,
                                        decoded_db)
from auncel_tpu_torch.types import Metric

_FORMAT_VERSION = 1

# kinds the JAX package writes that the port does not load yet, and the
# ROADMAP.md item that ports each
_NOT_PORTED = {
    "IVFPQR": "queue 1 item 7 (ivfpqr.py)",
    "2Layer": "queue 1 item 7 (twolayer.py)",
    "BFlat": "queue 1 item 7 (binary.py)",
    "BIVF": "queue 1 item 7 (binary.py)",
    "BHNSW": "queue 1 item 7 (binary.py)",
}


def save_index(index, path: str) -> None:
    """Write a flat index, or an IVF-Flat (or dedup) index, trained or not,
    empty or not."""
    if isinstance(index, FlatIndex):
        header = dict(version=_FORMAT_VERSION, kind="Flat", d=index.d,
                      metric=index.metric.value)
        np.savez(path, header=json.dumps(header), xb=index.xb)
        return
    if not isinstance(index, IVFFlatIndex):
        raise NotImplementedError(
            f"cannot serialize {type(index).__name__}: the port writes "
            "Flat, IVFFlat and IVFFlatDedup files only (ROADMAP.md queue 1 "
            "item 7)")
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
        if kind in _NOT_PORTED:
            raise NotImplementedError(
                f"index kind {kind!r} is not ported: ROADMAP.md "
                f"{_NOT_PORTED[kind]}")
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
