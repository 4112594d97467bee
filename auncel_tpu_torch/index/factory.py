"""Index factory strings (port of ``auncel_tpu/index/factory.py``; the
reference grammar of ``AutoTune.cpp:741-960``).

Served: the transform prefixes ``PCAn``, ``PCARn``, ``OPQm``, ``RR`` and
``L2norm``; the cells ``Flat``, ``PQm``, ``SQ8``, ``SQ4``, ``SQ6``,
``SQfp16`` and ``SQbf16`` (fp16 maps to bf16, as in the JAX package);
``IVFn,{Flat,SQ8,SQ4,SQ6,SQfp16,SQbf16,PQm}`` and the same cells over IMI
product cells, ``IMI2xb,...`` (nlist = 4^b, ``index/imi.py``);
``IVFn,PQm+r`` (``IndexIVFPQR``), ``LSHn[r][t]`` (``IndexLSH``: r rotates,
t trains thresholds) and ``IVFn,SHn`` (``IVFSpectralHashIndex``); the
graph cells ``HNSWn[,Flat]``, ``HNSWn_SQ8``, ``HNSWn_PQm``,
``HNSWn_l+PQm`` and ``HNSWn_2xb+PQm`` (``index/hnsw.py``: flat, SQ8, PQ
and two-level storage, the last over k-means or IMI product cells), and
``IVFn_HNSWm,...`` (the IVF cells with the lists of fixed-nprobe search
ranked by an HNSW graph over the centroids); and the ``,RFlat`` and
``IDMap`` wrappers. Anything else raises as the JAX package does. Binary
descriptions go through ``index/binary.py::index_binary_factory``.
"""

import re

from auncel_tpu_torch.index.base import Index
from auncel_tpu_torch.index.flat import (FlatIndex, IndexRefineFlat,
                                         IndexScalarQuantizer)
from auncel_tpu_torch.index.hnsw import (
    HNSWIndex, IndexHNSW2Level, IndexHNSWPQ, IndexHNSWSQ)
from auncel_tpu_torch.index.ivf import IVFFlatIndex
from auncel_tpu_torch.index.ivfpqr import IndexIVFPQR
from auncel_tpu_torch.index.lsh import IndexLSH, IVFSpectralHashIndex
from auncel_tpu_torch.index.meta import IndexIDMap
from auncel_tpu_torch.index.pq_index import IndexPQ
from auncel_tpu_torch.index.transform import (
    IndexPreTransform, NormalizationTransform, OPQMatrix, PCAMatrix,
    RandomRotationMatrix)
from auncel_tpu_torch.index.twolayer import IMICoarseQuantizer
from auncel_tpu_torch.types import Metric

_SQ_CELLS = {"SQ8": "sq8", "SQ4": "sq4", "SQ6": "sq6", "SQfp16": "bf16",
             "SQbf16": "bf16"}


def index_factory(d: int, description: str, metric: Metric = Metric.L2,
                  device="cuda") -> Index:
    """The index a factory string describes, on ``device``."""
    metric = Metric.parse(metric)
    parts = [p.strip() for p in description.strip().split(",")]

    # leading transform prefixes (AutoTune.cpp:760-800)
    transforms = []
    cur_d = d
    while parts:
        p = parts[0]
        m = re.fullmatch(r"PCA(R?)(\d+)", p)
        if m:
            transforms.append(PCAMatrix(cur_d, int(m.group(2)),
                                        random_rotation=bool(m.group(1)),
                                        device=device))
            cur_d = int(m.group(2))
        elif re.fullmatch(r"OPQ(\d+)", p):
            transforms.append(OPQMatrix(cur_d, int(p[3:]), device=device))
        elif p == "L2norm":
            transforms.append(NormalizationTransform(cur_d))
        elif re.fullmatch(r"RR(\d+)?", p):
            transforms.append(RandomRotationMatrix(cur_d))
        else:
            break
        parts.pop(0)

    # "IDMap" wraps the final index for user ids (AutoTune.cpp:812-816);
    # a trailing "RFlat" re-ranks exactly (AutoTune.cpp:911-918)
    want_idmap = "IDMap" in parts
    parts = [p for p in parts if p != "IDMap"]
    want_rflat = bool(parts) and parts[-1] == "RFlat"
    if want_rflat:
        parts = parts[:-1]

    desc = ",".join(parts)
    if desc == "Flat":
        index: Index = FlatIndex(cur_d, metric, device=device)
    elif m := re.fullmatch(r"HNSW(\d+)?(,Flat)?", desc):
        # the standalone graph (AutoTune.cpp:888-905)
        index = HNSWIndex(cur_d, M=int(m.group(1) or 32), metric=metric,
                          device=device)
    elif m := re.fullmatch(r"HNSW(\d+)_SQ8", desc):
        # graph over SQ8 codes (AutoTune.cpp:908-910; SQ8 only there)
        index = IndexHNSWSQ(cur_d, M=int(m.group(1)), metric=metric,
                            device=device)
    elif m := re.fullmatch(r"HNSW(\d+)_PQ(\d+)", desc):
        # graph over PQ codes (AutoTune.cpp:902-904)
        index = IndexHNSWPQ(cur_d, pq_m=int(m.group(2)), M=int(m.group(1)),
                            metric=metric, device=device)
    elif m := re.fullmatch(r"HNSW(\d+)_(\d+)\+PQ(\d+)", desc):
        # graph over two-level codes, k-means lists (AutoTune.cpp:886-891)
        index = IndexHNSW2Level(cur_d, nlist=int(m.group(2)),
                                pq_m=int(m.group(3)), M=int(m.group(1)),
                                metric=metric, device=device)
    elif m := re.fullmatch(r"HNSW(\d+)_2x(\d+)\+PQ(\d+)", desc):
        # graph over two-level codes, IMI product cells
        # (AutoTune.cpp:893-899)
        nbit = int(m.group(2))
        index = IndexHNSW2Level(
            cur_d, nlist=(1 << nbit) ** 2, pq_m=int(m.group(3)),
            M=int(m.group(1)), metric=metric, device=device,
            quantizer=IMICoarseQuantizer(cur_d, nbit, metric, device=device))
    elif re.fullmatch(r"PQ(\d+)", desc):
        index = IndexPQ(cur_d, M=int(desc[2:]), metric=metric, device=device)
    elif desc in _SQ_CELLS:
        index = IndexScalarQuantizer(cur_d, qtype=_SQ_CELLS[desc],
                                     metric=metric, device=device)
    elif m := re.fullmatch(r"LSH(\d+)?(r)?(t)?", desc):
        # sign-bit signatures (IndexLSH.h:21)
        index = IndexLSH(cur_d, nbits=int(m.group(1) or cur_d),
                         rotate_data=bool(m.group(2)),
                         train_thresholds=bool(m.group(3)), device=device)
    elif m := re.fullmatch(r"IVF(\d+),SH(\d+)?", desc):
        # IVF over spectral-hash codes (IndexIVFSpectralHash.h:30)
        index = IVFSpectralHashIndex(cur_d, nlist=int(m.group(1)),
                                     nbit=int(m.group(2) or cur_d),
                                     device=device)
    elif m := re.fullmatch(r"IVF(\d+),PQ(\d+)\+(\d+)", desc):
        # IVFPQ with the refinement PQ re-rank (AutoTune.cpp:854-866; L2
        # only there, as IndexIVFPQR enforces)
        index = IndexIVFPQR(cur_d, int(m.group(1)), M=int(m.group(2)),
                            M_refine=int(m.group(3)), metric=metric,
                            device=device)
    else:
        coarse, hnsw_m = "kmeans", None
        m = re.fullmatch(r"IMI2x(\d+),(\w+)", desc)
        if m:
            # inverted multi-index cells (AutoTune.cpp:807): (2^b)^2
            nlist, cell, coarse = (1 << int(m.group(1))) ** 2, m.group(2), \
                "imi"
        else:
            m = re.fullmatch(r"IVF(\d+)(?:_HNSW(\d+))?,(\w+)", desc)
            if not m:
                raise NotImplementedError(
                    f"factory description {description!r}")
            nlist, cell = int(m.group(1)), m.group(3)
            hnsw_m = int(m.group(2)) if m.group(2) else None
        if cell == "Flat":
            storage = "f32"
        elif cell in _SQ_CELLS:
            storage = _SQ_CELLS[cell]
        elif re.fullmatch(r"PQ\d+", cell):
            m_sub = int(cell[2:])
            if cur_d % m_sub != 0:
                raise ValueError(f"PQ{m_sub}: d={cur_d} not divisible")
            storage = f"pq{m_sub}"
        else:
            raise NotImplementedError(
                f"IVF cell type {cell!r} not implemented yet (reference "
                f"grammar: AutoTune.cpp:741-960)")
        index = IVFFlatIndex(cur_d, nlist, metric, device=device,
                             storage=storage, coarse=coarse)
        # IVF%d_HNSW%d (AutoTune.cpp:807-820): the lists of fixed-nprobe
        # search ranked through an HNSW graph over the centroids
        index.coarse_hnsw_m = hnsw_m

    if want_rflat:
        index = IndexRefineFlat(index)
    if want_idmap:
        index = IndexIDMap(index)
    if transforms:
        return IndexPreTransform(index, transforms)
    return index
