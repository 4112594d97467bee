"""Shared fixture of the parity tests between auncel_tpu (JAX, the
reference) and auncel_tpu_torch (the PyTorch port).

A small skewed IVF index (d=16, nlist=32, ~4000 vectors, max_topk=20, 80
training and 20 held-out queries) is built ONCE per process with the JAX
package: centroids, multi-row layout, ground truth and trained profile.
``port_state`` hands the same state to the port through
``auncel_tpu_torch.convert``, so both packages compute on identical data.
``padded_systems`` gives both packages an ErrorSys on the same index
without the multi-row layout, serving the fixture's saved profile.
"""

import functools
import os
import tempfile

import numpy as np
import torch

torch.set_num_threads(1)  # the suite runs several test processes at once

# the port's entry points default to the card; its parity tests run on the
# CPU, where every kernel's plain version runs
DEVICE = "cpu"

D, NLIST, NB = 16, 32, 4000
N_TRAIN, N_TEST, MAX_TOPK, K = 80, 20, 20, 10
ROW_CAP = 64
ACC = 0.9


def make_data(seed: int = 11):
    """Clustered corpus with skewed list sizes (share ~ 1/sqrt(rank): the
    largest lists span several rows) and queries near the clusters.
    Centred data keeps distances comparable to the norms, so the L2
    expansion stays accurate to ~1e-6 relative in both packages."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(NLIST, D).astype(np.float32)
    pops = 1.0 / np.sqrt(np.arange(1, NLIST + 1))
    pops /= pops.sum()
    which = rng.choice(NLIST, size=NB, p=pops)
    xb = (centers[which] + 0.5 * rng.randn(NB, D)).astype(np.float32)
    nq = N_TRAIN + N_TEST
    xq = (centers[rng.choice(NLIST, nq)]
          + 0.6 * rng.randn(nq, D)).astype(np.float32)
    return centers, xb, xq


def as_numpy(nt) -> dict:
    """A JAX NamedTuple's fields as numpy arrays (nested NamedTuples as
    dicts, None kept)."""
    out = {}
    for f, v in nt._asdict().items():
        if hasattr(v, "_asdict"):
            out[f] = as_numpy(v)
        else:
            out[f] = None if v is None else np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def jax_fixture():
    """The JAX reference: index with the multi-row layout, GT and a
    trained ErrorSys (bounds ACC, query_k K)."""
    import auncel_tpu as at
    from auncel_tpu.index.ivf import IVFFlatIndex
    centers, xb, xq = make_data()
    idx = IVFFlatIndex(D, NLIST)
    idx.set_centroids(centers)
    idx.add(xb)
    idx.enable_multirow(row_cap=ROW_CAP)
    gt_D, gt_I = idx.exact_search(xq, MAX_TOPK)
    es = at.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    es.sys_train(N_TRAIN, xq)
    es.set_topk(K)
    es.set_queries(N_TEST, xq, np.full(N_TRAIN + N_TEST, ACC, np.float32))
    es.set_hyper(2.0, 1.0)
    return dict(idx=idx, es=es, centers=centers, xb=xb, xq=xq, gt_D=gt_D,
                gt_I=gt_I)


@functools.lru_cache(maxsize=None)
def port_state():
    """The fixture's JAX state carried into the port: (index, arrays,
    multirow, traces), all on the CPU."""
    from auncel_tpu_torch.convert import (
        ivf_arrays_from_numpy, multirow_from_numpy, traces_from_numpy)
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    arrays = ivf_arrays_from_numpy(as_numpy(f["idx"].arrays), DEVICE)
    mr = multirow_from_numpy(as_numpy(f["idx"].multirow), DEVICE)
    traces = traces_from_numpy(as_numpy(f["es"].traces), DEVICE)
    index = IVFFlatIndex.from_state(f["centers"], arrays, multirow=mr)
    return index, arrays, mr, traces


@functools.lru_cache(maxsize=None)
def padded_systems():
    """(port ErrorSys, JAX ErrorSys) on the fixture's index WITHOUT the
    multi-row layout, so both run their padded engines. The JAX index is
    built on the fixture's centroids and vectors; the port's shares the
    carried padded arrays. Both load the fixture's saved profile instead of
    training again."""
    import auncel_tpu as at
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    import auncel_tpu_torch as att
    f = jax_fixture()
    jidx = JIVF(D, NLIST)
    jidx.set_centroids(f["centers"])
    jidx.add(f["xb"])
    _, arrays, _, _ = port_state()
    index = att.IVFFlatIndex.from_state(f["centers"], arrays)
    jes = at.ErrorSys(jidx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es = att.ErrorSys(index, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.npz")
        f["es"].save_profile(path)
        for e in (es, jes):
            e.set_gt(f["gt_D"], f["gt_I"])
            e.load_profile(path)
    return es, jes


def tnp(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
