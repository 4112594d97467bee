"""Carry index, profile and LAET model state from the JAX package into the
port.

Each function takes the JAX package's state as a dict of numpy arrays
(``{name: np.asarray(value)}`` of an ``IVFArrays``, ``MultiRowArrays``,
``TraceSet`` or LAET ``_MLP``; a nested ``rows`` dict for
``MultiRowArrays``), so this module imports no jax. The LAET regressor's
weights are the ones carried across. The storage codec comes across as it
is: float32 or bfloat16 vectors, SQ codes with their range, or PQ codes
with their codebooks. With them both packages compute on identical state. The tensors go to the card unless
``device`` says otherwise.
"""

import numpy as np
import torch

from auncel_tpu_torch.baselines.laet import MLP
from auncel_tpu_torch.index.scan import IVFArrays, RowArrays
from auncel_tpu_torch.index.multirow import MultiRowArrays
from auncel_tpu_torch.profile.trace import TraceSet, traces_from_arrays

_INT_FIELDS = ("vec_ids", "list_sizes", "row_table", "rows_per_list",
               "row_base", "row_list", "n_bins")


def _tensor(name: str, a, device) -> torch.Tensor:
    dtype = np.int32 if name in _INT_FIELDS else np.float32
    return torch.as_tensor(np.array(a, dtype=dtype, order="C"), device=device)


def _storage(a) -> torch.Tensor:
    """The stored vectors as they are: float32, uint8 codes, or bfloat16,
    whose bytes are reinterpreted (never rounded through float32; the
    dtype is recognised by name, so no ml_dtypes import is needed)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    if a.dtype == np.uint8:
        return torch.from_numpy(np.ascontiguousarray(a).copy())
    return torch.as_tensor(np.array(a, dtype=np.float32, order="C"))


def ivf_arrays_from_numpy(state: dict, device="cuda") -> IVFArrays:
    """IVFArrays from the JAX package's IVFArrays fields: float32 or
    bfloat16 vectors, uint8 SQ codes with ``sq_scale`` and ``sq_bias``, or
    uint8 PQ codes with ``pq_codebooks``. The JAX package marks residual PQ
    with ``pq_residual`` = ``()`` (None otherwise); the port with True."""
    fields = {}
    for f in IVFArrays._fields:
        v = state.get(f)
        if f == "db":
            fields[f] = _storage(v).to(device)
        elif f == "pq_residual":
            fields[f] = v is not None
        elif v is not None:
            fields[f] = _tensor(f, v, device)
    return IVFArrays(**fields)


def multirow_from_numpy(state: dict, device="cuda") -> MultiRowArrays:
    """MultiRowArrays from the JAX package's fields; ``state["rows"]`` is
    the IVFArrays dict of the row layout."""
    rows = RowArrays(*ivf_arrays_from_numpy(state["rows"], device))
    return MultiRowArrays(rows, *(_tensor(f, state[f], device)
                                  for f in MultiRowArrays._fields[1:]))


def traces_from_numpy(state: dict, device="cuda") -> TraceSet:
    """TraceSet from the JAX package's TraceSet fields."""
    return traces_from_arrays(state["phi"], state["u"], state["std"],
                              state["n_bins"], device)


def mlp_from_numpy(state: dict, device="cuda"):
    """The LAET regressor from the JAX package's ``_MLP`` fields (numpy
    ``w1, b1, w2, b2, w3, b3``, weights [in, out])."""
    w1 = np.asarray(state["w1"], np.float32)
    mlp = MLP(w1.shape[0], w1.shape[1])
    with torch.no_grad():
        for f in ("w1", "b1", "w2", "b2", "w3", "b3"):
            getattr(mlp, f).copy_(torch.from_numpy(
                np.array(state[f], np.float32)))
    return mlp.to(device)
