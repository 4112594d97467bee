"""Carry index and profile state from the JAX package into the port.

Each function takes the JAX package's state as a dict of numpy arrays
(``{name: np.asarray(value)}`` of an ``IVFArrays``, ``MultiRowArrays`` or
``TraceSet``; a nested ``rows`` dict for ``MultiRowArrays``), so this module
imports no jax. With them both packages compute on identical state. The
tensors go to the card unless ``device`` says otherwise.
"""

import numpy as np
import torch

from auncel_tpu_torch.index.scan import IVFArrays, RowArrays
from auncel_tpu_torch.index.multirow import MultiRowArrays
from auncel_tpu_torch.profile.trace import TraceSet, traces_from_arrays

_INT_FIELDS = ("vec_ids", "list_sizes", "row_table", "rows_per_list",
               "row_base", "row_list", "n_bins")


def _tensor(name: str, a, device) -> torch.Tensor:
    dtype = np.int32 if name in _INT_FIELDS else np.float32
    return torch.as_tensor(np.array(a, dtype=dtype, order="C"), device=device)


def ivf_arrays_from_numpy(state: dict, device="cuda") -> IVFArrays:
    """IVFArrays from the JAX package's IVFArrays fields (f32 storage)."""
    for codec in ("sq_scale", "pq_codebooks"):
        if state.get(codec) is not None:
            raise NotImplementedError(
                f"{codec}: only float32 storage is ported")
    return IVFArrays(**{f: _tensor(f, state[f], device)
                        for f in IVFArrays._fields})


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
