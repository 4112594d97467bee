"""The decision step of the bounded engines (``csrc/decide.cu``).

``decide_step(traces, dtb, vals, std_m, ind=..., window=..., query_k=...,
max_topk=..., slack=..., ip=..., exact_mask=None, mr=None)`` launches the
kernel that computes, for each query row, the per-boundary recall estimate
of ``profile/bounded.py::_decide_at_stage`` at trace ``ind``: its predicted
recall from its running top-k values and its boundary distances. Given
``mr`` (an ``MRDecide``), the same launch applies the multi-row latency
engine's state update after it (``profile/bounded.py::_mr_update``) and
returns the new state. Its plain version, and the rules the kernel
follows, live in ``profile/bounded.py``: ``decision_step`` there runs the
plain version for CPU tensors and this kernel for CUDA tensors.

Its kernel replaces no ``pallas_call``: the JAX package's decision step is
XLA ops. On the card the plain version is about 300 small torch kernels a
deciding wave at batch 1, each one host dispatch; the kernel is one launch,
bit for bit the plain version (see the source for how). It is bound by
latency, not by bytes or operations.

The kernel has no CPU mode: ``decide_step`` launches it or raises, and
never waits for the card. ``decide_step.launches`` counts the launches.
"""

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from auncel_tpu_torch.kernels import build

WARPS = 4              # rows a block (csrc/decide.cu kWarps)
MAX_SMEM = 48 * 1024   # the kernel's predicate words, bytes a block
MAX_WINDOW = 15        # boundaries a window sums (csrc/decide.cu kWindow)


class MRDecide(NamedTuple):
    """What the multi-row latency engine's state update reads: each
    query's row frontier and the rows of its first min(stage, S) ranked
    lists (``offsets[:, min(stage, S) - 1]``), bound, stagnation limit, the
    0-d multipler, the carried state, and the boundary: its stage, whether
    its decision is forced, and the budget a forced decision of 0 takes."""
    frontier: torch.Tensor     # [B] int32
    stage_rows: torch.Tensor   # [B] int32
    require_acc: torch.Tensor  # [B] float32
    stops: torch.Tensor        # [B] int32
    multipler: torch.Tensor    # 0-d float32
    my_np: torch.Tensor        # [B] int32, 0 = undecided
    decided_at: torch.Tensor   # [B] int32
    stoped: torch.Tensor       # [B] int32
    pre_val: torch.Tensor      # [B] float32
    last_stage: torch.Tensor   # [B] int32
    stage: int
    forced: bool
    nlist: int

    def tensors(self) -> dict:
        return {name: t for name, t in self._asdict().items()
                if isinstance(t, torch.Tensor)}


def _fields(ctype, names: str) -> list:
    return [(name, ctype) for name in names.split()]


class _Args(ctypes.Structure):
    """csrc/decide.cu ``Args``, field by field."""
    _fields_ = (
        _fields(ctypes.c_void_p, "vals") + _fields(ctypes.c_longlong,
                                                   "vals_ld")
        + _fields(ctypes.c_void_p, "dtb") + _fields(ctypes.c_longlong,
                                                    "dtb_ld")
        + _fields(ctypes.c_void_p,
                  "phi u sd n_bins std_m exact recall frontier stage_rows "
                  "require_acc stops multipler my_np_in decided_in "
                  "stoped_in pre_in last_in my_np decided stoped pre_val "
                  "last_stage")
        + _fields(ctypes.c_longlong, "rows_ld B")
        + _fields(ctypes.c_int,
                  "win_start win_len max_bins k k1 iters_k iters_k1 n_words "
                  "is_ip stage nlist forced worst_col")
        + _fields(ctypes.c_float, "inv_k inv_k1 slack_k slack_k1"))


def _iters(k: int) -> int:
    """``_simulate_cur_num``'s iteration count at width k."""
    return max(int(np.ceil(np.log2(max(k, 2)))) + 1, 10)


def _check(traces, dtb, vals, std_m, exact_mask, mr, ind, window,
           query_k, max_topk):
    f32, i32 = torch.float32, torch.int32
    want = [("vals", vals, f32), ("dtb", dtb, f32), ("std_m", std_m, f32),
            ("traces.phi", traces.phi, f32), ("traces.u", traces.u, f32),
            ("traces.std", traces.std, f32),
            ("traces.n_bins", traces.n_bins, i32)]
    if exact_mask is not None:
        want.append(("exact_mask", exact_mask, torch.bool))
    if mr is not None:
        want += [(f"mr.{name}", t, f32 if name in (
            "require_acc", "multipler", "pre_val") else i32)
            for name, t in mr.tensors().items()]
    for name, t, dtype in want:
        if t.dtype != dtype:
            raise TypeError(f"decide_step takes {name} as {dtype}, got "
                            f"{t.dtype}")
    B = vals.shape[0]
    if vals.dim() != 2 or vals.shape[1] < max_topk or dtb.dim() != 2 or \
            dtb.shape[0] != B:
        raise ValueError(f"decide_step takes vals [B, >= {max_topk}] and "
                         f"dtb [B, n]: got {tuple(vals.shape)} and "
                         f"{tuple(dtb.shape)}")
    if not 1 <= query_k <= max_topk:
        raise ValueError(f"query_k must lie in [1, {max_topk}], got "
                         f"{query_k}")
    if not 0 <= window <= MAX_WINDOW:
        raise ValueError(f"decide_step sums windows of at most {MAX_WINDOW} "
                         f"boundaries, got {window}")
    if not 0 <= ind < traces.phi.shape[0] or traces.phi.dim() != 2:
        raise ValueError(f"the stage's trace {ind} is not among the "
                         f"{traces.phi.shape[0]} traces")
    if any(t.shape != traces.phi.shape or t.stride(1) != 1
           for t in (traces.phi, traces.u, traces.std)):
        raise ValueError("the traces' phi, u and std must be one shape, "
                         "each row contiguous")
    if std_m.numel() != 1:
        raise ValueError("std_m must hold one value")
    if exact_mask is not None and exact_mask.shape != (B,):
        raise ValueError(f"exact_mask must be [{B}], got "
                         f"{tuple(exact_mask.shape)}")
    if mr is not None:
        for name, t in mr.tensors().items():
            shape = () if name == "multipler" else (B,)
            if t.dim() != len(shape) or (shape and t.shape[0] != B):
                raise ValueError(f"mr.{name} must be {list(shape)}, got "
                                 f"{tuple(t.shape)}")


def decide_step(traces, dtb: torch.Tensor, vals: torch.Tensor,
                std_m: torch.Tensor, *, ind: int, window: int, query_k: int,
                max_topk: int, slack: float, ip: bool,
                exact_mask: torch.Tensor | None = None,
                mr: MRDecide | None = None):
    """The decision step at trace ``ind`` (a ``TraceSet``'s row): ``vals``
    [B, >= max_topk] the sorted running top-k, ``dtb`` [B, n_boundaries]
    the boundary distances whose ``window`` from 2^ind - 1 each candidate's
    phi sums, ``std_m`` 0-d, ``slack`` the all-k fast path's factor,
    ``ip`` whether ``vals`` are inner products, ``exact_mask`` [B] bool or
    None (the rows that also estimate at width query_k + 1, where that is
    at most max_topk). Returns recall [B], or with ``mr`` (recall, my_np,
    decided_at, stoped, pre_val, last_stage), recall then carrying the
    stagnation override."""
    tensors = [traces.phi, traces.u, traces.std, traces.n_bins, dtb, vals,
               std_m] + ([] if exact_mask is None else [exact_mask]) + (
                   [] if mr is None else list(mr.tensors().values()))
    devices = {t.device for t in tensors}
    dev = vals.device
    if len(devices) != 1 or dev.type != "cuda":
        raise ValueError(f"decide_step needs all tensors on one CUDA device "
                         f"(the kernel has no CPU mode), got {devices}")
    _check(traces, dtb, vals, std_m, exact_mask, mr, ind, window, query_k,
           max_topk)
    B = vals.shape[0]
    k = query_k
    k1 = k + 1 if exact_mask is not None and k + 1 <= max_topk else 0
    n_words = -(-max(k, k1) // 32)
    if 4 * WARPS * 2 * n_words > MAX_SMEM:
        raise ValueError(f"decide_step takes k below "
                         f"{MAX_SMEM // (8 * WARPS) * 32}, got {k}")
    recall = torch.empty(B, dtype=torch.float32, device=dev)
    if mr is not None:
        ints = torch.empty((4, B), dtype=torch.int32, device=dev)
        pre_val = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return recall if mr is None else (recall, *ints[:3], pre_val,
                                          ints[3])
    if vals.stride(1) != 1:
        vals = vals.contiguous()
    if dtb.stride(1) != 1:
        dtb = dtb.contiguous()
    start = (1 << ind) - 1
    f32 = np.float32
    a = _Args()
    a.vals, a.vals_ld = vals.data_ptr(), vals.stride(0)
    a.dtb, a.dtb_ld = dtb.data_ptr(), dtb.stride(0)
    # the stage's trace: row ind of each (4-byte elements)
    a.phi, a.u, a.sd, a.n_bins = (
        t.data_ptr() + 4 * ind * t.stride(0)
        for t in (traces.phi, traces.u, traces.std, traces.n_bins))
    a.std_m = std_m.data_ptr()
    if k1:
        exact_mask = exact_mask.contiguous()
        a.exact = exact_mask.data_ptr()
    a.recall = recall.data_ptr()
    a.B = B
    a.win_start = start
    a.win_len = max(0, min(window, dtb.shape[1] - start))
    a.max_bins = traces.phi.shape[1]
    a.k, a.k1 = k, k1
    a.iters_k, a.iters_k1 = _iters(k), _iters(k1)
    a.n_words = n_words
    a.is_ip = int(ip)
    # as torch computes k * U <= k * slack and pre_num / k on the card: the
    # Python number's float32, and a product with its reciprocal
    a.inv_k, a.inv_k1 = f32(1) / f32(k), f32(1) / f32(max(k1, 1))
    a.slack_k = f32(k * slack)
    a.slack_k1 = f32(k1 * slack)
    if mr is not None:
        # the state is read and written as [B] arrays
        ins = [t if t.dim() == 0 or t.stride(0) == 1 else t.contiguous()
               for t in (mr.frontier, mr.require_acc, mr.stops, mr.multipler,
                         mr.my_np, mr.decided_at, mr.stoped, mr.pre_val,
                         mr.last_stage)]
        (a.frontier, a.require_acc, a.stops, a.multipler, a.my_np_in,
         a.decided_in, a.stoped_in, a.pre_in, a.last_in) = (
            t.data_ptr() for t in ins)
        a.stage_rows, a.rows_ld = mr.stage_rows.data_ptr(), \
            mr.stage_rows.stride(0)
        base, step = ints.data_ptr(), 4 * ints.stride(0)
        a.my_np, a.decided, a.stoped, a.last_stage = (
            base, base + step, base + 2 * step, base + 3 * step)
        a.pre_val = pre_val.data_ptr()
        a.stage, a.nlist = mr.stage, mr.nlist
        a.forced = int(mr.forced)
        a.worst_col = max_topk - 1
    stream = torch.cuda.current_stream(dev)
    err = _library().decide_run(ctypes.byref(a), dev.index,
                                stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"decide_step kernel launch failed: CUDA error "
                           f"{err}")
    decide_step.launches += 1
    if mr is None:
        return recall
    return recall, ints[0], ints[1], ints[2], pre_val, ints[3]


decide_step.launches = 0


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the library's function for ctypes."""
    fn = lib.decide_run
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library():
    return bind(build.load("decide"))
