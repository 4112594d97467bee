"""The exact running top-k merge of the probe scan (``csrc/topk_merge.cu``).

``topk_merge(rvals, rids, scores, ids, k, metric)`` merges a running result
``[..., kr]`` with a chunk's candidates ``[..., n]`` into the top-k of their
concatenation, bit for bit ``topk_scores(cat([rvals, scores]), cat([rids,
ids]), k, metric)``: values and ids best-first, ties to the earlier
position (the running result's slots come first), -0.0 and +0.0 one key,
NaN ranked as the largest value (as ``torch.sort`` ranks it), a winner
whose value is the metric's worst keeps id -1, and slots past ``kr + n``
get the worst value and id -1. Any k.

Its kernel replaces ``auncel_tpu/ops/topk.py:67`` ``merge_topk_verified``,
which is not a ``pallas_call``: on the TPU it is XLA's ``approx_min_k``
under an exactness certificate, a selection that does not sort the window.
The kernel is bound by device-memory bytes (each chunk value read once,
ids read for the k winners only). It never builds the concatenation: a
block streams a segment of a row with 16-byte loads, filters each value
against a bound of the row's k-th taken from the running result's first k
slots (and shared by the row's segments), and keeps the few that pass as
unique 64-bit (key, position) keys; a radix select cuts them to k, and
the winners are ranked by counting (a bitonic sort above k 256). A row
takes several segments when the batch alone would not fill the card
(``segments``); the row's last segment merges them in the same launch.
For k above 1024 the candidate buffers live in scratch; see the source.

``topk_merge`` runs the kernel for CUDA tensors and its plain version,
``topk_merge_ref``, for CPU tensors. A CUDA tensor never falls back: the
kernel launches or the wrapper raises. ``topk_merge.launches`` counts the
calls that launched it.
"""

import ctypes
import functools

import torch

from auncel_tpu_torch.kernels import build
from auncel_tpu_torch.ops.topk import merge_topk
from auncel_tpu_torch.types import Metric

SEGMENT_MIN = 2048   # positions a segment at least: one load step
BLOCKS_PER_SM = 4    # resident blocks a multiprocessor (256 threads, 42 KB)


# the plain PyTorch version: the stable-sort top-k of the concatenation
topk_merge_ref = merge_topk


def segments(B: int, n_total: int, n_sm: int) -> int:
    """Segments a row of ``n_total`` positions: as many as fill the card's
    resident blocks (``BLOCKS_PER_SM`` a multiprocessor) with B rows, each
    of ``SEGMENT_MIN`` positions at least; one once B rows fill half."""
    return max(1, min((BLOCKS_PER_SM * n_sm) // B,
                      -(-n_total // SEGMENT_MIN)))


def _check(rvals, rids, scores, ids, k):
    if rvals.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"topk_merge takes float32 values, got {rvals.dtype} "
                        f"and {scores.dtype}")
    if rids.dtype != torch.int32 or ids.dtype != torch.int32:
        raise TypeError(f"topk_merge takes int32 ids, got {rids.dtype} and "
                        f"{ids.dtype}")
    if rvals.shape != rids.shape or scores.shape != ids.shape:
        raise ValueError(f"values and ids differ in shape: {tuple(rvals.shape)}"
                         f" {tuple(rids.shape)}, {tuple(scores.shape)} "
                         f"{tuple(ids.shape)}")
    if rvals.dim() < 1 or rvals.shape[:-1] != scores.shape[:-1]:
        raise ValueError(f"batch shapes differ: {tuple(rvals.shape)} and "
                         f"{tuple(scores.shape)}")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")


def topk_merge(rvals: torch.Tensor, rids: torch.Tensor, scores: torch.Tensor,
               ids: torch.Tensor, k: int, metric: Metric):
    """Running ``rvals``/``rids [..., kr]`` and candidates ``scores``/``ids
    [..., n]`` (float32 values, int32 ids) -> (vals, ids ``[..., k]``), the
    top-k of their concatenation best-first."""
    _check(rvals, rids, scores, ids, k)
    tensors = (rvals, rids, scores, ids)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return topk_merge_ref(rvals, rids, scores, ids, k, metric)
    dev = rvals.device
    if len(devices) != 1 or dev.type != "cuda":
        raise ValueError(f"topk_merge needs all tensors on one CUDA device "
                         f"or all on the CPU, got {devices}")
    lead = rvals.shape[:-1]
    kr, n = rvals.shape[-1], scores.shape[-1]
    if kr + n >= 2**31:
        raise ValueError(f"topk_merge takes rows of fewer than 2^31 "
                         f"positions, got {kr + n}")
    B = 1
    for s in lead:
        B *= s
    out_v = torch.empty(lead + (k,), dtype=torch.float32, device=dev)
    out_i = torch.empty(lead + (k,), dtype=torch.int32, device=dev)
    if B == 0 or k == 0:
        return out_v, out_i
    rv, ri, sv, si = (t.reshape(B, t.shape[-1]).contiguous() for t in tensors)
    n_seg = segments(B, kr + n, _multiprocessors(dev))
    lib = _library()
    n_scratch = lib.topk_merge_scratch_bytes(B, k, n_seg)
    scratch = (torch.empty(n_scratch, dtype=torch.uint8, device=dev)
               if n_scratch > 0 else None)
    stream = torch.cuda.current_stream(dev)
    state = _row_state(dev, stream.cuda_stream, B) if n_seg > 1 else None
    err = lib.topk_merge_run(
        rv.data_ptr(), ri.data_ptr(), sv.data_ptr(), si.data_ptr(),
        out_v.data_ptr(), out_i.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if state is None else state.data_ptr(), B, kr, n, k,
        int(metric is Metric.IP), n_seg, dev.index, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"topk_merge kernel launch failed: CUDA error "
                           f"{err}")
    topk_merge.launches += 1
    return out_v, out_i


topk_merge.launches = 0

# (device index, stream handle) -> the rows' state the kernel shares between
# a row's segments: 4 int64 a row, the first all ones, the rest zero, as
# every launch on that stream leaves it
_ROW_STATE: dict = {}


def _row_state(dev: torch.device, stream: int, B: int) -> torch.Tensor:
    st = _ROW_STATE.get((dev.index, stream))
    if st is None or st.shape[0] < B:
        st = torch.zeros((max(B, 1024), 4), dtype=torch.int64, device=dev)
        st[:, 0] = -1
        _ROW_STATE[(dev.index, stream)] = st
    return st


@functools.cache
def _multiprocessors(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the library's functions for ctypes."""
    fn = lib.topk_merge_scratch_bytes
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    fn = lib.topk_merge_run
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library():
    return bind(build.load("topk_merge"))
