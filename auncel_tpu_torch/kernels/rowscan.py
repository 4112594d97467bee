"""K1, the row scan of the multi-row layout (``csrc/rowscan.cu``).

``rowscan_scores`` is the main path's: scores and candidate ids of every
slot of every probed row, ``[B, n_slots * row_cap]`` each, with K2's
contract (``kernels/scan_scores.py``) over rows: for query ``b``, row slot
``s`` and slot ``c`` of ``r = rows[b, s]`` the score is
``max((q_sq[b] + db_sq[r, c]) - 2 * dot, 0)`` for L2 and ``dot`` for IP, the
id ``vec_ids[r, c]``; a slot is dead, with the metric's worst value and id
-1, when ``r < 0`` (an inactive entry), ``c >= row_sizes[r]`` or
``vec_ids[r, c] < 0``, and row ids ``>= n_rows`` clamp. Its kernel replaces
the Pallas TPU kernel ``auncel_tpu/pallas_kernels/rowscan.py::rowscan_dots``
together with the score assembly and masks its caller runs
(``auncel_tpu/index/scan.py:249-268``). It is bound by device-memory
bandwidth, and row-grouped: the live entries are grouped by row on the
device, inactive entries read nothing, and each row is read once per chunk
of up to 32 of the queries that probe it, through a TMA-fed ring. It takes
K2's storage codecs (float32, bfloat16, and uint8 SQ8/SQ4/SQ6 codes with
``sq_scale`` and ``sq_bias``), decoded in registers as K2 decodes them;
PQ codes raise, as ``build_multirow`` refuses PQ storage.

``rowscan_dots`` is the first, query-major port: the TPU kernel's own
contract ``dots[t, c] = <db[work_rows[t], c, :], qs[t]>`` without its
``T % 16`` rule, float32 storage only; it reads a row once for every
entry. Nothing on the serving paths calls it.

Each runs its kernel for CUDA tensors and its plain version (``*_ref``)
for CPU tensors. A CUDA tensor never falls back: the kernel launches or the
wrapper raises. ``rowscan_scores.launches`` and ``rowscan_dots.launches``
count the calls that launched a kernel.
"""

import ctypes
import functools

import torch

from auncel_tpu_torch.kernels import build
from auncel_tpu_torch.kernels.scan_scores import (
    bind_scan, check_scan_args, launch_scan, scan_scores_ref)
from auncel_tpu_torch.types import Metric

# rowscan_dots: dynamic shared memory holds one query row; above 48 KB a
# launch would need an opt-in attribute
MAX_D = 48 * 1024 // 4
MAX_ROW_CAP = 65535 * 64  # grid.y limit x slots per block
MAX_T = 2**31 - 1         # grid.x limit


def rowscan_scores_ref(db, db_sq, vec_ids, row_sizes, q, q_sq, rows,
                       metric: Metric, sq_scale=None, sq_bias=None):
    """Plain PyTorch version: K2's, rows being lists."""
    return scan_scores_ref(db, db_sq, vec_ids, row_sizes, q, q_sq, rows,
                           metric, sq_scale, sq_bias)


def rowscan_scores(db: torch.Tensor, db_sq: torch.Tensor,
                   vec_ids: torch.Tensor, row_sizes: torch.Tensor,
                   q: torch.Tensor, q_sq: torch.Tensor, rows: torch.Tensor,
                   metric: Metric, sq_scale: torch.Tensor | None = None,
                   sq_bias: torch.Tensor | None = None,
                   pq_codebooks: torch.Tensor | None = None,
                   centroids: torch.Tensor | None = None):
    """Rows ``db [n_rows, row_cap, d]`` f32 or bf16 (or ``[n_rows, row_cap,
    width]`` uint8 SQ codes with ``sq_scale`` and ``sq_bias`` [d] f32) with
    their ``db_sq``, ``vec_ids`` and ``row_sizes``, queries ``q [B, d]``
    f32 with ``q_sq``, row slots ``rows [B, n_slots]`` int32 (-1:
    inactive) -> (scores ``[B, n_slots * row_cap]`` f32, ids
    ``[B, n_slots * row_cap]`` int32). ``pq_codebooks`` and ``centroids``
    raise: rows carry no PQ codes."""
    if pq_codebooks is not None or centroids is not None:
        raise ValueError(
            "rowscan_scores: the multi-row layout takes no PQ codes "
            "(build_multirow refuses PQ storage; K2 scans it)")
    args = (db, db_sq, vec_ids, row_sizes, q, q_sq, rows)
    on_cpu, codec = check_scan_args("rowscan_scores", args, metric, sq_scale,
                                    sq_bias)
    if on_cpu:
        return rowscan_scores_ref(*args, metric, sq_scale, sq_bias)
    scores, ids, launched = launch_scan("rowscan_scores", _library(), args,
                                        metric, codec, sq_scale, sq_bias)
    rowscan_scores.launches += launched
    return scores, ids


rowscan_scores.launches = 0


def rowscan_dots_ref(db: torch.Tensor, work_rows: torch.Tensor,
                     qs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (row ids clamped like the kernel's)."""
    rows = work_rows.long().clamp(0, db.shape[0] - 1)
    return torch.einsum("tcd,td->tc", db[rows], qs)


def _check(db, work_rows, qs):
    if db.dtype != torch.float32 or qs.dtype != torch.float32:
        raise TypeError(f"rowscan_dots takes float32 db and qs, got "
                        f"{db.dtype} and {qs.dtype}")
    if work_rows.dtype != torch.int32:
        raise TypeError(f"rowscan_dots takes int32 work_rows, got "
                        f"{work_rows.dtype}")
    if db.dim() != 3 or work_rows.dim() != 1 or qs.dim() != 2:
        raise ValueError("rowscan_dots takes db [n_rows, row_cap, d], "
                         "work_rows [T] and qs [T, d]")
    if qs.shape[0] != work_rows.shape[0] or qs.shape[1] != db.shape[2]:
        raise ValueError(f"shape mismatch: db {tuple(db.shape)}, work_rows "
                         f"{tuple(work_rows.shape)}, qs {tuple(qs.shape)}")
    if db.shape[0] == 0:
        raise ValueError("rowscan_dots needs at least one row")


def rowscan_dots(db: torch.Tensor, work_rows: torch.Tensor,
                 qs: torch.Tensor) -> torch.Tensor:
    """[n_rows, row_cap, d] f32, [T] int32, [T, d] f32 -> [T, row_cap] f32."""
    _check(db, work_rows, qs)
    devices = {db.device, work_rows.device, qs.device}
    if devices == {torch.device("cpu")}:
        return rowscan_dots_ref(db, work_rows, qs)
    if len(devices) != 1 or db.device.type != "cuda":
        raise ValueError(f"rowscan_dots needs all tensors on one CUDA "
                         f"device or all on the CPU, got {devices}")
    if not (db.is_contiguous() and work_rows.is_contiguous()
            and qs.is_contiguous()):
        raise ValueError("rowscan_dots needs contiguous tensors")
    n_rows, row_cap, d = db.shape
    T = work_rows.shape[0]
    if d > MAX_D or row_cap > MAX_ROW_CAP or T > MAX_T:
        raise ValueError(f"rowscan_dots supports d <= {MAX_D}, row_cap <= "
                         f"{MAX_ROW_CAP} and T <= {MAX_T}, got d={d} "
                         f"row_cap={row_cap} T={T}")
    out = torch.empty((T, row_cap), dtype=torch.float32, device=db.device)
    if T == 0 or row_cap == 0 or d == 0:
        return out.zero_()
    err = _library().rowscan_dots_launch(
        db.data_ptr(), work_rows.data_ptr(), qs.data_ptr(), out.data_ptr(),
        T, n_rows, row_cap, d, db.device.index,
        torch.cuda.current_stream(db.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rowscan_dots kernel launch failed: CUDA error "
                           f"{err}")
    rowscan_dots.launches += 1
    return out


rowscan_dots.launches = 0


@functools.cache
def _library():
    lib = bind_scan(build.load("rowscan"), "rowscan_scores")
    fn = lib.rowscan_dots_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
