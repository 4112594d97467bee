"""K1, the worklist row-scan: ``dots[t, c] = <db[work_rows[t], c, :], qs[t]>``.

The hand-written CUDA kernel (``csrc/rowscan.cu``) replaces the Pallas TPU
kernel ``auncel_tpu/pallas_kernels/rowscan.py::rowscan_dots`` with the same
contract, without its ``T % 16 == 0`` requirement. It is bound by
device-memory bandwidth (it reads ``T * row_cap * d * 4`` bytes and does one
FMA per 4 bytes); see the source for what its design does about that.

``rowscan_dots`` runs the kernel for CUDA tensors and the plain version,
``rowscan_dots_ref``, for CPU tensors. A CUDA tensor never falls back: the
kernel launches or the wrapper raises. ``rowscan_dots.launches`` counts the
kernel launches.
"""

import ctypes

import torch

from auncel_tpu_torch.kernels import build

# dynamic shared memory holds one query row; above 48 KB a launch would need
# an opt-in attribute
MAX_D = 48 * 1024 // 4
MAX_ROW_CAP = 65535 * 64  # grid.y limit x slots per block
MAX_T = 2**31 - 1         # grid.x limit


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
    fn = _launcher()
    err = fn(db.data_ptr(), work_rows.data_ptr(), qs.data_ptr(),
             out.data_ptr(), T, n_rows, row_cap, d, db.device.index,
             torch.cuda.current_stream(db.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rowscan_dots kernel launch failed: CUDA error "
                           f"{err}")
    rowscan_dots.launches += 1
    return out


rowscan_dots.launches = 0


def _launcher():
    lib = build.load("rowscan")
    fn = lib.rowscan_dots_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
