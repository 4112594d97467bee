"""K2, the padded-layout probe scan: scores and candidate ids of every slot
of every probed list, ``[B, n_slots * cap]`` each.

For query ``b``, probe slot ``s`` and list slot ``c`` of ``l = lists[b, s]``
the score is ``max((q_sq[b] + db_sq[l, c]) - 2 * dot, 0)`` for L2 and
``dot`` for IP, with ``dot = <db[l, c], q[b]>``, and the id is
``vec_ids[l, c]``. A slot is dead, with the metric's worst value and id -1,
when ``l < 0`` (an inactive probe slot), ``c >= list_sizes[l]`` or
``vec_ids[l, c] < 0``. List ids ``>= nlist`` clamp to ``nlist - 1``.

The hand-written CUDA kernel (``csrc/scan_scores.cu``) replaces the Pallas
TPU kernel ``auncel_tpu/pallas_kernels/scan_scores.py::scan_scores_pallas``
with the JAX package's XLA-scan semantics: stored norms, padding by id (an
exact-zero stored vector is a valid result, where the TPU kernel treats
zero norm as padding), list id -1 for a masked probe and no
``n_slots % 8`` rule. It is bound by device-memory bandwidth and reads only
live slots; see the source.

``scan_scores`` runs the kernel for CUDA tensors and the plain version,
``scan_scores_ref``, for CPU tensors. A CUDA tensor never falls back: the
kernel launches or the wrapper raises. ``scan_scores.launches`` counts the
kernel launches.
"""

import ctypes

import torch

from auncel_tpu_torch.kernels import build
from auncel_tpu_torch.types import Metric, worst_value

# dynamic shared memory holds one query row beside the kernel's 768 bytes of
# static shared memory; above 48 KB in all a launch would need an opt-in
MAX_D = (48 * 1024 - 1024) // 4
MAX_CAP = 65535 * 64      # grid.y limit x slots per block
MAX_WORK = 2**31 - 1      # grid.x limit on B * n_slots


def scan_scores_ref(db, db_sq, vec_ids, list_sizes, q, q_sq, lists,
                    metric: Metric):
    """Plain PyTorch version: the gather, dot and masks of the XLA scan."""
    B, S = lists.shape
    nlist, cap, _ = db.shape
    flat = lists.reshape(-1).long().clamp(0, nlist - 1)
    dots = torch.einsum("tcd,td->tc", db[flat],
                        q.repeat_interleave(S, dim=0)).reshape(B, S, cap)
    sel = flat.reshape(B, S)
    if metric is Metric.L2:
        scores = (q_sq[:, None, None] + db_sq[sel] - 2.0 * dots).clamp_min(0.0)
    else:
        scores = dots
    sub_ids = vec_ids[sel]
    slot = torch.arange(cap, device=db.device)
    live = ((lists >= 0)[:, :, None] & (slot < list_sizes[sel][:, :, None])
            & (sub_ids >= 0))
    scores = torch.where(live, scores, worst_value(metric))
    sub_ids = torch.where(live, sub_ids, -1)
    return scores.reshape(B, S * cap), sub_ids.reshape(B, S * cap)


def _check(db, db_sq, vec_ids, list_sizes, q, q_sq, lists, metric):
    if not isinstance(metric, Metric):
        raise TypeError(f"scan_scores takes a Metric, got {metric!r}")
    for name, t, dtype in (("db", db, torch.float32),
                           ("db_sq", db_sq, torch.float32),
                           ("vec_ids", vec_ids, torch.int32),
                           ("list_sizes", list_sizes, torch.int32),
                           ("q", q, torch.float32),
                           ("q_sq", q_sq, torch.float32),
                           ("lists", lists, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"scan_scores takes {dtype} {name}, got "
                            f"{t.dtype}")
    if db.dim() != 3 or q.dim() != 2 or lists.dim() != 2:
        raise ValueError("scan_scores takes db [nlist, cap, d], q [B, d] and "
                         "lists [B, n_slots]")
    nlist, cap, d = db.shape
    B = q.shape[0]
    if (db_sq.shape != (nlist, cap) or vec_ids.shape != (nlist, cap)
            or list_sizes.shape != (nlist,) or q.shape[1] != d
            or q_sq.shape != (B,) or lists.shape[0] != B):
        raise ValueError(
            f"shape mismatch: db {tuple(db.shape)}, db_sq "
            f"{tuple(db_sq.shape)}, vec_ids {tuple(vec_ids.shape)}, "
            f"list_sizes {tuple(list_sizes.shape)}, q {tuple(q.shape)}, "
            f"q_sq {tuple(q_sq.shape)}, lists {tuple(lists.shape)}")
    if nlist == 0:
        raise ValueError("scan_scores needs at least one list")


def scan_scores(db: torch.Tensor, db_sq: torch.Tensor, vec_ids: torch.Tensor,
                list_sizes: torch.Tensor, q: torch.Tensor, q_sq: torch.Tensor,
                lists: torch.Tensor, metric: Metric):
    """Padded lists ``db [nlist, cap, d]`` f32 with their ``db_sq``,
    ``vec_ids`` and ``list_sizes``, queries ``q [B, d]`` f32 with ``q_sq``,
    probes ``lists [B, n_slots]`` int32 (-1: inactive) -> (scores
    ``[B, n_slots * cap]`` f32, ids ``[B, n_slots * cap]`` int32)."""
    args = (db, db_sq, vec_ids, list_sizes, q, q_sq, lists)
    _check(*args, metric)
    devices = {t.device for t in args}
    if devices == {torch.device("cpu")}:
        return scan_scores_ref(*args, metric)
    if len(devices) != 1 or db.device.type != "cuda":
        raise ValueError(f"scan_scores needs all tensors on one CUDA device "
                         f"or all on the CPU, got {devices}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("scan_scores needs contiguous tensors")
    nlist, cap, d = db.shape
    B, S = lists.shape
    if d > MAX_D or cap > MAX_CAP or B * S > MAX_WORK:
        raise ValueError(f"scan_scores supports d <= {MAX_D}, cap <= "
                         f"{MAX_CAP} and B * n_slots <= {MAX_WORK}, got "
                         f"d={d} cap={cap} B*n_slots={B * S}")
    scores = torch.empty((B, S * cap), dtype=torch.float32, device=db.device)
    ids = torch.empty((B, S * cap), dtype=torch.int32, device=db.device)
    if B * S == 0 or cap == 0:
        return scores, ids
    err = _launcher()(
        db.data_ptr(), db_sq.data_ptr(), vec_ids.data_ptr(),
        list_sizes.data_ptr(), q.data_ptr(), q_sq.data_ptr(),
        lists.data_ptr(), scores.data_ptr(), ids.data_ptr(), B * S, S, nlist,
        cap, d, int(metric is Metric.L2), db.device.index,
        torch.cuda.current_stream(db.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_scores kernel launch failed: CUDA error "
                           f"{err}")
    scan_scores.launches += 1
    return scores, ids


scan_scores.launches = 0


def _launcher():
    lib = build.load("scan_scores")
    fn = lib.scan_scores_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
