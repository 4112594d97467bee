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
``n_slots % 8`` rule. It is bound by device-memory bandwidth. It is
list-major: the probes are grouped by list on the device, and each probed
list's live slots are read once per chunk of up to 32 of the queries that
probe it; see the source.

Storage codecs: ``db`` may hold float32 or bfloat16 vectors, or uint8
scalar-quantizer codes with ``sq_scale`` and ``sq_bias`` ([d] float32),
SQ8, SQ4 or SQ6 by the packed width as ``ops/sq.py::sq_decode_dev``
decides it. The kernel stages the stored bytes and decodes each element in
registers, a multiply then an add, each rounded, so a decoded element is
bitwise the plain version's; ``db_sq`` holds the decoded norms, and ``q``
is taken as given (the caller rounds it to bf16 for bf16 storage).

Product quantization: uint8 ``db [nlist, cap, M]`` with ``pq_codebooks
[M, 256, d / M]`` f32 holds M codes a slot, decoded by a codebook gather
(bitwise ``ops/pq.py::decode_pq``). With ``centroids [nlist, d]`` f32 the
codes are residuals of the list's centroid ``c_l`` (IVFPQ by residual),
and the score of a slot ``r`` is the JAX package's (``auncel_tpu/index/
scan.py:226-247``): L2 ``max((||q - c_l||^2 + db_sq) - 2 <r, q - c_l>, 0)``,
IP ``<c_l, q> + <r, q>``. The kernel does not decode: it builds each
(query, list) pair's ADC lookup table ``[M, 256]`` of partial dots in
shared memory and sums a slot's M entries, so it takes an M whose one
table and ring fit a block (``check_pq_fits``); the multi-row layout (K1)
takes no PQ codes. ``qcodes [B, n_slots, M]`` uint8 (the query's code for
each probe slot) with an int ``ht`` apply the polysemous filter of the
JAX package's scan (``auncel_tpu/index/scan.py:259-266``): a live slot
whose code is more than ``ht`` bits from its probe's query code is dead.
The kernel computes the Hamming distance from the staged codes and skips
the lookups of the slots it drops.

``scan_scores`` runs the kernel for CUDA tensors and the plain version,
``scan_scores_ref``, for CPU tensors. A CUDA tensor never falls back: the
kernel launches or the wrapper raises. ``scan_scores.launches`` counts the
calls that launched it: one call enqueues the scan and, when there are
more probes than one chunk of queries, the small kernels that build its
worklist. K1's ``rowscan_scores`` (``kernels/rowscan.py``) has this contract
over the multi-row layout's rows and shares the checks and the launch.
"""

import ctypes
import functools
import numbers

import torch

from auncel_tpu_torch.kernels import build
from auncel_tpu_torch.ops.pq import PQCodebooks, decode_pq
from auncel_tpu_torch.ops.sq import sq_decode_dev, sq_kind
from auncel_tpu_torch.types import Metric, worst_value

# a block's shared memory holds at least two 8-slot tiles of the list and
# four query rows (80 * d bytes and change) within the card's 227 KB
MAX_D = 2880
# a block's dynamic shared memory on sm_90 (227 KB), less the 1 KB the
# launch checks keep for the kernels' static variables
MAX_SMEM = 232448 - 1024
MAX_CAP = 2**31 - 1       # slot indices are int32
MAX_WORK = 2**31 - 1      # entry indices are int32
# the plain version decodes and contracts this many elements at a time
REF_CHUNK = 1 << 26

# the kernels' codec ids (csrc/worklist.cuh)
CODECS = {"f32": 0, "bf16": 1, "sq8": 2, "sq4": 3, "sq6": 4, "pq": 5}


def pq_shared_bytes(M: int, d: int) -> int:
    """Shared memory of a K2 block on PQ codes with one query's table:
    the table (M x 256 floats), two ring tiles of 256 slots' codes with
    their norms and ids, the query's code and the query, q_sq and row
    (``csrc/scan_scores.cu``'s ``pq_smem_bytes`` at chunk 1)."""
    stage = (256 * M + 15) // 16 * 16
    return (M * 1024 + 2 * stage + (M + 15) // 16 * 16
            + 4 * (d + 2 * 2 * 256 + 2))


def max_pq_m(d: int) -> int:
    """The largest M whose table and ring fit a block at width d (0 when
    none does)."""
    M = 256
    while M > 0 and pq_shared_bytes(M, d) > MAX_SMEM:
        M -= 1
    return M


def check_pq_fits(name: str, M: int, d: int) -> None:
    """Raise ValueError unless K2 can hold PQ codes of M bytes at width d:
    one query's lookup table and the ring within a block's shared memory."""
    if pq_shared_bytes(M, d) > MAX_SMEM:
        raise ValueError(
            f"{name} holds one query's PQ lookup table (M x 256 floats) and "
            f"two tiles of 256 codes in shared memory: M <= {max_pq_m(d)} "
            f"at d={d}, got M={M}")


def popcount8(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint8 (the JAX package's ``POPCOUNT8`` table), by
    three masked adds on the bytes themselves."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def decode_slots(sub, d: int, sq_scale=None, sq_bias=None,
                 pq_codebooks=None) -> torch.Tensor:
    """Stored slots [..., width] as float32 vectors [..., d]: the affine SQ
    decode, the PQ codebook gather, or the exact widening."""
    if sq_scale is not None:
        return sq_decode_dev(sub, d, sq_scale, sq_bias)
    if pq_codebooks is not None:
        return decode_pq(PQCodebooks(pq_codebooks), sub)
    return sub.to(torch.float32)


def scan_scores_ref(db, db_sq, vec_ids, list_sizes, q, q_sq, lists,
                    metric: Metric, sq_scale=None, sq_bias=None,
                    pq_codebooks=None, centroids=None, qcodes=None,
                    ht=None):
    """Plain PyTorch version: the gather, decode, dot and masks of the XLA
    scan (with ``qcodes``, the polysemous filter's ``ham <= ht``), over the
    active (query, probe slot) entries only (an inactive one is all
    padding), a bounded number at a time."""
    B, S = lists.shape
    nlist, cap, _ = db.shape
    d = q.shape[1]
    dev = db.device
    flat = lists.reshape(-1).long()
    active = (flat >= 0).nonzero().squeeze(1)
    scores = torch.full((B * S, cap), worst_value(metric),
                        dtype=torch.float32, device=dev)
    sub_ids = torch.full((B * S, cap), -1, dtype=torch.int32, device=dev)
    slot = torch.arange(cap, device=dev)
    step = max(1, REF_CHUNK // max(cap * d, 1))
    for t0 in range(0, active.numel(), step):
        e = active[t0:t0 + step]
        sel = flat[e].clamp_max(nlist - 1)   # ids past nlist: the last
        x = decode_slots(db[sel], d, sq_scale, sq_bias, pq_codebooks)
        qb = q[e // S]
        if centroids is not None:
            # residual PQ, as auncel_tpu/index/scan.py:226-247 writes it
            cl = centroids[sel]
            if metric is Metric.L2:
                qc = qb - cl
                dots = torch.einsum("tcd,td->tc", x, qc)
                sc = (((qc * qc).sum(-1))[:, None] + db_sq[sel]
                      - 2.0 * dots).clamp_min(0.0)
            else:
                sc = ((cl * qb).sum(-1)[:, None]
                      + torch.einsum("tcd,td->tc", x, qb))
        else:
            dots = torch.einsum("tcd,td->tc", x, qb)
            if metric is Metric.L2:
                sc = (q_sq[e // S][:, None] + db_sq[sel] - 2.0 * dots
                      ).clamp_min(0.0)
            else:
                sc = dots
        ids = vec_ids[sel]
        live = (slot < list_sizes[sel][:, None]) & (ids >= 0)
        if qcodes is not None:
            qc = qcodes.reshape(B * S, -1)[e]
            ham = popcount8(db[sel] ^ qc[:, None, :]).sum(
                -1, dtype=torch.int32)
            live &= ham <= ht
        scores[e] = torch.where(live, sc, worst_value(metric))
        sub_ids[e] = torch.where(live, ids, -1)
    return scores.reshape(B, S * cap), sub_ids.reshape(B, S * cap)


# the arguments of the shared contract, by position
_ARG_NAMES = ("db", "db_sq", "vec_ids", "list_sizes", "q", "q_sq", "lists")


def scan_codec(name: str, db: torch.Tensor, d: int, sq_scale, sq_bias,
               pq_codebooks=None, centroids=None) -> int:
    """The kernels' codec id of ``db`` (``CODECS``) at query width ``d``;
    raises on a storage the scan does not take."""
    if db.dtype != torch.uint8:
        if db.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} takes float32, bfloat16 or uint8 db, "
                            f"got {db.dtype}")
        if (sq_scale is not None or sq_bias is not None
                or pq_codebooks is not None):
            raise ValueError(f"{name}: sq_scale, sq_bias and pq_codebooks "
                             f"go with uint8 db")
        if db.shape[-1] != d:
            raise ValueError(f"{name}: db's width {db.shape[-1]} is not the "
                             f"queries' {d}")
        return CODECS["f32" if db.dtype == torch.float32 else "bf16"]
    if pq_codebooks is not None:
        M = db.shape[-1]
        if sq_scale is not None or sq_bias is not None:
            raise ValueError(f"{name}: PQ codes take no SQ range")
        if (pq_codebooks.dtype != torch.float32 or M == 0 or d % M
                or pq_codebooks.shape != (M, 256, d // M)):
            raise ValueError(
                f"{name}: uint8 db of width M={M} needs float32 pq_codebooks "
                f"[M, 256, d / M] (d={d}), got {pq_codebooks.dtype} "
                f"{tuple(pq_codebooks.shape)}")
        if centroids is not None and (
                centroids.dtype != torch.float32
                or centroids.shape != (db.shape[0], d)):
            raise ValueError(f"{name} takes float32 centroids [nlist, {d}], "
                             f"got {centroids.dtype} "
                             f"{tuple(centroids.shape)}")
        return CODECS["pq"]
    if centroids is not None:
        raise ValueError(f"{name}: centroids go with pq_codebooks")
    kind = sq_kind(db.shape[-1], d)
    if sq_scale is None or sq_bias is None or kind is None:
        raise ValueError(
            f"{name}: uint8 db needs sq_scale and sq_bias and a packed width "
            f"of d, d/2 or 3d/4 bytes (d={d}, width {db.shape[-1]}), or "
            f"pq_codebooks")
    for arg, t in (("sq_scale", sq_scale), ("sq_bias", sq_bias)):
        if t.dtype != torch.float32 or t.shape != (d,):
            raise ValueError(f"{name} takes float32 {arg} [{d}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return CODECS[kind]


def check_filter(name: str, codec: int, db, lists, qcodes, ht) -> None:
    """Check the polysemous filter's arguments: ``qcodes [B, n_slots, M]``
    uint8 with an int ``ht``, on PQ codes only (as the JAX package's scan
    takes them)."""
    if qcodes is None:
        if ht is not None:
            raise ValueError(f"{name}: ht goes with qcodes")
        return
    if codec != CODECS["pq"]:
        raise ValueError(f"{name}: the polysemous filter (qcodes) takes PQ "
                         f"codes only")
    want = tuple(lists.shape) + (db.shape[-1],)
    if qcodes.dtype != torch.uint8 or tuple(qcodes.shape) != want:
        raise ValueError(f"{name} takes uint8 qcodes {list(want)} [B, "
                         f"n_slots, M], got {qcodes.dtype} "
                         f"{tuple(qcodes.shape)}")
    if isinstance(ht, bool) or not isinstance(ht, numbers.Integral):
        raise TypeError(f"{name}: qcodes need an int ht, got {ht!r}")


def check_scan_args(name: str, args: tuple, metric, sq_scale=None,
                    sq_bias=None, pq_codebooks=None, centroids=None,
                    qcodes=None, ht=None) -> tuple:
    """Check the contract K2 and K1's ``rowscan_scores`` share (K1's lists
    are rows): (whether every tensor lies on the CPU, where the plain
    version runs, or else on one CUDA device; the codec id). Raises
    otherwise: a tensor elsewhere never takes the plain version."""
    if not isinstance(metric, Metric):
        raise TypeError(f"{name} takes a Metric, got {metric!r}")
    dtypes = (None, torch.float32, torch.int32, torch.int32,
              torch.float32, torch.float32, torch.int32)
    for arg, t, dtype in zip(_ARG_NAMES, args, dtypes):
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name} takes {dtype} {arg}, got {t.dtype}")
    db, db_sq, vec_ids, list_sizes, q, q_sq, lists = args
    if db.dim() != 3 or q.dim() != 2 or lists.dim() != 2:
        raise ValueError(f"{name} takes db [nlist, cap, width], q [B, d] "
                         f"and lists [B, n_slots]")
    nlist, cap, _ = db.shape
    B, d = q.shape
    if (db_sq.shape != (nlist, cap) or vec_ids.shape != (nlist, cap)
            or list_sizes.shape != (nlist,) or q_sq.shape != (B,)
            or lists.shape[0] != B):
        raise ValueError(f"{name}: shape mismatch: " + ", ".join(
            f"{arg} {tuple(t.shape)}" for arg, t in zip(_ARG_NAMES, args)))
    codec = scan_codec(name, db, d, sq_scale, sq_bias, pq_codebooks,
                       centroids)
    check_filter(name, codec, db, lists, qcodes, ht)
    if nlist == 0:
        raise ValueError(f"{name} needs at least one list")
    tensors = args + tuple(t for t in (sq_scale, sq_bias, pq_codebooks,
                                       centroids, qcodes) if t is not None)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return True, codec
    if len(devices) != 1 or db.device.type != "cuda":
        raise ValueError(f"{name} needs all tensors on one CUDA device or "
                         f"all on the CPU, got {devices}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    B, S = lists.shape
    if not 1 <= d <= MAX_D or cap > MAX_CAP or B * S > MAX_WORK:
        raise ValueError(f"{name} supports 1 <= d <= {MAX_D}, cap <= "
                         f"{MAX_CAP} and B * n_slots <= {MAX_WORK}, got "
                         f"d={d} cap={cap} B*n_slots={B * S}")
    if codec == CODECS["pq"]:
        check_pq_fits(name, db.shape[-1], d)
    return False, codec


def launch_scan(name: str, lib, args: tuple, metric, codec: int = 0,
                sq_scale=None, sq_bias=None, pq_codebooks=None,
                centroids=None, qcodes=None, ht=None):
    """Enqueue ``lib``'s ``{name}_launch`` (``{name}_pq_launch`` for PQ
    codes, with the filter's ``qcodes`` and ``ht``), with its worklist
    scratch, on the args' CUDA device and current stream: (scores, ids,
    whether a kernel was launched)."""
    db, db_sq, vec_ids, list_sizes, q, q_sq, lists = args
    nlist, cap, width = db.shape
    B, S = lists.shape
    d = q.shape[1]
    scores = torch.empty((B, S * cap), dtype=torch.float32, device=db.device)
    ids = torch.empty((B, S * cap), dtype=torch.int32, device=db.device)
    if B * S == 0 or cap == 0:
        return scores, ids, False
    pq = codec == CODECS["pq"]
    # the worklist's scratch (none up to one chunk of entries)
    if pq:
        n_scratch = getattr(lib, f"{name}_pq_scratch_ints")(
            nlist, cap, d, width, B * S)
    else:
        n_scratch = getattr(lib, f"{name}_scratch_ints")(nlist, cap, d,
                                                         B * S, codec)
    if n_scratch < 0:
        raise ValueError(f"{name}: the worklist for B * n_slots = {B * S} "
                         f"over cap {cap} does not fit int32, or the shared "
                         f"memory of d = {d} does not fit the card")
    # freed on return while the kernels may still run: the caching
    # allocator hands it out again only to work queued after them on this
    # stream
    scratch = (torch.empty(n_scratch, dtype=torch.int32, device=db.device)
               if n_scratch else None)

    def ptr(t):
        return None if t is None else t.data_ptr()
    head = (db.data_ptr(), db_sq.data_ptr(), vec_ids.data_ptr(),
            list_sizes.data_ptr(), q.data_ptr(), q_sq.data_ptr(),
            lists.data_ptr(), scores.data_ptr(), ids.data_ptr(),
            ptr(scratch))
    tail = (db.device.index, torch.cuda.current_stream(db.device).cuda_stream)
    if pq:
        err = getattr(lib, f"{name}_pq_launch")(
            *head, ptr(pq_codebooks), ptr(centroids), ptr(qcodes), B * S, S,
            nlist, cap, d, width, int(metric is Metric.L2),
            0 if ht is None else max(-1, min(int(ht), 8 * width)), *tail)
    else:
        err = getattr(lib, f"{name}_launch")(
            *head, ptr(sq_scale), ptr(sq_bias), B * S, S, nlist, cap, d,
            int(metric is Metric.L2), codec, *tail)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return scores, ids, True


def scan_scores(db: torch.Tensor, db_sq: torch.Tensor, vec_ids: torch.Tensor,
                list_sizes: torch.Tensor, q: torch.Tensor, q_sq: torch.Tensor,
                lists: torch.Tensor, metric: Metric,
                sq_scale: torch.Tensor | None = None,
                sq_bias: torch.Tensor | None = None,
                pq_codebooks: torch.Tensor | None = None,
                centroids: torch.Tensor | None = None,
                qcodes: torch.Tensor | None = None, ht: int | None = None):
    """Padded lists ``db [nlist, cap, d]`` f32 or bf16 (or ``[nlist, cap,
    width]`` uint8 SQ codes with ``sq_scale`` and ``sq_bias`` [d] f32, or
    ``[nlist, cap, M]`` uint8 PQ codes with ``pq_codebooks`` [M, 256, d/M]
    f32 and, for residual codes, ``centroids`` [nlist, d] f32; on PQ codes
    ``qcodes [B, n_slots, M]`` uint8 and ``ht`` apply the polysemous
    filter) with their ``db_sq``, ``vec_ids`` and ``list_sizes``, queries
    ``q [B, d]`` f32 with ``q_sq``, probes ``lists [B, n_slots]`` int32
    (-1: inactive) -> (scores ``[B, n_slots * cap]`` f32, ids ``[B,
    n_slots * cap]`` int32)."""
    args = (db, db_sq, vec_ids, list_sizes, q, q_sq, lists)
    codec_args = (sq_scale, sq_bias, pq_codebooks, centroids, qcodes, ht)
    on_cpu, codec = check_scan_args("scan_scores", args, metric, *codec_args)
    if on_cpu:
        return scan_scores_ref(*args, metric, *codec_args)
    scores, ids, launched = launch_scan("scan_scores", _library(), args,
                                        metric, codec, *codec_args)
    scan_scores.launches += launched
    return scores, ids


scan_scores.launches = 0


def bind_scan(lib, name: str, pq: bool = False):
    """Set the ctypes signatures of ``lib``'s ``{name}_scratch_ints`` and
    ``{name}_launch`` (and with ``pq`` of ``{name}_pq_scratch_ints`` and
    ``{name}_pq_launch``)."""
    fn = getattr(lib, f"{name}_scratch_ints")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if pq:
        fn = getattr(lib, f"{name}_pq_scratch_ints")
        fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_longlong]
        fn.restype = ctypes.c_longlong
        fn = getattr(lib, f"{name}_pq_launch")
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_longlong] + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _library():
    return bind_scan(build.load("scan_scores"), "scan_scores", pq=True)
