"""The port on a CUDA card, skipped without one: K1 (rowscan_scores on the
main path, rowscan_dots beside it) and K2 against their plain versions, on
every storage codec too (float32, bf16, SQ8, SQ4, SQ6, at widths whose
slots are and are not a multiple of 16 bytes; K2 on PQ codes, residual and
plain, at dsub 2, 4 and 6, at d 256 / M 32 and d 192 / M 64, without and
with the polysemous filter), and the bounded-search slices (the multi-row
path, on float32 and SQ8 storage, and the padded path, on float32 and PQ
storage) on the card against the same slices on the CPU, where the
kernels' plain versions run; K2 on a block batch paged from an on-disk
directory, ``range_search`` with K2 against its plain version, and the
on-disk index on the card against the CPU; the IMI slice on both layouts,
IVFPQR, the transferred two-layer index, the binary and LSH indexes on
the card against the CPU, and K2 on PQ codes at the IMI and transfer
shapes; k-means twice on the card (bitwise equal), the HNSW family (two
builds on the card give one graph, an integer-data build equals the
CPU's, and searches on the card equal the CPU's on the same graph: flat,
SQ8, PQ and two-level storage, binary HNSW, BIVF_HNSW and IVF_HNSW with
K2); four shards of a ShardedIVF on one card against the CPU, data-
parallel k-means on the card (bitwise repeatable) and the C API's demo on
the card; four gloo ranks on the one card, each loading its shard,
bitwise the one-process ShardedIVF there, NCCL ranks sharing the card
refused at once, and clone_index on the card; the running top-k merge kernel (``csrc/topk_merge.cu``) bit for
bit its plain version at batch 1 to 1024, chunks from below k to 160k,
k 1 to 128, at 1 to 600 segments a row (one launch, the row's state left
as found), with empty, half-full, full and unsorted running results, and
at k 129, 640, 1024 and 6400 (the buffers in scratch above 1024). The entry points' default device is checked everywhere. This file imports no jax, so it also runs where jax is not
installed, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import inspect

import numpy as np
import pytest
import torch

import auncel_tpu_torch as att
from auncel_tpu_torch import convert
from auncel_tpu_torch.index.flat import sq_levels, sq_pack
from auncel_tpu_torch.index.ivf import compute_interdis
from auncel_tpu_torch.kernels.rowscan import (
    rowscan_dots, rowscan_dots_ref, rowscan_scores, rowscan_scores_ref)
from auncel_tpu_torch.kernels.scan_scores import (
    max_pq_m, scan_scores, scan_scores_ref)
from auncel_tpu_torch.ops.kmeans import kmeans
from auncel_tpu_torch.ops.pq import PQCodebooks, decode_pq
from auncel_tpu_torch.ops.sq import sq_decode_dev
from auncel_tpu_torch.types import Metric
from torch_parity import (ACC, D, K, MAX_TOPK, N_TEST, N_TRAIN, NLIST,
                          ROW_CAP, dot_order_scores, make_data)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def test_entry_points_default_to_the_card():
    """Every entry point allocates on the card unless the caller passes
    device="cpu"; without a card the first allocation raises instead of
    falling back to the CPU."""
    from auncel_tpu_torch.eval_harness import dist_bench
    from auncel_tpu_torch.index.binary import BinaryHNSWIndex
    for fn in (att.IVFFlatIndex.__init__, compute_interdis, kmeans,
               convert.ivf_arrays_from_numpy, convert.multirow_from_numpy,
               convert.traces_from_numpy, att.HNSWIndex.__init__,
               BinaryHNSWIndex.__init__, convert.hnsw_from_numpy,
               convert.sharded_from_numpy, dist_bench.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    centers, _, _ = make_data()
    idx = att.IVFFlatIndex(D, NLIST)
    assert idx.device.type == "cuda"
    if torch.cuda.is_available():
        idx.set_centroids(centers)
        assert idx.arrays.db.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            idx.set_centroids(centers)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    for n_rows, row_cap, d, T in ((300, 256, 128, 4093), (40, 77, 100, 33),
                                  (8, 3, 4, 0)):
        s = d ** -0.5  # O(1) dots: the 1e-5 tolerance checks the kernel
        db = torch.randn((n_rows, row_cap, d), generator=gen, device=dev) * s
        rows = torch.randint(0, n_rows, (T,), generator=gen, device=dev,
                             dtype=torch.int32)
        qs = torch.randn((T, d), generator=gen, device=dev) * s
        before = rowscan_dots.launches
        got = rowscan_dots(db, rows, qs)
        torch.cuda.synchronize()
        assert rowscan_dots.launches == before + (T > 0)
        torch.testing.assert_close(got, rowscan_dots_ref(db, rows, qs),
                                   rtol=1e-5, atol=1e-5)


def padded_inputs(nlist, cap, d, B, n_slots, device, seed=0):
    """A padded layout with ragged lists, a dead id inside a list, and
    probes with inactive slots (-1) and out-of-range list ids; entries
    ~ N(0, 1/d), so scores are O(1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = d ** -0.5
    sizes = torch.randint(0, cap + 1, (nlist,), generator=gen, device=device,
                          dtype=torch.int32)
    slot = torch.arange(cap, device=device)
    live = slot[None, :] < sizes[:, None]
    ids = torch.where(live, torch.arange(nlist * cap, device=device,
                                         dtype=torch.int32).reshape(nlist, cap),
                      -1)
    ids[0, 0] = -1
    db = torch.randn((nlist, cap, d), generator=gen, device=device) * s
    db = torch.where(live[:, :, None], db, 0.0)
    q = torch.randn((B, d), generator=gen, device=device) * s
    lists = torch.randint(-1, nlist + 2, (B, n_slots), generator=gen,
                          device=device, dtype=torch.int32)
    return (db, (db * db).sum(-1), ids.to(torch.int32), sizes, q,
            (q * q).sum(-1), lists)


@pytest.mark.cuda
def test_k2_matches_plain_version():
    dev = _card()
    for nlist, cap, d, B, n_slots in ((64, 1000, 128, 40, 5),
                                      (9, 77, 100, 7, 3), (4, 8, 16, 0, 2)):
        args = padded_inputs(nlist, cap, d, B, n_slots, dev)
        for metric in (Metric.L2, Metric.IP):
            before = scan_scores.launches
            scores, ids = scan_scores(*args, metric)
            torch.cuda.synchronize()
            assert scan_scores.launches == before + (B > 0)
            want_s, want_i = scan_scores_ref(*args, metric)
            torch.testing.assert_close(scores, want_s, rtol=1e-5, atol=1e-5)
            assert torch.equal(ids, want_i)


def _lists_one_list(B, S, nlist, gen, dev):
    return torch.full((B, S), 3, dtype=torch.int32, device=dev)


def _lists_inactive(B, S, nlist, gen, dev):
    return torch.full((B, S), -1, dtype=torch.int32, device=dev)


def _lists_repeated(B, S, nlist, gen, dev):
    lists = torch.randint(0, nlist, (B, S), generator=gen, device=dev,
                          dtype=torch.int32)
    lists[0, 0] = nlist - 1
    lists[:, 1] = lists[:, 0]
    lists[0, 2] = nlist + 3          # clamps onto nlist - 1 as well
    return lists


def _lists_past_nlist(B, S, nlist, gen, dev):
    return torch.randint(nlist, nlist + 4, (B, S), generator=gen, device=dev,
                         dtype=torch.int32)


# (nlist, cap, d, B, n_slots, lists or None for padded_inputs' own, whether
# every list is empty): the list-major kernel's edge cases
K2_CASES = {
    "one list, more queries than a chunk": (16, 300, 128, 100, 1,
                                            _lists_one_list, False),
    "batch 1, one slot": (64, 1000, 128, 1, 1, None, False),
    "batch 1, eight slots": (64, 1000, 128, 1, 8, None, False),
    "every slot inactive": (16, 300, 128, 40, 3, _lists_inactive, False),
    "lists of size 0": (16, 300, 128, 40, 3, None, True),
    "one list twice in a row": (16, 300, 128, 50, 3, _lists_repeated, False),
    "batch 1, one list three times": (16, 300, 128, 1, 3, _lists_repeated,
                                      False),
    "ids past nlist": (16, 300, 128, 40, 2, _lists_past_nlist, False),
    "cap not a multiple of the tile": (32, 1000, 128, 64, 4, None, False),
    "d = 100, the scalar path": (32, 300, 100, 64, 3, None, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_list_major_cases(case):
    dev = _card()
    nlist, cap, d, B, n_slots, make_lists, empty = K2_CASES[case]
    args = list(padded_inputs(nlist, cap, d, B, n_slots, dev, seed=3))
    gen = torch.Generator(device=dev).manual_seed(4)
    if make_lists is not None:
        args[6] = make_lists(B, n_slots, nlist, gen, dev)
    if empty:
        args[3] = torch.zeros_like(args[3])
    for metric in (Metric.L2, Metric.IP):
        before = scan_scores.launches
        scores, ids = scan_scores(*args, metric)
        torch.cuda.synchronize()
        assert scan_scores.launches == before + 1
        want_s, want_i = scan_scores_ref(*args, metric)
        assert torch.equal(ids, want_i)
        torch.testing.assert_close(scores, want_s, rtol=1e-5, atol=1e-5)


def _rows_one_row(B, S, n_rows, gen, dev):
    return torch.full((B, S), 5, dtype=torch.int32, device=dev)


def _rows_inactive(B, S, n_rows, gen, dev):
    return torch.full((B, S), -1, dtype=torch.int32, device=dev)


# (n_rows, row_cap, d, B, n_slots, rows or None for padded_inputs' own):
# the row scan's edge cases (each at L2 and IP)
K1_CASES = {
    "rows of 256 x 128, worklist mode": (300, 256, 128, 64, 8, None),
    "every entry inactive": (64, 256, 128, 40, 8, _rows_inactive),
    "one row probed by more than 32 queries": (64, 256, 128, 100, 2,
                                               _rows_one_row),
    "batch 1, direct mode": (64, 256, 128, 1, 8, None),
    "d = 100, no 16-byte path": (64, 200, 100, 40, 4, None),
    "row_cap not a multiple of the tile": (64, 77, 128, 50, 3, None),
    "T = 1": (16, 256, 128, 1, 1, None),
    "T = 0": (16, 256, 128, 0, 4, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_CASES))
def test_k1_rowscan_scores_cases(case):
    """K1 against its plain version (ids equal, scores within 1e-5 on
    N(0, 1/d) data), and bitwise equal to K2 over the same rows: the two
    share their dot units and epilogue arithmetic."""
    dev = _card()
    n_rows, row_cap, d, B, n_slots, make_rows = K1_CASES[case]
    args = list(padded_inputs(n_rows, row_cap, d, B, n_slots, dev, seed=5))
    if make_rows is not None:
        gen = torch.Generator(device=dev).manual_seed(6)
        args[6] = make_rows(B, n_slots, n_rows, gen, dev)
    for metric in (Metric.L2, Metric.IP):
        before = rowscan_scores.launches
        scores, ids = rowscan_scores(*args, metric)
        torch.cuda.synchronize()
        assert rowscan_scores.launches == before + (B * n_slots > 0)
        want_s, want_i = rowscan_scores_ref(*args, metric)
        assert torch.equal(ids, want_i)
        torch.testing.assert_close(scores, want_s, rtol=1e-5, atol=1e-5)
        k2_s, k2_i = scan_scores(*args, metric)
        assert torch.equal(scores, k2_s) and torch.equal(ids, k2_i)


@pytest.mark.cuda
def test_k1_direct_mode_equals_worklist_mode():
    """A query's entries alone (one chunk: the direct mode, one launch)
    give bitwise the scores and ids of the same entries inside a batch
    (the worklist)."""
    dev = _card()
    args = padded_inputs(300, 256, 128, 40, 8, dev, seed=7)
    scores, ids = rowscan_scores(*args, Metric.L2)
    for b in range(0, 40, 7):
        one = [t[b:b + 1] if i >= 4 else t for i, t in enumerate(args)]
        s1, i1 = rowscan_scores(*one, Metric.L2)
        torch.cuda.synchronize()
        assert torch.equal(s1, scores[b:b + 1]) and torch.equal(i1,
                                                               ids[b:b + 1])


def coded_inputs(codec, n, cap, d, B, n_slots, device, seed=0):
    """``padded_inputs`` with the stored vectors in ``codec``: bf16 values,
    or SQ codes (random levels, a range that decodes to about N(0, 1/d))
    with their scale and bias; db_sq the decoded norms, zero at dead
    slots. Returns (args, sq_scale, sq_bias)."""
    args = list(padded_inputs(n, cap, d, B, n_slots, device, seed=seed))
    live = args[2] >= 0
    if codec == "f32":
        return args, None, None
    if codec == "bf16":
        db = args[0].to(torch.bfloat16)
        x = db.float()
        args[0] = db
        args[1] = torch.where(live, (x * x).sum(-1), 0.0)
        return args, None, None
    rng = np.random.RandomState(seed)
    levels = int(sq_levels(codec))
    codes = rng.randint(0, levels + 1, (n * cap, d)).astype(np.uint8)
    scale = (rng.rand(d) * 4.0 / levels / d ** 0.5 + 1e-3).astype(
        np.float32)
    bias = (-0.5 * levels * scale + 0.1 * rng.randn(d)).astype(np.float32)
    sq_scale = torch.from_numpy(scale).to(device)
    sq_bias = torch.from_numpy(bias).to(device)
    db = torch.from_numpy(sq_pack(codes, codec)).to(device).reshape(
        n, cap, -1)
    x = sq_decode_dev(db, d, sq_scale, sq_bias)
    args[0] = db
    args[1] = torch.where(live, (x * x).sum(-1), 0.0)
    return args, sq_scale, sq_bias


# (codec, d): every codec at d = 96 and 128 and at a width whose slot is
# not a multiple of 16 bytes (bf16 200 and SQ8 100 bytes: float4 dots,
# no TMA; SQ6 72 bytes at d = 96; SQ4 49 and SQ6 27 bytes: byte copies,
# and SQ4 at d = 98 the scalar dots)
CODEC_CASES = [(c, d) for c in ("f32", "bf16", "sq8", "sq4", "sq6")
               for d in (96, 128)] + [
    ("bf16", 100), ("sq8", 100), ("sq4", 98), ("sq6", 36), ("f32", 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("codec, d", CODEC_CASES)
def test_codec_kernels_match_plain_version(codec, d):
    """K2 and K1 on coded storage against their plain versions (ids equal,
    scores within 1e-5 on N(0, 1/d) data), and K1 bitwise equal to K2 over
    the same rows: worklist mode with inactive entries, ragged sizes and
    out-of-range ids, a row probed by more than a chunk, and batch 1 (the
    direct mode)."""
    dev = _card()
    for n, cap, B, n_slots, one_row in ((40, 200, 64, 6, False),
                                       (16, 256, 100, 2, True),
                                       (40, 77, 1, 8, False)):
        args, sc, bi = coded_inputs(codec, n, cap, d, B, n_slots, dev,
                                    seed=d + B)
        if one_row:
            args[6] = torch.full((B, n_slots), 5, dtype=torch.int32,
                                 device=dev)
        for metric in (Metric.L2, Metric.IP):
            k2 = scan_scores.launches
            s2, i2 = scan_scores(*args, metric, sq_scale=sc, sq_bias=bi)
            k1 = rowscan_scores.launches
            s1, i1 = rowscan_scores(*args, metric, sq_scale=sc, sq_bias=bi)
            torch.cuda.synchronize()
            assert scan_scores.launches == k2 + 1
            assert rowscan_scores.launches == k1 + 1
            want_s, want_i = scan_scores_ref(*args, metric, sc, bi)
            assert torch.equal(i2, want_i)
            torch.testing.assert_close(s2, want_s, rtol=1e-5, atol=1e-5)
            assert torch.equal(s1, s2) and torch.equal(i1, i2)


@pytest.mark.cuda
@pytest.mark.parametrize("codec, d", [("bf16", 96), ("sq8", 96),
                                      ("sq4", 128), ("sq6", 96),
                                      ("sq8", 100), ("sq4", 98),
                                      ("sq6", 36)])
def test_codec_decode_bitwise(codec, d):
    """With unit queries a dot is one decoded element (the other products
    are zeros), so the kernels' IP scores are their decoded values: equal
    bit for bit to the plain decode (a multiply, then an add)."""
    dev = _card()
    n, cap = 6, 40
    args, sc, bi = coded_inputs(codec, n, cap, d, d, n, dev, seed=1)
    args[2] = torch.arange(n * cap, dtype=torch.int32,
                           device=dev).reshape(n, cap)
    args[3] = torch.full((n,), cap, dtype=torch.int32, device=dev)
    args[4] = torch.eye(d, device=dev)
    args[5] = torch.ones(d, device=dev)
    args[6] = torch.arange(n, dtype=torch.int32,
                           device=dev).repeat(d, 1)
    x = (sq_decode_dev(args[0], d, sc, bi) if sc is not None
         else args[0].float())                       # [n, cap, d]
    want = x.permute(2, 0, 1).reshape(d, n * cap)    # [query dim, slot]
    for fn in (scan_scores, rowscan_scores):
        got, _ = fn(*args, Metric.IP, sq_scale=sc, sq_bias=bi)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _decoded(args, sc, bi):
    """The stored slots of coded_inputs' args as float32 vectors."""
    db, d = args[0], args[4].shape[1]
    if sc is not None:
        return sq_decode_dev(db, d, sc, bi)
    return db.float()


@pytest.mark.cuda
@pytest.mark.parametrize("entries", [1, 2, 3, 8, 32])
@pytest.mark.parametrize("codec, d", [(c, d)
                                      for c in ("f32", "bf16", "sq8", "sq4",
                                                "sq6") for d in (96, 128)])
def test_kernels_follow_the_dot_order(codec, d, entries):
    """K1 and K2 give bitwise the dot order's model (torch_parity.
    dot_order_dots, on the CPU) with every row probed by 1, 2, 3, 8 or 32
    queries: the direct mode, the slot-a-thread route of small chunks,
    the warp units of large ones and the crossover between them."""
    dev = _card()
    n, cap = 16, 256
    args, sc, bi = coded_inputs(codec, n, cap, d, entries, n, dev,
                                seed=entries + d)
    args[6] = torch.arange(n, dtype=torch.int32,
                           device=dev).repeat(entries, 1).contiguous()
    cpu = [t.cpu() for t in args]
    x = _decoded(cpu, None if sc is None else sc.cpu(),
                 None if bi is None else bi.cpu())
    for metric in (Metric.L2, Metric.IP):
        want_s, want_i = dot_order_scores(cpu, x, metric)
        for fn in (rowscan_scores, scan_scores):
            got_s, got_i = fn(*args, metric, sq_scale=sc, sq_bias=bi)
            torch.cuda.synchronize()
            assert torch.equal(got_i.cpu(), want_i), fn.__name__
            assert torch.equal(got_s.cpu(), want_s), fn.__name__


@pytest.mark.cuda
@pytest.mark.parametrize("codec", ["f32", "sq8", "sq4", "sq6"])
def test_one_query_alone_equals_inside_a_crowded_batch(codec):
    """Each query's entries alone (the direct mode, one query a row: the
    slot-a-thread route) give bitwise the scores and ids of the same
    entries inside a batch of 48 queries on 10 rows (about 38 queries a
    row: the warp units), for K1 and K2."""
    dev = _card()
    args, sc, bi = coded_inputs(codec, 10, 256, 96, 48, 8, dev, seed=17)
    gen = torch.Generator(device=dev).manual_seed(4)
    args[6] = torch.argsort(torch.rand((48, 10), generator=gen, device=dev),
                            dim=1)[:, :8].to(torch.int32).contiguous()
    for fn in (rowscan_scores, scan_scores):
        scores, ids = fn(*args, Metric.L2, sq_scale=sc, sq_bias=bi)
        for b in range(0, 48, 5):
            one = [t[b:b + 1] if i >= 4 else t for i, t in enumerate(args)]
            s1, i1 = fn(*one, Metric.L2, sq_scale=sc, sq_bias=bi)
            torch.cuda.synchronize()
            assert torch.equal(s1, scores[b:b + 1]), (fn.__name__, b)
            assert torch.equal(i1, ids[b:b + 1]), (fn.__name__, b)


@pytest.mark.cuda
def test_plan_over_40000_rows():
    """An SQ8 layout of 40000 rows, most of them empty (the worklist's plan
    then spans 40 blocks of lists): K1 in worklist mode matches the plain
    version, equals K2 over the same rows, and equals bitwise each query
    alone (the direct mode)."""
    dev = _card()
    n_rows, cap, d, B, S = 40000, 32, 96, 64, 24
    args, sc, bi = coded_inputs("sq8", n_rows, cap, d, B, S, dev, seed=9)
    gen = torch.Generator(device=dev).manual_seed(9)
    full = torch.randperm(n_rows, generator=gen, device=dev)[:1500]
    sizes = torch.zeros(n_rows, dtype=torch.int32, device=dev)
    sizes[full] = torch.randint(1, cap + 1, (1500,), generator=gen,
                                device=dev, dtype=torch.int32)
    args[3] = sizes
    pick = torch.randint(0, 1500, (B, S), generator=gen, device=dev)
    rows = full[pick].to(torch.int32)
    rows[:, -4:] = torch.randint(0, n_rows, (B, 4), generator=gen,
                                 device=dev, dtype=torch.int32)
    rows[::5, -1] = -1
    args[6] = rows.contiguous()
    before = rowscan_scores.launches
    scores, ids = rowscan_scores(*args, Metric.L2, sq_scale=sc, sq_bias=bi)
    torch.cuda.synchronize()
    assert rowscan_scores.launches == before + 1
    want_s, want_i = rowscan_scores_ref(*args, Metric.L2, sc, bi)
    assert torch.equal(ids, want_i)
    torch.testing.assert_close(scores, want_s, rtol=1e-5, atol=1e-5)
    k2_s, k2_i = scan_scores(*args, Metric.L2, sq_scale=sc, sq_bias=bi)
    assert torch.equal(scores, k2_s) and torch.equal(ids, k2_i)
    for b in range(0, B, 9):
        one = [t[b:b + 1] if i >= 4 else t for i, t in enumerate(args)]
        s1, i1 = rowscan_scores(*one, Metric.L2, sq_scale=sc, sq_bias=bi)
        torch.cuda.synchronize()
        assert torch.equal(s1, scores[b:b + 1]) and torch.equal(
            i1, ids[b:b + 1])


def _slice(device, storage="f32"):
    """The main path after k-means, at the parity fixture's size."""
    centers, xb, xq = make_data()
    idx = att.IVFFlatIndex(D, NLIST, device=device, storage=storage)
    idx.set_centroids(centers)
    idx.add(xb)
    idx.enable_multirow(row_cap=ROW_CAP)
    gt_D, gt_I = idx.exact_search(xq, MAX_TOPK)
    es = att.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    es.sys_train(N_TRAIN, xq)
    es.set_topk(K)
    es.set_queries(N_TEST, xq, np.full(N_TRAIN + N_TEST, ACC, np.float32))
    es.calibrate(0, N_TRAIN, target_bound=ACC, std_m_grid=(1.0, 4.0))
    D_out, I_out = es.search(N_TRAIN, N_TEST)
    out = dict(gt_I=gt_I, D=D_out, I=I_out, mult=es.multipler,
               np=es.my_nprobe[N_TRAIN:].copy(),
               ns=es.n_scanned[N_TRAIN:].copy())
    D1, I1 = es.search(N_TRAIN + 1, 1)
    out.update(D1=D1, I1=I1, np1=int(es.my_nprobe[N_TRAIN + 1]))
    return out


@pytest.mark.cuda
def test_slice_on_the_card_matches_the_cpu():
    dev = _card()
    cpu = _slice("cpu")
    k1, dots = rowscan_scores.launches, rowscan_dots.launches
    card = _slice(dev)
    assert rowscan_scores.launches > k1 and rowscan_dots.launches == dots
    np.testing.assert_array_equal(card["gt_I"], cpu["gt_I"])
    assert card["mult"] == cpu["mult"]
    for name in ("I", "np", "ns", "I1", "np1"):
        np.testing.assert_array_equal(card[name], cpu[name])
    for name in ("D", "D1"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-5)


@pytest.mark.cuda
def test_sq8_slice_on_the_card_matches_the_cpu():
    """The main path on SQ8 storage: K1 and K2 decode the codes on the
    card, the plain versions on the CPU."""
    dev = _card()
    cpu = _slice("cpu", storage="sq8")
    k1, k2 = rowscan_scores.launches, scan_scores.launches
    card = _slice(dev, storage="sq8")
    assert rowscan_scores.launches > k1 and scan_scores.launches > k2
    np.testing.assert_array_equal(card["gt_I"], cpu["gt_I"])
    assert card["mult"] == cpu["mult"]
    for name in ("I", "np", "ns", "I1", "np1"):
        np.testing.assert_array_equal(card[name], cpu[name])
    for name in ("D", "D1"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-5)


def _padded_slice(device):
    """The padded path at the fixture's size: profile training, calibration,
    a two-phase window and batch-1 windows on an index without the
    multi-row layout."""
    centers, xb, xq = make_data()
    idx = att.IVFFlatIndex(D, NLIST, device=device)
    idx.set_centroids(centers)
    idx.add(xb)
    gt_D, gt_I = idx.exact_search(xq, MAX_TOPK)
    es = att.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    es.sys_train(N_TRAIN, xq)
    es.set_topk(K)
    es.set_queries(N_TEST, xq, np.full(N_TRAIN + N_TEST, ACC, np.float32))
    es.calibrate(0, N_TRAIN, target_bound=ACC, std_m_grid=(1.0, 4.0))
    D_out, I_out = es.search(N_TRAIN, N_TEST)
    out = dict(D=D_out, I=I_out, mult=es.multipler,
               np=es.my_nprobe[N_TRAIN:].copy(),
               ns=es.n_scanned[N_TRAIN:].copy())
    b1 = [es.search(N_TRAIN + i, 1) for i in range(4)]
    out.update(D1=np.concatenate([d for d, _ in b1]),
               I1=np.concatenate([i for _, i in b1]),
               np1=es.my_nprobe[N_TRAIN:N_TRAIN + 4].copy(),
               ns1=es.n_scanned[N_TRAIN:N_TRAIN + 4].copy())
    return out


@pytest.mark.cuda
def test_padded_path_on_the_card_matches_the_cpu():
    dev = _card()
    cpu = _padded_slice("cpu")
    k1, dots, k2 = (rowscan_scores.launches, rowscan_dots.launches,
                    scan_scores.launches)
    card = _padded_slice(dev)
    assert scan_scores.launches > k2
    assert rowscan_scores.launches == k1 and rowscan_dots.launches == dots
    assert card["mult"] == cpu["mult"]
    for name in ("I", "np", "ns", "I1", "np1", "ns1"):
        np.testing.assert_array_equal(card[name], cpu[name])
    for name in ("D", "D1"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-5)


def pq_inputs(nlist, cap, d, M, B, n_slots, device, residual, seed=0):
    """``padded_inputs`` with PQ storage: random codes [nlist, cap, M], a
    codebook [M, 256, d / M] and (residual) centroids ~ N(0, 1/d); db_sq the
    decoded norms, zero at dead slots. Returns (args, codec keywords)."""
    args = list(padded_inputs(nlist, cap, d, B, n_slots, device, seed=seed))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    s = d ** -0.5
    books = torch.randn((M, 256, d // M), generator=gen, device=device) * s
    codes = torch.randint(0, 256, (nlist, cap, M), generator=gen,
                          device=device, dtype=torch.int32).to(torch.uint8)
    x = decode_pq(PQCodebooks(books), codes)
    args[0] = codes
    args[1] = torch.where(args[2] >= 0, (x * x).sum(-1), 0.0)
    cents = (torch.randn((nlist, d), generator=gen, device=device) * s
             if residual else None)
    return args, {"pq_codebooks": books, "centroids": cents}


def pq_terms(args, codec, metric):
    """[B, n_slots * cap] magnitudes of each score's terms: ||q - c_l||^2 +
    db_sq (L2) or |<c_l, q>| + ||q|| ||r|| (IP) on residual codes, else
    q_sq + db_sq or ||q|| ||x||: the 1e-5 tolerance of the SQ codecs' tests
    is taken of these."""
    db, db_sq, _, _, q, q_sq, lists = args
    B, S = lists.shape
    sel = lists.long().clamp(0, db.shape[0] - 1)
    cents = codec["centroids"]
    if cents is None:
        cents = torch.zeros((db.shape[0], q.shape[1]), device=q.device)
    cl = cents[sel]                                        # [B, S, d]
    if metric is Metric.L2:
        t = ((q[:, None, :] - cl) ** 2).sum(-1)[:, :, None] + db_sq[sel]
    else:
        t = ((cl * q[:, None, :]).sum(-1).abs()[:, :, None]
             + q_sq.sqrt()[:, None, None] * db_sq[sel].sqrt())
    return t.reshape(B, S * db.shape[1])


# (d, M): dsub 2, 4 and 6 at d 96, dsub 6 at d 18 (M % 4 != 0: the codes
# read byte by byte, the byte copies of 3-byte slots), and the widths the
# codebook in shared memory refused before the lookup tables: d 256 / M 32
# (two tables a chunk) and d 192 / M 64 (one)
PQ_CASES = [(d, M, res) for d, M in ((96, 48), (96, 24), (96, 16), (18, 3),
                                     (256, 32), (192, 64))
            for res in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("ht", [None, "half", "all"])
@pytest.mark.parametrize("d, M, residual", PQ_CASES)
def test_k2_pq_matches_plain_version(d, M, residual, ht):
    """K2 on PQ codes against its plain version: ids equal, scores within
    1e-5 of their terms, on the worklist with inactive entries, ragged
    sizes and out-of-range ids; every query on one list longer than a tile
    (more entries than a chunk's tables: the chunk split); batch 1 on short
    lists and on lists cut into spans; and every probe dead. Without the
    polysemous filter, and with it at ht 4M (random query codes: about
    half the codes kept) and 8M (every code kept); a kept slot's score is
    bitwise the unfiltered kernel's."""
    dev = _card()
    for nlist, cap, B, n_slots, lists in ((40, 200, 64, 6, None),
                                          (16, 600, 100, 2, "one"),
                                          (40, 77, 1, 8, None),
                                          (8, 3000, 1, 8, None),
                                          (8, 64, 5, 3, "dead")):
        args, codec = pq_inputs(nlist, cap, d, M, B, n_slots, dev, residual,
                                seed=d + M + B)
        if lists is not None:
            args[6] = torch.full((B, n_slots), 5 if lists == "one" else -1,
                                 dtype=torch.int32, device=dev)
        if ht is not None:
            gen = torch.Generator(device=dev).manual_seed(M + B)
            codec["qcodes"] = torch.randint(
                0, 256, (B, n_slots, M), generator=gen, device=dev,
                dtype=torch.int32).to(torch.uint8)
            codec["ht"] = 4 * M if ht == "half" else 8 * M
        for metric in (Metric.L2, Metric.IP):
            before = scan_scores.launches
            got_s, got_i = scan_scores(*args, metric, **codec)
            torch.cuda.synchronize()
            assert scan_scores.launches == before + 1
            want_s, want_i = scan_scores_ref(*args, metric, **codec)
            assert torch.equal(got_i, want_i)
            fin = torch.isfinite(want_s)
            assert torch.equal(torch.isfinite(got_s), fin)
            tol = 1e-5 * pq_terms(args, codec, metric) + 1e-6
            assert bool(((got_s - want_s).abs() <= tol)[fin].all())
            if ht is not None:
                plain = {k: v for k, v in codec.items()
                         if k not in ("qcodes", "ht")}
                all_s, _ = scan_scores(*args, metric, **plain)
                assert torch.equal(got_s[fin], all_s[fin])
                n_all = int(torch.isfinite(all_s).sum())
                if ht == "half" and n_all:
                    assert 0 < int(fin.sum()) < n_all


@pytest.mark.cuda
@pytest.mark.parametrize("d, M", [(96, 16), (96, 24), (18, 3)])
def test_k2_pq_decode_bitwise(d, M):
    """With unit queries a dot is one decoded element, so plain PQ's IP
    scores are the codebook's values bit for bit; residual IP adds <c_l,
    e_i> = c_l[i] to them, one rounding, as the plain version does."""
    dev = _card()
    n, cap = 6, 40
    for residual in (False, True):
        args, codec = pq_inputs(n, cap, d, M, d, n, dev, residual, seed=3)
        args[2] = torch.arange(n * cap, dtype=torch.int32,
                               device=dev).reshape(n, cap)
        args[3] = torch.full((n,), cap, dtype=torch.int32, device=dev)
        args[4] = torch.eye(d, device=dev)
        args[5] = torch.ones(d, device=dev)
        args[6] = torch.arange(n, dtype=torch.int32, device=dev).repeat(d, 1)
        got, _ = scan_scores(*args, Metric.IP, **codec)
        want, _ = scan_scores_ref(*args, Metric.IP, **codec)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_k2_pq_refuses_what_it_cannot_hold():
    """An M whose one lookup table and ring do not fit a block's shared
    memory (M = d = 256: 256 KB of table) raises ValueError on the card
    (never the plain version), and K1 refuses PQ codes."""
    dev = _card()
    d = 256
    assert max_pq_m(d) < d
    args, codec = pq_inputs(4, 16, d, d, 2, 2, dev, True)
    with pytest.raises(ValueError, match=f"M <= {max_pq_m(d)} at d={d}"):
        scan_scores(*args, Metric.L2, **codec)
    args, codec = pq_inputs(4, 16, 16, 4, 2, 2, dev, True)
    with pytest.raises(ValueError):
        rowscan_scores(*args, Metric.L2, **codec)


def _pq_slice(device, arrays):
    """The padded path on PQ storage at the fixture's size, on the given
    arrays moved to ``device``: profile training, calibration, a window
    and batch-1 windows, then fixed-nprobe search with and without the
    polysemous filter."""
    centers, _, xq = make_data()
    a = arrays._replace(**{f: getattr(arrays, f).to(device)
                           for f in arrays._fields
                           if isinstance(getattr(arrays, f), torch.Tensor)})
    idx = att.IVFFlatIndex.from_state(centers, a)
    gt_D, gt_I = idx.exact_search(xq, MAX_TOPK)
    es = att.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    es.sys_train(N_TRAIN, xq)
    es.set_topk(K)
    es.set_queries(N_TEST, xq, np.full(N_TRAIN + N_TEST, ACC, np.float32))
    es.calibrate(0, N_TRAIN, target_bound=ACC, std_m_grid=(1.0, 4.0))
    D_out, I_out = es.search(N_TRAIN, N_TEST)
    out = dict(gt_I=gt_I, D=D_out, I=I_out, mult=es.multipler,
               np=es.my_nprobe[N_TRAIN:].copy(),
               ns=es.n_scanned[N_TRAIN:].copy())
    D1, I1 = es.search(N_TRAIN + 1, 1)
    out.update(D1=D1, I1=I1)
    out["Df"], out["If"] = idx.search(xq, K, nprobe=6)
    idx.polysemous_ht = 12
    out["Dh"], out["Ih"] = idx.search(xq, K, nprobe=6)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [True, False])
def test_pq_slice_on_the_card_matches_the_cpu(residual):
    """The PQ slice on the same state on the card (K2 decodes the codes)
    and on the CPU (its plain version): equal ids and decisions."""
    dev = _card()
    centers, xb, _ = make_data()
    build = att.IVFFlatIndex(D, NLIST, device="cpu", storage="pq4",
                             pq_residual=residual)
    build.set_centroids(centers)
    build.add(xb)
    cpu = _pq_slice("cpu", build.arrays)
    k1, k2 = rowscan_scores.launches, scan_scores.launches
    card = _pq_slice(dev, build.arrays)
    assert scan_scores.launches > k2 and rowscan_scores.launches == k1
    assert card["mult"] == cpu["mult"]
    for name in ("gt_I", "I", "np", "ns", "I1", "If", "Ih"):
        np.testing.assert_array_equal(card[name], cpu[name])
    for name in ("D", "D1", "Df", "Dh"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-5,
                                   atol=1e-5)


def _ondisk_dir(tmp_path):
    """The fixture's index written as an on-disk directory, and its
    profile: (directory, profile path)."""
    from auncel_tpu_torch.index.io import save_index_ondisk
    centers, xb, xq = make_data()
    idx = att.IVFFlatIndex(D, NLIST, device="cpu")
    idx.set_centroids(centers)
    idx.add(xb)
    gt_D, gt_I = idx.exact_search(xq, MAX_TOPK)
    es = att.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    es.sys_train(N_TRAIN, xq)
    save_index_ondisk(idx, str(tmp_path / "ondisk"))
    es.save_profile(str(tmp_path / "profile.npz"))
    return str(tmp_path / "ondisk"), str(tmp_path / "profile.npz")


@pytest.mark.cuda
def test_k2_on_paged_blocks_matches_plain_version(tmp_path):
    """K2 on a block batch paged from disk (the stored list sizes, norms
    computed from the paged vectors) against its plain version, within
    1e-5 of q_sq + db_sq."""
    from auncel_tpu_torch.index.ondisk import OnDiskIVFIndex
    from auncel_tpu_torch.ops.distance import sqnorms
    dev = _card()
    path, _ = _ondisk_dir(tmp_path)
    od = OnDiskIVFIndex(path, device=dev)
    _, _, xq = make_data()
    q = torch.as_tensor(xq, device=dev)
    _, cids = od._coarse(q, 6)
    blocks, block_ids, sizes, uniq = od._page_blocks(cids.cpu().numpy())
    assert np.array_equal(sizes.cpu().numpy(), od.list_sizes[uniq])
    a = od._compact(blocks, block_ids, sizes)
    probe = torch.as_tensor(np.searchsorted(uniq, cids.cpu().numpy())
                            .astype(np.int32), device=dev)
    args = (a.db, a.db_sq, a.vec_ids, a.list_sizes, q, sqnorms(q), probe)
    before = scan_scores.launches
    got_s, got_i = scan_scores(*args, Metric.L2)
    want_s, want_i = scan_scores_ref(*args, Metric.L2)
    torch.cuda.synchronize()
    assert scan_scores.launches == before + 1
    assert torch.equal(got_i, want_i) and (got_i >= 0).any()
    fin = torch.isfinite(want_s)
    assert torch.equal(torch.isfinite(got_s), fin)
    terms = (sqnorms(q)[:, None, None]
             + a.db_sq[probe.long()]).reshape(q.shape[0], -1)
    assert bool(((got_s - want_s).abs()[fin] <= 1e-5 * terms[fin]
                 + 1e-5).all())


@pytest.mark.cuda
def test_range_search_kernel_matches_plain_version(monkeypatch):
    """range_search with K2 against the same function with K2's plain
    version on the same card tensors."""
    import auncel_tpu_torch.index.aux as aux
    dev = _card()
    centers, xb, xq = make_data()
    idx = att.IVFFlatIndex(D, NLIST, device=dev)
    idx.set_centroids(centers)
    idx.add(xb)
    v, _ = idx.search(xq, K, nprobe=4)
    radius = float(np.median(v[:, K - 1]))
    before = scan_scores.launches
    got = aux.range_search(idx, xq, radius, nprobe=12)
    assert scan_scores.launches > before and got.lims[-1] > 0
    monkeypatch.setattr(aux, "scan_scores", scan_scores_ref)
    want = aux.range_search(idx, xq, radius, nprobe=12)
    np.testing.assert_array_equal(got.lims, want.lims)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.distances, want.distances, rtol=1e-5,
                               atol=1e-5)


def _ondisk_slice(path, profile, device):
    """Fixed-nprobe and bounded search (some queries past nlist/8) of an
    on-disk directory served on ``device``."""
    from auncel_tpu_torch.index.ondisk import OnDiskIVFIndex
    od = OnDiskIVFIndex(path, device=device)
    od.attach_profile(profile, multipler=8.0, std_m=1.0, max_topk=MAX_TOPK)
    _, _, xq = make_data()
    out = {}
    out["D"], out["I"] = od.search(xq, K, nprobe=8)
    acc = np.full(len(xq), ACC, np.float32)
    out["Db"], out["Ib"], out["ns"] = od.search_bounded(xq, acc, K)
    return out


@pytest.mark.cuda
def test_ondisk_on_the_card_matches_the_cpu(tmp_path):
    dev = _card()
    path, profile = _ondisk_dir(tmp_path)
    cpu = _ondisk_slice(path, profile, "cpu")
    before = scan_scores.launches
    card = _ondisk_slice(path, profile, dev)
    assert scan_scores.launches > before
    assert (card["ns"] > NLIST // 8).any()
    for name in ("I", "Ib", "ns"):
        np.testing.assert_array_equal(card[name], cpu[name])
    for name in ("D", "Db"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-5)


def _imi_slice(device, centroids, layout: str):
    """ErrorSys over IMI product cells (IMI2x3) at the fixture's size on
    ``device``: the window, a batch-1 window, the decisions, and
    fixed-nprobe search with and without max_codes."""
    _, xb, xq = make_data()
    idx = convert.imi_from_numpy(centroids, device=device)
    idx.add(xb)
    if layout == "multirow":
        idx.enable_multirow(row_cap=ROW_CAP)
    gt_D, gt_I = idx.exact_search(xq, MAX_TOPK)
    es = att.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    es.sys_train(N_TRAIN, xq)
    es.set_topk(K)
    es.set_queries(N_TEST, xq, np.full(N_TRAIN + N_TEST, ACC, np.float32))
    es.set_hyper(4.0, 1.0)
    D_out, I_out = es.search(N_TRAIN, N_TEST)
    out = dict(gt_I=gt_I, D=D_out, I=I_out,
               np=es.my_nprobe[N_TRAIN:].copy(),
               ns=es.n_scanned[N_TRAIN:].copy())
    out["D1"], out["I1"] = es.search(N_TRAIN + 3, 1)
    out["Df"], out["If"] = idx.search(xq, K, nprobe=8)
    idx.max_codes = 150
    out["Dm"], out["Im"] = idx.search(xq, K, nprobe=8)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["padded", "multirow"])
def test_imi_slice_on_the_card_matches_the_cpu(layout):
    """IMI cells on the card (K1 on the rows, K2 in profile training and on
    the padded lists) and on the CPU: equal ids and decisions."""
    from auncel_tpu_torch.index.imi import train_imi_centroids
    dev = _card()
    _, xb, _ = make_data()
    cents = train_imi_centroids(xb, 64, Metric.L2, device="cpu")
    cpu = _imi_slice("cpu", cents, layout)
    k1, k2 = rowscan_scores.launches, scan_scores.launches
    card = _imi_slice(dev, cents, layout)
    assert scan_scores.launches > k2
    assert (rowscan_scores.launches > k1) == (layout == "multirow")
    for name in ("gt_I", "I", "np", "ns", "I1", "If", "Im"):
        np.testing.assert_array_equal(card[name], cpu[name])
    for name in ("D", "D1", "Df", "Dm"):
        np.testing.assert_allclose(card[name], cpu[name], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.cuda
def test_ivfpqr_on_the_card_matches_the_cpu(tmp_path):
    """IndexIVFPQR built on the CPU, its file loaded on the card: the base
    search (K2 on the codes) and the re-rank give the CPU's ids, and the
    two-stage reconstructions are bitwise the CPU's."""
    from auncel_tpu_torch.index.io import load_index, save_index
    from auncel_tpu_torch.index.ivfpqr import IndexIVFPQR
    dev = _card()
    _, xb, xq = make_data()
    cpu = IndexIVFPQR(D, NLIST, M=4, M_refine=8, device="cpu")
    cpu.train(xb)
    cpu.add(xb)
    save_index(cpu, str(tmp_path / "pqr.npz"))
    card = load_index(str(tmp_path / "pqr.npz"), device=dev)
    assert card.arrays.db.is_cuda
    before = scan_scores.launches
    for k_factor in (1.0, 4.0):
        for x in (cpu, card):
            x.k_factor = k_factor
        cv, ci = card.search(xq, K, nprobe=4)
        pv, pi = cpu.search(xq, K, nprobe=4)
        np.testing.assert_array_equal(ci, pi)
        np.testing.assert_allclose(cv, pv, rtol=1e-5, atol=1e-5)
    assert scan_scores.launches > before
    keys = np.arange(0, len(xb), 37, dtype=np.int64)
    np.testing.assert_array_equal(card.reconstruct_batch(keys),
                                  cpu.reconstruct_batch(keys))


@pytest.mark.cuda
def test_transferred_twolayer_on_the_card_matches_the_cpu():
    """Index2Layer's codes moved into inverted lists on the card (cap =
    the largest list, not rounded) and on the CPU: K2 on the residual PQ
    codes gives the CPU's ids; reconstructions bitwise reconstruct_n's;
    the exact decoded search equal."""
    from auncel_tpu_torch.index.twolayer import Index2Layer
    dev = _card()
    _, xb, xq = make_data()
    cpu = Index2Layer(D, NLIST, M=4, device="cpu")
    cpu.train(xb)
    cpu.add(xb[:3001])
    card = convert.twolayer_from_numpy(dict(
        d=D, nlist=NLIST, M=4, centroids=cpu.centroids,
        books=cpu._pq.codebooks.numpy(), list_ids=cpu.list_ids,
        codes=cpu.codes), device=dev)
    tc, tp_ = card.transfer_to_ivfpq(), cpu.transfer_to_ivfpq()
    assert tc.arrays.db.is_cuda
    np.testing.assert_array_equal(tc.reconstruct_n(0, card.ntotal),
                                  card.reconstruct_n())
    before = scan_scores.launches
    cv, ci = tc.search(xq, K, nprobe=6)
    assert scan_scores.launches > before
    pv, pi = tp_.search(xq, K, nprobe=6)
    np.testing.assert_array_equal(ci, pi)
    np.testing.assert_allclose(cv, pv, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(card.search(xq, K)[1], cpu.search(xq, K)[1])


@pytest.mark.cuda
def test_binary_and_lsh_on_the_card_match_the_cpu():
    """BinaryFlat, BinaryIVF (every nprobe to all lists), IndexLSH and the
    spectral hash on the card and on the CPU, on the same codes and
    trained state: equal ids and distances."""
    from auncel_tpu_torch.index import binary as tbin
    from auncel_tpu_torch.index.lsh import IndexLSH, IVFSpectralHashIndex
    dev = _card()
    _, xb, xq = make_data()
    lsh = IndexLSH(D, 64, rotate_data=True, device="cpu")
    lsh.add(xb)
    codes, qcodes = lsh.codes, tbin.pack_bits(lsh._encode(xq))
    bivf = tbin.BinaryIVFIndex(64, 16, device="cpu")
    bivf.train(codes)
    state = dict(d=64, nlist=16, codes=codes,
                 centroid_bits=bivf.centroid_bits)
    sh = IVFSpectralHashIndex(D, NLIST, 32, device="cpu")
    sh.train(xb)
    sh_state = dict(d=D, nlist=NLIST, nbit=32, threshold_type=sh.threshold_type,
                    period=sh.period, rrot=sh.rrot, centroids=sh.centroids,
                    trained=sh.trained, x=xb, ids=np.arange(len(xb)))
    out = {}
    for device in ("cpu", dev):
        res = []
        flat = convert.binary_from_numpy(dict(d=64, codes=codes), device)
        res.append(flat.search(qcodes, K))
        ivf = convert.binary_from_numpy(state, device)
        for nprobe in (1, 4, 16):
            res.append(ivf.search(qcodes, K, nprobe=nprobe))
        res.append(convert.lsh_from_numpy(dict(
            d=D, nbits=64, rotate_data=True, train_thresholds=False,
            rrot=lsh.rrot, thresholds=lsh.thresholds, bits=lsh._bits),
            device).search(xq, K))
        res.append(convert.spectral_hash_from_numpy(sh_state, device).search(
            xq, K, nprobe=4))
        out[str(device)] = res
    for (cv, ci), (pv, pi) in zip(out[str(dev)], out["cpu"]):
        np.testing.assert_array_equal(ci, pi)
        np.testing.assert_array_equal(cv, pv)
    np.testing.assert_array_equal(out["cpu"][0][0], out["cpu"][3][0])


@pytest.mark.cuda
@pytest.mark.parametrize("nlist, cap", [(16384, 61), (1024, 3001)])
def test_k2_pq_at_imi_and_transfer_shapes(nlist, cap):
    """K2 on residual PQ codes over many short lists (IMI's 16384 product
    cells) and over a cap that is no multiple of 8 (transfer_to_ivfpq's
    layout), against its plain version within 1e-5 of the terms."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    d, M, B, S = 128, 16, 64, 8
    books = torch.randn((M, 256, d // M), generator=gen, device=dev) * 0.1
    sizes = torch.randint(0, cap + 1, (nlist,), generator=gen, device=dev,
                          dtype=torch.int32)
    live = torch.arange(cap, device=dev)[None] < sizes[:, None]
    db = torch.randint(0, 256, (nlist, cap, M), generator=gen, device=dev,
                       dtype=torch.int32).to(torch.uint8)
    ids = torch.where(live, torch.arange(nlist * cap, device=dev,
                                         dtype=torch.int32).reshape(nlist,
                                                                    cap), -1)
    cents = torch.randn((nlist, d), generator=gen, device=dev) * 0.1
    dec = decode_pq(PQCodebooks(books), db)
    db_sq = torch.where(live, (dec * dec).sum(-1), 0.0)
    del dec
    q = torch.randn((B, d), generator=gen, device=dev) * 0.1
    lists = torch.randint(0, nlist, (B, S), generator=gen, device=dev,
                          dtype=torch.int32)
    args = (db, db_sq, ids.to(torch.int32), sizes, q, (q * q).sum(-1), lists)
    codec = dict(pq_codebooks=books, centroids=cents)
    got_s, got_i = scan_scores(*args, Metric.L2, **codec)
    want_s, want_i = scan_scores_ref(*args, Metric.L2, **codec)
    torch.cuda.synchronize()
    assert torch.equal(got_i, want_i)
    fin = torch.isfinite(want_s)
    assert torch.equal(torch.isfinite(got_s), fin)
    cl = cents[lists.long()]                                  # [B, S, d]
    terms = (((q[:, None] - cl) ** 2).sum(-1)[:, :, None]
             + db_sq[lists.long()]).reshape(B, -1)
    assert ((got_s - want_s).abs()[fin] <= 1e-5 * terms[fin] + 1e-6).all()


@pytest.mark.cuda
@pytest.mark.parametrize("init", ["kmeans++", "random"])
def test_kmeans_on_the_card_is_bitwise_repeatable(init):
    """The mean update sums each centroid in a fixed order (a stable sort
    by assignment, then one sequential sum a segment), so two trainings
    on the card are bitwise equal; with numpy-drawn initial centroids the
    card lands within the CPU's tolerance of the CPU."""
    from auncel_tpu_torch.ops.kmeans import KmeansParams
    dev = _card()
    x = np.random.RandomState(3).randn(65536, 32).astype(np.float32)
    p = KmeansParams(niter=8, init=init, balance_iters=2)
    a = kmeans(x, 256, p, device=dev)
    b = kmeans(x, 256, p, device=dev)
    np.testing.assert_array_equal(a.centroids, b.centroids)
    assert a.error == b.error
    if init == "random":
        c = kmeans(x, 256, p, device="cpu")
        np.testing.assert_allclose(a.centroids, c.centroids, rtol=1e-4,
                                   atol=1e-4)


def _hnsw_data(n: int = 4000, d: int = 32):
    rng = np.random.RandomState(6)
    c = rng.randn(40, d).astype(np.float32)
    xb = (c[rng.randint(0, 40, n)] + 0.3 * rng.randn(n, d)).astype(
        np.float32)
    xq = (c[rng.randint(0, 40, 200)] + 0.4 * rng.randn(200, d)).astype(
        np.float32)
    return xb, xq


def _tables(idx):
    return [idx.levels, idx.entry_point] + list(idx.nb_tables) + \
        list(idx.g2u)


@pytest.mark.cuda
def test_hnsw_builds_on_the_card_repeat():
    """Two builds on the card (with a k-means-trained two-level storage
    too) give one graph; on integer vectors, where every sum is exact, and
    on floats (the graph's distances are float64 sums rounded once) the
    card's build is the CPU's."""
    dev = _card()
    xb, _ = _hnsw_data()
    for desc in ("HNSW16", "HNSW16_64+PQ8"):
        built = []
        for _ in range(2):
            idx = att.index_factory(32, desc, device=dev)
            idx.train(xb)
            idx.add(xb)
            idx.build()
            built.append(_tables(idx))
        for a, b in zip(*built):
            np.testing.assert_array_equal(a, b)
        if desc == "HNSW16":
            float_card = built[0]
    xi = np.random.RandomState(2).randint(-8, 8, (3000, 16)).astype(
        np.float32)
    for x, d, card in ((xi, 16, None), (xb, 32, float_card)):
        out = [card] if card is not None else []
        for device in ((dev, "cpu") if card is None else ("cpu",)):
            idx = att.index_factory(d, "HNSW16" if card is not None
                                    else "HNSW8", device=device)
            idx.add(x)
            idx.build()
            out.append(_tables(idx))
        for a, b in zip(*out):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("desc", ["HNSW16", "HNSW16_SQ8", "HNSW16_PQ8",
                                  "HNSW16_64+PQ8"])
def test_hnsw_search_on_the_card_equals_the_cpu(desc):
    """A graph built on the card, carried to the CPU by its state: equal
    ids, values within 1e-5, at ef 16 and 128."""
    dev = _card()
    xb, xq = _hnsw_data()
    card = att.index_factory(32, desc, device=dev)
    card.train(xb)
    card.add(xb)
    card.build()
    assert card._dev[0].device.type == dev.type
    cpu = convert.hnsw_from_numpy(card.state(), device="cpu")
    for ef in (16, 128):
        cv, ci = card.search(xq, 10, ef=ef)
        pv, pi = cpu.search(xq, 10, ef=ef)
        np.testing.assert_array_equal(ci, pi)
        np.testing.assert_allclose(cv, pv, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_graph_quantizers_on_the_card_equal_the_cpu():
    """BinaryHNSW, BIVF_HNSW and IVF_HNSW (K2 on the graph-ranked lists)
    on the card against the CPU on the same state and coarse graph."""
    from auncel_tpu_torch.index import binary as tbin
    dev = _card()
    xb, xq = _hnsw_data()

    def on_cpu(bh):
        """The same binary graph on the CPU (its file's keys)."""
        g = bh._g
        return convert.hnsw_from_numpy(dict(
            g.state(), kind="BHNSW", codes=tbin.pack_bits(g._xb > 0.5)),
            "cpu")
    codes = tbin.pack_bits((xb > 0).astype(np.uint8))
    qcodes = tbin.pack_bits(xq > 0)
    bh = tbin.BinaryHNSWIndex(32, M=8, device=dev)
    bh.add(codes)
    bh.build()
    for a, b in zip(bh.search(qcodes, 10, ef=32),
                    on_cpu(bh).search(qcodes, 10, ef=32)):
        np.testing.assert_array_equal(a, b)
    bivf = tbin.BinaryIVFIndex(32, 16, coarse_hnsw_m=8, device=dev)
    bivf.train(codes)
    bivf.add(codes)
    cpu_ivf = convert.binary_from_numpy(dict(
        d=32, nlist=16, codes=codes, centroid_bits=bivf.centroid_bits),
        "cpu")
    cpu_ivf.coarse_hnsw_m = 8
    bivf.search(qcodes[:1], 1, nprobe=4)
    cpu_ivf._coarse_g = on_cpu(bivf._coarse_g)
    for nprobe in (1, 4, 16):
        for a, b in zip(bivf.search(qcodes, 10, nprobe=nprobe),
                        cpu_ivf.search(qcodes, 10, nprobe=nprobe)):
            np.testing.assert_array_equal(a, b)
    ivf = att.index_factory(32, "IVF64_HNSW16,Flat", device=dev)
    ivf.train(xb)
    ivf.add(xb)
    state = {f: v.cpu().numpy() for f, v in ivf.arrays._asdict().items()
             if isinstance(v, torch.Tensor)}
    cpu = att.IVFFlatIndex.from_state(
        ivf.centroids, convert.ivf_arrays_from_numpy(state, "cpu"))
    cpu.coarse_hnsw_m = 16
    cpu._hnswq = convert.hnsw_from_numpy(ivf.hnsw_quantizer().state(), "cpu")
    for nprobe in (4, 16):
        np.testing.assert_array_equal(ivf.hnsw_probes(xq, nprobe),
                                      cpu.hnsw_probes(xq, nprobe))
        before = scan_scores.launches
        cv, ci = ivf.search(xq, K, nprobe=nprobe)
        assert scan_scores.launches > before
        pv, pi = cpu.search(xq, K, nprobe=nprobe)
        # K2 and its plain version sum the dots in other orders: ids may
        # swap only between results within 1e-5 of each other
        np.testing.assert_allclose(cv, pv, rtol=1e-5, atol=1e-5)
        for r, c in zip(*np.nonzero(ci != pi)):
            near = np.abs(pv[r] - pv[r, c]) <= 1e-5 * abs(pv[r, c]) + 1e-5
            assert ci[r, c] in pi[r][near] or c == K - 1, (r, c)


def _sharded_pair(tmp_path):
    """A 4-shard IVF built and profiled by the port on the CPU, saved, and
    loaded twice from the directory: on the CPU, and with all four shards
    on the one card (make_mesh's default devices)."""
    from auncel_tpu_torch.data import make_clustered_dataset
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh
    ds = make_clustered_dataset(nb=16000, nq=40, d=32, n_clusters=64,
                                seed=21)
    s = ShardedIVF(ds.d, nlist=32, n_shards=4,
                   mesh=make_mesh(4, devices=["cpu"]))
    s.build(ds.xb)
    s.train_profiles(ds.xq[:20], max_topk=50)
    s.multipler = 8.0
    s.save(str(tmp_path / "sharded"))
    cpu = ShardedIVF.load(str(tmp_path / "sharded"),
                          mesh=make_mesh(4, devices=["cpu"]))
    card = ShardedIVF.load(str(tmp_path / "sharded"), mesh=make_mesh(4))
    return ds, cpu, card


@pytest.mark.cuda
def test_sharded_on_one_card_matches_the_cpu(tmp_path):
    """Four shards on one card (K2 in the fixed and padded searches, K1 in
    the one-shot engine) against the same index on the CPU: equal ids and
    n_scanned, distances within 1e-5."""
    dev = _card()
    ds, cpu, card = _sharded_pair(tmp_path)
    assert {d for d in card.mesh.devices.flat} == {dev}
    assert all(sh.arrays.db.is_cuda for sh in card.shards)
    acc = np.full(40, 0.9, np.float32)

    def same(a, b):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-5)
        if len(a) > 2:
            np.testing.assert_array_equal(a[2], b[2])
    k1, k2 = rowscan_scores.launches, scan_scores.launches
    for nprobe in (4, 32):
        same(card.search(ds.xq, 10, nprobe), cpu.search(ds.xq, 10, nprobe))
    same(card.search_bounded(ds.xq, acc, 10),
         cpu.search_bounded(ds.xq, acc, 10))
    assert scan_scores.launches > k2
    for s in (cpu, card):
        s.enable_multirow(64)
    same(card.search_bounded(ds.xq, acc, 10),
         cpu.search_bounded(ds.xq, acc, 10))
    assert rowscan_scores.launches > k1


@pytest.mark.cuda
def test_dp_kmeans_on_the_card_is_bitwise_repeatable():
    """Four shards of one card: two runs bitwise equal, within 1e-4 of the
    same run on the CPU."""
    from auncel_tpu_torch.parallel import dp_kmeans, make_mesh
    _card()
    x = np.random.RandomState(3).randn(65536, 32).astype(np.float32)
    a = dp_kmeans(x, 256, make_mesh(4), niter=5)
    b = dp_kmeans(x, 256, make_mesh(4), niter=5)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1]
    c = dp_kmeans(x, 256, make_mesh(4, devices=["cpu"]), niter=5)
    np.testing.assert_allclose(a[0], c[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(a[1], c[1], rtol=1e-4)


@pytest.mark.cuda
def test_c_api_demo_runs_on_the_card():
    """The demo with AUNCEL_C_DEVICE=cuda returns the ids of the same
    calls made in Python on the card."""
    from test_torch_c_api import _toolchain_available, python_ids, run_demo
    _card()
    if not _toolchain_available():
        pytest.skip("no C compiler / make / python3-config")
    got = run_demo("cuda")
    fixed, bounded = python_ids("cuda")
    np.testing.assert_array_equal(got["fixed"], fixed)
    np.testing.assert_array_equal(got["bounded"], bounded)


def _merge_inputs(kind: str, B: int, kr: int, n: int, metric, dev, seed,
                  fill: str = "half"):
    """A merge's inputs (numpy-made, then on the card): a running result
    ``fill`` "half" full (sorted values, then the worst value and id -1),
    "full", "empty" (all worst) or "unsorted" (full, shuffled), and a
    chunk of ``kind``: "random", "ties" (four levels), "zeros" (+0.0 and
    -0.0 among worse values), "worst" (every slot the worst value),
    "masked" (a few live slots among worst ones) or "nan" (a tenth NaN)."""
    rng = np.random.RandomState(seed)
    sgn = 1.0 if metric is Metric.L2 else -1.0
    w = np.float32(np.inf * sgn)
    half = {"half": kr // 2, "empty": 0}.get(fill, kr)
    rv = np.full((B, kr), w, np.float32)
    rv[:, :half] = np.sort(rng.rand(B, half), 1) * 0.1 * sgn
    ri = np.full((B, kr), -1, np.int32)
    ri[:, :half] = np.arange(half)
    if fill == "unsorted":
        order = rng.permutation(kr)
        rv, ri = rv[:, order], ri[:, order]
    s = rng.rand(B, n).astype(np.float32)
    if kind == "ties":
        s = np.round(s * 3)
    elif kind == "zeros":
        s = np.where(rng.rand(B, n) < 0.5, 0.0, -0.0)
        s[rng.rand(B, n) < 0.7] = sgn
    elif kind == "worst":
        s[:] = w
    elif kind == "masked":
        s[rng.rand(B, n) < 0.99] = w
    elif kind == "nan":
        s[rng.rand(B, n) < 0.1] = np.nan
    si = rng.randint(0, 1 << 30, (B, n)).astype(np.int32)
    si[s == w] = -1
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (rv, ri, s.astype(np.float32), si))


MERGE_KINDS = ("random", "ties", "zeros", "worst", "masked", "nan")


def _merge_equal(args, k, metric):
    from auncel_tpu_torch.kernels.topk_merge import topk_merge, topk_merge_ref
    got = topk_merge(*args, k, metric)
    want = topk_merge_ref(*args, k, metric)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
@pytest.mark.parametrize("B, n", [(1, 50), (1, 16384), (7, 3000),
                                  (256, 65536), (1000, 19736), (1024, 1024),
                                  (100, 160000)])
def test_topk_merge_is_bitwise_its_plain_version(B, n, metric):
    """The merge kernel against the stable sort of the concatenation, at
    batch 1 to 1024 and chunks from below k to 160k, every kind of chunk,
    k 1, 10, 100 and 128: values and ids bit for bit."""
    from auncel_tpu_torch.kernels.topk_merge import topk_merge
    dev = _card()
    before = topk_merge.launches
    for i, kind in enumerate(MERGE_KINDS):
        for k in (1, 10, 100, 128):
            _merge_equal(_merge_inputs(kind, B, k, n, metric, dev, i), k,
                         metric)
    assert topk_merge.launches == before + 4 * len(MERGE_KINDS)


@pytest.mark.cuda
@pytest.mark.parametrize("n_seg", [1, 2, 3, 8, 64, 150, 600])
def test_topk_merge_at_every_segment_count(n_seg, monkeypatch):
    """Rows cut into 1 to 600 segments, whatever the batch, sharing the
    row's threshold and the largest of their j-th best keys (j = ceil(k /
    segments)), merged by the row's last segment: the same bits, and the
    rows' state left as the wrapper keeps it between launches."""
    from auncel_tpu_torch.kernels import topk_merge as tm
    dev = _card()
    monkeypatch.setattr(tm, "segments", lambda *a: n_seg)
    for i, kind in enumerate(MERGE_KINDS):
        for B, n, k in ((3, 20000, 100), (64, 5000, 10), (2, 300, 128)):
            for fill in ("half", "full", "empty"):
                _merge_equal(_merge_inputs(kind, B, k, n, Metric.L2, dev, i,
                                           fill), k, Metric.L2)
    if n_seg > 1:
        st = tm._ROW_STATE[(dev.index, torch.cuda.current_stream(dev)
                            .cuda_stream)]
        assert (st[:, 0] == -1).all() and (st[:, 1:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["empty", "half", "full", "unsorted"])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
def test_topk_merge_running_results(fill, metric):
    """Empty, half-full, full and out-of-order running results (the bound
    of the row's k-th taken from the first k slots), at batch 1 and 1000,
    with running results longer than k: bit for bit."""
    dev = _card()
    for i, kind in enumerate(MERGE_KINDS):
        for B, kr, n, k in ((1, 100, 1775872, 100), (1000, 100, 19736, 100),
                            (7, 300, 3001, 10)):
            _merge_equal(_merge_inputs(kind, B, kr, n, metric, dev, i, fill),
                         k, metric)


@pytest.mark.cuda
def test_topk_merge_at_batch_1_is_one_launch():
    """A batch-1 merge of the 10M recorded width (B 1 x 1775872, hundreds
    of segments) runs as one kernel launch on the card."""
    from auncel_tpu_torch.kernels.topk_merge import topk_merge
    dev = _card()
    args = _merge_inputs("random", 1, 100, 1775872, Metric.L2, dev, 0,
                         "full")
    _merge_equal(args, 100, Metric.L2)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        topk_merge(*args, 100, Metric.L2)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("topk_merge" in n for n in names) == 1, names


@pytest.mark.cuda
@pytest.mark.parametrize("k", [129, 640, 1024, 6400])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
def test_topk_merge_raises_above_its_k(k, metric):
    """The card serves every k through the kernel (it refused k above 128
    before): k 129, 640 and 1024 with their candidates in shared memory,
    6400 in scratch, bit for bit the plain version at B 64 x 65536 and at
    batch 1 (several segments), every kind of chunk and running result."""
    from auncel_tpu_torch.kernels.topk_merge import topk_merge
    dev = _card()
    before = topk_merge.launches
    n_calls = 0
    for i, kind in enumerate(MERGE_KINDS):
        for B, n in ((64, 65536), (1, 200000)):
            fill = ("half", "full", "empty")[i % 3]
            _merge_equal(_merge_inputs(kind, B, k, n, metric, dev, i, fill),
                         k, metric)
            n_calls += 1
    assert topk_merge.launches == before + n_calls


@pytest.mark.cuda
def test_clone_index_on_the_card():
    """clone_index on the card: the copy owns its tensors there, and an
    add then a reset of it leave the original's search as it was."""
    from torch_parity import check_clone
    check_clone(_card())


@pytest.mark.cuda
def test_rank_mesh_on_one_card_is_bitwise_one_process(tmp_path):
    """Four gloo ranks on the one card, each loading its shard of a saved
    directory: bounded (the one-shot engine) and fixed search bitwise the
    one-process ShardedIVF on the card, and every rank launched K1 and
    the merge kernel in the bounded search and K2 in the fixed one."""
    from auncel_tpu_torch.data import make_clustered_dataset
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh
    from auncel_tpu_torch.parallel.distributed import serve, spawn
    _card()
    ds = make_clustered_dataset(nb=16000, nq=40, d=32, n_clusters=64,
                                seed=21)
    s = ShardedIVF(ds.d, nlist=32, n_shards=4, storage="sq8",
                   mesh=make_mesh(4, devices=["cpu"]))
    s.build(ds.xb)
    s.train_profiles(ds.xq[:20], max_topk=50)
    s.multipler = 8.0
    s.enable_multirow(64)
    s.save(str(tmp_path / "sharded"))
    card = ShardedIVF.load(str(tmp_path / "sharded"), mesh=make_mesh(4))
    acc = np.full(40, 0.9, np.float32)
    want = {"b": card.search_bounded(ds.xq, acc, 10),
            "f": card.search(ds.xq, 10, 8)}
    np.save(tmp_path / "q.npy", ds.xq)
    q = str(tmp_path / "q.npy")
    spawn(serve, 4, ([dict(op="load", dir=str(tmp_path / "sharded"),
                           mesh=(4, 1)),
                      dict(op="bounded", name="b", q=q, acc=0.9, k=10),
                      dict(op="fixed", name="f", q=q, k=10, nprobe=8)],
                     str(tmp_path / "out")),
          backend="gloo", timeout_s=120, join_timeout_s=600)
    for r in range(4):
        z = np.load(tmp_path / "out" / f"rank{r}.npz")
        for name, res in want.items():
            for key, a in zip(("vals", "ids", "n_scanned"), res):
                np.testing.assert_array_equal(z[f"{name}/{key}"], a)
        k1, _, merge = z["b/launches"]
        assert k1 > 0 and merge > 0, z["b/launches"]
        assert z["f/launches"][1] > 0, z["f/launches"]


@pytest.mark.cuda
def test_nccl_ranks_on_one_card_raise(tmp_path):
    """NCCL refuses two ranks on one card: the mesh raises on both ranks
    before any NCCL collective, and the spawner fails at once."""
    import time
    import torch.distributed as dist
    from auncel_tpu_torch.parallel.distributed import serve, spawn
    _card()
    if not dist.is_nccl_available():
        pytest.skip("this torch has no NCCL")
    np.save(tmp_path / "x.npy", np.zeros((64, 8), np.float32))
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="NCCL needs a card a rank"):
        spawn(serve, 2, ([dict(op="kmeans", name="km",
                               x=str(tmp_path / "x.npy"), k=4, niter=1,
                               shards=2)],
                         str(tmp_path / "out"), ["cuda:0"]),
              backend="nccl", timeout_s=60, join_timeout_s=300)
    assert time.perf_counter() - t0 < 120
