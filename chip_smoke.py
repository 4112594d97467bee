"""Smoke run of the PyTorch/CUDA port (auncel_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases: the card; the kernels' build (one nvcc per source, in parallel);
each kernel against its plain PyTorch version on synthetic inputs: K1's
rowscan_scores at the bench, one-shot tail-round and batch-1 worklists,
timed in turns with the dots route it replaced (rowscan_dots and the score
assembly as separate passes), K2 over the same rows and the plain version,
and rowscan_dots alone; K1 and K2 on each storage codec (bf16, SQ8, SQ4,
SQ6) at the bench shapes ([k1 CODEC], [k2 CODEC]); K2 on PQ codes at
synthetic layouts of the recorded PQ calls ([k2 pq]: the [pq 10M] window's
largest, batch 1, a training chunk, [2layer]'s call and d 256 / M 32),
residual and plain, without and with the polysemous filter; K1 and K2 on
SQ8 codes at synthetic layouts of the recorded 10M SQ8 calls ([k1 sq8
synth], [k2 sq8 synth]: the window's largest row scan, batch 1, the
sharded window's largest, a training chunk, the sharded fixed call), each
with the device time of the worklist's kernels; the merge kernel
(csrc/topk_merge.cu, the running top-k merge of scan_probe_range) at the
widths of the main path's merges on uniform, tied and all-dead chunks
([topk synth]; a 10M window with a full running result, the steady state
of a window's later rounds, and the 10M batch-1 width too) and at k 129,
640, 1024 and 6400 ([topk k]), bitwise its plain version and timed against
it and torch.topk; the decision step's kernel (csrc/decide.cu, one launch a
deciding wave) at the benchmark's shape (nlist 1024, B 1, k 10 of a top-100
at stages 16 and 128, with and without the multi-row state update) and at
a window's (B 1000, k 100), bitwise its plain version or the run fails,
with the device and host time of both ([decide]); the bounded-search
main path on the multi-row layout (K1 in search, K2 in profile
training): calibration with its
measured dense crossover, the held-out window through the one-shot engine
and batch-1 windows, then
  [oneshot]        the 0.9 window, one-shot against the wave engine, K1
                   at the worklists its A1 waves recorded, and the window
                   against itself with its row scans on the dots route;
                   [topk] the merge kernel at every merge of the window,
                   bitwise its plain version (the concatenation and the
                   stable sort, the merge before the kernel) or the run
                   fails, timed against it and torch.topk, with the
                   bound, the sums over the window and the largest merge;
  [oneshot strict] the window at bound 1.0 with stragglers past nlist/8,
                   one-shot against the wave engine, K1 at the worklists
                   its waves and rounds recorded, the window against
                   itself on the dots route, and the dense routes (the
                   per-query crossover, every query dense) against
                   gather;
  [dense decide]   the 0.9 window with the decisions from one corpus pass;
  [profile mode]   t_recalls of the 0.9 window;
  [stream]         search_stream against search over the same windows;
  [time mode]      calibrate_time, time_search at batch 1 over 200 budgets,
                   nprobe_search_mr against the fixed-nprobe scan;
the padded path on the same index without the multi-row layout (K2
throughout, with the two-phase window held to single phase on a strict
window whose stragglers take phase B, and time_search at batch 1); then
  [ondisk]         that index written by save_index_ondisk to a temporary
                   directory (about 1.9 GiB, left in the page cache) and
                   served from it by OnDiskIVFIndex, paging only the
                   probed lists into pinned memory and uploading them as
                   one block batch a phase: [ondisk fixed] at nprobe 8
                   and 32 (ids equal to the resident search, values
                   within 1e-5), [ondisk bounded] at bound 0.9 on the
                   padded path's profile (ids and n_scanned equal to the
                   resident padded engine, worst recall@10 >= 0.9),
                   [ondisk strict] at bound 1.0 with the multipler
                   doubled until a query passes nlist/8 (phase B pages
                   and scans; the same checks but the recall), each
                   with the lists and bytes paged and the split between
                   paging, upload and device (CUDA events), and K2 at the
                   largest block batch against its plain version;
  [range]          range_search at nprobe 32 with K2 against the same with
                   its plain version (equal lims and labels, distances
                   within 1e-5 of q_sq + db_sq);
  [shards]         the index split in two by id range (copy_subset_to)
                   and served as IndexShards at nprobe 32 against the
                   whole index;
each
kernel against its plain version on the index's own arrays, K2 at the
shapes the main path gives it (the window's waves, a training chunk, batch
1 and one list probed by every query);
  [ivf hnsw]       the same index as "IVF1024_HNSW32,Flat": an HNSW graph
                   over its 1024 centroids ranks the lists of fixed-
                   nprobe search (nprobe 16, 32), K2 scans them (it must
                   launch), recall@10 against the exact rank's and the
                   lists' overlap with coarse_rank's reported, K2 at the
                   largest call against its plain version;
then, on the same corpus,
  [imi]            "IMI2x7,Flat": 16384 IMI product cells trained on 400k
                   vectors (their size spread and both layouts' bytes
                   printed before the index is packed), served on the
                   multi-row layout by ErrorSys: profile training (K2),
                   calibration, the held-out window at bound 0.9 (mean
                   recall@10 >= 0.9 or the run fails; the worst case and
                   bound_ok reported, not checked), 200 batch-1 queries,
                   fixed-nprobe search at nprobe 64 with and without
                   max_codes 4096, and K1 and K2 against their plain
                   versions at the largest calls of the path;
  [2layer]         Index2Layer(128, 1024, M=16), moved by transfer_to_ivfpq
                   into a residual-PQ IVF index served at nprobe 32 (K2
                   launched; reconstructions bitwise reconstruct_n's), and
                   its exact decoded search, recall@10 of both reported;
  [binary]         the corpus hashed by "LSH128r", its codes in BFlat and
                   "BIVF1024" (nprobe 16, and 1024 equal to BFlat), and
                   "IVF1024,SH64" at nprobe 16, each equal to the same
                   index on the CPU on 100 queries; times and recall@10
                   reported;
  [bhnsw]          BinaryHNSWIndex (M 16) over 20k of those codes and
                   "BIVF1024_HNSW16" over all of them, recall@10 against
                   BFlat, each equal to the CPU on 100 queries;
then the HNSW cells of the JAX package's tests/test_hnsw.py:
  [hnsw]           HNSWIndex on 20k x 32 (64 clusters, M 16,
                   efConstruction 40): the build (insert, repair,
                   refine), recall@10 against Flat at ef 10, 32, 64, 128
                   (>= 0.90 at 64 and >= 0.95 at 128 or the run fails),
                   the 64 queries as a batch and at batch 1 (p50, p99,
                   device time), a second card build equal, and a CPU
                   search of the card's graph with equal ids;
  [hnsw sq8],      "HNSW16_SQ8" and "HNSW16_PQ8" on the same cell (>= 0.85
  [hnsw pq8]       against Flat and >= 0.80 against the decoded corpus at
                   ef 64), their bytes on the card;
  [hnsw 200k]      HNSWIndex on 200k x 128 (600 clusters, M 16,
                   efConstruction 80, two refinement passes): the build
                   and recall@10 at ef 64 (>= 0.95 or the run fails);
then
  [sq8 10M]        the JAX package's headline configuration, synthDeep10M
                   (10M x 96; the corpus made by a process of its own
                   from the script's start) with IVF1024 + SQ8 storage,
                   built on the card: profile training (K2 on the
                   codes), calibration on 2000 disjoint queries, the
                   1000 held-out queries as one window (worst-case
                   recall@10 >= 0.9 or the run
                   fails) and 200 at batch 1 (K1 on the row codes), fixed-
                   nprobe search on the dense route against the gathers
                   and with max_codes, and K1 and K2 on the codes at
                   worklists recorded from this path (K1 with the device
                   time of the worklist's kernels beside each call); the
                   [topk] lines of the window's merges, of 5 batch-1
                   queries' and of a training chunk's largest;
  [eval 10M]       the JAX package's headline evaluation on the [sq8 10M]
                   phase's index, ErrorSys and ground truth, from a
                   temporary directory: [eval 10M compare] is
                   compare.run("synthDeep10M", 3000, 1000, 10, 0.10,
                   storage="sq8", profile_size=1000) on the harness's
                   caches (its own corpus, made by common.load_dataset in
                   a process of its own from the script's start and held
                   to build_10m's by SHA-1; where equal, the quantizer and
                   ground truth seeded from [sq8 10M]): the five rows and
                   ELP's tuned nprobe without and with headroom, each
                   timed on the dense route and on the gathers in turns
                   (distances within 1e-5 of q_sq + db_sq or the run
                   fails); [eval 10M latency] is
                   scripts/torch_latency_fig.py on 200 held-out queries
                   at batch 1, Auncel then ELP at
                   compare's nprobe with headroom; [eval 10M matrix] is
                   scripts/torch_matrix10M.py's nine k x eps cells; each
                   row beside the TPU record's decisions (mean probes or
                   mean_scan, bound_ok; no TPU time). The run fails unless
                   Auncel's worst recall@10 in compare is >= 0.9, the k
                   10, eps 0.10 cell holds, K1, K2 and the merge launched
                   (every merge of index/scan.py through the kernel) and
                   the tree's git status is unchanged;
  [pq 10M]         the same corpus with residual IVFPQ (IVF1024,PQ16,
                   polysemous codebooks) on the [sq8 10M] phase's coarse
                   centroids, served by the padded engines with K2 on
                   the codes: profile training, calibration, the held-out
                   window (worst-case recall@10 >= 0.9 or the run fails)
                   and 200 batch-1 queries, fixed-nprobe search at nprobe
                   32 without and with the polysemous filter (inside K2;
                   at ht 48 and 64 its ids and kept distances equal to
                   the filter as a plain-torch mask on K2's output, or
                   the run fails; the query codes' encode timed), and
                   K2 against its plain version at calls recorded from
                   this path (the window's largest, batch 1, a training
                   chunk, the largest filtered call at ht 48 and 64)
                   and the [topk] lines of the window's merges;
                   unfiltered, its recall@10 by ids against the
                   float ground truth is [pqr 10M]'s floor;
  [pqr 10M]        "IVF1024,PQ16+16" (IVFPQ re-ranked by a refinement PQ,
                   k_factor 4) on the same corpus and centroids: the stage
                   times of both PQs, the held-out queries at nprobe 32
                   (the base search, K2 on the codes, and the re-rank
                   timed apart), the first 100 at k_factor 64 and
                   nprobe 8 (the base search at k 640, through the merge
                   kernel) against a CPU copy's ids, recall@10 by ids at
                   least [pq 10M
                   fixed]'s or the run fails, reconstruct_batch of 1000
                   ids equal to the CPU's, K2 against its plain version;
  [sharded 10M]    the reference's distributed mode on the same corpus:
                   ShardedIVF with four IVF1024 + SQ8 shards of 2.5M
                   rows, all on the one card (make_mesh(4)): the build,
                   per-shard profiles on the 1000 training queries,
                   enable_multirow(256) with the plan shared by every
                   shard, the held-out window at bound 0.9 (multipler
                   from 8, doubled up to 64 while the worst recall@10
                   against the merged per-shard exact search misses 0.9;
                   the run fails below it), timed beside the unsharded
                   [sq8 10M] window, and 50 batch-1 queries; each
                   shard's n_scanned equal to its own one-shot engine,
                   the merge equal to a numpy stable merge, K1 at the
                   largest per-shard row scan against its plain version;
                   fixed-nprobe search at nprobe 32 equal to the shards
                   merged, K2 at its largest call against its plain
                   version; save -> load through a temporary directory
                   (equal ids and n_scanned); drop_shard(1) (no id of
                   shard 1, the survivors' n_scanned unchanged);
  [ranks 10M]      the directory [sharded 10M] saved, served by four
                   gloo ranks on the one card (parallel/distributed.py),
                   each loading only its shard: the held-out window at
                   bound 0.9 (timed from a barrier, median of 5), 50
                   batch-1 queries, fixed nprobe 32 and drop_shard(1),
                   each bitwise the one-process results on every rank or
                   the run fails, worst recall@10 >= 0.9, K1 and the
                   merge kernel launched in every rank's window and K2 in
                   its fixed search; dp_kmeans on two ranks over 1M of
                   the vectors (k 1024, 5 steps) bitwise the one-process
                   run;
  [dp kmeans]      data-parallel k-means over the same 10M vectors, four
                   shards of the card, k 1024: two runs bitwise equal or
                   the run fails, the error against a one-shard run;
  [eval]           the evaluation harness's experiments on the card
                   (auncel_tpu_torch.eval_harness), from a temporary
                   directory that holds their caches and logs: bound and
                   compare at synthHard1M (1M x 128 with the hard query
                   tail, IVF1024,Flat, profile on 1000 queries,
                   calibration on 1000 disjoint ones, 1000 held out),
                   each failing unless K1 and K2 launched in it, with
                   Auncel's worst-case recall@10 and bound_ok reported,
                   not checked (the JAX package's own margin study at
                   this cell misses 0.9 in 12 of 16 settings,
                   Calib_margin_synthHard1M.log); compare's rows
                   (auncel, elp, elp_margin, laet, laet_worst) and the
                   route of every point of ELP's nprobe sweeps; K1 at the
                   largest row scan of LAET's search and K2 at LAET's
                   feature call against their plain versions; then
                   effect_error (satisfaction of the mixed bounds >= 0.9
                   or it fails), effect_time and overhead at synth100K;
  [dist]           dist_bench.run at its defaults (synth10K, 1, 2, 4 and
                   8 shards on the card) into a temporary directory, its
                   log and figure, failing unless K1 and K2 launched;
  [c api]          the C API (auncel_tpu_torch/c_api) built with make and
                   its demo run with AUNCEL_C_DEVICE=cuda, failing if
                   either fails where python3-config works (the line says
                   so where it does not).
Every path is driven through the port's public entry points on their
default device, with the kernels' launch counts set to 0 just before it
and read just after (the launches that compare K1 with other routes are
not counted); every path that runs scan_probe_range must launch the
merge kernel, once for every merge index/scan.py makes (a counter wraps
its merge_topk_verified), so none sorts. Exits non-zero
when there is no CUDA device or any phase fails. The last line of stdout is
``{"ok": true, "device": {...}}``; the line before it lists each kernel.

    python3 chip_smoke.py [--profile DIR] [--against DIR]

``--against DIR`` (DIR the root of another tree of the port, such as the
parent commit's) builds that tree's csrc/rowscan.cu, csrc/scan_scores.cu
and csrc/topk_merge.cu with this tree's flags and times its K1, K2 and
merge beside this tree's wherever k1_compare, k2_compare and topk_compare
run (float32 and SQ codes; merges at k <= 128 on a merge of the first
design, which refused more), in turns, with whether the two give the same
bits: at the calls and merges recorded from this tree's main path too,
which a run from the other tree's root cannot replay.

``--profile DIR`` also writes torch.profiler tables of one batched and one
batch-1 search on each path (the 10M one too), of the 0.9 and the strict
window through the one-shot and the wave engine, of the strict window
through the one-shot engine with its row scans on the dots route, and of
one two-phase and one single-phase run of the phase-B window.

    python3 chip_smoke.py --kernels

builds and checks the kernels on synthetic inputs and on the 1M index's
own arrays, prints their ``[k1]``/``[k1 dots]``/``[k2]`` (and codec and
``[k2 pq]``) lines and stops: no serving path, no 10M phase, no JSON
lines. It times whichever ``auncel_tpu_torch`` is first on ``sys.path``,
so run from another tree's root with
``python3 -c "import runpy, sys; sys.argv = ['chip_smoke.py', '--kernels'];
runpy.run_path('PATH/chip_smoke.py', run_name='__main__')"`` it times that
tree's kernels on the same shapes (a K2 without the fused filter takes the
filter as a plain-torch mask after it).
"""

import atexit
import contextlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def log(msg):
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    """A failed check fails the run (unlike assert, also under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_pair(kernel, plain, reps: int) -> tuple:
    """(kernel ms, plain ms), timed in turns: plain, kernel, kernel, plain."""
    t_ref = cuda_time_ms(plain, max(reps // 2, 1))
    t_k = cuda_time_ms(kernel, reps)
    t_k = min(t_k, cuda_time_ms(kernel, reps))
    t_ref = min(t_ref, cuda_time_ms(plain, max(reps // 2, 1)))
    return t_k, t_ref


# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# and fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def bound(n_bytes: float, n_flops: float) -> tuple:
    """(least ms the card could take, what bounds it)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(db, rows, qs) -> tuple:
    """Each distinct row read once, work_rows and qs read, dots written."""
    T = rows.shape[0]
    _, row_cap, d = db.shape
    n_rows = int(torch.unique(rows).numel())
    n_bytes = n_rows * row_cap * d * 4 + T * 4 + T * d * 4 + T * row_cap * 4
    return bound(n_bytes, 2.0 * T * row_cap * d)


def k2_work(db, db_sq, vec_ids, list_sizes, q, q_sq, lists,
            codec: dict | None = None) -> dict:
    """What K2's inputs need: the live slots of each distinct probed list
    read once (the stored vector at its codec's width: 4d bytes for f32, d
    for SQ8, M for PQ; norm; id) with the list sizes, probes and queries;
    for PQ the codebook once, residual, the centroid row of each distinct
    probed list once and, filtered, the query codes; scores and ids
    written for every slot. Also the live bytes the kernel reads, once per
    (query, probe slot)."""
    nlist, cap, width = db.shape
    d = q.shape[1]
    B, S = lists.shape
    active = lists[lists >= 0].long().clamp_max(nlist - 1)
    sizes = list_sizes.long().clamp(0, cap)
    distinct = torch.unique(active)
    live_distinct = int(sizes[distinct].sum())
    live_probed = int(sizes[active].sum())
    slot_bytes = width * db.element_size() + 4 + 4
    out_bytes = B * S * cap * 8
    n_bytes = (live_distinct * slot_bytes + distinct.numel() * 4
               + B * S * 4 + B * d * 4 + B * 4 + out_bytes)
    cd = codec or {}
    if cd.get("pq_codebooks") is not None:
        n_bytes += cd["pq_codebooks"].numel() * 4
        if cd.get("centroids") is not None:
            n_bytes += distinct.numel() * d * 4
        if cd.get("qcodes") is not None:
            n_bytes += cd["qcodes"].numel()
    ms, by = bound(n_bytes, 2.0 * d * live_probed)
    return {"bound_ms": ms, "bound_by": by, "bound_bytes": n_bytes,
            "live_bytes": live_probed * slot_bytes + out_bytes}


# (name, n_rows, row_cap, d, T): the dots route's kernel (rowscan_dots) at
# the multirow scan's shape at the benchmark configuration, the one-shot
# engine's tail round (a sub-batch of 256 queries at the first geometric
# width, 64 row slots), a ragged worklist, and the scalar-load path
K1_SHAPES = (("bench", 4608, 256, 128, 4096),
             ("tail", 4608, 256, 128, 256 * 64),
             ("ragged", 4608, 256, 128, 4093),
             ("scalar", 64, 200, 100, 77))
# (name, n_rows, row_cap, d, B, n_slots): rowscan_scores at the same bench
# and tail worklists (T = B * n_slots), batch 1 in direct mode and through
# the worklist, and the scalar-load path
K1_ROW_SHAPES = (("bench", 4608, 256, 128, 1024, 4),
                 ("tail", 4608, 256, 128, 256, 64),
                 ("batch 1, direct", 4608, 256, 128, 1, 8),
                 ("batch 1, worklist", 4608, 256, 128, 1, 64),
                 ("scalar", 64, 200, 100, 33, 3))
# (name, nlist, cap, d, B, n_slots): a padded layout with the benchmark's d,
# and the scalar-load path
K2_SHAPES = (("synthetic", 512, 1024, 128, 256, 5),
             ("scalar", 64, 300, 100, 33, 3))


# (name, nlist, cap, mean list size, d, M, B, n_slots): K2 on PQ codes at
# synthetic layouts of the recorded calls: the [pq 10M] cell's window's
# largest call, a batch-1 call and a training chunk (IVF1024 over 10M x 96,
# PQ16), the [2layer] call (IVF1024 over 1M x 128, PQ16), and d 256 / M 32
# on that layout, a width the codebook in shared memory refused
K2_PQ_SHAPES = (("10M window", 1024, 20448, 9766, 96, 16, 1000, 1),
                ("10M batch 1", 1024, 20448, 9766, 96, 16, 1, 64),
                ("10M training chunk", 1024, 20448, 9766, 96, 16, 100, 8),
                ("2layer", 1024, 3859, 977, 128, 16, 1000, 4),
                ("d 256 M 32", 1024, 3859, 977, 256, 32, 1000, 4))


# (name, kernel, lists or rows, cap, mean list size (None: rows, 90 % of
# them full), d, B, n_slots, inactive share of each query's slots): K1 and
# K2 on SQ8 codes at synthetic layouts of the calls recorded from the 10M
# SQ8 path: the [sq8 10M] window's largest row scan (a tail round, about
# 29500 distinct live rows of 39576), a batch-1 row scan through the
# worklist, the largest per-shard row scan of [sharded 10M] (2.5M rows a
# shard), a profile-training chunk of [sq8 10M] (IVF1024, cap 20416) and
# the largest per-shard call of [sharded 10M fixed] (nprobe 32)
SQ8_10M_SHAPES = (
    ("10M window, largest", "k1", 39576, 256, None, 96, 256, 256, 0.174),
    ("10M batch 1", "k1", 39576, 256, None, 96, 1, 64, 0.0),
    ("sharded 10M window, largest", "k1", 10800, 256, None, 96, 1000, 39,
     0.1),
    ("10M training chunk", "k2", 1024, 20416, 9766, 96, 100, 8, 0.0),
    ("sharded 10M fixed", "k2", 1024, 4560, 2441, 96, 1000, 3, 0.0))


def synthetic_sq8(device, n, cap, mean, d, B, n_slots, inactive, seed):
    """An SQ8 layout of random codes made on the card: a per-dimension
    range that decodes to about N(0, 1/d), db_sq the decoded norms (zero
    at dead slots), ids by slot and -1 past the size; rows (mean None)
    90 % full, lists uniform in [0, 2 * mean]; queries ~ N(0, 1/d), each
    probing n_slots distinct rows or lists, the last ``inactive`` share of
    them inactive (-1), as past a query's limit. Returns (args, codec
    keywords)."""
    from auncel_tpu_torch.ops.sq import sq_decode_dev
    gen = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(0, 256, (n, cap, d), generator=gen, device=device,
                          dtype=torch.uint8)
    scale = torch.rand(d, generator=gen, device=device) * 4.0 / 255 \
        / d ** 0.5 + 1e-3
    bias = (-127.5 * scale + 0.1 * torch.randn(d, generator=gen,
                                               device=device)).contiguous()
    if mean is None:
        sizes = torch.where(
            torch.rand(n, generator=gen, device=device) < 0.9, cap,
            torch.randint(1, cap + 1, (n,), generator=gen, device=device))
    else:
        sizes = torch.randint(0, min(cap, 2 * mean) + 1, (n,), generator=gen,
                              device=device)
    sizes = sizes.to(torch.int32)
    live = torch.arange(cap, device=device)[None, :] < sizes[:, None]
    ids = torch.where(live, torch.arange(n * cap, device=device,
                                         dtype=torch.int32).reshape(n, cap),
                      -1)
    db_sq = torch.empty((n, cap), device=device)
    step = max(1, (1 << 26) // (cap * d))
    for r0 in range(0, n, step):
        x = sq_decode_dev(codes[r0:r0 + step], d, scale, bias)
        db_sq[r0:r0 + step] = torch.where(live[r0:r0 + step],
                                          (x * x).sum(-1), 0.0)
    del x
    q = torch.randn((B, d), generator=gen, device=device) * d ** -0.5
    probes = torch.argsort(torch.rand((B, n), generator=gen, device=device),
                           dim=1)[:, :n_slots].to(torch.int32)
    n_off = int(round(n_slots * inactive))
    if n_off:
        probes[:, n_slots - n_off:] = -1
    args = (codes, db_sq, ids.to(torch.int32), sizes, q, (q * q).sum(-1),
            probes.contiguous())
    return args, {"sq_scale": scale.contiguous(), "sq_bias": bias}


def sq8_10m_check(device, card: str) -> dict:
    """K1 and K2 on SQ8 codes at SQ8_10M_SHAPES against their plain
    versions (within 1e-5 of q_sq + db_sq), each with the worklist's
    kernels' device time: the [k1 sq8 synth] and [k2 sq8 synth] lines.
    Run from another tree's root (the docstring) it times that tree's
    kernels on the same layouts. Returns the numbers by name."""
    from auncel_tpu_torch import Metric
    out = {}
    for name, kernel, n, cap, mean, d, B, S, off in SQ8_10M_SHAPES:
        args, cd = synthetic_sq8(device, n, cap, mean, d, B, S, off, seed=8)
        compare = k1_compare if kernel == "k1" else k2_compare
        out[name] = compare(name, args, Metric.L2, card,
                            reps=200 if B * S <= 64 else 10, terms_tol=True,
                            codec=cd, label=f"{kernel} sq8 synth",
                            worklist=True)
        del args, cd
        torch.cuda.empty_cache()
    return out


# (name, B, running k, chunk width, k, running result): the merge kernel at
# the widths the recorded merges of the main path take (PERF.md section 6):
# the 10M SQ8 window's largest (B 256 x 256 row slots x row_cap 256), the
# same with a full running result whose k-th beats 99.9 % of the chunk (the
# steady state of a window's later rounds), its batch 1 (64 row slots) and
# the largest recorded batch-1 merge (B 1 x 1775872), the PQ16 window's (B
# 1000 x one list of cap 19736), a 10M training chunk (B 100 x 8 x 19736),
# a 1M window's (B 1000 x 4 x 256), a chunk narrower than k, and k 10
TOPK_SHAPES = (("10M window", 256, 100, 65536, 100, "half"),
               ("10M window, full running result", 256, 100, 65536, 100,
                "full"),
               ("10M batch 1", 1, 100, 16384, 100, "half"),
               ("10M batch 1 recorded width", 1, 100, 1775872, 100, "half"),
               ("PQ window", 1000, 100, 19736, 100, "half"),
               ("10M training chunk", 100, 100, 157888, 100, "half"),
               ("1M window", 1000, 100, 1024, 100, "half"),
               ("narrow", 1000, 100, 50, 100, "half"),
               ("k 10", 1000, 10, 19736, 10, "half"))
# k above the first design's 128: [topk k] merges at B 64 x 65536 (k 640 is
# IVFPQR's base search at k_factor 64 and k 10; above 1024 the candidate
# buffers live in scratch)
TOPK_KS = (129, 640, 1024, 6400)


def synthetic_merge(device, B: int, kr: int, n: int, k: int, kind: str,
                    seed: int, fill: str = "half") -> tuple:
    """A merge's inputs on the card (L2): a running result half full
    (sorted values below 0.1, then the worst value and id -1), or with
    ``fill`` "full" full of sorted values below 0.001, and a chunk of
    uniform scores of which a tenth are dead (the worst value, id -1);
    ``kind`` "ties" rounds the scores to four levels, "worst" makes every
    chunk slot dead."""
    g = torch.Generator(device=device).manual_seed(seed)
    inf = float("inf")
    half, scale = (kr, 0.001) if fill == "full" else (kr // 2, 0.1)
    rv = torch.full((B, kr), inf, device=device)
    ri = torch.full((B, kr), -1, dtype=torch.int32, device=device)
    rv[:, :half] = torch.sort(torch.rand((B, half), generator=g,
                                         device=device), dim=1).values * scale
    ri[:, :half] = torch.arange(half, dtype=torch.int32, device=device)
    sv = torch.rand((B, n), generator=g, device=device)
    if kind == "ties":
        sv = torch.round(sv * 3)
    si = torch.randint(0, 1 << 30, (B, n), generator=g, device=device,
                       dtype=torch.int32)
    dead = torch.rand((B, n), generator=g, device=device) < (
        1.0 if kind == "worst" else 0.1)
    sv = torch.where(dead, inf, sv)
    si = torch.where(dead, -1, si)
    return rv, ri, sv, si


def topk_line(tag: str, name: str, r: dict, card: str) -> None:
    B, kr, n, k = r["shape"]
    log(f"[{tag}] {name}: B {B}, running {kr}, chunk {n}, k {k}: kernel "
        f"{r['ms']:.4f} ms, device {r['dev_ms']:.4f} ms "
        f"({100 * r['bound_ms'] / r['dev_ms']:.1f} % of its bound "
        f"{r['bound_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms "
        f"({r['plain_ms'] / r['ms']:.2f}x), torch.topk "
        f"{r['library_ms']:.4f} ms; bitwise equal" + other_merge(r)
        + f" [{card}]")


def topk_check(device, card: str) -> dict:
    """The merge kernel at TOPK_SHAPES on synthetic inputs: uniform scores,
    then ties and an all-dead chunk, each bitwise its plain version, timed
    against it and torch.topk: the [topk synth] lines; then at each k of
    TOPK_KS: the [topk k] lines. Returns the numbers by name."""
    from auncel_tpu_torch import Metric
    out = {}
    for name, B, kr, n, k, fill in TOPK_SHAPES:
        for kind in ("uniform", "ties", "worst"):
            call = ("synthetic", *synthetic_merge(device, B, kr, n, k, kind,
                                                  seed=9, fill=fill),
                    k, Metric.L2)
            r = topk_compare(f"{name} {kind}", call, card,
                             reps=50 if B * n <= 1 << 16 else 10)
            topk_line("topk synth", f"{name}, {kind}", r, card)
            out[(name, kind)] = r
            del call
        torch.cuda.empty_cache()
    for k in TOPK_KS:
        for kind in ("uniform", "ties"):
            call = ("synthetic", *synthetic_merge(device, 64, k, 65536, k,
                                                  kind, seed=10), k,
                    Metric.L2)
            r = topk_compare(f"k {k} {kind}", call, card, reps=10)
            topk_line("topk k", f"k {k}, {kind}", r, card)
            out[(f"k {k}", kind)] = r
            del call
        torch.cuda.empty_cache()
    return out


# [decide]: (B, k, stage, with the state update) at nlist 1024 and a
# top-100: the benchmark's batch-1 decisions and a window's
DECIDE_SHAPES = ((1, 10, 16, False), (1, 10, 16, True), (1, 10, 128, False),
                 (1, 10, 128, True), (1000, 100, 16, True),
                 (1000, 100, 128, True))
DECIDE_NLIST, DECIDE_TOPK = 1024, 100


def synthetic_decide(device, B: int, k: int, stage: int, update: bool,
                     seed: int) -> tuple:
    """decision_step's arguments at nlist DECIDE_NLIST: random ascending
    traces, a sorted top-DECIDE_TOPK a row (a quarter of the rows
    unfilled from some slot on), boundary distances, the exact mask on
    half the rows and, with ``update``, a later visit's carried state."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.kernels.decide import MRDecide
    from auncel_tpu_torch.profile.geometry import n_boundaries
    from auncel_tpu_torch.profile.trace import make_trace_set
    from auncel_tpu_torch.types import worst_value
    rng = np.random.RandomState(seed)
    per = []
    for _ in range(8):
        n = int(rng.randint(50, 300))
        per.append((np.sort(rng.uniform(0, 8, n)).astype(np.float32),
                    rng.uniform(0.2, 3, n).astype(np.float32),
                    rng.uniform(0, 0.3, n).astype(np.float32)))
    traces = make_trace_set(per, device)
    vals = np.sort(rng.uniform(0.05, 3, (B, DECIDE_TOPK)), 1).astype(
        np.float32)
    for b in range(0, B, 4):
        vals[b, rng.randint(0, DECIDE_TOPK):] = worst_value(Metric.L2)
    dtb = rng.uniform(-0.5, 2.5, (B, n_boundaries(DECIDE_NLIST)))

    def dev(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=device)
    exact = torch.as_tensor(rng.rand(B) < 0.5, device=device)
    mr = None
    if update:
        i32 = np.int32
        rows = rng.randint(0, 5000, B)
        acc = rng.choice([0.9, 1.0], B)
        my_np = np.where(rng.rand(B) < 0.3, rng.randint(1, 300, B), 0)
        mr = MRDecide(dev(rows + rng.randint(-30, 30, B), i32), dev(rows, i32),
                      dev(acc), dev(np.floor(acc * 12), i32),
                      torch.tensor(2.7, device=device), dev(my_np, i32),
                      dev(np.where(my_np > 0, 8, 0), i32),
                      dev(rng.randint(0, 20, B), i32),
                      dev(np.where(rng.rand(B) < 0.5, vals[:, -1], 1.0)),
                      dev(rng.choice([0, 8], B), i32), stage,
                      stage >= DECIDE_NLIST // 8, DECIDE_NLIST)
    return (traces, dev(dtb), dev(vals), stage, DECIDE_NLIST, k,
            DECIDE_TOPK, torch.tensor(1.5, device=device), Metric.L2,
            exact, mr)


def decide_check(device, card: str) -> dict:
    """The decision step's kernel at DECIDE_SHAPES: decision_step (one
    launch) bitwise decision_step_ref (its plain torch ops on the card) or
    the run fails, then the device time of each (profiler) and the host's
    time a call with the card never waited for (the loop's wall clock over
    its calls, after one sync): the [decide] lines. Returns the numbers by
    shape."""
    from auncel_tpu_torch.kernels.decide import decide_step
    from auncel_tpu_torch.profile.bounded import (
        decision_step, decision_step_ref)
    out = {}
    for shape in DECIDE_SHAPES:
        B, k, stage, update = shape
        args = synthetic_decide(device, *shape, seed=B + k + stage)
        with uncounted():
            before = decide_step.launches
            got = decision_step(*args)
            check(decide_step.launches == before + 1,
                  f"[decide] {shape}: the kernel did not launch")
        want = decision_step_ref(*args)
        if not update:
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            gb, wb = g.cpu().numpy(), w.cpu().numpy()
            check(g.dtype == w.dtype and np.array_equal(
                gb.view(np.int32), wb.view(np.int32)),
                f"[decide] {shape}: the kernel differs from its plain "
                f"version")

        def host_ms(fn, reps=200):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            ms = (time.perf_counter() - t0) / reps * 1e3
            torch.cuda.synchronize()
            return ms

        def kernel():
            return decision_step(*args)

        def plain():
            return decision_step_ref(*args)
        with uncounted():
            t_k, t_ref = time_pair(kernel, plain, 50)
            dev_k, dev_ref = device_ms(kernel, 50), device_ms(plain, 50)
            host_k, host_ref = host_ms(kernel), host_ms(plain)
        r = {"max_abs_err": 0.0, "ms": t_k, "plain_ms": t_ref,
             "bound_ms": None, "bound_by": "latency", "dev_ms": dev_k,
             "plain_dev_ms": dev_ref, "host_ms": host_k,
             "plain_host_ms": host_ref}
        out[shape] = r
        log(f"[decide] B {B}, k {k} of {DECIDE_TOPK}, stage {stage}, nlist "
            f"{DECIDE_NLIST}, state update {update}: bitwise equal; kernel "
            f"device {dev_k * 1e3:.2f} us, host {host_k * 1e3:.2f} us a "
            f"call; plain device {dev_ref * 1e3:.2f} us, host "
            f"{host_ref * 1e3:.2f} us ({host_ref / host_k:.1f}x the "
            f"kernel's host time) [{card}]")
    return out


def k1_dots_check(device, card: str) -> dict:
    """Compare rowscan_dots, off the main path, with its plain version and
    time both."""
    from auncel_tpu_torch.kernels.rowscan import (
        rowscan_dots, rowscan_dots_ref)

    gen = torch.Generator(device=device).manual_seed(0)
    result = {}
    for name, n_rows, row_cap, d, T in K1_SHAPES:
        # entries ~ N(0, 1/d): dots are O(1), so the fp32 error of summing
        # d products in another order (~1e-7) sits well inside 1e-5
        scale = d ** -0.5
        db = torch.randn((n_rows, row_cap, d), generator=gen,
                         device=device) * scale
        rows = torch.randint(0, n_rows, (T,), generator=gen, device=device,
                             dtype=torch.int32)
        qs = torch.randn((T, d), generator=gen, device=device) * scale
        got = rowscan_dots(db, rows, qs)
        want = rowscan_dots_ref(db, rows, qs)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        err = float((got - want).abs().max())
        gb = T * row_cap * d * 4 / 1e9
        t_k, t_ref = time_pair(lambda: rowscan_dots(db, rows, qs),
                               lambda: rowscan_dots_ref(db, rows, qs), 20)
        log(f"[k1 dots] {name}: T={T} row_cap={row_cap} d={d} max_abs_err="
            f"{err:.3g} kernel {t_k:.4f} ms ({gb / t_k * 1e3:.1f} GB/s) "
            f"plain {t_ref:.4f} ms ({gb / t_ref * 1e3:.1f} GB/s) [{card}]")
        if name in ("bench", "tail"):
            b_ms, b_by = k1_bound(db, rows, qs)
            log(f"[k1 dots] {name}: bound {b_ms:.4f} ms ({b_by}; distinct "
                f"rows read once), {100 * b_ms / t_k:.1f} % of it [{card}]")
        if name == "bench":
            result = {"max_abs_err": err, "ms": t_k, "plain_ms": t_ref,
                      "bound_ms": b_ms, "bound_by": b_by}
        del db, rows, qs, got, want
    torch.cuda.empty_cache()
    return result


def dots_route(db, db_sq, vec_ids, row_sizes, q, q_sq, rows, metric):
    """rowscan_scores' function as the main path computed it before that
    kernel: rowscan_dots over every entry, masked or not (an inactive entry
    reads row 0), then the score assembly and masks as separate passes. Row
    ids clamp, as in the kernels."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.kernels.rowscan import rowscan_dots
    from auncel_tpu_torch.types import worst_value
    B, S = rows.shape
    cap = db.shape[1]
    in_limit = rows >= 0
    safe = rows.clamp(0, db.shape[0] - 1)
    dots = rowscan_dots(db, safe.reshape(-1),
                        q.repeat_interleave(S, dim=0)).reshape(B, S, cap)
    safe = safe.long()
    sub_sq, sub_ids = db_sq[safe], vec_ids[safe]
    if metric is Metric.L2:
        scores = (q_sq[:, None, None] + sub_sq - 2.0 * dots).clamp_min(0.0)
    else:
        scores = dots
    active = in_limit[:, :, None] & (sub_ids >= 0)
    scores = torch.where(active, scores, worst_value(metric))
    sub_ids = torch.where(active, sub_ids, -1)
    return scores.reshape(B, S * cap), sub_ids.reshape(B, S * cap)


# --against DIR: the libraries of another tree of the port, whose K1, K2 and
# merge are timed beside this tree's (load_against, against_route,
# against_merge)
AGAINST: dict = {}


def load_against(root: str) -> None:
    """Build the tree at ``root``'s csrc/rowscan.cu, csrc/scan_scores.cu and
    csrc/topk_merge.cu with this tree's nvcc flags into its _build (one
    nvcc each, in parallel) and bind them as this tree binds its own (a
    merge of the first design by its own interface)."""
    import ctypes
    from auncel_tpu_torch.kernels import build
    from auncel_tpu_torch.kernels.scan_scores import bind_scan
    from auncel_tpu_torch.kernels.topk_merge import bind
    pkg = os.path.join(root, "auncel_tpu_torch")
    os.makedirs(os.path.join(pkg, "_build"), exist_ok=True)

    def make(name):
        so = os.path.abspath(os.path.join(pkg, "_build", f"against_{name}.so"))
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so,
                        os.path.join(pkg, "csrc", f"{name}.cu")],
                       check=True, capture_output=True)
        return ctypes.CDLL(so)
    with ThreadPoolExecutor(max_workers=3) as pool:
        k1, k2, mg = pool.map(make, ("rowscan", "scan_scores", "topk_merge"))
    AGAINST["rowscan_scores"] = bind_scan(k1, "rowscan_scores")
    AGAINST["scan_scores"] = bind_scan(k2, "scan_scores", pq=True)
    if hasattr(mg, "topk_merge_run"):
        AGAINST["topk_merge"] = (bind(mg), None)
    else:  # the first design: (..., int* scratch, B, kr, n, k, is_ip,
        # segments <= 64, device, stream), k <= 128
        mg.topk_merge_scratch_ints.argtypes = [ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_int]
        mg.topk_merge_scratch_ints.restype = ctypes.c_longlong
        mg.topk_merge_launch.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_longlong] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        mg.topk_merge_launch.restype = ctypes.c_int
        AGAINST["topk_merge"] = (mg, 128)


def against_merge(rv, ri, sv, si, k: int, metric):
    """The other tree's merge on one merge's inputs, as a bare callable
    (outputs and scratch allocated once); None without --against or above
    the k it takes."""
    if "topk_merge" not in AGAINST:
        return None
    return merge_route(*AGAINST["topk_merge"], rv, ri, sv, si, k, metric)


def this_merge(rv, ri, sv, si, k: int, metric):
    """This tree's merge kernel as the same bare callable, so that the two
    trees are timed through the same host path."""
    from auncel_tpu_torch.kernels import topk_merge as tm
    return merge_route(tm._library(), None, rv, ri, sv, si, k, metric)


def merge_route(lib, max_k, rv, ri, sv, si, k: int, metric):
    """A merge library's kernel on one merge's inputs as a callable: this
    design's interface (max_k None) or the first design's (k <= max_k);
    None above max_k."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.kernels import topk_merge as tm
    if max_k is not None and k > max_k:
        return None
    B, kr = rv.shape
    n = sv.shape[1]
    dev = rv.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    is_ip = int(metric is Metric.IP)
    out_v = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev)
    if max_k is None:
        n_seg = tm.segments(B, kr + n, n_sm)
        scratch = torch.empty(max(lib.topk_merge_scratch_bytes(B, k, n_seg),
                                  8), dtype=torch.uint8, device=dev)
        state = torch.zeros((B, 4), dtype=torch.int64, device=dev)
        state[:, 0] = -1

        def run():
            err = lib.topk_merge_run(
                rv.data_ptr(), ri.data_ptr(), sv.data_ptr(), si.data_ptr(),
                out_v.data_ptr(), out_i.data_ptr(), scratch.data_ptr(),
                state.data_ptr(), B, kr, n, k, is_ip, n_seg, dev.index,
                stream.cuda_stream)
            check(err == 0, f"a merge kernel: CUDA error {err}")
            return out_v, out_i
        return run
    # the first design's segments: 6 blocks a multiprocessor, >= 2048
    # positions a segment, at most 64
    target = 6 * n_sm
    n_seg = 1 if B >= target else max(1, min(-(-target // B),
                                             -(-(kr + n) // 2048), 64))
    scratch = torch.empty(max(lib.topk_merge_scratch_ints(B, k, n_seg), 1),
                          dtype=torch.int32, device=dev)

    def run():
        err = lib.topk_merge_launch(
            rv.data_ptr(), ri.data_ptr(), sv.data_ptr(), si.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), scratch.data_ptr(), B, kr, n,
            k, is_ip, n_seg, dev.index, stream.cuda_stream)
        check(err == 0, f"a merge kernel: CUDA error {err}")
        return out_v, out_i
    return run


def other_merge(r: dict) -> str:
    """A [topk] line's words on the other tree's merge, if it ran: device
    times (profiler; nan where it recorded no device event), then event
    times in turns, each tree's kernel through the same bare call."""
    if r.get("other_ms") is None:
        return ""
    return (f"; against the other tree's merge: device this "
            f"{r['dev_ms']:.4f} ms, other {r['other_dev_ms']:.4f} ms "
            f"({r['other_dev_ms'] / r['dev_ms']:.2f}x), in turns this "
            f"{r['turns_ms']:.4f} ms, other {r['other_ms']:.4f} ms; bitwise "
            f"equal: {r['other_equal']}")


def against_route(name: str, args, metric, codec: dict):
    """The other tree's kernel ``name`` (rowscan_scores or scan_scores) on
    args, float32 or SQ codes, as a callable; None without --against."""
    lib = AGAINST.get(name)
    if lib is None or codec.get("pq_codebooks") is not None:
        return None
    from auncel_tpu_torch.kernels.scan_scores import launch_scan, scan_codec
    sc, bi = codec.get("sq_scale"), codec.get("sq_bias")
    cid = scan_codec(name, args[0], args[4].shape[1], sc, bi)
    return lambda: launch_scan(name, lib, args, metric, cid, sc, bi)[:2]


def other_line(routes: dict, t: dict, got: tuple) -> str:
    """``routes``' other tree, if any: its time and whether it gives this
    tree's kernel's scores and ids bit for bit."""
    if "other tree" not in routes:
        return ""
    o_s, o_i = routes["other tree"]()
    torch.cuda.synchronize()
    eq = torch.equal(o_s, got[0]) and torch.equal(o_i, got[1])
    return (f", other tree {t['other tree']:.4f} ms (bitwise equal: "
            f"{eq})")


def time_routes(routes: dict, reps: int) -> dict:
    """Milliseconds per call of each route (CUDA events over reps calls),
    in turns: every route in order, then in reverse; the lesser of the
    two."""
    out = {}
    for name in list(routes) + list(routes)[::-1]:
        t = cuda_time_ms(routes[name], reps)
        out[name] = min(out.get(name, t), t)
    return out


def k1_compare(name, args, metric, card: str, reps: int = 20,
               terms_tol: bool = False, codec: dict | None = None,
               label: str = "k1", worklist: bool = False) -> dict:
    """rowscan_scores against its plain version on one input set (ids and
    dead slots equal; scores within rtol = atol = 1e-5, or with
    ``terms_tol`` within 1e-5 of q_sq + db_sq, as k2_compare), timed in
    turns with the dots route (float32 storage only), K2 over the same
    rows (bitwise equal) and the plain version; returns its numbers.
    ``codec``: the SQ range (sq_scale, sq_bias) of uint8 storage;
    ``worklist``: also print the device time of the worklist's kernels."""
    from auncel_tpu_torch.kernels.rowscan import (
        rowscan_scores, rowscan_scores_ref)
    from auncel_tpu_torch.kernels.scan_scores import scan_scores
    cd = codec or {}
    routes = {"kernel": lambda: rowscan_scores(*args, metric, **cd),
              "dots route": lambda: dots_route(*args, metric),
              "K2 on rows": lambda: scan_scores(*args, metric, **cd),
              "plain": lambda: rowscan_scores_ref(*args, metric, **cd)}
    if args[0].dtype != torch.float32:
        del routes["dots route"]
    other = against_route("rowscan_scores", args, metric, cd)
    if other is not None:
        routes["other tree"] = other
    got_s, got_i = routes["kernel"]()
    want_s, want_i = routes["plain"]()
    torch.cuda.synchronize()
    check(torch.equal(got_i, want_i), f"K1 {name}: ids differ")
    check(torch.equal(torch.isfinite(got_s), torch.isfinite(want_s)),
          f"K1 {name}: dead slots differ")
    fin = torch.isfinite(want_s)
    diff = (got_s - want_s).abs()[fin]
    err = float(diff.max()) if diff.numel() else 0.0
    db, db_sq, _, _, _, q_sq, rows = args
    if terms_tol:
        B, S = rows.shape
        sel = rows.long().clamp(0, db.shape[0] - 1)
        terms = (q_sq[:, None, None] + db_sq[sel]).reshape(B, -1)
        check(bool((diff <= 1e-5 * terms[fin] + 1e-5).all()),
              f"K1 {name}: scores beyond 1e-5 of their terms")
        tol = "1e-5 of q_sq + db_sq"
    else:
        torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-5)
        tol = "rtol = atol = 1e-5"
    k2_s, k2_i = routes["K2 on rows"]()
    check(torch.equal(k2_s, got_s) and torch.equal(k2_i, got_i),
          f"K1 {name}: K2 over the same rows differs")
    if "dots route" in routes:
        check(torch.equal(routes["dots route"]()[1], got_i),
              f"K1 {name}: the dots route gives other ids")
    del want_s, want_i, diff, fin, k2_s, k2_i
    t = time_routes(routes, reps)
    other_s = other_line(routes, t, (got_s, got_i))
    del got_s, got_i
    t.setdefault("dots route", float("nan"))   # float32 storage only
    t_dev, split = device_split(routes["kernel"], 10)
    work = k2_work(*args)
    live = rows >= 0
    distinct = int(torch.unique(
        rows[live].clamp_max(db.shape[0] - 1)).numel())
    pct = 100 * work["bound_ms"] / t["kernel"]
    log(f"[{label}] {name}: B={rows.shape[0]} n_slots={rows.shape[1]} "
        f"row_cap={db.shape[1]} d={args[4].shape[1]} {metric.name} "
        f"{db.dtype} live share "
        f"{float(live.float().mean()) if live.numel() else 0.0:.3f} distinct "
        f"live rows {distinct} max_abs_err={err:.3g} ({tol}); kernel "
        f"{t['kernel']:.4f} ms ({pct:.1f} % of the bound; device time a call "
        + ("not measured" if t_dev is None else f"{t_dev:.4f} ms")
        + "), dots route " + (f"{t['dots route']:.4f} ms"
                              if "dots route" in routes else "f32 only")
        + f", K2 on rows "
        f"{t['K2 on rows']:.4f} ms, plain {t['plain']:.4f} ms" + other_s
        + f"; bound {work['bound_ms']:.4f} ms ({work['bound_by']}, "
        f"{work['bound_bytes'] / 1e9:.3f} GB: each distinct live row read "
        f"once) [{card}]")
    if worklist:
        log(f"[{label}] {name}: " + worklist_line(split) + f" [{card}]")
    return {"max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"],
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"],
            "dots_ms": t["dots route"], "k2_ms": t["K2 on rows"],
            "other_ms": t.get("other tree", float("nan"))}


def k1_check(device, card: str) -> dict:
    """rowscan_scores on synthetic row layouts at K1_ROW_SHAPES, both
    metrics at the bench shape; returns the bench shape's L2 numbers."""
    from auncel_tpu_torch import Metric
    result = None
    for name, *shape in K1_ROW_SHAPES:
        args = synthetic_padded(device, *shape, seed=3, full=0.9, drop=0.0)
        for metric in ((Metric.L2, Metric.IP) if name == "bench"
                       else (Metric.L2,)):
            res = k1_compare(f"{name} {metric.name}", args, metric, card)
            result = result or res
        del args
        torch.cuda.empty_cache()
    return result


def k2_compare(name, args, metric, card: str, reps: int = 20,
               terms_tol: bool = False, codec: dict | None = None,
               label: str = "k2", routes: tuple | None = None,
               worklist: bool = False) -> dict:
    """K2 against its plain version on one input set; returns its numbers.
    ``routes``: the (kernel, plain) pair to call instead of scan_scores
    and scan_scores_ref (``filter_routes``); ``worklist``: also print the
    device time of the worklist's kernels.
    With ``terms_tol`` the L2 tolerance is 1e-5 of the score's terms
    (q_sq + db_sq) rather than of the score: on data of SIFT's scale a
    near neighbour's score is the difference of terms ~60x larger than it,
    and the two versions' dots differ in sum order (for residual PQ the
    terms are ||q - c_l||^2 + db_sq). ``codec``: the SQ range (sq_scale,
    sq_bias) or the PQ codebook (pq_codebooks, and centroids for residual
    codes, and qcodes and ht for the polysemous filter) of uint8 storage."""
    from auncel_tpu_torch.kernels.scan_scores import (
        scan_scores, scan_scores_ref)
    scan_scores, scan_scores_ref = routes or (scan_scores, scan_scores_ref)
    cd = codec or {}
    got_s, got_i = scan_scores(*args, metric, **cd)
    want_s, want_i = scan_scores_ref(*args, metric, **cd)
    torch.cuda.synchronize()
    check(torch.equal(got_i, want_i), f"K2 {name}: ids differ")
    check(torch.equal(torch.isfinite(got_s), torch.isfinite(want_s)),
          f"K2 {name}: dead slots differ")
    fin = torch.isfinite(want_s)
    diff = (got_s - want_s).abs()[fin]
    err = float(diff.max()) if diff.numel() else 0.0
    rel = float((diff / want_s.abs()[fin].clamp_min(1e-30)).max()) \
        if diff.numel() else 0.0
    if terms_tol:
        db, db_sq, _, _, q, q_sq, lists = args
        B, S = lists.shape
        sel = lists.long().clamp(0, db.shape[0] - 1)
        _, qsq, dsq = l2_terms(args, cd)
        terms = (qsq + dsq).reshape(B, -1)
        ok = bool(((got_s - want_s).abs()[fin]
                   <= 1e-5 * terms[fin] + 1e-5).all())
        check(ok, f"K2 {name}: scores beyond 1e-5 of their terms")
        tol = ("1e-5 of ||q - c_l||^2 + db_sq" if cd.get("centroids")
               is not None else "1e-5 of q_sq + db_sq")
        # how far each fp32 version is from the same function in float64,
        # on the first queries: the difference above is their two errors
        n = max(1, min(32, B, (1 << 26) // max(S * db.shape[1] * q.shape[1],
                                                1)))
        qq, qsq, dsq = l2_terms(args, cd, n, torch.float64)
        dots = torch.einsum("bscd,bsd->bsc",
                            decoded(db[sel[:n]], q.shape[1], cd).double(),
                            qq)
        exact = (qsq + dsq - 2.0 * dots).clamp_min(0.0).reshape(n, -1)
        f = fin[:n]
        e_k = float((got_s[:n] - exact)[f].abs().max())
        e_p = float((want_s[:n] - exact)[f].abs().max())
        log(f"[{label}] {name}: against float64 on {n} queries: kernel "
            f"max abs err {e_k:.3g}, plain {e_p:.3g}; largest score "
            f"{float(exact[f].max()):.4g}")
        del dots, exact
    else:
        torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-5)
        tol = "rtol = atol = 1e-5"
    del want_s, want_i
    t_k, t_ref = time_pair(lambda: scan_scores(*args, metric, **cd),
                           lambda: scan_scores_ref(*args, metric, **cd), reps)
    other = None if routes else against_route("scan_scores", args, metric,
                                              cd)
    other_s = ""
    if other is not None:
        pair = {"kernel": lambda: scan_scores(*args, metric, **cd),
                "other tree": other}
        t_o = time_routes(pair, reps)
        other_s = other_line(pair, t_o, (got_s, got_i))
    del got_s, got_i
    t_dev, split = device_split(lambda: scan_scores(*args, metric, **cd), 20)
    dev = "not measured" if t_dev is None else f"{t_dev:.4f} ms"
    work = k2_work(*args, codec=cd)
    B, S = args[6].shape
    log(f"[{label}] {name}: B={B} n_slots={S} cap={args[0].shape[1]} "
        f"d={args[4].shape[1]} {metric.name} {args[0].dtype} "
        f"max_abs_err={err:.3g} max rel "
        f"err={rel:.3g} ({tol}) kernel {t_k:.4f} ms "
        f"({work['bound_bytes'] / t_k / 1e6:.1f} GB/s of the bound's bytes; "
        f"{work['live_bytes'] / t_k / 1e6:.1f} GB/s of live bytes, once per "
        f"probe), device time a call {dev}; plain {t_ref:.4f} ms{other_s}; "
        f"bound {work['bound_ms']:.4f} ms ({work['bound_by']}, "
        f"{work['bound_bytes'] / 1e9:.3f} GB), "
        f"{100 * work['bound_ms'] / t_k:.1f} % of it [{card}]")
    if worklist:
        log(f"[{label}] {name}: " + worklist_line(split) + f" [{card}]")
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_ref,
            "bound_ms": work["bound_ms"], "bound_by": work["bound_by"]}


def synthetic_padded(device, nlist, cap, d, B, n_slots, seed,
                     full: float = 0.0, drop: float = 0.2):
    """A padded layout as _pack lays it out (ragged live prefix, id -1 and
    zero vectors after it, one dead id inside a list), with probes of which
    a share ``drop`` is inactive (-1) and one out of range; entries
    ~ N(0, 1/d), so scores are O(1) and the fp32 error of another sum order
    (~1e-7) sits well inside 1e-5. With ``full``, that share of the lists is
    full, as the rows of the multi-row layout are but each list's last."""
    gen = torch.Generator(device=device).manual_seed(seed)
    s = d ** -0.5
    sizes = torch.randint(0, cap + 1, (nlist,), generator=gen,
                          device=device, dtype=torch.int32)
    if full:
        sizes = torch.where(torch.rand((nlist,), generator=gen,
                                       device=device) < full, cap,
                            sizes).to(torch.int32)
    live = torch.arange(cap, device=device)[None, :] < sizes[:, None]
    ids = torch.where(live, torch.arange(nlist * cap, device=device,
                                         dtype=torch.int32).reshape(nlist,
                                                                    cap), -1)
    ids[0, 0] = -1
    db = torch.where(live[:, :, None],
                     torch.randn((nlist, cap, d), generator=gen,
                                 device=device) * s, 0.0)
    q = torch.randn((B, d), generator=gen, device=device) * s
    lists = torch.randint(0, nlist, (B, n_slots), generator=gen,
                          device=device, dtype=torch.int32)
    dropped = torch.rand((B, n_slots), generator=gen, device=device) < drop
    lists = torch.where(dropped, -1, lists)
    if B * n_slots:
        lists[0, 0] = nlist + 3
    return (db, (db * db).sum(-1), ids.to(torch.int32), sizes, q,
            (q * q).sum(-1), lists)


def pq_masked(scores, ids, db, lists, metric, qcodes, ht) -> tuple:
    """The polysemous filter as a plain-torch mask on K2's output: each
    probed list's codes gathered again and a slot more than ht bits from
    its probe's query code set to the worst value and id -1 (the route
    of index/scan.py's scan_probe_range before K2 took the filter)."""
    from auncel_tpu_torch.index.scan import popcount8
    from auncel_tpu_torch.types import worst_value
    B = lists.shape[0]
    raw = db[lists.clamp_min(0).long()]               # [B, S, cap, M]
    ham = popcount8(raw ^ qcodes[:, :, None, :]).sum(
        -1, dtype=torch.int32).reshape(B, -1)
    keep = ham <= ht
    return (torch.where(keep, scores, worst_value(metric)),
            torch.where(keep, ids, -1))


def filter_routes(kernel, plain) -> tuple:
    """(kernel, plain) callables of K2's contract that take the filter's
    qcodes and ht: the wrappers themselves where they take them, else (a
    tree whose K2 predates the fused filter) each followed by pq_masked."""
    import inspect
    if "qcodes" in inspect.signature(kernel).parameters:
        return kernel, plain

    def masked(fn):
        def run(*args, qcodes=None, ht=None, **kw):
            out = fn(*args, **kw)
            if qcodes is None:
                return out
            return pq_masked(*out, args[0], args[6], args[7], qcodes, ht)
        return run
    return masked(kernel), masked(plain)


def synthetic_pq(device, nlist, cap, mean, d, M, B, n_slots, seed) -> tuple:
    """A padded layout of PQ codes: list sizes uniform in [0, 2 * mean]
    (at most cap), random codes, ids by slot and -1 past the size, a
    codebook and centroids ~ N(0, 1/d), db_sq the decoded norms (zero at
    dead slots); queries ~ N(0, 1/d), each probing n_slots distinct lists;
    random query codes for the filter. Returns (args, codebook, centroids,
    query codes)."""
    from auncel_tpu_torch.ops.pq import PQCodebooks, decode_pq
    gen = torch.Generator(device=device).manual_seed(seed)
    s = d ** -0.5
    sizes = torch.randint(0, min(cap, 2 * mean) + 1, (nlist,), generator=gen,
                          device=device, dtype=torch.int32)
    live = torch.arange(cap, device=device)[None, :] < sizes[:, None]
    ids = torch.where(live, torch.arange(nlist * cap, device=device,
                                         dtype=torch.int32).reshape(nlist,
                                                                    cap), -1)
    codes = torch.randint(0, 256, (nlist, cap, M), generator=gen,
                          device=device, dtype=torch.uint8)
    books = torch.randn((M, 256, d // M), generator=gen, device=device) * s
    cents = torch.randn((nlist, d), generator=gen, device=device) * s
    db_sq = torch.zeros((nlist, cap), device=device)
    for l0 in range(0, nlist, 32):
        x = decode_pq(PQCodebooks(books), codes[l0:l0 + 32])
        db_sq[l0:l0 + 32] = torch.where(live[l0:l0 + 32], (x * x).sum(-1),
                                        0.0)
    del x
    q = torch.randn((B, d), generator=gen, device=device) * s
    lists = torch.argsort(torch.rand((B, nlist), generator=gen,
                                     device=device), dim=1)[:, :n_slots]
    qcodes = torch.randint(0, 256, (B, n_slots, M), generator=gen,
                           device=device, dtype=torch.uint8)
    args = (codes, db_sq, ids.to(torch.int32), sizes, q, (q * q).sum(-1),
            lists.to(torch.int32).contiguous())
    return args, books, cents, qcodes


def pq_check(device, card: str) -> dict:
    """K2 on PQ codes at K2_PQ_SHAPES, residual and plain, without and
    with the polysemous filter (random query codes at ht 4M, about half
    the codes kept), each against its plain version within 1e-5 of the
    score's terms: the [k2 pq] lines. Run from another tree's root (the
    docstring) it times that tree's K2: one that predates the fused filter
    takes it as K2 then pq_masked, and a width that K2 refuses is reported
    so. A K2 with the fused filter refuses nothing here: its refusal fails
    the run. Returns the numbers by (shape, residual, filtered)."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.kernels.scan_scores import (
        scan_scores, scan_scores_ref)
    routes = filter_routes(scan_scores, scan_scores_ref)
    fused = routes[0] is scan_scores
    out = {}
    for name, nlist, cap, mean, d, M, B, S in K2_PQ_SHAPES:
        args, books, cents, qcodes = synthetic_pq(device, nlist, cap, mean,
                                                  d, M, B, S, seed=4)
        for residual in (True, False):
            for filt in (False, True):
                cd = {"pq_codebooks": books,
                      "centroids": cents if residual else None}
                if filt:
                    cd.update(qcodes=qcodes, ht=4 * M)
                what = (f"{name}, PQ{M} {'residual' if residual else 'plain'}"
                        + (f", filter ht={4 * M}" if filt else ""))
                try:
                    out[(name, residual, filt)] = k2_compare(
                        what, args, Metric.L2, card,
                        reps=200 if B * S <= 64 else PQ_SYNTH_REPS,
                        terms_tol=True,
                        codec=cd, label="k2 pq", routes=routes)
                except ValueError as e:
                    if fused:
                        raise
                    log(f"[k2 pq] {what}: refused by this tree's K2 ({e}) "
                        f"[{card}]")
        del args, books, cents, qcodes
        torch.cuda.empty_cache()
    return out


def k2_check(device, card: str) -> None:
    """K2 against its plain version on synthetic padded layouts: both
    metrics, n_slots not a multiple of 8, and the scalar-load path."""
    from auncel_tpu_torch import Metric
    for name, *shape in K2_SHAPES:
        args = synthetic_padded(device, *shape, seed=2)
        for metric in (Metric.L2, Metric.IP):
            k2_compare(f"{name} {metric.name}", args, metric, card)
        del args
    torch.cuda.empty_cache()


def decoded(x, d: int, codec: dict) -> torch.Tensor:
    """Stored vectors as float32: the plain SQ decode with ``codec``'s
    range, the PQ codebook gather (residuals for residual PQ), the exact
    widening of bf16, float32 as it is."""
    from auncel_tpu_torch.kernels.scan_scores import decode_slots
    return decode_slots(x, d, codec.get("sq_scale"), codec.get("sq_bias"),
                        codec.get("pq_codebooks"))


def l2_terms(args, codec: dict, n: int | None = None,
             dtype=torch.float32) -> tuple:
    """The L2 score's terms of the first ``n`` queries of K2's args: (the
    query side [n, S, d], its squared norms [n, S, 1], the stored norms
    [n, S, cap]): q and q_sq, or for residual PQ q - c_l and its squared
    norm."""
    db, db_sq, _, _, q, q_sq, lists = args
    n = q.shape[0] if n is None else n
    sel = lists[:n].long().clamp(0, db.shape[0] - 1)
    qq = q[:n].to(dtype)[:, None, :].expand(n, sel.shape[1], q.shape[1])
    if codec.get("centroids") is not None:
        qq = qq - codec["centroids"][sel].to(dtype)
        qsq = (qq * qq).sum(-1)[:, :, None]
    else:
        qsq = q_sq[:n].to(dtype)[:, None, None].expand(n, sel.shape[1], 1)
    return qq, qsq, db_sq[sel].to(dtype)


def coded(args, codec: str, seed: int) -> tuple:
    """A synthetic layout's vectors stored in ``codec``: (args, the SQ range
    as wrapper keywords or {}). bf16 rounds the vectors; the SQ codecs
    quantize them on a per-dimension min-max range, as the index does, and
    pack them. Stored norms are the decoded vectors', zero at dead
    slots."""
    from auncel_tpu_torch.index.flat import (
        sq_encode, sq_pack, sq_train_range)
    args = list(args)
    db, vec_ids = args[0], args[2]
    nlist, cap, d = db.shape
    if codec == "bf16":
        args[0] = db.to(torch.bfloat16)
        cd = {}
    else:
        x = db.reshape(-1, d).cpu().numpy()
        gen = np.random.RandomState(seed)
        vmin, scale = sq_train_range(x[gen.rand(x.shape[0]) < 0.05], codec)
        packed = sq_pack(sq_encode(x, vmin, scale, codec), codec)
        args[0] = torch.as_tensor(packed, device=db.device).reshape(
            nlist, cap, -1)
        cd = {"sq_scale": torch.as_tensor(scale, device=db.device),
              "sq_bias": torch.as_tensor(vmin, device=db.device)}
    x = decoded(args[0], d, cd)
    args[1] = torch.where(vec_ids >= 0, (x * x).sum(-1), 0.0)
    return tuple(args), cd


CODECS = ("bf16", "sq8", "sq4", "sq6")


def codec_check(device, card: str) -> dict:
    """Each storage codec of K1 and K2 against the plain versions at the
    bench shapes (K1: 1024 x 4 row slots of rows 256 x 128; K2: 256 x 5
    probes of lists 1024 x 128): the [k1 CODEC] and [k2 CODEC] lines.
    Returns each (kernel, codec)'s numbers."""
    from auncel_tpu_torch import Metric
    out = {}
    for codec in CODECS:
        name, *shape = K1_ROW_SHAPES[0]
        args, cd = coded(synthetic_padded(device, *shape, seed=3, full=0.9,
                                          drop=0.0), codec, seed=3)
        out[("rowscan_scores", codec)] = k1_compare(
            f"{name} L2", args, Metric.L2, card, codec=cd,
            label=f"k1 {codec}")
        del args
        name, *shape = K2_SHAPES[0]
        args, cd = coded(synthetic_padded(device, *shape, seed=2), codec,
                         seed=2)
        out[("scan_scores", codec)] = k2_compare(
            f"{name} L2", args, Metric.L2, card, codec=cd,
            label=f"k2 {codec}")
        del args
        torch.cuda.empty_cache()
    return out


# The benchmark configuration (bench.py): a synthetic SIFT-like corpus,
# IVF1024,Flat, recall@10 >= 0.9 per query, 1000 queries to train and
# calibrate the profile and 1000 held-out queries to serve.
NB, D, NLIST = 1_000_000, 128, 1024
N_TRAIN_Q, N_TEST_Q, K, MAX_TOPK, EPS = 1000, 1000, 10, 100, 0.10
N_LATENCY = 1000  # all held-out queries: p99 has 10 samples beyond it
N_LATENCY_PADDED = 300
SEARCH_REPS = 5
STD_M_GRID = (0.2, 1.0, 4.0, 8.0, 12.0)  # ErrorSys.calibrate's default


def synced(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class ScanMerges:
    """Counts the calls index/scan.py makes to merge_topk_verified (from
    scan_probe_range and masked_full_scan), once ``count_scan_merges`` has
    wrapped it. On the card every such call launches the merge kernel."""
    launches = 0


SCAN_MERGES = ScanMerges()


def count_scan_merges() -> None:
    """Wraps index/scan.py's merge_topk_verified so that each call counts
    in SCAN_MERGES."""
    import auncel_tpu_torch.index.scan as scan
    real = scan.merge_topk_verified

    def counting(*args, **kw):
        SCAN_MERGES.launches += 1
        return real(*args, **kw)
    scan.merge_topk_verified = counting


def kernel_wrappers() -> dict:
    from auncel_tpu_torch.kernels.decide import decide_step
    from auncel_tpu_torch.kernels.rowscan import rowscan_dots, rowscan_scores
    from auncel_tpu_torch.kernels.scan_scores import scan_scores
    from auncel_tpu_torch.kernels.topk_merge import topk_merge
    return {"rowscan_scores": rowscan_scores, "rowscan_dots": rowscan_dots,
            "scan_scores": scan_scores, "topk_merge": topk_merge,
            "decide_step": decide_step, "scan_merges": SCAN_MERGES}


def launch_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def set_counts(counts: dict) -> None:
    for k, fn in kernel_wrappers().items():
        fn.launches = counts[k]


def reset_counts() -> None:
    set_counts({k: 0 for k in kernel_wrappers()})


@contextlib.contextmanager
def uncounted():
    """Launches inside compare kernels with other routes: they are not the
    main path's, so the counts are restored after."""
    saved = launch_counts()
    try:
        yield
    finally:
        set_counts(saved)


@contextlib.contextmanager
def scans_through(fn, name: str = "rowscan_scores", module=None):
    """The serving path's row scans (index/scan.py's rowscan_scores), or
    with ``name`` "scan_scores" its padded-list scans, go through
    fn(real, *args, **codec) instead; ``module`` names another caller
    (index/aux.py's range search)."""
    import auncel_tpu_torch.index.scan as scan
    module = module or scan
    real = getattr(module, name)
    setattr(module, name, lambda *args, **kw: fn(real, *args, **kw))
    try:
        yield
    finally:
        setattr(module, name, real)


def on_dots_route(fn):
    """fn with the serving path's row scans on the dots route."""
    def run():
        with scans_through(lambda real, *args: dots_route(*args)):
            return fn()
    return run


def against_dots_route(label: str, fn, card: str) -> None:
    """A window (fn: its D, I and n_scanned) with its row scans by K1
    against the same window on the dots route, timed in turns; the results'
    differences are reported."""
    bad = differ(fn(), on_dots_route(fn)())
    ms_k1, ms_dots, t_k1, t_dots = in_turns(fn, on_dots_route(fn), 2)
    log(f"[{label}] row scans by K1 {ms_k1:.2f} ms ({t_k1}) against the "
        f"dots route {ms_dots:.2f} ms ({t_dots}); queries whose ids differ "
        f"{bad[0]}, n_scanned differ {bad[1]}, max |D| diff {bad[2]:.3g} "
        f"[{card}]")


def engine_stage() -> str:
    """Which part of the one-shot engine made the current call."""
    names = set()
    f = sys._getframe(1)
    while f is not None:
        names.add(f.f_code.co_name)
        f = f.f_back
    for fn, stage in (("masked_full_scan", "dense pass"),
                      ("_tail_rounds", "tail round"), ("_a2_rounds", "A2"),
                      ("bounded_oneshot_mr", "A1 wave")):
        if fn in names:
            return stage
    return "wave"


def record_row_scans(fn, name: str = "rowscan_scores", module=None) -> list:
    """Run fn and return the inputs of every row scan it made (with
    ``name`` "scan_scores", of every padded-list scan; ``module`` as for
    ``scans_through``), as (engine stage, args, metric, codec keywords):
    queries, norms and row slots copied, the index's tensors by
    reference."""
    calls = []

    def record(real, db, db_sq, vec_ids, row_sizes, q, q_sq, rows, metric,
               **kw):
        calls.append((engine_stage(), (db, db_sq, vec_ids, row_sizes,
                                       q.clone(), q_sq.clone(), rows.clone()),
                      metric, kw))
        return real(db, db_sq, vec_ids, row_sizes, q, q_sq, rows, metric,
                    **kw)

    with scans_through(record, name, module):
        fn()
    return calls


def k1_recorded(label: str, calls: list, card: str, tag: str = "k1",
                worklist: bool = False, reps: int = 10) -> dict:
    """K1 at the worklists a window's row scans gave it: each call checked
    against the plain version (within 1e-5 of q_sq + db_sq) and timed in
    turns with the dots route, K2 on the same rows and the plain version;
    then the sums over the window, and each route's device time over all
    the calls (torch.profiler)."""
    from auncel_tpu_torch.kernels.rowscan import rowscan_scores
    from auncel_tpu_torch.kernels.scan_scores import scan_scores
    tot = {"ms": 0.0, "dots_ms": 0.0, "k2_ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "other_ms": 0.0}
    for i, (stage, args, metric, kw) in enumerate(calls):
        res = k1_compare(f"{label}, call {i + 1} of {len(calls)} ({stage})",
                         args, metric, card, reps=reps, terms_tol=True,
                         codec=kw, label=tag, worklist=worklist)
        for k in tot:
            tot[k] += res[k]
    dev = {}
    routes = (("kernel", rowscan_scores), ("dots route", dots_route),
              ("K2 on rows", scan_scores))
    for name, fn in routes:
        if name == "dots route" and calls and calls[0][3]:
            dev[name] = "f32 only"
            continue
        t = device_ms(lambda: [fn(*a, m, **kw) for _, a, m, kw in calls], 3)
        dev[name] = "not measured" if t is None else f"{t:.3f} ms"
    log(f"[{tag}] {label}, all {len(calls)} row scans: kernel {tot['ms']:.3f} "
        f"ms ({100 * tot['bound_ms'] / tot['ms']:.1f} % of the summed bound "
        f"{tot['bound_ms']:.3f} ms), dots route {tot['dots_ms']:.3f} ms, K2 "
        f"on rows {tot['k2_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms"
        + (f", other tree {tot['other_ms']:.3f} ms" if AGAINST else "")
        + f"; device time over the calls (profiler): kernel {dev['kernel']}, "
        f"dots route {dev['dots route']}, K2 on rows {dev['K2 on rows']} "
        f"[{card}]")
    return tot


def record_merges(fn) -> list:
    """Run fn and return every merge scan_probe_range made, as (engine
    stage, rvals, rids, scores, ids, k, metric): the running result copied,
    the chunk's candidates (fresh tensors of the scan) by reference."""
    import auncel_tpu_torch.index.scan as scan
    real = scan.merge_topk_verified
    calls = []

    def record(rvals, rids, scores, ids, k, metric):
        calls.append((engine_stage(), rvals.clone(), rids.clone(), scores,
                      ids, k, metric))
        return real(rvals, rids, scores, ids, k, metric)

    scan.merge_topk_verified = record
    try:
        fn()
    finally:
        scan.merge_topk_verified = real
    return calls


def merge_bound(rv, sv, k: int) -> tuple:
    """The merge's least time: a row's running and chunk values read once
    (4 bytes a slot), the k winners' ids gathered (4) and k values and ids
    written (8); one compare a value for the operations."""
    B, kr = rv.shape
    n = sv.shape[1]
    return bound(B * (4 * (kr + n) + 12 * k), B * (kr + n))


def topk_compare(label: str, call: tuple, card: str, reps: int) -> dict:
    """The merge kernel at one recorded merge: bitwise its plain version
    (values and ids), or the run fails; timed in turns with the plain
    version (the concatenation and the stable sort, the main path's merge
    before the kernel), and torch.topk on the concatenation built
    beforehand (the library call: equal values, no promise on the order of
    ties)."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.kernels.topk_merge import topk_merge, topk_merge_ref
    stage, rv, ri, sv, si, k, metric = call
    with uncounted():
        got = topk_merge(rv, ri, sv, si, k, metric)
        want = topk_merge_ref(rv, ri, sv, si, k, metric)
        torch.cuda.synchronize()
        check(torch.equal(got[0].view(torch.int32),
                          want[0].view(torch.int32))
              and torch.equal(got[1], want[1]),
              f"[topk] {label}: the kernel differs from its plain version")
        err = float((got[0] - want[0]).abs().nan_to_num(0.0).max())
        cat_v = torch.cat([rv, sv], dim=-1)
        t_k, t_p = time_pair(lambda: topk_merge(rv, ri, sv, si, k, metric),
                             lambda: topk_merge_ref(rv, ri, sv, si, k,
                                                    metric), reps)
        t_lib = cuda_time_ms(lambda: torch.topk(
            cat_v, k, dim=-1, largest=metric is Metric.IP, sorted=True), reps)
        del cat_v
        t_dev = device_ms(lambda: topk_merge(rv, ri, sv, si, k, metric),
                          reps)
        other = against_merge(rv, ri, sv, si, k, metric)
        t_o = t_turns = eq = t_odev = None
        if other is not None:
            t_odev = device_ms(other, reps)
            o_v, o_i = other()
            torch.cuda.synchronize()
            eq = (torch.equal(o_v.view(torch.int32), got[0].view(torch.int32))
                  and torch.equal(o_i, got[1]))
            t = time_routes({"this": this_merge(rv, ri, sv, si, k, metric),
                             "other": other}, reps)
            t_o, t_turns = t["other"], t["this"]
    b_ms, b_by = merge_bound(rv, sv, k)
    return {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "library_ms": t_lib, "bound_ms": b_ms, "bound_by": b_by,
            "dev_ms": t_dev if t_dev is not None else float("nan"),
            "other_ms": t_o, "turns_ms": t_turns, "other_equal": eq,
            "other_dev_ms": t_odev if t_odev is not None else float("nan"),
            "stage": stage, "shape": (rv.shape[0], rv.shape[1], sv.shape[1],
                                      k)}


# [topk] numbers by window, for the kernels line
TOPK_RECORDS: dict = {}


def topk_recorded(label: str, calls: list, card: str, reps: int = 5) -> dict:
    """[topk]: the merge kernel at every merge a window made (topk_compare
    at each), then the sums over the window, each route's device time over
    all the merges (torch.profiler), and the largest merge's numbers, which
    it returns (and keeps in TOPK_RECORDS under ``label``)."""
    from auncel_tpu_torch.kernels.topk_merge import topk_merge, topk_merge_ref
    check(len(calls) > 0, f"[topk] {label}: no merge recorded")
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    tot = {key: 0.0 for key in keys + ("other_ms", "turns_ms")}
    res = []
    slower = unequal = 0
    for i, call in enumerate(calls):
        r = topk_compare(f"{label}, merge {i + 1} of {len(calls)}", call,
                         card, reps)
        for key in keys:
            tot[key] += r[key]
        if r["other_ms"] is not None:
            for key in ("other_ms", "turns_ms"):
                tot[key] += r[key]
            slower += r["turns_ms"] > 1.05 * r["other_ms"]
            unequal += not r["other_equal"]
        res.append(r)
    dev = {}
    with uncounted():
        for name, fn in (("kernel", topk_merge), ("plain", topk_merge_ref)):
            t = device_ms(lambda: [fn(*c[1:]) for c in calls], 3)
            dev[name] = "not measured" if t is None else f"{t:.3f} ms"
            tot[f"{name}_dev"] = t
        others = [against_merge(*c[1:]) for c in calls]
        if others and all(o is not None for o in others):
            t = device_ms(lambda: [o() for o in others], 3)
            dev["other tree"] = "not measured" if t is None else f"{t:.3f} ms"
            tot["other_dev"] = t
        del others
    big = max(res, key=lambda r: r["shape"][0] * r["shape"][2])
    B, kr, n, k = big["shape"]
    log(f"[topk] {label}, the largest of {len(calls)} merges ({big['stage']};"
        f" B {B}, running {kr}, chunk {n}, k {k}): kernel {big['ms']:.4f} ms "
        f"({100 * big['bound_ms'] / big['ms']:.1f} % of its bound "
        f"{big['bound_ms']:.4f} ms; device {big['dev_ms']:.4f} ms), plain "
        f"(concatenation and stable sort) "
        f"{big['plain_ms']:.4f} ms, torch.topk {big['library_ms']:.4f} ms"
        + other_merge(big) + f" [{card}]")
    share = 100 * tot["bound_ms"] / tot["ms"]
    log(f"[topk] {label}, all {len(calls)} merges, each bitwise equal to the "
        f"plain version: kernel {tot['ms']:.3f} ms ({share:.1f} % of the "
        f"summed bound {tot['bound_ms']:.3f} ms), "
        f"plain {tot['plain_ms']:.3f} ms ({tot['plain_ms'] / tot['ms']:.2f}x),"
        f" torch.topk {tot['library_ms']:.3f} ms; device time over the "
        f"merges (profiler): kernel {dev['kernel']}, plain {dev['plain']}"
        + (f", other tree {dev['other tree']}" if "other tree" in dev
           else "")
        + (f"; against the other tree's merge in turns (bare calls): this "
           f"{tot['turns_ms']:.3f} ms, other {tot['other_ms']:.3f} ms "
           f"({tot['other_ms'] / tot['turns_ms']:.2f}x); {slower} of "
           f"{len(calls)} merges more than 5 % slower, {unequal} with other "
           f"bits" if AGAINST.get("topk_merge") else "") + f" [{card}]")
    stages = {}
    for r in res:
        st = stages.setdefault(r["stage"], [0, 0.0, 0.0])
        st[0] += 1
        st[1] += r["ms"]
        st[2] += r["plain_ms"]
    log(f"[topk] {label}, by engine stage (merges, kernel ms, plain ms): "
        + "; ".join(f"{st} {n}, {a:.3f}, {b:.3f}"
                    for st, (n, a, b) in stages.items()) + f" [{card}]")
    out = {key: big[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by")}
    out["window"] = tot
    TOPK_RECORDS[label] = out
    return out


def counted(fn):
    """(fn(), launches of each kernel while it ran)."""
    before = launch_counts()
    out = fn()
    return out, {k: v - before[k] for k, v in launch_counts().items()}


def check_merges(label: str, n: dict) -> None:
    """A path that ran scan_probe_range merged on the merge kernel: it
    launched, once for every merge index/scan.py made, so none sorted."""
    check(n.get("topk_merge", 0) > 0,
          f"[{label}] the merge kernel never launched: {n}")
    check(n.get("scan_merges", 0) == n.get("topk_merge", 0),
          f"[{label}] {n.get('scan_merges')} merges in index/scan.py, "
          f"{n.get('topk_merge')} launches of the merge kernel")


def serve_window(es, gt_D, card: str, label: str,
                 start: int = N_TRAIN_Q) -> dict:
    """The 1000 held-out queries from ``start`` as one window, escalating
    the multipler if the bound is missed, then the median of warm
    repeats."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.autotune import recall_counts

    def serve():
        ((D_out, I_out), dt), n = counted(
            lambda: synced(lambda: es.search(start, N_TEST_Q)))
        cnt = recall_counts(D_out, gt_D[start:start + N_TEST_Q], K,
                            Metric.L2)
        return D_out, I_out, dt, cnt, n

    D_out, I_out, dt, cnt, n = serve()
    while cnt.min() < K * (1.0 - EPS) and es.multipler < 64.0:
        es.multipler = min(es.multipler * 1.5, 64.0)
        log(f"[{label}] bound violated at min_recall={cnt.min() / K:.3f}; "
            f"escalating multipler to {es.multipler:.2f}")
        D_out, I_out, dt, cnt, n = serve()
    reps = [serve()[2] for _ in range(SEARCH_REPS)]
    dt = float(np.median(reps))
    log(f"[{label}] window times over {SEARCH_REPS} warm repeats: "
        + " ".join(f"{r * 1e3:.2f}" for r in reps) + " ms (median "
        f"{dt * 1e3:.2f} ms)")
    check(D_out.shape == (N_TEST_Q, K) and I_out.shape == (N_TEST_Q, K),
          f"{label}: result shapes {D_out.shape} {I_out.shape}")
    check(np.isfinite(D_out).all() and (I_out >= 0).all(),
          f"{label}: non-finite distances or missing ids")
    min_recall = cnt.min() / K
    check(min_recall >= 1.0 - EPS, f"{label}: worst-case recall {min_recall}")
    nscan = es.n_scanned[start:start + N_TEST_Q]
    log(f"[{label}] {N_TEST_Q} held-out queries: worst recall@{K}="
        f"{min_recall:.3f} mean={cnt.mean() / K:.4f} mean n_scanned="
        f"{nscan.mean():.2f} max={nscan.max()} multipler="
        f"{es.multipler:.3f} std_m={es.std_m} qps={N_TEST_Q / dt:.1f} "
        f"({dt * 1e3:.1f} ms) launches={n} [{card}]")
    return {"seconds": dt, "launches": n, "min_recall": min_recall,
            "mean_n_scanned": float(nscan.mean())}


def serve_batch1(es, n_queries: int, card: str, label: str,
                 start: int = N_TRAIN_Q) -> dict:
    """Each of the first ``n_queries`` held-out queries (from ``start``)
    alone."""
    lat = []
    total = {}
    for i in range(n_queries):
        ((Dq, _), t), n = counted(
            lambda: synced(lambda: es.search(start + i, 1)))
        for k, v in n.items():
            total[k] = total.get(k, 0) + v
        check(Dq.shape == (1, K) and np.isfinite(Dq).all(),
              f"{label}: batch-1 result of query {start + i}")
        lat.append(t * 1e3)
    lat = np.asarray(lat)
    log(f"[{label}] batch-1 over {n_queries} held-out queries: p50="
        f"{np.percentile(lat, 50):.2f} ms p90={np.percentile(lat, 90):.2f} "
        f"ms p99={np.percentile(lat, 99):.2f} ms max={lat.max():.2f} ms "
        f"mean={lat.mean():.2f} ms mean n_scanned="
        f"{es.n_scanned[start:start + n_queries].mean():.2f} "
        f"launches={total} [{card}]")
    return total


def build_corpus(card: str) -> dict:
    """The benchmark configuration's data, index (on the entry points'
    default device, the card) and value-consistent ground truth."""
    from auncel_tpu_torch import IVFFlatIndex
    from auncel_tpu_torch.data import make_clustered_dataset

    t0 = time.perf_counter()
    ds = make_clustered_dataset(nb=NB, nq=N_TRAIN_Q + N_TEST_Q, d=D,
                                n_clusters=1024, cluster_std=0.22,
                                query_mode="perturb", seed=42)
    xb, xq = ds.xb, ds.xq
    log(f"[data] {NB}x{D} corpus, {xq.shape[0]} queries in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    times = {}
    idx = IVFFlatIndex(D, NLIST)
    check(idx.device.type == "cuda", f"default device {idx.device}")
    _, times["train"] = synced(lambda: idx.train(xb[:400_000]))
    _, times["add+pack"] = synced(lambda: (idx.add(xb), idx.arrays))
    mr, times["multirow"] = synced(lambda: idx.enable_multirow())
    a = idx.arrays
    log(f"[index] cap={a.cap} packing={idx.packing_efficiency:.3f} rows="
        f"{mr.rows.db.shape[0]}x{mr.rows.db.shape[1]} device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    (gt_D, gt_I), times["exact_search"] = synced(
        lambda: idx.exact_search(xq, MAX_TOPK, batch=N_TRAIN_Q))
    return dict(idx=idx, xb=xb, xq=xq, gt_D=gt_D, gt_I=gt_I, times=times)


def multirow_path(c: dict, card: str, profile_dir: str | None) -> dict:
    """Profile-train, calibrate and serve on the multi-row layout. Returns
    each kernel's launches over the path."""
    from auncel_tpu_torch import ErrorSys

    idx, xq, gt_D, times = c["idx"], c["xq"], c["gt_D"], c["times"]
    reset_counts()
    es = ErrorSys(idx, train_num=N_TRAIN_Q + N_TEST_Q, max_topk=MAX_TOPK)
    es.set_gt(gt_D, c["gt_I"])
    (_, times["sys_train"]), train = counted(
        lambda: synced(lambda: es.sys_train(N_TRAIN_Q, xq)))
    es.set_topk(K)
    acc = np.full(N_TRAIN_Q + N_TEST_Q, 1.0 - EPS, np.float32)
    es.set_queries(N_TEST_Q, xq, acc)
    log(f"[calibrate] std_m grid {STD_M_GRID}")
    mult, times["calibrate"] = synced(
        lambda: es.calibrate(0, N_TRAIN_Q, target_bound=1.0 - EPS,
                             std_m_grid=STD_M_GRID))
    route = ("the whole window dense"
             if es._mr_oneshot_plan(N_TEST_Q).dense_cut_rows == 0
             else "per-query crossover")
    log(f"[calibrate] multipler={mult:.3f} std_m={es.std_m} _cal_mean_scan="
        f"{es._cal_mean_scan:.3f} _dense_min_bsz={es._dense_min_bsz}: a "
        f"{N_TEST_Q}-query window takes the one-shot engine, {route}")
    window = serve_window(es, gt_D, card, "search")
    times["search"] = window["seconds"]
    lat = serve_batch1(es, N_LATENCY, card, "latency")
    gather = oneshot_phase(es, gt_D, card, profile_dir)
    strict_phase(es, card, profile_dir)
    dense_decide_phase(es, gt_D, gather["n_scanned"], card)
    profile_mode_phase(es, card)
    stream_phase(es, card)
    time_mode_phase(es, card)
    launches = launch_counts()
    log("[stages] " + " ".join(f"{k}={v:.2f}s" for k, v in times.items())
        + f" [{card}]")
    log(f"[multirow] launches over the path: {launches}, profile training "
        f"{train}")
    check(train["scan_scores"] > 0, "profile training never launched K2")
    check(window["launches"]["rowscan_scores"] > 0
          and lat.get("rowscan_scores", 0) > 0, "search never launched K1")
    check(launches["rowscan_dots"] == 0,
          "the multi-row path launched rowscan_dots")
    check(lat.get("decide_step", 0) > 0,
          "batch-1 search never launched the decision kernel")
    for part in (train, window["launches"], lat):
        check_merges("multirow", part)
    if profile_dir:
        profile_search(es, profile_dir, card, "multirow")
    return launches


def padded_path(c: dict, card: str, profile_dir: str | None) -> dict:
    """The same corpus served by the padded engines: an index on the same
    centroids and padded arrays (shared device tensors) without the
    multi-row layout, its own profile training and calibration, one
    two-phase window, batch-1 windows and a strict window whose stragglers
    take phase B."""
    from auncel_tpu_torch import ErrorSys, IVFFlatIndex

    idx, xq, gt_D = c["idx"], c["xq"], c["gt_D"]
    pidx = IVFFlatIndex.from_state(idx.centroids, idx.arrays)
    check(pidx.multirow is None and pidx.arrays.db is idx.arrays.db,
          "padded index shares the arrays, without multi-row")
    times = {}
    reset_counts()
    es = ErrorSys(pidx, train_num=N_TRAIN_Q + N_TEST_Q, max_topk=MAX_TOPK)
    es.set_gt(gt_D, c["gt_I"])
    (_, times["sys_train"]), train = counted(
        lambda: synced(lambda: es.sys_train(N_TRAIN_Q, xq)))
    es.set_topk(K)
    es.set_queries(N_TEST_Q, xq,
                   np.full(N_TRAIN_Q + N_TEST_Q, 1.0 - EPS, np.float32))
    mult, times["calibrate"] = synced(
        lambda: es.calibrate(0, N_TRAIN_Q, target_bound=1.0 - EPS))
    log(f"[padded] calibrate: multipler={mult:.3f} std_m={es.std_m} "
        f"(default std_m grid)")
    window = serve_window(es, gt_D, card, "padded")
    times["search"] = window["seconds"]
    lat = serve_batch1(es, N_LATENCY_PADDED, card, "padded latency")
    phase_b(es, gt_D, card, profile_dir)
    padded_time_mode(es, card)
    launches = launch_counts()
    log("[padded stages] " + " ".join(f"{k}={v:.2f}s"
                                      for k, v in times.items())
        + f" [{card}]")
    log(f"[padded] launches over the path: {launches}, profile training "
        f"{train}")
    check(train["scan_scores"] > 0, "padded profile training never "
          "launched K2")
    check(window["launches"]["scan_scores"] > 0,
          "the two-phase window never launched K2")
    check(lat.get("scan_scores", 0) > 0, "batch-1 never launched K2")
    for part in (train, window["launches"], lat):
        check_merges("padded", part)
    check(launches["rowscan_scores"] == 0 and launches["rowscan_dots"] == 0,
          "the padded path launched K1")
    if profile_dir:
        profile_search(es, profile_dir, card, "padded")
    return launches, es


def phase_b(es, gt_D, card: str, profile_dir: str | None = None) -> dict:
    """The two-phase path with stragglers, against single-phase
    ``bounded_search`` on the same window. Every held-out query's bound is
    raised to recall@10 = 1.0, so that queries still undecided near nlist/8
    (and, if there are none, late deciders at a doubled multipler) take
    ``finish_scan``. Both engines must give the same ids, distances and
    n_scanned; each is timed, median of warm repeats taken in turns."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.autotune import recall_counts
    from auncel_tpu_torch.profile.bounded import bounded_search

    idx = es.index
    nlist, dev = idx.nlist, idx.device
    saved = (es.require_acc, es.multipler)
    win = slice(N_TRAIN_Q, N_TRAIN_Q + N_TEST_Q)
    acc = np.full(N_TRAIN_Q + N_TEST_Q, 1.0, np.float32)
    es.set_queries(es.num, es.queries, acc)

    def two():
        return es.search(N_TRAIN_Q, N_TEST_Q)

    while True:
        (D2, I2), n2 = counted(two)
        ns2 = es.n_scanned[win].copy()
        stragglers = int((ns2 > nlist // 8).sum())
        if stragglers or es.multipler >= 64.0:
            break
        es.multipler = min(es.multipler * 2.0, 64.0)
    check(stragglers > 0, "no query of the strict window reached phase B")
    f32 = torch.float32
    q = torch.as_tensor(es.queries[win], device=dev)
    acc_t = torch.as_tensor(acc[win], device=dev)
    m = torch.tensor(es.multipler, dtype=f32, device=dev)
    sm = torch.tensor(es.std_m, dtype=f32, device=dev)
    margin = es._decide_margin_flag()

    def single():
        vals, ids, _, ns, _ = bounded_search(
            idx.arrays, es.traces, q, acc_t, m, sm,
            torch.zeros(N_TEST_Q, device=dev), K, MAX_TOPK, idx.metric,
            decide_margin=margin)
        return (vals[:, :K].cpu().numpy(), ids[:, :K].cpu().numpy(),
                ns.cpu().numpy())

    (D1, I1, ns1), n1 = counted(single)
    bad_ids = int((I1 != I2).any(axis=1).sum())
    bad_ns = int((ns1 != ns2).sum())
    d_err = float(np.abs(D1 - D2).max())
    t_one, t_two = [], []
    for _ in range(3):
        t_one.append(synced(single)[1])
        t_two.append(synced(two)[1])
        t_two.append(synced(two)[1])
        t_one.append(synced(single)[1])
    cnt = recall_counts(D2, gt_D[win], K, Metric.L2)
    ms_one, ms_two = np.median(t_one) * 1e3, np.median(t_two) * 1e3
    log(f"[phase B] bound 1.0 at multipler {es.multipler:.3f}: "
        f"{stragglers} of {N_TEST_Q} queries past nlist/8, mean n_scanned "
        f"{ns2.mean():.2f} max {ns2.max()}; worst recall@{K} "
        f"{cnt.min() / K:.3f} mean {cnt.mean() / K:.4f}; two-phase "
        f"{ms_two:.2f} ms ({' '.join(f'{t * 1e3:.2f}' for t in t_two)}), "
        f"single-phase {ms_one:.2f} ms "
        f"({' '.join(f'{t * 1e3:.2f}' for t in t_one)}); launches two-phase "
        f"{n2}, single-phase {n1}; queries whose ids differ {bad_ids}, "
        f"n_scanned differ {bad_ns}, max |D| diff {d_err:.3g} [{card}]")
    check(bad_ids == 0 and bad_ns == 0 and d_err == 0.0,
          "two-phase and single-phase windows differ")
    if profile_dir:
        profile_call(two, profile_dir, card, "phase B two-phase")
        profile_call(single, profile_dir, card, "phase B single-phase")
    es.set_queries(es.num, es.queries, saved[0])
    es.multipler = saved[1]
    return {"two_ms": ms_two, "single_ms": ms_one, "stragglers": stragglers}


@contextlib.contextmanager
def ondisk_split(od):
    """Record how an OnDiskIVFIndex's searches inside the block spend their
    time: a list with one entry a paging (distinct lists, bytes paged,
    host ms to page them into pinned memory, the upload's CUDA events) and
    the CUDA events around each device scan (the decision phase, phase B,
    a fixed-nprobe scan), with the K2 launches of each."""
    import auncel_tpu_torch.index.ondisk as ondisk
    pages, scans = [], []

    def page(uniq):
        t0 = time.perf_counter()
        host = type(od)._page(od, uniq)
        pages.append({"lists": int(uniq.size),
                      "bytes": sum(t.numel() * t.element_size()
                                   for t in host),
                      "page_ms": (time.perf_counter() - t0) * 1e3})
        return host

    def events(fn, kind):
        def run(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out, n = counted(lambda: fn(*args, **kw))
            e1.record()
            if kind == "upload":
                pages[-1]["events"] = (e0, e1)
            else:
                scans.append({"kind": kind, "events": (e0, e1),
                              "launches": n["scan_scores"]})
            return out
        return run

    decide = ondisk.bounded_search_decide_ranked
    od._page = page
    od._upload = events(lambda host: type(od)._upload(od, host), "upload")
    od._scan_uploaded = events(
        lambda *a: type(od)._scan_uploaded(od, *a), "fixed")
    od._finish_uploaded = events(
        lambda *a: type(od)._finish_uploaded(od, *a), "phase B")
    ondisk.bounded_search_decide_ranked = events(decide, "phase A")
    try:
        yield pages, scans
    finally:
        ondisk.bounded_search_decide_ranked = decide
        for name in ("_page", "_upload", "_scan_uploaded",
                     "_finish_uploaded"):
            delattr(od, name)


def split_ms(pages, scans) -> dict:
    """Sums of one search's split (after a synchronise): host ms to page,
    upload ms and device scan ms (CUDA events)."""
    torch.cuda.synchronize()
    return {"page": sum(p["page_ms"] for p in pages),
            "upload": sum(p["events"][0].elapsed_time(p["events"][1])
                          for p in pages),
            "device": sum(s["events"][0].elapsed_time(s["events"][1])
                          for s in scans)}


def timed_searches(od, fn, reps: int = SEARCH_REPS) -> tuple:
    """fn once to warm, then ``reps`` timed runs: (the last run's pages
    and scans, the median of each split and of the wall time, ms)."""
    fn()
    rows = []
    for _ in range(reps):
        with ondisk_split(od) as (pages, scans):
            _, dt = synced(fn)
        rows.append({**split_ms(pages, scans), "wall": dt * 1e3})
    med = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
    return pages, scans, med


def ondisk_phase(es, c: dict, card: str) -> dict:
    """[ondisk]: the padded path's index written to a temporary directory
    and served from it by OnDiskIVFIndex, fixed-nprobe against the
    resident search and bounded against the resident padded engine; then
    [range] and [shards] on the resident index. Returns K2's numbers at
    the nprobe-32 search's block batch and the on-disk phases' launches."""
    import os
    import shutil
    import tempfile
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.autotune import recall_counts
    from auncel_tpu_torch.index.io import save_index_ondisk
    from auncel_tpu_torch.index.ondisk import OnDiskIVFIndex
    from auncel_tpu_torch.profile.bounded import bounded_search

    pidx, win = es.index, held_out()
    q = c["xq"][win]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ondisk_")
    try:
        path = os.path.join(tmp, "ivf")
        _, t_save = synced(lambda: save_index_ondisk(pidx, path))
        n_bytes = sum(os.path.getsize(os.path.join(path, f))
                      for f in os.listdir(path))
        log(f"[ondisk] save: {n_bytes} bytes ({n_bytes / 2**30:.3f} GiB) "
            f"in {t_save:.2f} s; the files are in the page cache, so the "
            f"paging times below read memory, not the drive [{card}]")
        od = OnDiskIVFIndex(path)
        check(od.device.type == "cuda", f"on-disk device {od.device}")
        reset_counts()
        calls = None
        for nprobe in (8, 32):
            with uncounted():
                (D_r, I_r), n_res = counted(
                    lambda: pidx.search(q, K, nprobe=nprobe))
            if nprobe == 32:
                calls = record_row_scans(
                    lambda: od.search(q, K, nprobe=nprobe), "scan_scores")
            (D_o, I_o), n = counted(lambda: od.search(q, K, nprobe=nprobe))
            pages, scans, med = timed_searches(
                od, lambda: od.search(q, K, nprobe=nprobe))
            bad = int((I_o != I_r).any(axis=1).sum())
            rel = float(np.max(np.abs(D_o - D_r)
                               / np.maximum(np.abs(D_r), 1e-30)))
            log(f"[ondisk fixed] nprobe {nprobe}, {N_TEST_Q} queries, k "
                f"{K}: queries whose ids differ from the resident search "
                f"{bad}, max rel |D| diff {rel:.3g}; paged "
                f"{pages[0]['lists']} distinct lists, {pages[0]['bytes']} "
                f"bytes; medians of {SEARCH_REPS}: page {med['page']:.2f} "
                f"ms (host, from the page cache), upload "
                f"{med['upload']:.2f} ms, device {med['device']:.2f} ms "
                f"(CUDA events), wall {med['wall']:.2f} ms; resident "
                f"search launches {n_res}, on-disk {n} [{card}]")
            check(bad == 0 and rel <= 1e-5,
                  f"[ondisk fixed] nprobe {nprobe} differs from resident")
            check(n["scan_scores"] > 0, f"[ondisk fixed] launches {n}")
            check_merges("ondisk fixed", n)

        acc = np.full(N_TEST_Q, 1.0 - EPS, np.float32)
        od.attach_profile(es.traces, es.multipler, es.std_m, MAX_TOPK)
        f32, dev = torch.float32, pidx.device

        def resident(acc=acc, mult=es.multipler):
            vals, ids, _, ns, _ = bounded_search(
                pidx.arrays, es.traces, torch.as_tensor(q, device=dev),
                torch.as_tensor(acc, device=dev),
                torch.tensor(mult, dtype=f32, device=dev),
                torch.tensor(es.std_m, dtype=f32, device=dev),
                torch.zeros(N_TEST_Q, device=dev), K, MAX_TOPK, Metric.L2)
            return (vals[:, :K].cpu().numpy(), ids[:, :K].cpu().numpy(),
                    ns.cpu().numpy())
        with uncounted():
            D_r, I_r, ns_r = resident()
        with ondisk_split(od) as (pages, scans):
            (D_o, I_o, ns_o), n = counted(
                lambda: od.search_bounded(q, acc, K))
        torch.cuda.synchronize()
        by_kind = {s["kind"]: s["launches"] for s in scans}
        _, _, med = timed_searches(od, lambda: od.search_bounded(q, acc, K))
        cnt = recall_counts(D_o, c["gt_D"][win], K, Metric.L2)
        past = int((ns_o > NLIST // 8).sum())
        bad = int((I_o != I_r).any(axis=1).sum())
        bad_ns = int((ns_o != ns_r).sum())
        log(f"[ondisk bounded] bound {1.0 - EPS} at multipler "
            f"{es.multipler:.3f} std_m {es.std_m}: worst recall@{K} "
            f"{cnt.min() / K:.3f} mean {cnt.mean() / K:.4f}, mean n_scanned "
            f"{ns_o.mean():.2f} max {ns_o.max()}, {past} queries past "
            f"nlist/8; against the resident padded engine: ids differ "
            f"{bad}, n_scanned differ {bad_ns}, max |D| diff "
            f"{float(np.abs(D_o - D_r).max()):.3g}; paged a phase: "
            + ", ".join(f"{p['lists']} lists {p['bytes']} bytes"
                        for p in pages)
            + f"; window medians of {SEARCH_REPS}: wall {med['wall']:.2f} "
            f"ms, page {med['page']:.2f} ms (host, from the page cache), "
            f"upload {med['upload']:.2f} ms, device {med['device']:.2f} ms "
            f"(CUDA events); K2 launches by phase {by_kind} [{card}]")
        check(bad == 0 and bad_ns == 0,
              "[ondisk bounded] differs from the resident padded engine")
        check(cnt.min() >= K * (1.0 - EPS),
              f"[ondisk bounded] worst recall {cnt.min() / K}")
        check(by_kind.get("phase A", 0) > 0
              and (past == 0 or by_kind.get("phase B", 0) > 0),
              f"[ondisk bounded] K2 launches by phase {by_kind}")
        ondisk_strict(od, es, q, resident, card)
        launches = launch_counts()
        del od
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # every chunk of the nprobe-32 search reads its one batch of blocks,
    # the phase's largest but phase A's (one list more)
    _, args, metric, _ = calls[0]
    with uncounted():
        k2 = k2_compare(
            f"on-disk block batch ({args[0].shape[0]} blocks, nprobe 32)",
            args, metric, card, reps=10, terms_tol=True, label="k2 ondisk")
    del calls, args
    torch.cuda.empty_cache()
    range_phase(pidx, c, card)
    shards_phase(pidx, c, card)
    return {"kernels": k2, "launches": launches}


def ondisk_strict(od, es, q, resident, card: str) -> None:
    """[ondisk strict]: bound 1.0, the multipler doubled (as [phase B]
    does) until a query passes nlist/8, so that phase B pages and scans
    on the card; ids and n_scanned against the resident padded engine."""
    acc = np.ones(N_TEST_Q, np.float32)
    mult = es.multipler
    while True:
        od.multipler = mult
        with ondisk_split(od) as (pages, scans):
            (D_o, I_o, ns_o), n = counted(
                lambda: od.search_bounded(q, acc, K))
        torch.cuda.synchronize()
        past = int((ns_o > NLIST // 8).sum())
        if past or mult >= 64.0:
            break
        mult = min(mult * 2.0, 64.0)
    by_kind = {s["kind"]: s["launches"] for s in scans}
    _, _, med = timed_searches(od, lambda: od.search_bounded(q, acc, K))
    with uncounted():
        D_r, I_r, ns_r = resident(acc, mult)
    od.multipler = es.multipler
    bad = int((I_o != I_r).any(axis=1).sum())
    bad_ns = int((ns_o != ns_r).sum())
    log(f"[ondisk strict] bound 1.0 at multipler {mult:.3f}: {past} queries "
        f"past nlist/8, mean n_scanned {ns_o.mean():.2f} max {ns_o.max()}; "
        f"against the resident padded engine: ids differ {bad}, n_scanned "
        f"differ {bad_ns}, max |D| diff {float(np.abs(D_o - D_r).max()):.3g};"
        f" paged a phase: "
        + ", ".join(f"{p['lists']} lists {p['bytes']} bytes" for p in pages)
        + f"; window medians of {SEARCH_REPS}: wall {med['wall']:.2f} ms, "
        f"page {med['page']:.2f} ms (host, from the page cache), upload "
        f"{med['upload']:.2f} ms, device {med['device']:.2f} ms (CUDA "
        f"events); K2 launches by phase {by_kind} [{card}]")
    check(past > 0, "[ondisk strict] no query passed nlist/8")
    check(bad == 0 and bad_ns == 0,
          "[ondisk strict] differs from the resident padded engine")
    check(by_kind.get("phase B", 0) > 0,
          f"[ondisk strict] K2 launches by phase {by_kind}")


def range_phase(pidx, c: dict, card: str) -> None:
    """[range]: range_search on the resident index at nprobe 32, radius the
    median 10th true distance of the held-out queries, with K2 and with
    its plain version in K2's place."""
    import auncel_tpu_torch.index.aux as aux
    from auncel_tpu_torch.kernels.scan_scores import scan_scores_ref

    win = held_out()
    q = c["xq"][win]
    radius = float(np.median(c["gt_D"][win, K - 1]))
    (res, t_k), n = counted(
        lambda: synced(lambda: aux.range_search(pidx, q, radius, nprobe=32)))
    reps = [synced(lambda: aux.range_search(pidx, q, radius, nprobe=32))[1]
            for _ in range(3)]
    calls = record_row_scans(
        lambda: aux.range_search(pidx, q, radius, nprobe=32), "scan_scores",
        module=aux)
    real = aux.scan_scores
    aux.scan_scores = scan_scores_ref
    try:
        want, t_ref = synced(
            lambda: aux.range_search(pidx, q, radius, nprobe=32))
    finally:
        aux.scan_scores = real
    same = (np.array_equal(res.lims, want.lims)
            and np.array_equal(res.labels, want.labels))
    # the kernel is held to 1e-5 of each hit's terms q_sq + db_sq (scores
    # of SIFT scale cancel), so a hit that close to the radius may fall on
    # either side of it in the two versions; every other hit must agree
    a = pidx.arrays
    norm = np.zeros(int(a.vec_ids.max()) + 1, np.float32)
    live = a.vec_ids >= 0
    norm[a.vec_ids[live].cpu().numpy()] = a.db_sq[live].cpu().numpy()
    q_sq = (q * q).sum(1)

    def hits(r):
        qi = np.repeat(np.arange(N_TEST_Q), np.diff(r.lims))
        return {(int(i), int(lab)): float(d)
                for i, lab, d in zip(qi, r.labels, r.distances)}

    def tol(key):
        return 1e-5 * float(q_sq[key[0]] + norm[key[1]]) + 1e-5
    got, ref = hits(res), hits(want)
    common = got.keys() & ref.keys()
    one_side = [(key, got.get(key, ref.get(key)))
                for key in got.keys() ^ ref.keys()]
    diff = max((abs(got[key] - ref[key]) for key in common), default=0.0)
    vals_ok = all(abs(got[key] - ref[key]) <= tol(key) for key in common)
    edge_ok = all(abs(v - radius) <= tol(key) for key, v in one_side)
    log(f"[range] nprobe 32, radius {radius:.4g} (median 10th true "
        f"distance), {N_TEST_Q} queries: {res.lims[-1]} results (mean "
        f"{res.lims[-1] / N_TEST_Q:.1f} a query); {t_k * 1e3:.1f} ms, "
        f"warm {' '.join(f'{t * 1e3:.1f}' for t in reps)} ms; K2 launches "
        f"{n['scan_scores']} over {len(calls)} chunk calls; plain version "
        f"{t_ref * 1e3:.1f} ms ({want.lims[-1]} results); lims and labels "
        f"equal {same}; {len(one_side)} hits in one version only, each "
        f"within 1e-5 of q_sq + db_sq of the radius {edge_ok}; the "
        f"{len(common)} common hits' max |dist| diff {diff:.3g}, within "
        f"1e-5 of q_sq + db_sq {vals_ok} [{card}]")
    check(vals_ok and edge_ok, "[range] K2 and its plain version differ")
    check(n["scan_scores"] > 0, f"[range] launches {n}")
    with uncounted():
        k2_compare(f"range_search chunk (B x n_slots "
                   f"{tuple(calls[0][1][6].shape)})", calls[0][1],
                   calls[0][2], card, reps=10, terms_tol=True,
                   label="k2 range")
    del calls
    torch.cuda.empty_cache()


def shards_phase(pidx, c: dict, card: str) -> None:
    """[shards]: the resident index split in two by id range with
    ivflib.copy_subset_to over the shared centroids, served as an
    IndexShards at nprobe 32 against the whole index."""
    from auncel_tpu_torch import IVFFlatIndex
    from auncel_tpu_torch.index.ivflib import copy_subset_to
    from auncel_tpu_torch.index.meta import IndexShards

    win = held_out()
    q = c["xq"][win]
    shards = IndexShards(D)
    t0 = time.perf_counter()
    for lo, hi in ((0, NB // 2), (NB // 2, NB)):
        half = IVFFlatIndex(D, NLIST)
        half.set_centroids(pidx.centroids)
        copy_subset_to(pidx, half, lo, hi)
        half.nprobe = 32
        shards.add_shard(half)
    t_split = time.perf_counter() - t0
    check(shards.ntotal == pidx.ntotal, "[shards] halves lost vectors")
    D_w, I_w = pidx.search(q, K + 1, nprobe=32)
    (D_s, I_s), n = counted(lambda: shards.search(q, K))
    reps = [synced(lambda: shards.search(q, K))[1] for _ in range(3)]
    close = np.abs(D_s - D_w[:, :K]) <= 1e-5 * np.abs(D_w[:, :K]) + 1e-5
    sep = D_w[:, K - 1] != D_w[:, K]
    bad = int(sum(set(I_s[i]) != set(I_w[i, :K])
                  for i in np.where(sep)[0]))
    log(f"[shards] 2 shards (ids [0, {NB // 2}) and [{NB // 2}, {NB})), "
        f"split in {t_split:.2f} s, nprobe 32, {N_TEST_Q} queries: values "
        f"within 1e-5 of the whole index's {bool(close.all())}, queries "
        f"whose id sets differ {bad} of {int(sep.sum())} with distinct "
        f"10th and 11th values; warm "
        f"{' '.join(f'{t * 1e3:.1f}' for t in reps)} ms; launches {n} "
        f"[{card}]")
    check(close.all() and bad == 0, "[shards] differs from the whole index")
    check(n["scan_scores"] > 0, f"[shards] launches {n}")
    check_merges("shards", n)


def held_out() -> slice:
    return slice(N_TRAIN_Q, N_TRAIN_Q + N_TEST_Q)


def in_turns(a, b, turns: int) -> tuple:
    """Median ms of a and of b over calls in turns a, b, b, a, and the
    times themselves."""
    ta, tb = [], []
    for _ in range(turns):
        ta.append(synced(a)[1])
        tb.append(synced(b)[1])
        tb.append(synced(b)[1])
        ta.append(synced(a)[1])
    return (float(np.median(ta)) * 1e3, float(np.median(tb)) * 1e3,
            " ".join(f"{t * 1e3:.2f}" for t in ta),
            " ".join(f"{t * 1e3:.2f}" for t in tb))


def oneshot_route(es):
    """The held-out window through es.search: (D, I, n_scanned)."""
    D, I = es.search(N_TRAIN_Q, N_TEST_Q)
    return D, I, es.n_scanned[held_out()].copy()


def wave_route(es):
    """The held-out window through the single-phase wave engine under
    ``plan_mr_waves`` (the port's route for such windows before the
    one-shot engine), at es's bounds and hyperparameters."""
    from auncel_tpu_torch.profile.bounded_mr import (
        bounded_search_mr, plan_mr_waves)
    idx = es.index
    dev = idx.device
    mr = idx.multirow
    plan = plan_mr_waves(mr.rows_per_list.cpu().numpy(), idx.nlist,
                         decide_only=False)
    q = torch.as_tensor(es.queries[held_out()], device=dev)
    acc = torch.as_tensor(es.require_acc[held_out()], device=dev)
    m = torch.tensor(es.multipler, dtype=torch.float32, device=dev)
    sm = torch.tensor(es.std_m, dtype=torch.float32, device=dev)
    z = torch.zeros(N_TEST_Q, dtype=torch.float32, device=dev)
    margin = es._decide_margin_flag()

    def run():
        vals, ids, _, ns, _ = bounded_search_mr(
            idx.arrays, mr, es.traces, q, acc, m, sm, z, K, MAX_TOPK,
            idx.metric, plan, False, margin)
        return (vals[:, :K].cpu().numpy(), ids[:, :K].cpu().numpy(),
                ns.cpu().numpy())
    return run


def differ(a, b) -> tuple:
    """(queries whose ids differ, n_scanned that differ, max |D| diff)."""
    return (int((a[1] != b[1]).any(axis=1).sum()), int((a[2] != b[2]).sum()),
            float(np.abs(a[0] - b[0]).max()))


def oneshot_phase(es, gt_D, card: str, profile_dir: str | None) -> dict:
    """[oneshot]: the 0.9 window through es.search (the one-shot engine,
    gather route) against the wave engine: equal ids, n_scanned and
    distances (both scan with K1, whose dots do not depend on the batch),
    each timed in turns."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.autotune import recall_counts
    saved = es.dense_auto
    es.dense_auto = False   # per-query routing: every 0.9 budget gathers
    one, n1 = counted(lambda: oneshot_route(es))
    wave = wave_route(es)
    two, n2 = counted(wave)
    bad = differ(one, two)
    ms_one, ms_wave, t_one, t_wave = in_turns(lambda: oneshot_route(es),
                                              wave, 3)
    cnt = recall_counts(one[0], gt_D[held_out()], K, Metric.L2)
    log(f"[oneshot] bound 0.9, multipler {es.multipler:.3f}: worst "
        f"recall@{K} {cnt.min() / K:.3f} mean n_scanned {one[2].mean():.2f} "
        f"max {one[2].max()}; one-shot {ms_one:.2f} ms ({t_one}), wave "
        f"engine {ms_wave:.2f} ms ({t_wave}); launches one-shot {n1}, wave "
        f"{n2}; queries whose ids differ {bad[0]}, n_scanned differ {bad[1]},"
        f" max |D| diff {bad[2]:.3g} [{card}]")
    check(bad == (0, 0, 0.0), "one-shot and wave engine differ at 0.9")
    check(cnt.min() >= K * (1.0 - EPS), "one-shot window misses the bound")
    if profile_dir:
        profile_call(lambda: oneshot_route(es), profile_dir, card,
                     "oneshot window")
        profile_call(wave, profile_dir, card, "wave window")
    calls = record_row_scans(lambda: oneshot_route(es))
    with uncounted():
        k1_recorded("0.9 window", calls, card)
        against_dots_route("oneshot", lambda: oneshot_route(es), card)
    del calls
    topk_recorded("1M 0.9 window", record_merges(lambda: oneshot_route(es)),
                  card)
    es.dense_auto = saved
    return {"oneshot_ms": ms_one, "wave_ms": ms_wave, "n_scanned": one[2]}


def result_norms(idx) -> torch.Tensor:
    """Stored squared norm of every vector, by id."""
    a = idx.arrays
    live = a.vec_ids >= 0
    norms = torch.zeros(idx.ntotal, dtype=torch.float32, device=idx.device)
    norms[a.vec_ids[live].long()] = a.db_sq[live]
    return norms


def strict_phase(es, card: str, profile_dir: str | None) -> dict:
    """[oneshot strict]: the held-out queries at bound 1.0, the multipler
    doubled until some budget passes nlist/8. One-shot (gather route)
    against the wave engine: equal results. Then the default per-query
    crossover (budgets over dense_cut of the rows dense) and every query
    dense, against gather: equal n_scanned, distances within 1e-5 of
    q_sq + db_sq, ids differing only where the two distances lie within
    that tolerance."""
    idx = es.index
    nlist = idx.nlist
    saved = (es.require_acc, es.multipler, es.dense_cut, es.dense_auto)
    es.set_queries(es.num, es.queries,
                   np.full(N_TRAIN_Q + N_TEST_Q, 1.0, np.float32))
    es.dense_cut, es.dense_auto = None, False   # gather only
    while True:
        one, n1 = counted(lambda: oneshot_route(es))
        stragglers = int((one[2] > nlist // 8).sum())
        if stragglers or es.multipler >= 64.0:
            break
        es.multipler = min(es.multipler * 2.0, 64.0)
    check(stragglers > 0, "no query of the strict window passed nlist/8")
    wave = wave_route(es)
    two, n2 = counted(wave)
    bad = differ(one, two)
    ms_one, ms_wave, t_one, t_wave = in_turns(lambda: oneshot_route(es),
                                              wave, 2)
    log(f"[oneshot strict] bound 1.0 at multipler {es.multipler:.3f}: "
        f"{stragglers} of {N_TEST_Q} queries past nlist/8, mean n_scanned "
        f"{one[2].mean():.2f} max {one[2].max()}; one-shot (gather) "
        f"{ms_one:.2f} ms ({t_one}), wave engine {ms_wave:.2f} ms ({t_wave});"
        f" launches one-shot {n1}, wave {n2}; queries whose ids differ "
        f"{bad[0]}, n_scanned differ {bad[1]}, max |D| diff {bad[2]:.3g} "
        f"[{card}]")
    check(bad == (0, 0, 0.0), "one-shot and wave engine differ at 1.0")
    if profile_dir:
        profile_call(lambda: oneshot_route(es), profile_dir, card,
                     "strict oneshot")
        profile_call(wave, profile_dir, card, "strict wave")
    calls = record_row_scans(lambda: oneshot_route(es))
    with uncounted():
        rec = k1_recorded("strict window", calls, card)
        against_dots_route("oneshot strict", lambda: oneshot_route(es), card)
        if profile_dir:
            profile_call(on_dots_route(lambda: oneshot_route(es)),
                         profile_dir, card, "strict oneshot, dots route")
    q = torch.as_tensor(es.queries[held_out()], device=idx.device)
    q_sq = (q * q).sum(1).cpu().numpy()
    norms = result_norms(idx)
    out = {"gather_ms": ms_one, "wave_ms": ms_wave,
           "stragglers": stragglers, "k1": rec}
    def routed(cut):
        def run():
            es.dense_cut = cut
            return oneshot_route(es)
        return run

    for label, cut in (("crossover 0.25", 0.25), ("all dense", 0.0)):
        dense, nd = counted(routed(cut))
        ms_d, ms_g, t_d, t_g = in_turns(routed(cut), routed(None), 2)
        terms = q_sq[:, None] + np.maximum(
            norms[torch.as_tensor(one[1], device=idx.device)].cpu().numpy(),
            norms[torch.as_tensor(dense[1], device=idx.device)].cpu().numpy())
        diff = np.abs(dense[0] - one[0])
        within = bool((diff <= 1e-5 * terms).all())
        ids_differ = int((dense[1] != one[1]).sum())
        log(f"[oneshot strict] {label}: {ms_d:.2f} ms ({t_d}) against "
            f"gather {ms_g:.2f} ms ({t_g}); launches {nd}; n_scanned differ "
            f"{int((dense[2] != one[2]).sum())}; max |D| diff "
            f"{diff.max():.3g} (largest 1e-5 (q_sq + db_sq) "
            f"{1e-5 * terms.max():.3g}); id positions that differ "
            f"{ids_differ} [{card}]")
        check(np.array_equal(dense[2], one[2]), f"{label}: n_scanned differ")
        check(within, f"{label}: distances beyond 1e-5 of q_sq + db_sq")
        out[label] = ms_d
    es.set_queries(es.num, es.queries, saved[0])
    es.multipler, es.dense_cut, es.dense_auto = saved[1:]
    return out


def dense_decide_phase(es, gt_D, gather_ns, card: str) -> None:
    """[dense decide]: the 0.9 window with the decision ladder replayed
    from one shared corpus pass, against the gather decisions."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.autotune import recall_counts
    saved = es.dense_auto
    es.dense_auto, es.dense_decide = False, True
    (D, _, ns), n = counted(lambda: oneshot_route(es))
    ms = float(np.median([synced(lambda: oneshot_route(es))[1]
                          for _ in range(3)])) * 1e3
    es.dense_decide, es.dense_auto = False, saved
    cnt = recall_counts(D, gt_D[held_out()], K, Metric.L2)
    log(f"[dense decide] bound 0.9: {int((ns != gather_ns).sum())} of "
        f"{N_TEST_Q} decisions differ from the gather route; worst recall@"
        f"{K} {cnt.min() / K:.3f}; mean n_scanned {ns.mean():.2f}; {ms:.2f} "
        f"ms median of 3; launches {n} [{card}]")
    check(cnt.min() >= K * (1.0 - EPS), "dense decide misses the bound")


def profile_mode_phase(es, card: str) -> None:
    """[profile mode]: t_recalls of the 0.9 window."""
    es.profile = True
    es.search(N_TRAIN_Q, N_TEST_Q)
    es.profile = False
    t = es.t_recalls[held_out()]
    log(f"[profile mode] t_recalls over {N_TEST_Q} queries: mean "
        f"{t.mean():.4f} min {t.min():.3f} [{card}]")
    check(t.mean() >= 1.0 - EPS, "profile mode: mean t_recall below 0.9")


def stream_phase(es, card: str) -> None:
    """[stream]: search_stream over windows of 256 against search over the
    same windows, bookkeeping included."""
    w = 256
    (D, I), n = counted(lambda: es.search_stream(N_TRAIN_Q, N_TEST_Q,
                                                 window=w))
    ns = es.n_scanned[held_out()].copy()
    outs = [es.search(N_TRAIN_Q + o, min(w, N_TEST_Q - o))
            for o in range(0, N_TEST_Q, w)]
    same = (np.array_equal(D, np.concatenate([o[0] for o in outs]))
            and np.array_equal(I, np.concatenate([o[1] for o in outs]))
            and np.array_equal(ns, es.n_scanned[held_out()]))
    log(f"[stream] search_stream over windows of {w}: equal to search over "
        f"the same windows {same}; launches {n} [{card}]")
    check(same, "search_stream differs from search")


def time_mode_phase(es, card: str) -> dict:
    """[time mode]: calibrate_time on the card, then time_search at batch 1
    over 200 held-out queries with budgets spread over the table's range:
    each spends exactly _budget_to_probes(budget). Reports, with no
    threshold, the share of calls within budget (wall time, and wall time
    less the dispatch floor, as the JAX package's effect_time) and the
    correlation of the model's cost with the measured one. Then
    nprobe_search_mr at a fixed nprobe against multirow_search_fixed."""
    from auncel_tpu_torch.index.multirow import multirow_search_fixed
    from auncel_tpu_torch.profile.bounded_mr import nprobe_search_mr
    idx = es.index
    nlist = idx.nlist
    saved = es.require_acc
    n_q = 200
    (slope, dt), n_cal = counted(lambda: synced(es.calibrate_time))
    tbl = es._time_cost_table
    grid = [1]
    while grid[-1] < nlist:
        grid.append(grid[-1] * 2)
    log(f"[time mode] calibrate_time {dt:.2f} s, launches {n_cal}: cost "
        + " ".join(f"{g}:{tbl[g - 1]:.3f}" for g in grid)
        + f" ms; per_probe_ms {slope:.5f} [{card}]")
    lo = max(float(tbl[tbl > 0].min()) if (tbl > 0).any() else 0.01, 0.01)
    budgets = np.geomspace(lo, max(float(tbl[-1]), lo * 2), n_q) / 0.95
    acc = np.full(N_TRAIN_Q + N_TEST_Q, 1e-6, np.float32)
    acc[N_TRAIN_Q:N_TRAIN_Q + n_q] = budgets
    es.set_queries(es.num, es.queries, acc)
    es.time_search(N_TRAIN_Q + n_q - 1, 1)   # warm
    wall = np.zeros(n_q)
    launches = {}
    for i in range(n_q):
        (_, t), n = counted(lambda: synced(
            lambda: es.time_search(N_TRAIN_Q + i, 1)))
        wall[i] = t * 1e3
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
    spent = es.n_scanned[N_TRAIN_Q:N_TRAIN_Q + n_q].copy()
    want = es._budget_to_probes(acc[N_TRAIN_Q:N_TRAIN_Q + n_q])
    # the dispatch floor: the same call at the least work (one probe)
    floor = float(np.median([synced(lambda: es.time_search(
        N_TRAIN_Q + n_q + j, 1))[1] for j in range(8)])) * 1e3
    dev_ms = np.maximum(wall - floor, 0.0)
    model = es.time_cost_ms(spent)
    b = acc[N_TRAIN_Q:N_TRAIN_Q + n_q]
    corr = float(np.corrcoef(model, dev_ms)[0, 1]) \
        if model.std() > 0 and dev_ms.std() > 0 else float("nan")
    log(f"[time mode] time_search at batch 1 over {n_q} queries, budgets "
        f"{b.min():.3f}-{b.max():.3f} ms: probes {spent.min()}-{spent.max()}"
        f", equal to _budget_to_probes {np.array_equal(spent, want)}; "
        f"within budget: wall {np.mean(wall <= b):.3f}, wall less the "
        f"{floor:.2f} ms floor {np.mean(dev_ms <= b):.3f}; corr(model, "
        f"measured less floor) {corr:.3f}; wall p50 "
        f"{np.percentile(wall, 50):.2f} ms max {wall.max():.2f} ms; "
        f"launches {launches} [{card}]")
    check(np.array_equal(spent, want), "time_search spent other counts")
    check(launches.get("rowscan_scores", 0) > 0, "time_search never "
          "launched K1")
    check_merges("time mode", launches)
    es.set_queries(es.num, es.queries, saved)
    # a fixed nprobe: the tail rounds against the fixed-nprobe scan
    nprobe = 16
    q = torch.as_tensor(es.queries[held_out()], device=idx.device)
    _, ids, _ = nprobe_search_mr(
        idx.arrays, idx.multirow, q, torch.full((N_TEST_Q,), nprobe,
                                                device=idx.device),
        MAX_TOPK, idx.metric, es._mr_oneshot_plan())
    rpl = np.sort(idx.multirow.rows_per_list.cpu().numpy())[::-1]
    _, fids = multirow_search_fixed(idx.multirow, q, K, nprobe,
                                    int(rpl[:nprobe].sum()), idx.metric)
    same = torch.equal(ids[:, :K], fids)
    log(f"[time mode] nprobe_search_mr at nprobe {nprobe} equals "
        f"multirow_search_fixed on ids: {same} [{card}]")
    check(same, "nprobe_search_mr differs from multirow_search_fixed")
    return {"per_probe_ms": slope, "within_wall": float(np.mean(wall <= b)),
            "corr": corr}


def padded_time_mode(es, card: str) -> None:
    """time_search on 100 batch-1 queries of the padded path under a
    linear per_probe_ms: counts ceil(0.95 b / t - 1) in float32, K2."""
    saved = (es.require_acc, es.per_probe_ms, es._time_cost_table)
    n_q, per_probe = 100, 0.05
    es.per_probe_ms, es._time_cost_table = per_probe, None
    budgets = np.linspace(0.05, 10.0, n_q).astype(np.float32)
    acc = np.full(N_TRAIN_Q + N_TEST_Q, 1.0, np.float32)
    acc[N_TRAIN_Q:N_TRAIN_Q + n_q] = budgets
    es.set_queries(es.num, es.queries, acc)
    launches = {}
    for i in range(n_q):
        _, n = counted(lambda: es.time_search(N_TRAIN_Q + i, 1))
        for k, v in n.items():
            launches[k] = launches.get(k, 0) + v
    spent = es.n_scanned[N_TRAIN_Q:N_TRAIN_Q + n_q]
    want = np.clip(np.ceil(np.float32(0.95) * budgets / np.float32(per_probe)
                           - np.float32(1.0)), 1, es.index.nlist)
    log(f"[padded time mode] time_search at batch 1 over {n_q} queries, "
        f"per_probe_ms {per_probe}: probes {spent.min()}-{spent.max()}, "
        f"equal to the float32 conversion {np.array_equal(spent, want)}; "
        f"launches {launches} [{card}]")
    check(np.array_equal(spent, want), "padded time_search counts")
    check(launches.get("scan_scores", 0) > 0, "padded time_search never "
          "launched K2")
    check_merges("padded time mode", launches)
    es.set_queries(es.num, es.queries, saved[0])
    es.per_probe_ms, es._time_cost_table = saved[1:]


def kernels_on_index(c: dict, device, card: str) -> dict:
    """Each kernel against its plain version on the real index: K1 on the
    multi-row search's rows, K2 on the padded lists at the two-phase
    window's chunk shape."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.index.scan import coarse_rank
    from auncel_tpu_torch.kernels.rowscan import rowscan_dots, \
        rowscan_dots_ref
    from auncel_tpu_torch.ops.distance import sqnorms

    idx, xq = c["idx"], c["xq"]
    a, db, T = idx.arrays, idx.multirow.rows.db, 4096
    gen = torch.Generator(device=device).manual_seed(1)
    xq_d = torch.as_tensor(xq, device=device)
    rows = torch.randint(0, db.shape[0], (T,), generator=gen, device=device,
                         dtype=torch.int32)
    qs = xq_d[torch.randint(0, xq.shape[0], (T,), generator=gen,
                            device=device)]
    got = rowscan_dots(db, rows, qs)
    want = rowscan_dots_ref(db, rows, qs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    gb = T * db.shape[1] * db.shape[2] * 4 / 1e9
    t_k, t_ref = time_pair(lambda: rowscan_dots(db, rows, qs),
                           lambda: rowscan_dots_ref(db, rows, qs), 10)
    log(f"[k1] index rows: T={T} row_cap={db.shape[1]} max rel err "
        f"{rel:.3g} kernel {t_k:.4f} ms ({gb / t_k * 1e3:.1f} GB/s) "
        f"plain {t_ref:.4f} ms ({gb / t_ref * 1e3:.1f} GB/s) [{card}]")
    del got, want
    # K2 at the shapes the main path gives it. The two-phase window's first
    # chunk (1000 held-out queries, each on its 4 best-ranked lists) is the
    # kernels line's entry, as in earlier runs.
    q = xq_d[N_TRAIN_Q:N_TRAIN_Q + N_TEST_Q].contiguous()
    q_sq = sqnorms(q)
    _, cids = coarse_rank(a, q, Metric.L2, q_sq=q_sq, rank_k=8)
    qt = xq_d[:N_TRAIN_Q].contiguous()
    qt_sq = sqnorms(qt)
    _, tids = coarse_rank(a, qt, Metric.L2, q_sq=qt_sq, rank_k=68)
    largest = int(torch.argmax(a.list_sizes))
    shapes = (
        ("index window chunk", q, q_sq, cids[:, :4], 10),
        ("index window wave, 1 slot", q, q_sq, cids[:, :1], 10),
        ("index window wave, 2 slots", q, q_sq, cids[:, :2], 10),
        ("index training chunk, ranks 64-67", qt, qt_sq, tids[:, 64:68], 10),
        ("index batch 1, 1 slot", q[:1], q_sq[:1], cids[:1, :1], 200),
        ("index batch 1, 8 slots", q[:1], q_sq[:1], cids[:1, :8], 200),
        ("index skewed, all queries on the largest list", q, q_sq,
         torch.full((N_TEST_Q, 1), largest, dtype=torch.int32,
                    device=device), 10))
    out = None
    for name, qq, qq_sq, lists, reps in shapes:
        args = (a.db, a.db_sq, a.vec_ids, a.list_sizes, qq.contiguous(),
                qq_sq.contiguous(), lists.contiguous())
        res = k2_compare(name, args, Metric.L2, card, reps=reps,
                         terms_tol=True)
        out = out or res
        torch.cuda.empty_cache()
    return out


# [imi]: the 1M corpus over IMI product cells, the JAX README's
# "IMI2x7,Flat" (README.md:456; the reference's IMI2x%d cell,
# AutoTune.cpp:807): 2^7 sub-centroids a half, 16384 cells, served on the
# multi-row layout by ErrorSys (K1 in search, K2 in profile training).
IMI_NBIT = 7
IMI_NPROBE, IMI_MAX_CODES = 64, 4096
N_LATENCY_IMI = 200
UNCHECKED_IMI = ("reported, not checked: nothing in the repo has measured "
                 "the worst case over IMI cells")


def row_count(sizes: np.ndarray, row_cap: int = 256) -> int:
    """Rows of the multi-row layout for lists of these sizes (an empty
    list takes none)."""
    return int(np.ceil(sizes / row_cap).sum())


def imi_phase(c: dict, card: str) -> dict:
    """[imi]: train the IMI cells on 400k vectors, print the cells' size
    spread and both layouts' bytes, add the 1M vectors, then profile
    training, calibration, the held-out window at bound 0.9 (mean recall@10
    >= 0.9 or the run fails; the worst case and bound_ok reported), 200
    batch-1 queries and fixed-nprobe search with and without max_codes;
    then K1 and K2 against their plain versions at the largest calls
    recorded on this path. Returns the launches and the kernels'
    numbers."""
    from auncel_tpu_torch import ErrorSys, Metric, index_factory
    from auncel_tpu_torch.autotune import recall_counts
    from auncel_tpu_torch.index.imi import imi_assign
    from auncel_tpu_torch.profile.trainer import train_profile

    xb, xq, gt_D = c["xb"], c["xq"], c["gt_D"]
    times = {}
    idx = index_factory(D, f"IMI2x{IMI_NBIT},Flat")
    nlist = idx.nlist
    check(idx.coarse == "imi" and nlist == 4 ** IMI_NBIT
          and idx.device.type == "cuda", f"IMI index: {idx.coarse} {nlist}")
    _, times["train"] = synced(lambda: idx.train(xb[:400_000]))
    _, times["interdis"] = synced(idx.ensure_interdis)
    sizes, times["assign"] = synced(lambda: np.bincount(
        imi_assign(xb, idx.centroids), minlength=nlist))
    cap = -(-int(sizes.max()) // 8) * 8
    live = sizes[sizes > 0]
    log(f"[imi] {nlist} product cells over {NB}x{D}: empty {int((sizes == 0).sum())}, "
        f"median {np.median(sizes):.0f} (of the non-empty {np.median(live):.0f}), "
        f"p99 {np.percentile(sizes, 99):.0f}, max {int(sizes.max())}; padded "
        f"layout (cap {cap}) {nlist * cap * (D * 4 + 8) / 2**30:.3f} GiB, "
        f"multi-row layout {row_count(sizes)} rows of 256, "
        f"{row_count(sizes) * 256 * (D * 4 + 8) / 2**30:.3f} GiB; interdis "
        f"{nlist * nlist * 4 / 2**30:.3f} GiB [{card}]")
    _, times["add+pack"] = synced(lambda: (idx.add(xb), idx.arrays))
    mr, times["multirow"] = synced(lambda: idx.enable_multirow())
    a = idx.arrays
    moved = int(np.abs(a.list_sizes.cpu().numpy() - sizes).sum())
    log(f"[imi] packed: cap {a.cap}, rows {mr.rows.db.shape[0]}x"
        f"{mr.rows.db.shape[1]} (cell sizes differing from the per-subspace "
        f"assignment's, summed: {moved}), allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]")
    reset_counts()
    es = ErrorSys(idx, train_num=N_TRAIN_Q + N_TEST_Q, max_topk=MAX_TOPK)
    es.set_gt(gt_D, c["gt_I"])
    (_, times["sys_train"]), train = counted(
        lambda: synced(lambda: es.sys_train(N_TRAIN_Q, xq)))
    es.set_topk(K)
    es.set_queries(N_TEST_Q, xq,
                   np.full(N_TRAIN_Q + N_TEST_Q, 1.0 - EPS, np.float32))
    mult, times["calibrate"] = synced(
        lambda: es.calibrate(0, N_TRAIN_Q, target_bound=1.0 - EPS))
    log(f"[imi] calibrate: multipler={mult:.3f} std_m={es.std_m} "
        f"_dense_min_bsz={es._dense_min_bsz}")
    win = held_out()

    def serve():
        ((D_out, I_out), dt), n = counted(
            lambda: synced(lambda: es.search(N_TRAIN_Q, N_TEST_Q)))
        return D_out, I_out, dt, n
    D_out, I_out, _, window = serve()
    reps = [serve()[2] for _ in range(SEARCH_REPS)]
    dt = float(np.median(reps))
    times["search"] = dt
    cnt = recall_counts(D_out, gt_D[win], K, Metric.L2)
    check(D_out.shape == (N_TEST_Q, K) and np.isfinite(D_out).all()
          and (I_out >= 0).all(), "IMI window results")
    nscan = es.n_scanned[win]
    log(f"[imi] window of {N_TEST_Q} held-out queries at bound "
        f"{1.0 - EPS:.1f}: mean recall@{K}={cnt.mean() / K:.4f}, worst "
        f"{cnt.min() / K:.3f} and bound_ok={bool(cnt.min() >= K * (1 - EPS))}"
        f" ({UNCHECKED_IMI}); mean n_scanned={nscan.mean():.2f} max="
        f"{nscan.max()}; times " + " ".join(f"{r * 1e3:.2f}" for r in reps)
        + f" ms (median {dt * 1e3:.2f} ms, qps {N_TEST_Q / dt:.1f}) "
        f"launches={window} [{card}]")
    check(cnt.mean() / K >= 0.9, f"IMI mean recall@{K} {cnt.mean() / K}")
    lat = serve_batch1(es, N_LATENCY_IMI, card, "imi latency")
    fixed = {}
    for max_codes in (0, IMI_MAX_CODES):
        idx.max_codes = max_codes
        (Df, If), t_f = synced(lambda: idx.search(xq[win], K,
                                                  nprobe=IMI_NPROBE))
        t_f = min(t_f, synced(lambda: idx.search(xq[win], K,
                                                 nprobe=IMI_NPROBE))[1])
        cf = recall_counts(Df, gt_D[win], K, Metric.L2)
        fixed[max_codes] = cf.mean() / K
        log(f"[imi fixed] B={N_TEST_Q} nprobe={IMI_NPROBE} max_codes="
            f"{max_codes or 'unlimited'}: {t_f * 1e3:.2f} ms, recall@{K} "
            f"mean {cf.mean() / K:.4f} worst {cf.min() / K:.3f} [{card}]")
    idx.max_codes = 0
    launches = launch_counts()
    log("[imi stages] " + " ".join(f"{k}={v:.2f}s" for k, v in times.items())
        + f" [{card}]")
    log(f"[imi] launches over the path: {launches}, profile training "
        f"{train}")
    check(train["scan_scores"] > 0, "IMI profile training never launched K2")
    check(window["rowscan_scores"] > 0 and lat.get("rowscan_scores", 0) > 0,
          "IMI search never launched K1")
    for part in (train, window, lat):
        check_merges("imi", part)
    with uncounted():
        calls = record_row_scans(lambda: es.search(N_TRAIN_Q, N_TEST_Q))
        big = max(calls, key=lambda x: int((x[1][6] >= 0).sum()))
        k1 = k1_compare(f"IMI window, the largest of {len(calls)} row scans "
                        f"({big[0]})", big[1], big[2], card, reps=10,
                        terms_tol=True, codec=big[3], label="k1 imi")
        k2_calls = record_row_scans(
            lambda: train_profile(a, xq[:100], gt_D[:100], MAX_TOPK,
                                  idx.metric, n_batches=1), "scan_scores")
        chunk = max(k2_calls, key=lambda x: x[1][6].numel())
        k2 = k2_compare(f"IMI training chunk, the largest of {len(k2_calls)} "
                        f"calls (B x n_slots {tuple(chunk[1][6].shape)})",
                        chunk[1], chunk[2], card, reps=10, terms_tol=True,
                        codec=chunk[3], label="k2 imi")
    return {"launches": launches, "kernels": {"rowscan_scores": k1,
                                              "scan_scores": k2}}


def id_recall(ids: np.ndarray, gt_ids: np.ndarray) -> float:
    """Mean |result ∩ true top-K| / K by ids."""
    return float(np.mean([len(set(a) & set(b)) / K for a, b in
                          zip(ids[:, :K].tolist(), gt_ids[:, :K].tolist())]))


def twolayer_phase(c: dict, card: str) -> dict:
    """[2layer]: Index2Layer(128, 1024, M=16) on the 1M corpus, moved into
    an IVF index by transfer_to_ivfpq and served at nprobe 32 (K2 on the
    residual PQ codes); its reconstructions bitwise reconstruct_n's; the
    exact decoded search and the IVF search's recall@10 by ids against
    the float ground truth, reported. Returns the launches and K2's
    numbers at the search's largest call."""
    from auncel_tpu_torch.index.twolayer import Index2Layer
    xb, xq, gt_I = c["xb"], c["xq"], c["gt_I"]
    win = held_out()
    times = {}
    tl = Index2Layer(D, NLIST, M=16)
    _, times["train"] = synced(lambda: tl.train(xb[:400_000]))
    _, times["add"] = synced(lambda: tl.add(xb))
    ivf, times["transfer"] = synced(tl.transfer_to_ivfpq)
    a = ivf.arrays
    check(a.pq_residual and a.db.dtype == torch.uint8 and a.db.is_cuda
          and ivf.ntotal == NB, "transferred index")
    same = bool(np.array_equal(ivf.reconstruct_n(0, NB), tl.reconstruct_n()))
    check(same, "transferred reconstructions differ from reconstruct_n")
    reset_counts()
    ((_, I_ivf), t_ivf), n = counted(
        lambda: synced(lambda: ivf.search(xq[win], K, nprobe=32)))
    launches = launch_counts()
    check(n["scan_scores"] > 0, "the transferred index never launched K2")
    check_merges("2layer", n)
    (_, I_tl), t_tl = synced(lambda: tl.search(xq[win], K))
    log(f"[2layer] Index2Layer({D}, {NLIST}, M=16): code size "
        f"{tl.code_size} B, cap {a.cap}; transferred reconstructions "
        f"bitwise reconstruct_n's: {same}; nprobe 32: {t_ivf * 1e3:.2f} ms, "
        f"recall@{K} (ids, float ground truth) {id_recall(I_ivf, gt_I[win]):.4f}"
        f"; exact decoded search: {t_tl * 1e3:.2f} ms, recall@{K} "
        f"{id_recall(I_tl, gt_I[win]):.4f}; launches {n} [{card}]")
    log("[2layer stages] " + " ".join(f"{k}={v:.2f}s"
                                      for k, v in times.items())
        + f" [{card}]")
    with uncounted():
        calls = record_row_scans(lambda: ivf.search(xq[win], K, nprobe=32),
                                 "scan_scores")
        big = max(calls, key=lambda x: int((x[1][6] >= 0).sum()))
        k2 = k2_compare(f"2layer nprobe 32, the largest of {len(calls)} "
                        f"calls (B x n_slots {tuple(big[1][6].shape)})",
                        big[1], big[2], card, reps=10, terms_tol=True,
                        codec=big[3], label="k2 2layer")
    return {"launches": launches, "kernels": k2}


N_BINARY_CPU = 100


def binary_phase(c: dict, card: str) -> dict:
    """[binary]: the 1M corpus hashed by "LSH128r"; its codes in BFlat and
    "BIVF1024" (nprobe 16 and 1024, which must equal BFlat's ids and
    distances), and "IVF1024,SH64" at nprobe 16; each checked on 100
    queries against the same index on the CPU (BIVF at nprobe 1024
    through BFlat: it equals BFlat on the card, and BFlat the CPU);
    times and recall@10 by ids against the float ground truth
    reported. Returns the codes, the query codes and the BIVF index."""
    from auncel_tpu_torch import convert, index_factory
    from auncel_tpu_torch.index.binary import index_binary_factory, pack_bits
    xb, xq, gt_I = c["xb"], c["xq"], c["gt_I"]
    win = held_out()
    q = xq[win]
    times = {}
    lsh = index_factory(D, "LSH128r")
    _, times["lsh add"] = synced(lambda: lsh.add(xb))
    codes, qc = lsh.codes, pack_bits(lsh._encode(q))
    bflat = index_binary_factory(128, "BFlat")
    bflat.add(codes)
    bivf = index_binary_factory(128, f"BIVF{NLIST}")
    _, times["bivf train"] = synced(lambda: bivf.train(codes[:400_000]))
    bivf.add(codes)
    sh = index_factory(D, f"IVF{NLIST},SH64")
    _, times["sh train"] = synced(lambda: sh.train(xb[:400_000]))
    sh.add(xb)
    cpu = {
        "LSH128r": convert.lsh_from_numpy(dict(
            d=D, nbits=128, rotate_data=True, train_thresholds=False,
            rrot=lsh.rrot, thresholds=lsh.thresholds, bits=lsh._bits),
            "cpu"),
        "BFlat": convert.binary_from_numpy(dict(d=128, codes=codes), "cpu"),
        "BIVF": convert.binary_from_numpy(dict(
            d=128, nlist=NLIST, codes=codes,
            centroid_bits=bivf.centroid_bits), "cpu"),
        "SH": convert.spectral_hash_from_numpy(dict(
            d=D, nlist=NLIST, nbit=64, threshold_type=sh.threshold_type,
            period=sh.period, rrot=sh.rrot, centroids=sh.centroids,
            trained=sh.trained, x=xb, ids=np.arange(NB)), "cpu")}
    runs = (("LSH128r", lsh, lambda x, qq, f: x.search(f, K), None),
            ("BFlat", bflat, lambda x, qq, f: x.search(qq, K), None),
            ("BIVF", bivf, lambda x, qq, f: x.search(qq, K, nprobe=16), 16),
            ("BIVF", bivf, lambda x, qq, f: x.search(qq, K, nprobe=NLIST),
             NLIST),
            ("SH", sh, lambda x, qq, f: x.search(f, K, nprobe=16), 16))
    out = {}
    for name, idx, fn, nprobe in runs:
        label = name if nprobe is None else f"{name} nprobe {nprobe}"
        fn(idx, qc[:8], q[:8])                                   # warm
        (v, i), t = synced(lambda: fn(idx, qc, q))
        t = min(t, synced(lambda: fn(idx, qc, q))[1])
        out[label] = (v, i)
        same = "through BFlat"
        if nprobe != NLIST:
            cv, ci = fn(cpu[name], qc[:N_BINARY_CPU], q[:N_BINARY_CPU])
            same = bool(np.array_equal(ci, i[:N_BINARY_CPU])
                        and np.array_equal(cv, v[:N_BINARY_CPU]))
            check(same, f"[binary] {label} differs from the CPU")
        log(f"[binary] {label}: {N_TEST_Q} queries {t * 1e3:.2f} ms, "
            f"recall@{K} (ids, float ground truth) "
            f"{id_recall(i, gt_I[win]):.4f} (reported, not bounded); equal "
            f"to the CPU on {N_BINARY_CPU} queries: {same} [{card}]")
    check(all(np.array_equal(x, y) for x, y in
              zip(out[f"BIVF nprobe {NLIST}"], out["BFlat"])),
          f"BIVF at nprobe {NLIST} differs from BFlat")
    log("[binary stages] " + " ".join(f"{k}={v:.2f}s"
                                      for k, v in times.items())
        + f"; BIVF at every list equals BFlat [{card}]")
    return {"codes": codes, "qc": qc, "bivf": bivf, "bflat": bflat}


# The JAX package's HNSW cells (tests/test_hnsw.py): 20k x 32 with 64
# clusters (seed 5, 64 queries; M 16, efConstruction 40; recall@10 against
# Flat >= 0.90 at ef 64 and >= 0.95 at ef 128; SQ8 >= 0.85 and PQ8 >= 0.80
# at ef 64) and 200k x 128 with 600 clusters (seed 3, 128 queries; M 16,
# efConstruction 80, two refinement passes; >= 0.95 at ef 64).
HNSW_CELL = dict(nb=20_000, nq=64, d=32, n_clusters=64, seed=5)
HNSW_SCALE_CELL = dict(nb=200_000, nq=128, d=128, n_clusters=600, seed=3)
HNSW_EFS = (10, 32, 64, 128)
HNSW_LIMITS = {64: 0.90, 128: 0.95}
HNSW_B1_REPS = 3          # batch-1 passes over the held-out queries
N_HNSW_CPU = 100


def hnsw_graph(idx) -> list:
    """An HNSW index's graph: levels, entry point, each level's links and
    row map."""
    return ([idx.levels, np.asarray([idx.entry_point])] + list(idx.nb_tables)
            + list(idx.g2u))


def hnsw_build(make, xb, train=None) -> tuple:
    """(index, build seconds): ``make()`` trained on ``train`` (or the
    corpus), the corpus added, the graph built, all on the card."""
    idx = make()
    t0 = time.perf_counter()
    idx.train(xb if train is None else train)
    idx.add(xb)
    idx.build()
    torch.cuda.synchronize()
    return idx, time.perf_counter() - t0


def hnsw_recalls(idx, xq, gt_I, efs=HNSW_EFS) -> dict:
    out = {}
    for ef in efs:
        _, i = idx.search(xq, K, ef=ef)
        out[ef] = id_recall(i, gt_I)
    return out


def hnsw_search_times(idx, xq, ef: int, reps: int = 1) -> tuple:
    """(median ms of the held-out queries as one batch over 5 calls,
    batch-1 latencies in ms over ``reps`` passes)."""
    idx.search(xq, K, ef=ef)                                   # warm
    batch = [synced(lambda: idx.search(xq, K, ef=ef))[1] * 1e3
             for _ in range(5)]
    lat = [synced(lambda: idx.search(xq[i:i + 1], K, ef=ef))[1] * 1e3
           for _ in range(reps) for i in range(xq.shape[0])]
    return float(np.median(batch)), np.asarray(lat)


def hnsw_phase(card: str) -> dict:
    """[hnsw], [hnsw sq8], [hnsw pq8]: the JAX test's 20k cell on the card
    (HNSWIndex, "HNSW16_SQ8", "HNSW16_PQ8"): the build time (insert,
    repair, refine), recall@10 against Flat at ef 10, 32, 64 and 128
    (the JAX limits checked), the held-out batch and batch-1 p50/p99; a
    second card build must give the same graph, and a CPU search of the
    card's graph the same ids. The compressed cells report their bytes on
    the card; PQ is held against exact search over its decoded corpus, as
    the JAX test holds it."""
    from auncel_tpu_torch import FlatIndex, HNSWIndex, convert, index_factory
    from auncel_tpu_torch.data import make_clustered_dataset
    ds = make_clustered_dataset(**HNSW_CELL)
    xb, xq, d = ds.xb, ds.xq, HNSW_CELL["d"]
    flat = FlatIndex(d)
    flat.add(xb)
    _, gt_I = flat.search(xq, K)
    out = {}

    def make():
        return HNSWIndex(d, M=16, ef_construction=40, ef_search=64)
    idx, t_build = hnsw_build(make, xb)
    rec = hnsw_recalls(idx, xq, gt_I)
    for ef, limit in HNSW_LIMITS.items():
        check(rec[ef] >= limit, f"[hnsw] recall@{K} {rec[ef]:.4f} at ef "
              f"{ef} below {limit}")
    t_batch, lat = hnsw_search_times(idx, xq, 64, HNSW_B1_REPS)
    dev_batch = device_ms(lambda: idx.search(xq, K, ef=64), 3)
    dev_b1 = device_ms(lambda: idx.search(xq[:1], K, ef=64), 5)
    again, t_again = hnsw_build(make, xb)
    same = all(np.array_equal(a, b) for a, b in
               zip(hnsw_graph(idx), hnsw_graph(again)))
    check(same, "[hnsw] two card builds gave different graphs")
    del again
    cpu = convert.hnsw_from_numpy(idx.state(), device="cpu")
    q = xq[:N_HNSW_CPU]
    cv, ci = cpu.search(q, K, ef=64)
    gv, gi = idx.search(q, K, ef=64)
    check(np.array_equal(ci, gi), "[hnsw] card ids differ from the CPU's")
    check(np.allclose(cv, gv, rtol=1e-5, atol=1e-5),
          "[hnsw] card values beyond 1e-5 of the CPU's")
    bt = idx.build_times
    log(f"[hnsw] {HNSW_CELL['nb']}x{d} ({HNSW_CELL['n_clusters']} clusters,"
        f" seed {HNSW_CELL['seed']}), M 16, efConstruction 40: build "
        f"{t_build:.2f} s (insert {bt['insert']:.2f} s, repair "
        f"{bt['repair']:.2f} s, refine {bt['refine']:.2f} s; again "
        f"{t_again:.2f} s, the same graph: {same}); levels "
        f"{idx.max_level + 1}; recall@{K} against Flat "
        + ", ".join(f"ef {ef} {r:.4f}" for ef, r in rec.items())
        + f"; {xq.shape[0]} queries at ef 64 {t_batch:.2f} ms (device time "
        f"{'not measured' if dev_batch is None else f'{dev_batch:.2f} ms'});"
        f" batch 1 p50 {np.percentile(lat, 50):.2f} ms p99 "
        f"{np.percentile(lat, 99):.2f} ms ({lat.size} searches; device time "
        f"{'not measured' if dev_b1 is None else f'{dev_b1:.2f} ms'} a "
        f"search); ids equal to the CPU's on {len(q)} queries [{card}]")
    out["hnsw"] = {"build_s": t_build, "recall": rec, "batch_ms": t_batch}
    del idx, cpu
    for cell, name, limit in (("HNSW16_SQ8", "hnsw sq8", 0.85),
                              ("HNSW16_PQ8", "hnsw pq8", 0.80)):
        idx, t_build = hnsw_build(lambda: index_factory(d, cell), xb)
        if name == "hnsw pq8":
            dec = FlatIndex(d)
            dec.add(idx._xb)                       # the decoded corpus
            ref_I = dec.search(xq, K)[1]
        else:
            ref_I = gt_I
        rec = hnsw_recalls(idx, xq, ref_I)
        check(rec[64] >= limit, f"[{name}] recall@{K} {rec[64]:.4f} at ef "
              f"64 below {limit}")
        t_batch, lat = hnsw_search_times(idx, xq, 64)
        store = idx._dev[0]
        check(store.dtype == torch.uint8 and store.is_cuda,
              f"[{name}] storage on the card is not uint8 codes")
        nbytes = store.numel() + sum((t.numel() + g.numel()) * 8
                                     for t, g in idx._dev[1])
        cpu = convert.hnsw_from_numpy(idx.state(), device="cpu")
        same = np.array_equal(cpu.search(q, K, ef=64)[1],
                              idx.search(q, K, ef=64)[1])
        check(same, f"[{name}] card ids differ from the CPU's")
        bt = idx.build_times
        log(f"[{name}] {cell} on the same cell: codes {store.numel()} B on "
            f"the card ({store.shape[1]} B a vector, float32 "
            f"{HNSW_CELL['nb'] * d * 4} B), with the links and row maps {nbytes} "
            f"B; "
            f"build {t_build:.2f} s (insert {bt['insert']:.2f} s, repair "
            f"{bt['repair']:.2f} s, refine {bt['refine']:.2f} s); recall@{K} "
            f"against {'its decoded corpus' if name == 'hnsw pq8' else 'Flat'}"
            f" " + ", ".join(f"ef {ef} {r:.4f}" for ef, r in rec.items())
            + f"; {xq.shape[0]} queries at ef 64 {t_batch:.2f} ms; batch 1 "
            f"p50 {np.percentile(lat, 50):.2f} ms p99 "
            f"{np.percentile(lat, 99):.2f} ms; ids equal to the CPU's on "
            f"{len(q)} queries [{card}]")
        out[name] = {"build_s": t_build, "recall": rec}
        del idx, cpu
    torch.cuda.empty_cache()
    return out


def hnsw_scale_phase(card: str) -> dict:
    """[hnsw 200k]: the JAX test's scale cell on the card (200k x 128, 600
    clusters, M 16, efConstruction 80, two refinement passes): the build
    time (insert, repair, refine) and recall@10 against Flat at ef 64
    (>= 0.95, the JAX test's limit, or the run fails), and the held-out
    batch at ef 64."""
    from auncel_tpu_torch import FlatIndex, HNSWIndex
    from auncel_tpu_torch.data import make_clustered_dataset
    t0 = time.perf_counter()
    ds = make_clustered_dataset(**HNSW_SCALE_CELL)
    xb, xq, d = ds.xb, ds.xq, HNSW_SCALE_CELL["d"]
    t_data = time.perf_counter() - t0
    flat = FlatIndex(d)
    flat.add(xb)
    _, gt_I = flat.search(xq, K)
    del flat
    idx, t_build = hnsw_build(lambda: HNSWIndex(
        d, M=16, ef_construction=80, refine_passes=2), xb)
    rec = hnsw_recalls(idx, xq, gt_I, (32, 64, 128))
    check(rec[64] >= 0.95, f"[hnsw 200k] recall@{K} {rec[64]:.4f} at ef 64 "
          "below 0.95")
    t_batch, lat = hnsw_search_times(idx, xq, 64)
    bt = idx.build_times
    log(f"[hnsw 200k] {HNSW_SCALE_CELL['nb']}x{d} "
        f"({HNSW_SCALE_CELL['n_clusters']} clusters, seed "
        f"{HNSW_SCALE_CELL['seed']}; data {t_data:.1f} s on the host), M 16,"
        f" efConstruction 80, refine x2: build {t_build:.2f} s (insert "
        f"{bt['insert']:.2f} s, repair {bt['repair']:.2f} s, refine "
        f"{bt['refine']:.2f} s); levels {idx.max_level + 1}; recall@{K} "
        "against Flat " + ", ".join(f"ef {ef} {r:.4f}"
                                    for ef, r in rec.items())
        + f"; {xq.shape[0]} queries at ef 64 {t_batch:.2f} ms; batch 1 p50 "
        f"{np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f} "
        f"ms [{card}]")
    del idx
    torch.cuda.empty_cache()
    return {"build_s": t_build, "recall": rec}


IVF_HNSW_M = 32
IVF_HNSW_NPROBES = (16, 32)


def ivf_hnsw_phase(c: dict, card: str) -> dict:
    """[ivf hnsw]: "IVF1024_HNSW32,Flat" on the 1M index: its 1024
    centroids in an HNSW graph (M 32) that ranks the lists of fixed-nprobe
    search, then K2 over the padded lists (the JAX package's
    _search_hnsw_coarse): recall@10 by ids at nprobe 16 and 32, the
    overlap of the graph's probe lists with coarse_rank's, K2 launched or
    the run fails; K2 at the largest call against its plain version
    (equal ids, values within 1e-5 of q_sq + db_sq). Returns the launches
    and K2's numbers."""
    idx, xq, gt_I = c["idx"], c["xq"], c["gt_I"]
    q = xq[held_out()]
    idx.coarse_hnsw_m = IVF_HNSW_M
    try:
        g, t_graph = synced(idx.hnsw_quantizer)
        _, exact = idx.coarse_rank_np(q)
        reset_counts()
        runs = {}
        for nprobe in IVF_HNSW_NPROBES:
            idx.search(q[:8], K, nprobe=nprobe)                      # warm
            (v, i), t = synced(lambda: idx.search(q, K, nprobe=nprobe))
            t = min(t, synced(lambda: idx.search(q, K, nprobe=nprobe))[1])
            probes = idx.hnsw_probes(q, nprobe)
            overlap = np.mean([len(set(a[a >= 0]) & set(b)) / nprobe
                               for a, b in zip(probes, exact[:, :nprobe])])
            runs[nprobe] = (t, id_recall(i, gt_I[held_out()]), overlap,
                            int((probes < 0).sum()))
        launches = launch_counts()
        check(launches["scan_scores"] > 0, "[ivf hnsw] K2 never launched")
        check_merges("ivf hnsw", launches)
        with uncounted():
            idx.coarse_hnsw_m = None
            exact_rec = {n: id_recall(idx.search(q, K, nprobe=n)[1],
                                      gt_I[held_out()]) for n in runs}
            idx.coarse_hnsw_m = IVF_HNSW_M
        for nprobe, (t, rec, overlap, short) in runs.items():
            log(f"[ivf hnsw] IVF{NLIST}_HNSW{IVF_HNSW_M},Flat nprobe "
                f"{nprobe}: {N_TEST_Q} queries {t * 1e3:.2f} ms, recall@{K} "
                f"(ids, exact ground truth) {rec:.4f} (the exact rank's "
                f"{exact_rec[nprobe]:.4f}); the graph's lists overlap "
                f"coarse_rank's top {nprobe} by {overlap:.4f} ({short} probe "
                f"slots the graph left empty) [{card}]")
        log(f"[ivf hnsw] the centroid graph ({g.ntotal} nodes, "
            f"{g.max_level + 1} levels) built in {t_graph:.2f} s at the "
            f"first search; launches {launches} [{card}]")
        with uncounted():
            calls = record_row_scans(
                lambda: idx.search(q, K, nprobe=max(IVF_HNSW_NPROBES)),
                "scan_scores")
            big = max(calls, key=lambda x: int((x[1][6] >= 0).sum()))
            k2 = k2_compare(
                f"ivf hnsw nprobe {max(IVF_HNSW_NPROBES)}, the largest of "
                f"{len(calls)} calls (B x n_slots {tuple(big[1][6].shape)})",
                big[1], big[2], card, reps=10, terms_tol=True, codec=big[3],
                label="k2 ivf hnsw")
    finally:
        idx.coarse_hnsw_m = None
        idx._hnswq = None
    return {"launches": launches, "kernels": k2}


def bhnsw_phase(b: dict, card: str) -> None:
    """[bhnsw]: BinaryHNSWIndex (M 16) over 20k of the [binary] phase's
    "LSH128r" codes, and "BIVF1024_HNSW16" (the [binary] phase's centroid
    bits, all 1M codes, its probes ranked by a binary HNSW over them):
    recall@10 by ids against BFlat over the same codes, and ids equal to
    the same index on the CPU (the card's graphs carried over) on 100
    queries."""
    from auncel_tpu_torch import convert
    from auncel_tpu_torch.index.binary import (
        BinaryFlatIndex, BinaryHNSWIndex, BinaryIVFIndex, pack_bits)
    codes, qc = b["codes"], b["qc"]
    n_sub = HNSW_CELL["nb"]

    def on_cpu(bh):
        """The same binary graph on the CPU (its file's keys)."""
        g = bh._g
        return convert.hnsw_from_numpy(dict(
            g.state(), kind="BHNSW", codes=pack_bits(g._xb > 0.5)), "cpu")
    sub = codes[:n_sub]
    bflat = BinaryFlatIndex(128)
    bflat.add(sub)
    _, gt = bflat.search(qc, K)
    bh = BinaryHNSWIndex(128, M=16)
    bh.add(sub)
    _, t_build = synced(bh.build)
    for ef in (16, 64):
        (v, i), t = synced(lambda: bh.search(qc, K, ef=ef))
        cv, ci = on_cpu(bh).search(qc[:N_BINARY_CPU], K, ef=ef)
        same = bool(np.array_equal(ci, i[:N_BINARY_CPU])
                    and np.array_equal(cv, v[:N_BINARY_CPU]))
        check(same, f"[bhnsw] BHNSW16 at ef {ef} differs from the CPU")
        log(f"[bhnsw] BHNSW16 over {n_sub} codes (built in {t_build:.2f} s):"
            f" ef {ef}: {N_TEST_Q} queries {t * 1e3:.2f} ms, recall@{K} "
            f"(ids, BFlat) {id_recall(i, gt):.4f}; equal to the CPU on "
            f"{N_BINARY_CPU} queries: {same} [{card}]")
    bivf = BinaryIVFIndex(128, NLIST, coarse_hnsw_m=16)
    bivf.centroid_bits = b["bivf"].centroid_bits
    bivf.is_trained = True
    bivf.add(codes)
    cpu = convert.binary_from_numpy(dict(
        d=128, nlist=NLIST, codes=codes,
        centroid_bits=bivf.centroid_bits), "cpu")
    cpu.coarse_hnsw_m = 16
    _, gt_all = b["bflat"].search(qc, K)
    for nprobe in (16, 64):
        bivf.search(qc[:8], K, nprobe=nprobe)                      # warm
        (v, i), t = synced(lambda: bivf.search(qc, K, nprobe=nprobe))
        if cpu._coarse_g is None:
            cpu._coarse_g = on_cpu(bivf._coarse_g)
        cv, ci = cpu.search(qc[:N_BINARY_CPU], K, nprobe=nprobe)
        same = bool(np.array_equal(ci, i[:N_BINARY_CPU])
                    and np.array_equal(cv, v[:N_BINARY_CPU]))
        check(same, f"[bhnsw] BIVF{NLIST}_HNSW16 nprobe {nprobe} differs "
              "from the CPU")
        log(f"[bhnsw] BIVF{NLIST}_HNSW16 nprobe {nprobe}: {N_TEST_Q} queries "
            f"{t * 1e3:.2f} ms, recall@{K} (ids, BFlat over all {len(codes)}"
            f" codes) {id_recall(i, gt_all):.4f}; equal to the CPU on "
            f"{N_BINARY_CPU} queries: {same} [{card}]")


# The JAX package's headline configuration, synthDeep10M with SQ8 storage
# (README.md "synthDeep10M"; auncel_tpu/eval_harness/common.py:52-77,
# :103-170), as ``python -m auncel_tpu.eval_harness.bound synthDeep10M 3000
# 1000 10 0.10 --storage sq8 --profile-size 1000`` serves it: profile on
# queries [0, 1000), calibration on [1000, 3000), the 1000 queries
# [3000, 4000) held out and served.
NB10M, D10M, NQ10M = 10_000_000, 96, 10_000
PROFILE10M, CAL10M, START10M = 1000, 2000, 3000
N_LATENCY10M = 200
# the sharded engines' batch 1 (four engines a query, about 100 ms) over
# fewer queries, and the 10M windows' recorded kernel calls (and K2 at the
# synthetic PQ layouts of the 10M calls, whose plain version takes up to
# 300 ms) at fewer timed repetitions, so that [eval 10M] fits the script's
# time limit
N_LATENCY_SHARDED10M = 50
RECORDED_REPS10M = 3
PQ_SYNTH_REPS = 3
FIXED_NPROBE10M, MAX_CODES10M = 32, 30_000
FIXED_REPS10M = 5       # [pq 10M fixed]: each setting's least of 5 calls


def data_10m_params() -> dict:
    """make_clustered_dataset's arguments for the synthDeep10M corpus."""
    return dict(nb=NB10M, nq=NQ10M, d=D10M, n_clusters=8192,
                cluster_std=0.13, query_mode="perturb", pert_easy=0.4,
                pert_hard=1.2, seed=42)


def build_10m(card: str, corpora: dict) -> dict:
    """The synthDeep10M data (generated by ``start_10m_corpora``'s process
    from the script's start), its IVF1024 + SQ8 index with the multi-row
    layout on the card, and the ground truth of the first 4000 queries."""
    from auncel_tpu_torch import IVFFlatIndex

    times = {}
    t0 = time.perf_counter()
    made = corpora_result(corpora, "build10m")
    paths = [os.path.join(corpora["tmp"], f"{name}10m.npy")
             for name in ("xb", "xq")]
    xb, xq = (np.load(path) for path in paths)
    for path in paths:
        os.remove(path)
    times["data"] = time.perf_counter() - t0
    log(f"[sq8 10M] data: generated in {made['seconds']:.2f} s by a process "
        f"of its own from the script's start, loaded in {times['data']:.2f}"
        f" s [{card}]")
    idx = IVFFlatIndex(D10M, NLIST, storage="sq8")
    _, times["train"] = synced(lambda: idx.train(xb[:400_000]))
    _, times["add+pack"] = synced(lambda: (idx.add(xb), idx.arrays))
    mr, times["multirow"] = synced(lambda: idx.enable_multirow())
    a, rows = idx.arrays, mr.rows
    check(a.db.dtype == torch.uint8 and rows.db.dtype == torch.uint8
          and a.db.shape[2] == D10M, f"SQ8 storage: {a.db.dtype} "
          f"{tuple(a.db.shape)}")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)
    log(f"[sq8 10M] index: {NB10M}x{D10M} SQ8, nlist {NLIST}, cap {a.cap} "
        f"(packing {idx.packing_efficiency:.3f}), rows {rows.db.shape[0]}x"
        f"{rows.db.shape[1]}; on the card: padded codes "
        f"{nbytes(a.db) / 2**30:.3f} GiB, row codes "
        f"{nbytes(rows.db) / 2**30:.3f} GiB, norms "
        f"{nbytes(a.db_sq, rows.db_sq) / 2**30:.3f} GiB, ids "
        f"{nbytes(a.vec_ids, rows.vec_ids) / 2**30:.3f} GiB; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]")
    (gt_D, gt_I), times["exact_search"] = synced(
        lambda: idx.exact_search(xq, MAX_TOPK, batch=1000))
    return dict(idx=idx, xb=xb, xq=xq, gt_D=gt_D, gt_I=gt_I, times=times,
                sha1={k: made[k] for k in ("xb", "xq")})


def sq8_10m_phase(card: str, profile_dir: str | None,
                  corpora: dict) -> dict:
    """[sq8 10M]: the headline configuration on the port's main path:
    profile training (K2 on the padded codes), calibration, the held-out
    window (one-shot engine, K1 on the row codes) and batch-1 windows,
    worst-case recall@10 >= 0.9 or the run fails; then fixed-nprobe
    search on the dense route against the gathers, and with max_codes;
    then K1 and K2 against their plain versions at worklists recorded from
    this path. Returns the main path's launches, the kernels' numbers, its
    ErrorSys (the index and the ground truth with it) for [eval 10M], and
    the corpus (vectors, queries, trained centroids) for [pq 10M]."""
    from auncel_tpu_torch import ErrorSys

    c = build_10m(card, corpora)
    idx, xq, gt_D, times = c["idx"], c["xq"], c["gt_D"], c["times"]
    reset_counts()
    es = ErrorSys(idx, train_num=START10M + N_TEST_Q, max_topk=MAX_TOPK)
    es.set_gt(gt_D, c["gt_I"])
    (_, times["sys_train"]), train = counted(
        lambda: synced(lambda: es.sys_train(PROFILE10M, xq)))
    es.set_topk(K)
    es.set_queries(N_TEST_Q, xq, np.full(START10M + N_TEST_Q, 1.0 - EPS,
                                         np.float32))
    mult, times["calibrate"] = synced(
        lambda: es.calibrate(PROFILE10M, CAL10M, target_bound=1.0 - EPS))
    log(f"[sq8 10M] calibrate on [{PROFILE10M}, {PROFILE10M + CAL10M}): "
        f"multipler={mult:.3f} std_m={es.std_m} _cal_mean_scan="
        f"{es._cal_mean_scan:.3f} _dense_min_bsz={es._dense_min_bsz}")
    window = serve_window(es, gt_D, card, "sq8 10M", start=START10M)
    times["search"] = window["seconds"]
    lat = serve_batch1(es, N_LATENCY10M, card, "sq8 10M latency",
                       start=START10M)
    launches = launch_counts()
    log("[sq8 10M stages] " + " ".join(f"{k}={v:.2f}s"
                                       for k, v in times.items())
        + f" [{card}]")
    log(f"[sq8 10M] launches over the path: {launches}, profile training "
        f"{train}")
    check(train["scan_scores"] > 0, "10M profile training never launched K2")
    check(window["launches"]["rowscan_scores"] > 0
          and lat.get("rowscan_scores", 0) > 0, "10M search never launched K1")
    for part in (train, window["launches"], lat):
        check_merges("sq8 10M", part)
    if profile_dir:
        profile_call(lambda: es.search(START10M, N_TEST_Q), profile_dir,
                     card, "sq8 10M window")
        profile_call(lambda: es.search(START10M, 1), profile_dir, card,
                     "sq8 10M batch1")
    with uncounted():
        fixed_10m(idx, xq, card)
        kernels = kernels_10m(es, xq, card)
    return {"launches": launches, "kernels": kernels,
            "min_recall": window["min_recall"],
            "window_ms": window["seconds"] * 1e3, "es": es,
            "corpus": dict(xb=c["xb"], xq=xq, centroids=idx.centroids,
                           sha1=c["sha1"])}


def dense_against_gathers(idx, q: np.ndarray, nprobe: int) -> dict:
    """Fixed-nprobe search of q at nprobe on the dense route (dense_cut
    0.0 forces it) and on the gathers (dense_cut None), timed in turns
    (medians of 4 calls each); the id positions that differ and the
    largest |D| difference against 1e-5 of q_sq + db_sq, the rule
    strict_phase judges by. idx.dense_cut is restored."""
    cut = idx.dense_cut

    def route(c):
        def run():
            idx.dense_cut = c
            return idx.search(q, K, nprobe=nprobe)
        return run
    try:
        (Dd, Id), (Dg, Ig) = route(0.0)(), route(None)()
        ms_d, ms_g, t_d, t_g = in_turns(route(0.0), route(None), 2)
    finally:
        idx.dense_cut = cut
    norms = result_norms(idx)
    q_sq = (q * q).sum(1)
    terms = q_sq[:, None] + np.maximum(
        norms[torch.as_tensor(Id, device=idx.device)].cpu().numpy(),
        norms[torch.as_tensor(Ig, device=idx.device)].cpu().numpy())
    diff = np.abs(Dd - Dg)
    return {"ms_dense": ms_d, "ms_gathers": ms_g, "times_dense": t_d,
            "times_gathers": t_g, "ids_differ": int((Id != Ig).sum()),
            "max_diff": float(diff.max()),
            "tol": float(1e-5 * terms.max()),
            "ok": bool((diff <= 1e-5 * terms).all())}


def fixed_10m(idx, xq, card: str) -> None:
    """Fixed-nprobe search of the held-out queries at nprobe 32: the
    default route (the dense crossover: 1000 x 32 passes 64 x 0.25 x
    nlist) against dense_cut None (the gathers), ids equal except where
    the two distances lie within 1e-5 of q_sq + db_sq, as strict_phase
    judges; then max_codes against the fixed-nprobe search at each query's
    own limit."""
    from auncel_tpu_torch.index.scan import coarse_rank, maxcodes_limit
    q = xq[START10M:START10M + N_TEST_Q]
    nprobe = FIXED_NPROBE10M
    check(idx.dense_route(N_TEST_Q, nprobe), "nprobe 32 is not dense")
    r = dense_against_gathers(idx, q, nprobe)
    log(f"[sq8 10M fixed] B={N_TEST_Q} nprobe={nprobe}: dense route "
        f"{r['ms_dense']:.2f} ms ({r['times_dense']}) against gather "
        f"{r['ms_gathers']:.2f} ms ({r['times_gathers']}); id positions "
        f"that differ {r['ids_differ']}; max |D| diff {r['max_diff']:.3g} "
        f"(largest 1e-5 (q_sq + db_sq) {r['tol']:.3g}) [{card}]")
    check(r["ok"], "10M dense and gather distances beyond 1e-5 of q_sq + "
          "db_sq")
    # max_codes: each query's limit, then the plain search at that limit
    idx.max_codes = MAX_CODES10M
    (Dm, Im), t_m = synced(lambda: idx.search(q, K, nprobe=nprobe))
    idx.max_codes = 0
    qt = torch.as_tensor(q, device=idx.device)
    _, cids = coarse_rank(idx.arrays, qt, idx.metric, rank_k=nprobe)
    g = maxcodes_limit(idx.arrays.list_sizes[cids.long()], nprobe,
                       MAX_CODES10M).cpu().numpy()
    bad = 0
    idx.dense_cut = None   # max_codes gathers; so do the searches it is
    for lim in np.unique(g):  # held to
        sel = np.where(g == lim)[0]
        _, Il = idx.search(q[sel], K, nprobe=int(lim))
        bad += int((Il != Im[sel]).any(axis=1).sum())
    idx.dense_cut = 0.25
    log(f"[sq8 10M fixed] max_codes {MAX_CODES10M} at nprobe {nprobe}: "
        f"lists scanned {g.min()}-{g.max()} (mean {g.mean():.2f}), "
        f"{t_m * 1e3:.2f} ms; queries whose ids differ from the search at "
        f"their own limit {bad} [{card}]")
    check(bad == 0, "10M max_codes differs from the search at its limits")


def kernels_10m(es, xq, card: str) -> dict:
    """K1 and K2 on the SQ8 codes at worklists recorded from the 10M path:
    the held-out window's row scans, a batch-1 search's and a profile-
    training chunk (the largest recorded K2 call), each against its plain
    version within 1e-5 of q_sq + db_sq."""
    from auncel_tpu_torch.profile.trainer import train_profile
    idx = es.index
    out = {}
    calls = record_row_scans(lambda: es.search(START10M, N_TEST_Q))
    tot = k1_recorded("10M window", calls, card, tag="k1 sq8",
                      worklist=True, reps=RECORDED_REPS10M)
    calls1 = record_row_scans(lambda: es.search(START10M, 1))
    k1_recorded("10M batch 1", calls1, card, tag="k1 sq8", worklist=True,
                reps=RECORDED_REPS10M)
    big = max(calls, key=lambda c: int((c[1][6] >= 0).sum()))
    out["rowscan_scores"] = k1_compare(
        f"10M window, the largest row scan ({big[0]})", big[1], big[2], card,
        reps=10, terms_tol=True, codec=big[3], label="k1 sq8")
    out["rowscan_scores"]["window_ms"] = tot["ms"]
    q = xq[:100]
    k2_calls = record_row_scans(
        lambda: train_profile(idx.arrays, q, es.gt_D[:100], MAX_TOPK,
                              idx.metric, n_batches=1), "scan_scores")
    chunk = max(k2_calls, key=lambda c: c[1][6].numel())
    out["scan_scores"] = k2_compare(
        f"10M training chunk ({len(k2_calls)} calls; B x n_slots "
        f"{tuple(chunk[1][6].shape)})", chunk[1], chunk[2], card, reps=10,
        terms_tol=True, codec=chunk[3], label="k2 sq8")
    del calls, calls1, big, k2_calls, chunk
    torch.cuda.empty_cache()
    topk_recorded("sq8 10M window", record_merges(
        lambda: es.search(START10M, N_TEST_Q)), card, RECORDED_REPS10M)
    topk_recorded("sq8 10M batch 1 (5 queries)", record_merges(
        lambda: [es.search(START10M + i, 1) for i in range(5)]), card)
    merges = record_merges(
        lambda: train_profile(idx.arrays, q, es.gt_D[:100], MAX_TOPK,
                              idx.metric, n_batches=1))
    topk_recorded("sq8 10M training chunk", [max(
        merges, key=lambda c: c[3].numel())], card)
    del merges
    torch.cuda.empty_cache()
    return out


# [eval 10M]: the JAX package's headline evaluation at synthDeep10M with
# SQ8 storage, on the [sq8 10M] phase's objects, through the port's
# counterparts of its three programs: ``compare synthDeep10M 3000 1000 10
# 0.10 --storage sq8 --profile-size 1000`` (Compare_synthDeep10M.log),
# scripts/latency_fig.py (*_Latency_synthDeep10M_10_10.log) and
# scripts/matrix10M.py (Matrix_synthDeep10M.log).
EVAL10M_DB = "synthDeep10M"
ROOT = os.path.dirname(os.path.abspath(__file__))
TPU_DECISIONS = "the TPU record's decisions"


def git_status() -> str | None:
    """``git status --porcelain`` of this script's tree, or None when the
    tree is not the root of a git checkout (or git is missing)."""
    def git(*args):
        out = subprocess.run(["git", *args], cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        return out.stdout if out.returncode == 0 else None
    try:
        top = git("rev-parse", "--show-toplevel")
        if top is None or (os.path.realpath(top.strip())
                           != os.path.realpath(ROOT)):
            return None
        return git("status", "--porcelain")
    except (OSError, subprocess.TimeoutExpired):
        return None


def start_10m_corpora() -> dict:
    """Start, in a process of its own at the lowest priority and in a new
    temporary directory, the two synthDeep10M corpora that the 10M phases
    need, while the kernels build and the earlier phases run: first
    build_10m's (``data_10m_params``), saved as ``xb10m.npy`` and
    ``xq10m.npy`` for [sq8 10M], then the harness's own,
    ``common.load_dataset("synthDeep10M", nq=4000)`` with ``BENCH_CACHE``
    under the directory [eval 10M] runs in; each step's seconds (and the
    harness's SHA-1s) in a JSON file that ``corpora_result`` reads. Also
    reads the tree's git status. The process ends, and the directory goes,
    at ``stop_10m_corpora`` or at exit."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_10m_")
    nq = START10M + N_TEST_Q
    code = ("import hashlib, json, os, time\n"
            "os.nice(19)\n"
            "import numpy as np\n"
            "from auncel_tpu_torch.data import make_clustered_dataset\n"
            "def done(name, arrays, **kw):\n"
            "    for k, v in zip(('xb', 'xq'), arrays):\n"
            "        v = np.ascontiguousarray(v)\n"
            "        kw[k] = hashlib.sha1(v).hexdigest()\n"
            "    with open(name + '.part', 'w') as f:\n"
            "        json.dump(kw, f)\n"
            "    os.replace(name + '.part', name + '.json')\n"
            "t0 = time.perf_counter()\n"
            f"ds = make_clustered_dataset(**{data_10m_params()!r})\n"
            f"xb, xq = ds.xb, ds.xq[:{nq}]\n"
            "np.save('xb10m.npy', xb)\n"
            "np.save('xq10m.npy', xq)\n"
            "t = time.perf_counter() - t0\n"
            "done('build10m', (xb, xq), seconds=t)\n"
            "del ds, xb, xq\n"
            "t0 = time.perf_counter()\n"
            "from auncel_tpu_torch.eval_harness import common\n"
            f"d = common.load_dataset({EVAL10M_DB!r}, nq={nq})\n"
            "t = time.perf_counter() - t0\n"
            "done('harness10m', (d.xb, d.xq), tag=d.cache_tag, seconds=t)\n")
    env = dict(os.environ, BENCH_CACHE=os.path.join(tmp, "bench_cache"),
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                             if p]))
    with open(os.path.join(tmp, "corpora.err"), "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=tmp,
                                env=env, stdin=subprocess.DEVNULL,
                                stdout=subprocess.DEVNULL, stderr=err)
    h = {"tmp": tmp, "proc": proc, "git": git_status()}
    atexit.register(stop_10m_corpora, h)
    return h


def stop_10m_corpora(h: dict) -> None:
    """End the corpora's process if it still runs and remove its
    directory; a second call does nothing."""
    import shutil
    proc = h.pop("proc", None)
    if proc is None:
        return
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    shutil.rmtree(h["tmp"], ignore_errors=True)


def corpora_result(h: dict, name: str) -> dict:
    """The JSON that ``start_10m_corpora``'s process writes at the end of
    step ``name``, once it is there; the run fails if the process ended
    without it."""
    path = os.path.join(h["tmp"], f"{name}.json")
    while not os.path.exists(path):
        if h["proc"].poll() is not None and not os.path.exists(path):
            with open(os.path.join(h["tmp"], "corpora.err")) as f:
                check(False, f"the 10M corpora's process ended with "
                      f"{h['proc'].returncode} before {name}: "
                      f"{f.read()[-2000:]}")
        time.sleep(0.2)
    with open(path) as f:
        return json.load(f)


def seed_harness_caches(es, tmp: str, tag: str) -> None:
    """The [sq8 10M] index's trained quantizer (an empty IVF1024,SQ8 on its
    centroids: add() trains the SQ range on the whole corpus, as there)
    and its ground truth, under the harness's cache names in ``tmp``."""
    from auncel_tpu_torch import IVFFlatIndex
    from auncel_tpu_torch.index.io import save_index
    os.makedirs(os.path.join(tmp, "trained_index"), exist_ok=True)
    q = IVFFlatIndex(D10M, NLIST, storage="sq8")
    q.set_centroids(es.index.centroids)
    name = f"{EVAL10M_DB}{tag}_IVF{NLIST},SQ8_trained.npz"
    save_index(q, os.path.join(tmp, "trained_index", name))
    np.savez(os.path.join(tmp, "bench_cache",
                          f"gt_{EVAL10M_DB}{tag}_sq8.npz"),
             D=es.gt_D, I=es.gt_I)


def tpu_record(name: str) -> list:
    """The lines of one of the JAX package's records in the tree's root
    (none where the tree does not hold it)."""
    path = os.path.join(ROOT, name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln for ln in f.read().splitlines() if ln.strip()]


def tpu_compare_row(system: str) -> str:
    """The TPU record's mean probes and bound for one compare row; no time
    and no qps of the TPU."""
    for ln in tpu_record(f"Compare_{EVAL10M_DB}.log"):
        f = ln.split()
        if f[0] == system:
            return (f"{TPU_DECISIONS} (Compare_{EVAL10M_DB}.log): mean "
                    f"probes {f[2]}, worst recall@{K} {f[3]}, bound_ok "
                    f"{float(f[3]) >= 1.0 - EPS}")
    return f"{TPU_DECISIONS}: no {system} row in this tree"


def tpu_matrix_cell(k: int, eps: float) -> str:
    for ln in tpu_record(f"Matrix_{EVAL10M_DB}.log"):
        r = json.loads(ln)
        if (r["k"], r["eps"]) == (k, eps):
            return (f"{TPU_DECISIONS} (Matrix_{EVAL10M_DB}.log): mean_scan "
                    f"{r['mean_scan']}, bound_ok {r['bound_ok']}")
    return f"{TPU_DECISIONS}: no k {k} eps {eps} cell in this tree"


def load_script(name: str):
    """scripts/<name>.py of this tree as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ms_stats(lat: np.ndarray) -> str:
    lat = np.asarray(lat) * 1e3
    return (f"mean {lat.mean():.2f} ms, p50 {np.percentile(lat, 50):.2f} "
            f"ms, p99 {np.percentile(lat, 99):.2f} ms")


def eval_10m_phase(sq8: dict, corpora: dict, card: str) -> dict:
    """[eval 10M]: compare, the batch-1 latency script and the k x eps
    matrix on the [sq8 10M] phase's index, ErrorSys and ground truth, from
    the harness's temporary directory, each with the launch counts set to
    0 before it and read after. compare runs through its own entry point
    on the caches: when the harness's own corpus (generated from the
    script's start by ``start_10m_corpora``) hashes equal to build_10m's,
    the
    quantizer and ground-truth caches are seeded from [sq8 10M]; else the
    harness builds its own. Fails unless Auncel's worst recall@10 in the
    compare is at least 0.9, the matrix's k 10, eps 0.10 cell holds, K1,
    K2 and the merge launched (every merge of index/scan.py through the
    kernel) and the tree's git status is unchanged. Returns the launches
    over the phase."""
    from auncel_tpu_torch.autotune import ParameterSpace
    from auncel_tpu_torch.eval_harness import common, compare
    es = sq8["es"]
    xq = sq8["corpus"]["xq"]
    tmp = corpora["tmp"]
    t_phase = time.perf_counter()
    gen = corpora_result(corpora, "harness10m")
    t_wait = time.perf_counter() - t_phase
    ours = sq8["corpus"]["sha1"]
    same = ours == {k: gen[k] for k in ours}
    log(f"[eval 10M] common.load_dataset({EVAL10M_DB!r}, nq={len(xq)}) "
        f"in its own process from the script's start: {gen['seconds']:.1f} "
        f"s (waited {t_wait:.1f} s more for it); SHA-1 xb {gen['xb']} xq "
        f"{gen['xq']} against build_10m's xb {ours['xb']} xq {ours['xq']}: "
        + ("equal, so compare's caches (quantizer, ground truth) are "
           "[sq8 10M]'s" if same else
           "DIFFERENT, so the harness builds its own quantizer and ground "
           "truth on its own copy"))
    if same:
        seed_harness_caches(es, tmp, gen["tag"])
    here, saved_cache = os.getcwd(), os.environ.get("BENCH_CACHE")
    totals, times = {}, {}

    def add(n):
        for k, v in n.items():
            totals[k] = totals.get(k, 0) + v
    os.chdir(tmp)
    os.environ["BENCH_CACHE"] = os.path.join(tmp, "bench_cache")
    try:
        with last_call(ParameterSpace, "tune_for_bound") as tuned, \
                timed_calls(common, "load_dataset", times, "load"), \
                timed_calls(common, "build_or_load_index", times, "build"), \
                timed_calls(common, "ensure_gt", times, "gt"):
            rows, n, dt = driven("10M compare", lambda: compare.run(
                EVAL10M_DB, START10M, N_TEST_Q, K, EPS, nlist=NLIST,
                max_topk=MAX_TOPK, log_dir=tmp, profile_size=PROFILE10M,
                storage="sq8"))
        add(n)
        log(f"[eval 10M compare] {EVAL10M_DB} 3000 1000 10 0.10 --storage "
            f"sq8 --profile-size 1000: {dt:.1f} s, of it load_dataset "
            f"{times['load']:.1f} s, build_or_load_index {times['build']:.1f}"
            f" s, ensure_gt {times['gt']:.1f} s"
            + ("" if same else f" (the harness's own copy: its generation "
               f"{gen['seconds']:.1f} s beside these)") + f" [{card}]")
        for r in rows:
            log(f"[eval 10M compare] {r['system']}: qps={r['qps']:.1f} mean "
                f"probes={r['mean_probes']:.2f} worst recall@{K}="
                f"{r['min_recall']:.3f} mean recall@{K}="
                f"{r['mean_recall']:.4f} [{card}]; "
                + tpu_compare_row(r["system"]))
        by = {r["system"]: r for r in rows}
        nprobe = int(by["elp"]["mean_probes"])
        npm = int(by.get("elp_margin", by["elp"])["mean_probes"])
        log(f"[eval 10M compare] ELP's tuned nprobe {nprobe} without "
            f"headroom, {npm} with one neighbour of headroom (1/{K})")
        check(by["auncel"]["min_recall"] >= 1.0 - EPS,
              f"[eval 10M compare] Auncel's worst recall@{K} "
              f"{by['auncel']['min_recall']}")
        check(n["rowscan_scores"] > 0 and n["scan_scores"] > 0,
              f"[eval 10M compare] launches {n}")
        check_merges("eval 10M compare", n)
        idx = tuned["self"].index
        q = xq[START10M:START10M + N_TEST_Q]
        with uncounted():
            for name, p in {"elp": nprobe, "elp_margin": npm}.items():
                if name == "elp_margin" and p == nprobe:
                    continue
                r = dense_against_gathers(idx, q, p)
                used = ("dense" if idx.dense_route(N_TEST_Q, p)
                        else "gathers (K1)")
                log(f"[eval 10M compare] {name} nprobe {p} over the "
                    f"{N_TEST_Q} held-out queries: dense route "
                    f"{r['ms_dense']:.2f} ms ({r['times_dense']}), gathers "
                    f"{r['ms_gathers']:.2f} ms ({r['times_gathers']}); the "
                    f"row used the {used} route; id positions that differ "
                    f"{r['ids_differ']}, max |D| diff {r['max_diff']:.3g} "
                    f"(largest 1e-5 (q_sq + db_sq) {r['tol']:.3g}) [{card}]")
                check(r["ok"], f"[eval 10M compare] {name}: dense and "
                      "gather distances beyond 1e-5 of q_sq + db_sq")
        del idx, tuned
        torch.cuda.empty_cache()

        lat_script = load_script("torch_latency_fig")
        lat, n, dt = driven("10M latency", lambda: lat_script.run(
            es, es.gt_D, xq, EVAL10M_DB, START10M, N_TEST_Q, K, EPS,
            N_LATENCY10M, PROFILE10M, out_dir=tmp,
            elp_nprobe=npm if same else None))
        add(n)
        log(f"[eval 10M latency] {N_LATENCY10M} held-out queries at batch "
            f"1 (multipler {lat['multipler']:.3f}, std_m {lat['std_m']}): "
            f"Auncel {ms_stats(lat['auncel_lat'])}, the window's worst "
            f"recall@{K} {lat['min_recall']:.3f} bound_ok {lat['bound_ok']}"
            f"; ELP at nprobe {lat['elp_nprobe']}"
            + (" (compare's, tuned with headroom 1/k)" if same else "")
            + f" {ms_stats(lat['elp_lat'])}, worst recall@{K} "
            f"{lat['elp_min_recall']:.3f} bound_ok {lat['elp_bound_ok']}; "
            f"mean per-query slowdown ELP/Auncel {lat['slowdown']:.3f}; "
            f"logs {sorted(os.path.basename(p) for p in lat['logs'].values())}"
            f", figures {len(lat['figures'])} [{card}]; the TPU record "
            f"(*_Latency_{EVAL10M_DB}_10_10.log) holds times only: none "
            "quoted")
        check(n["rowscan_scores"] > 0, f"[eval 10M latency] launches {n}")
        check_merges("eval 10M latency", n)

        mat_script = load_script("torch_matrix10M")
        mat, n, dt = driven("10M matrix", lambda: mat_script.run(
            es, es.gt_D, xq, EVAL10M_DB, PROFILE10M, CAL10M, N_TEST_Q,
            out_dir=tmp))
        add(n)
        for r in mat:
            log(f"[eval 10M matrix] k {r['k']} eps {r['eps']}: multipler "
                f"{r['multipler']} std_m {r['std_m']} min_recall "
                f"{r['min_recall']} bound_ok {r['bound_ok']} mean_scan "
                f"{r['mean_scan']} qps {r['qps']} [{card}]; "
                + tpu_matrix_cell(r["k"], r["eps"]))
        held = sum(r["bound_ok"] for r in mat)
        log(f"[eval 10M matrix] {held}/{len(mat)} cells hold; the cell k "
            f"{K} eps {EPS} is checked, the others reported")
        cell = next(r for r in mat if (r["k"], r["eps"]) == (K, EPS))
        check(cell["bound_ok"], f"[eval 10M matrix] k {K} eps {EPS}: {cell}")
        check(n["rowscan_scores"] > 0, f"[eval 10M matrix] launches {n}")
        check_merges("eval 10M matrix", n)
    finally:
        os.chdir(here)
        if saved_cache is None:
            os.environ.pop("BENCH_CACHE", None)
        else:
            os.environ["BENCH_CACHE"] = saved_cache
    after = git_status()
    if corpora["git"] is None:
        log("[eval 10M] the tree is not the root of a git checkout here: "
            "its git status is not compared")
    else:
        check(after == corpora["git"], "[eval 10M] the run changed the "
              f"tree's git status: {corpora['git']!r} -> {after!r}")
        log("[eval 10M] the tree's git status is the same before and after")
    check(totals["rowscan_scores"] > 0 and totals["scan_scores"] > 0,
          f"[eval 10M] launches {totals}")
    check_merges("eval 10M", totals)
    log(f"[eval 10M] {time.perf_counter() - t_phase:.1f} s; launches over "
        f"the phase: {totals} [{card}]")
    return {"launches": totals}


# [pq 10M]: residual IVFPQ (the JAX package's "IVFn,PQm" cell with the
# reference IVFPQ's by-residual default, auncel_tpu/index/ivf.py:399-438)
# on the same synthDeep10M corpus, served by the padded engines with every
# probe scored by K2 on the codes: IVF1024,PQ16 (16 bytes a vector), the
# [sq8 10M] phase's coarse quantizer, polysemous codebooks so that the
# Hamming filter of fixed-nprobe search is meaningful. Profile, calibration
# and held-out queries as in [sq8 10M].
PQ_M10M = 16
PQ_HT10M = (48, 64, 8 * PQ_M10M)   # Hamming thresholds; the last is off


@contextlib.contextmanager
def timed_calls(module, name: str, times: dict, key: str):
    """Add the seconds (synchronised) of each call of module.name made
    inside the block to times[key]."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        out, dt = synced(lambda: real(*args, **kw))
        times[key] = times.get(key, 0.0) + dt
        return out
    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def build_pq10m(corpus: dict, card: str) -> dict:
    """The IVF1024,PQ16 residual index on the card (the coarse centroids
    set, not trained again; PQ training on the first 200 000 residuals, the
    polysemous reordering, the encode and the decoded norms timed apart)
    and the ground truth of the first 4000 queries on it."""
    import auncel_tpu_torch.index.ivf as ivf
    from auncel_tpu_torch import IVFFlatIndex
    times = {}
    xb, xq = corpus["xb"], corpus["xq"]
    idx = IVFFlatIndex(D10M, NLIST, storage=f"pq{PQ_M10M}", polysemous=True)
    idx.set_centroids(corpus["centroids"])
    with timed_calls(ivf, "train_pq", times, "pq train"), \
            timed_calls(ivf, "reorder_codebook", times, "polysemous"), \
            timed_calls(ivf, "encode_pq", times, "encode"), \
            timed_calls(ivf, "_decoded_norms", times, "norms"):
        _, times["add+pack"] = synced(lambda: (idx.add(xb), idx.arrays))
    a = idx.arrays
    check(a.db.dtype == torch.uint8 and a.db.shape[2] == PQ_M10M
          and a.pq_residual and a.pq_codebooks is not None,
          f"PQ storage: {a.db.dtype} {tuple(a.db.shape)}")

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)
    log(f"[pq 10M] index: {NB10M}x{D10M} PQ{PQ_M10M} residual, nlist "
        f"{NLIST}, cap {a.cap} (packing {idx.packing_efficiency:.3f}); on "
        f"the card: codes {nbytes(a.db) / 2**30:.3f} GiB, norms "
        f"{nbytes(a.db_sq) / 2**30:.3f} GiB, ids "
        f"{nbytes(a.vec_ids) / 2**30:.3f} GiB, codebook "
        f"{nbytes(a.pq_codebooks) / 2**10:.0f} KiB; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]")
    (gt_D, gt_I), times["exact_search"] = synced(
        lambda: idx.exact_search(xq, MAX_TOPK, batch=1000))
    return dict(idx=idx, xq=xq, gt_D=gt_D, gt_I=gt_I, times=times)


def pq_10m_phase(corpus: dict, card: str, profile_dir: str | None,
                 gt_ids: np.ndarray) -> dict:
    """[pq 10M]: residual IVFPQ on the port's main path, the padded
    engines with K2 on the codes: profile training, calibration, the
    held-out window (worst-case recall@10 >= 0.9 or the run fails) and
    batch-1 windows, fixed-nprobe search with and without the polysemous
    filter; then K2 against its plain version at calls recorded from this
    path. Returns the main path's launches and the kernel's numbers."""
    from auncel_tpu_torch import ErrorSys
    c = build_pq10m(corpus, card)
    idx, xq, gt_D, times = c["idx"], c["xq"], c["gt_D"], c["times"]
    reset_counts()
    es = ErrorSys(idx, train_num=START10M + N_TEST_Q, max_topk=MAX_TOPK)
    es.set_gt(gt_D, c["gt_I"])
    (_, times["sys_train"]), train = counted(
        lambda: synced(lambda: es.sys_train(PROFILE10M, xq)))
    es.set_topk(K)
    es.set_queries(N_TEST_Q, xq, np.full(START10M + N_TEST_Q, 1.0 - EPS,
                                         np.float32))
    mult, times["calibrate"] = synced(
        lambda: es.calibrate(PROFILE10M, CAL10M, target_bound=1.0 - EPS))
    log(f"[pq 10M] calibrate on [{PROFILE10M}, {PROFILE10M + CAL10M}): "
        f"multipler={mult:.3f} std_m={es.std_m} _cal_mean_scan="
        f"{es._cal_mean_scan:.3f}")
    window = serve_window(es, gt_D, card, "pq 10M", start=START10M)
    times["search"] = window["seconds"]
    lat = serve_batch1(es, N_LATENCY10M, card, "pq 10M latency",
                       start=START10M)
    fixed, rec_ids = fixed_pq10m(idx, xq, gt_D, card, gt_ids)
    launches = launch_counts()
    log("[pq 10M stages] " + " ".join(f"{k}={v:.2f}s"
                                      for k, v in times.items())
        + f" [{card}]")
    log(f"[pq 10M] launches over the path: {launches}, profile training "
        f"{train}, fixed-nprobe {fixed}")
    check(train["scan_scores"] > 0, "PQ profile training never launched K2")
    check(window["launches"]["scan_scores"] > 0
          and lat.get("scan_scores", 0) > 0 and fixed["scan_scores"] > 0,
          "PQ search never launched K2")
    for part in (train, window["launches"], lat, fixed):
        check_merges("pq 10M", part)
    check(launches["rowscan_scores"] == 0 and launches["rowscan_dots"] == 0,
          "the PQ path launched K1, whose layout refuses PQ")
    if profile_dir:
        profile_call(lambda: es.search(START10M, N_TEST_Q), profile_dir,
                     card, "pq 10M window")
        profile_call(lambda: es.search(START10M, 1), profile_dir, card,
                     "pq 10M batch1")
    with uncounted():
        kernels = kernels_pq10m(es, xq, card)
    return {"launches": launches, "kernels": kernels,
            "filter_launches": fixed["filter"],
            "min_recall": window["min_recall"], "recall_ids": rec_ids}


def fixed_pq10m(idx, xq, gt_D, card: str, gt_ids: np.ndarray) -> tuple:
    """Fixed-nprobe search of the held-out queries at nprobe 32, then with
    the polysemous filter (inside K2) at each PQ_HT10M (the last keeps
    every code, so its ids equal the unfiltered search's), each below
    128 bits held to the same search with the filter as a plain-torch
    mask on K2's output (pq_masked; equal ids and kept distances, or the
    run fails); recall@10 against the ground truth over the codes (and,
    unfiltered, by ids against ``gt_ids``, the float ground truth) and
    the least time of FIXED_REPS10M calls of each; then the query codes'
    encode alone. Returns the launches (the filtered
    searches' apart, under "filter") and the unfiltered recall by ids."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.autotune import recall_counts
    q = xq[START10M:START10M + N_TEST_Q]
    gt = gt_D[START10M:START10M + N_TEST_Q]
    nprobe = FIXED_NPROBE10M

    def run():
        (Dq, Iq), t = synced(lambda: idx.search(q, K, nprobe=nprobe))
        for _ in range(FIXED_REPS10M - 1):
            t = min(t, synced(lambda: idx.search(q, K, nprobe=nprobe))[1])
        cnt = recall_counts(Dq, gt, K, Metric.L2)
        return Dq, Iq, t, cnt

    seen = {"live": 0, "kept": 0}

    def masked(real, *args, qcodes=None, ht=None, **kw):
        out = real(*args, **kw)
        if qcodes is None:
            return out
        out_m = pq_masked(*out, args[0], args[6], args[7], qcodes, ht)
        seen["live"] += int((out[1] >= 0).sum())
        seen["kept"] += int((out_m[1] >= 0).sum())
        return out_m

    (D0, I0, t0, c0), n = counted(run)
    check(D0.shape == (N_TEST_Q, K) and np.isfinite(D0).all(),
          "PQ fixed-nprobe results")
    rec_ids = id_recall(I0, gt_ids)
    log(f"[pq 10M fixed] B={N_TEST_Q} nprobe={nprobe}: {t0 * 1e3:.2f} ms, "
        f"recall@{K} worst {c0.min() / K:.3f} mean {c0.mean() / K:.4f}; by "
        f"ids against the float ground truth {rec_ids:.4f} [{card}]")
    total = dict(n)
    total["filter"] = 0
    for ht in PQ_HT10M:
        idx.polysemous_ht = ht
        (Dh, Ih, th, ch), n = counted(run)
        for k, v in n.items():
            total[k] += v
        total["filter"] += n["scan_scores"]
        kept = Ih >= 0
        check(np.isfinite(Dh[kept]).all() and (~np.isfinite(Dh[~kept])).all(),
              f"PQ ht={ht}: results")
        if ht == 8 * PQ_M10M:
            check(np.array_equal(Ih, I0) and bool(
                (np.abs(Dh - D0) <= 1e-5 * np.abs(D0) + 1e-5).all()),
                "the filter at every bit differs from the unfiltered search")
        mask = ""
        if ht < 8 * PQ_M10M:
            seen.update(live=0, kept=0)
            with uncounted(), scans_through(masked, "scan_scores"):
                Dm, Im, tm, _ = run()
            check(np.array_equal(Ih, Im),
                  f"PQ ht={ht}: the fused filter's ids differ from the "
                  f"plain mask's")
            # a kept slot's score is summed as without the filter
            check(np.array_equal(np.where(Im >= 0, Dh, 0),
                                 np.where(Im >= 0, Dm, 0)),
                  f"PQ ht={ht}: the fused filter's distances differ from "
                  f"the plain mask's")
            mask = (f"; the filter as a plain-torch mask on K2's output "
                    f"{tm * 1e3:.2f} ms, equal ids and distances, probed "
                    f"codes kept {seen['kept'] / max(seen['live'], 1):.4f}")
        log(f"[pq 10M fixed] polysemous ht={ht}: {th * 1e3:.2f} ms "
            f"({th / t0:.3f}x the unfiltered), recall@{K} worst "
            f"{ch.min() / K:.3f} mean {ch.mean() / K:.4f}, results kept "
            f"{kept.mean():.4f}{mask} [{card}]")
    idx.polysemous_ht = 0
    log(f"[pq 10M fixed] the filter's query codes alone ({N_TEST_Q} x "
        f"{nprobe} encodes): {encode_ms(idx, q, nprobe)} [{card}]")
    return total, rec_ids


def encode_ms(idx, q, nprobe: int) -> str:
    """The host and device time of the filter's query codes at nprobe (the
    encode of ivf_search_fixed_ht: each query's residual to each probed
    centroid, or the query itself for plain PQ), the least of 5 calls."""
    from auncel_tpu_torch.index.scan import coarse_rank
    from auncel_tpu_torch.ops.pq import PQCodebooks, encode_pq
    a = idx.arrays
    qt = torch.as_tensor(q, device=a.db.device)
    _, cids = coarse_rank(a, qt, idx.metric)
    lists = cids[:, :nprobe].long()
    pq = PQCodebooks(a.pq_codebooks)

    def encode():
        t = (qt[:, None, :] - a.centroids[lists] if a.pq_residual
             else qt[:, None, :].expand(-1, nprobe, -1))
        return encode_pq(pq, t.reshape(-1, qt.shape[1]))
    host = min(synced(encode)[1] for _ in range(5)) * 1e3
    dev = device_ms(encode, 5)
    return (f"{host:.3f} ms, device time a call "
            + ("not measured" if dev is None else f"{dev:.3f} ms"))


def kernels_pq10m(es, xq, card: str) -> dict:
    """K2 on the PQ codes at calls recorded from the [pq 10M] path: the
    held-out window's largest, a batch-1 search's largest, a profile-
    training chunk and, from [pq 10M fixed]'s search with the polysemous
    filter at each PQ_HT10M below 8M bits, the largest filtered call (its
    query codes and ht passed to both versions), each against its plain
    version within 1e-5 of ||q - c_l||^2 + db_sq. Returns the window
    call's numbers (the kernels line's entry), with the others under
    "batch1", "train" and ("filter", ht)."""
    from auncel_tpu_torch.profile.trainer import train_profile
    idx = es.index
    q = xq[START10M:START10M + N_TEST_Q]

    def largest(calls):
        return max(calls, key=lambda c: int((c[1][6] >= 0).sum()))

    def filtered(ht):
        idx.polysemous_ht = ht
        try:
            idx.search(q, K, nprobe=FIXED_NPROBE10M)
        finally:
            idx.polysemous_ht = 0

    runs = [("window", "10M window", lambda: es.search(START10M, N_TEST_Q)),
            ("batch1", "10M batch 1", lambda: es.search(START10M, 1)),
            ("train", "10M training chunk",
             lambda: train_profile(idx.arrays, xq[:100], es.gt_D[:100],
                                   MAX_TOPK, idx.metric, n_batches=1))]
    runs += [(("filter", ht), f"10M fixed, filter ht={ht}",
              lambda ht=ht: filtered(ht))
             for ht in PQ_HT10M if ht < 8 * PQ_M10M]
    out = {}
    for key, label, fn in runs:
        calls = record_row_scans(fn, "scan_scores")
        stage, args, metric, kw = largest(calls)
        check(key[0] != "filter" or kw.get("qcodes") is not None,
              f"{label}: K2 was not given the query codes")
        out[key] = k2_compare(
            f"{label}, the largest of {len(calls)} calls (B x n_slots "
            f"{tuple(args[6].shape)})", args, metric, card,
            reps=200 if key == "batch1" else 10, terms_tol=True, codec=kw,
            label="k2 pq")
        del calls, args, kw
        torch.cuda.empty_cache()
    topk_recorded("pq 10M window", record_merges(
        lambda: es.search(START10M, N_TEST_Q)), card, RECORDED_REPS10M)
    torch.cuda.empty_cache()
    return {**out.pop("window"), **out}


# [pqr 10M]: IVFPQ with the refinement PQ re-rank (the reference's
# "PQ%d+%d" cell, AutoTune.cpp:854-866) on the synthDeep10M corpus and the
# [sq8 10M] phase's coarse centroids: "IVF1024,PQ16+16", k_factor 4.
PQR_NPROBE = 32


def float_gt_10m(corpus: dict) -> np.ndarray:
    """The true top-K ids of the held-out queries over the float corpus
    (exact kNN on the card)."""
    from auncel_tpu_torch.ops.knn import knn
    q = corpus["xq"][START10M:START10M + N_TEST_Q]
    return knn(q, corpus["xb"], K, device="cuda").ids.astype(np.int64)


def pqr_10m_phase(corpus: dict, gt_ids: np.ndarray, pq_recall: float,
                  card: str) -> dict:
    """[pqr 10M]: build (the base PQ's training and encoding, the refine
    PQ's training and encoding, timed apart), serve the 1000 held-out
    queries at nprobe 32 (the base search and the re-rank timed apart),
    recall@10 by ids against the float ground truth at least the
    unfiltered IVFPQ's of [pq 10M fixed] or the run fails;
    reconstruct_batch of 1000 ids against the same on the CPU; K2 against
    its plain version at the search's largest call."""
    import auncel_tpu_torch.index.ivf as ivf
    import auncel_tpu_torch.index.ivfpqr as ivfpqr
    from auncel_tpu_torch import index_factory
    times = {}
    idx = index_factory(D10M, f"IVF{NLIST},PQ{PQ_M10M}+{PQ_M10M}")
    check(isinstance(idx, ivfpqr.IndexIVFPQR) and idx.k_factor == 4.0,
          "the factory's IVFPQR cell")
    idx.set_centroids(corpus["centroids"])
    _, times["add"] = synced(lambda: idx.add(corpus["xb"]))
    with timed_calls(ivf, "train_pq", times, "pq train"), \
            timed_calls(ivf, "encode_pq", times, "pq encode"):
        _, times["pack"] = synced(lambda: idx.arrays)
    with timed_calls(ivfpqr, "train_pq", times, "refine train"), \
            timed_calls(ivfpqr, "encode_pq", times, "refine encode"):
        refine, times["refine"] = synced(idx._ensure_refine)
    a = idx.arrays

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)
    log(f"[pqr 10M] index: {NB10M}x{D10M} PQ{PQ_M10M}+{PQ_M10M}, nlist "
        f"{NLIST}, cap {a.cap}; on the card: base codes "
        f"{nbytes(a.db) / 2**30:.3f} GiB, norms and ids "
        f"{nbytes(a.db_sq, a.vec_ids) / 2**30:.3f} GiB, refine codes "
        f"{nbytes(refine[2]) / 2**30:.3f} GiB, slots "
        f"{nbytes(refine[1]) / 2**30:.3f} GiB; raw vectors kept on the host "
        f"{idx._raw_x.nbytes / 2**30:.3f} GiB; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB [{card}]")
    q = corpus["xq"][START10M:START10M + N_TEST_Q]
    reset_counts()
    split = {}
    with timed_calls(ivfpqr, "_rerank", split, "re-rank"):
        (_, I_out), t_all = synced(lambda: idx.search(q, K,
                                                       nprobe=PQR_NPROBE))
    launches = launch_counts()
    check(launches["scan_scores"] > 0, "IVFPQR search never launched K2")
    check_merges("pqr 10M", launches)
    k2 = round(idx.k_factor * K)
    warm = [synced(lambda: idx.search(q, K, nprobe=PQR_NPROBE))[1]
            for _ in range(3)]
    base = [synced(lambda: ivf.IVFFlatIndex.search(
        idx, q, k2, PQR_NPROBE))[1] for _ in range(3)]
    rec = id_recall(I_out, gt_ids)
    log(f"[pqr 10M] B={N_TEST_Q} nprobe={PQR_NPROBE} k_factor "
        f"{idx.k_factor:g}: search {np.median(warm) * 1e3:.2f} ms (cold "
        f"{t_all * 1e3:.2f} ms, its re-rank {split['re-rank'] * 1e3:.2f} ms), "
        f"the base search alone (k {k2}) {np.median(base) * 1e3:.2f} ms; "
        f"recall@{K} (ids, float ground truth) {rec:.4f} against the "
        f"unfiltered IVFPQ's {pq_recall:.4f} ([pq 10M fixed]); launches "
        f"{launches} [{card}]")
    check(rec >= pq_recall, f"IVFPQR recall@{K} {rec} below IVFPQ's "
          f"{pq_recall}")
    k640 = pqr_k_factor_64(idx, q[:100], card)
    keys = np.random.RandomState(3).choice(NB10M, 1000, replace=False)
    got = idx.reconstruct_batch(keys)
    sorted_ids, pos, codes, books = refine
    rows = torch.as_tensor(np.searchsorted(sorted_ids, keys))
    host = a._replace(db=a.db.cpu(), centroids=a.centroids.cpu(),
                      pq_codebooks=a.pq_codebooks.cpu())
    want = ivfpqr.two_stage(host, pos.cpu()[rows], codes.cpu()[rows],
                            books.cpu()).numpy()
    same = bool(np.array_equal(got, want))
    err = float(np.sqrt(((got - corpus["xb"][keys]) ** 2).sum(1)).mean())
    log(f"[pqr 10M] reconstruct_batch of 1000 ids equal to the CPU's: "
        f"{same}; mean reconstruction error {err:.4f}")
    check(same, "IVFPQR reconstructions differ from the CPU's")
    log("[pqr 10M stages] " + " ".join(f"{k}={v:.2f}s"
                                       for k, v in times.items())
        + f" [{card}]")
    with uncounted():
        calls = record_row_scans(
            lambda: ivf.IVFFlatIndex.search(idx, q, k2, PQR_NPROBE),
            "scan_scores")
        big = max(calls, key=lambda x: int((x[1][6] >= 0).sum()))
        kern = k2_compare(f"pqr 10M base search, the largest of {len(calls)}"
                          f" calls (B x n_slots {tuple(big[1][6].shape)})",
                          big[1], big[2], card, reps=10, terms_tol=True,
                          codec=big[3], label="k2 pqr")
    return {"launches": launches, "kernels": kern, "recall": rec,
            "k640_launches": k640}


# [pqr 10M] at k_factor 64: probes a query (fewer than the phase's 32, so
# that the CPU copy's plain scan stays short; 8 lists hold about 78k codes,
# far more than the base search's k 640)
PQR_K64_NPROBE = 8


def pqr_k_factor_64(idx, q: np.ndarray, card: str) -> int:
    """[pqr 10M] at k_factor 64, the top of ParameterSpace's sweep: the
    base search asks the merge kernel for k 640. The card's ids against a
    CPU copy of the index (the same codes, norms and refine state) on the
    same queries at PQR_K64_NPROBE, equal or the run fails, except where
    the two sides' values at a slot are within 1e-5 relative (a near-tie
    that the order of a float sum may turn)."""
    from auncel_tpu_torch.index.io import ivfpqr_from_codes
    a = idx.arrays
    sorted_ids, pos, codes, books = idx._ensure_refine()
    state = dict(centroids=idx.centroids, db=a.db.cpu().numpy(),
                 vec_ids=a.vec_ids.cpu().numpy(),
                 list_sizes=a.list_sizes.cpu().numpy(),
                 pq_books=a.pq_codebooks.cpu().numpy(),
                 refine_books=books.cpu().numpy(),
                 refine_codes=codes.cpu().numpy(),
                 refine_sorted_ids=sorted_ids, refine_pos=pos.cpu().numpy())
    header = dict(d=idx.d, nlist=idx.nlist, M=PQ_M10M, M_refine=PQ_M10M,
                  k_factor=64.0, metric="l2", ntotal=idx.ntotal)
    cpu = ivfpqr_from_codes(state, header, device="cpu")
    cpu._arrays = cpu._arrays._replace(db_sq=a.db_sq.cpu())
    cpu._refine_of = cpu._arrays
    idx.k_factor = 64.0
    try:
        reset_counts()
        (cv, ci), t_card = synced(lambda: idx.search(q, K,
                                                     nprobe=PQR_K64_NPROBE))
        launches = launch_counts()
        t0 = time.perf_counter()
        parts = [cpu.search(q[i:i + 25], K, nprobe=PQR_K64_NPROBE)
                 for i in range(0, len(q), 25)]
        t_cpu = time.perf_counter() - t0
    finally:
        idx.k_factor = 4.0
    check_merges("pqr 10M k_factor 64", launches)
    pv = np.concatenate([p[0] for p in parts])
    pi = np.concatenate([p[1] for p in parts])
    diff = ci != pi
    near = np.abs(cv - pv) <= 1e-5 * np.maximum(np.abs(pv), 1e-30)
    log(f"[pqr 10M] k_factor 64 (base search k {round(64 * K)}), nprobe "
        f"{PQR_K64_NPROBE}, {len(q)} queries: card {t_card * 1e3:.2f} ms, CPU "
        f"copy {t_cpu:.2f} s; ids equal to the CPU's at "
        f"{int((~diff).sum())} of {diff.size} slots ({int(diff.any(1).sum())}"
        f" queries differ, every differing slot a near-tie: "
        f"{bool(near[diff].all())}); launches {launches} [{card}]")
    check(bool(near[diff].all()), "[pqr 10M] k_factor 64: ids differ from "
          "the CPU's beyond near-ties")
    return launches["topk_merge"]


# [sharded 10M]: the reference's distributed mode (dist/worker.cpp:153-235:
# a round-robin row split, an IVF and an error profile built on each shard,
# each shard's top-k merged a query, reduce.cpp:98-133) with the JAX
# package's production codec, on the synthDeep10M corpus: four shards of
# 2.5M x 96, each IVF1024 + SQ8, all on the one card (make_mesh(4) places
# every shard on it). Profiles on the [sq8 10M] phase's 1000 training
# queries, its 1000 held-out queries served at bound 0.9.
SHARDS10M, SHARD_ROW_CAP, SHARD_NPROBE = 4, 256, 32
SHARD_MULT0, SHARD_MULT_MAX = 8.0, 64.0   # dist_bench's multipler, cap


def np_merge(per: list, k: int) -> tuple:
    """The per-shard results (vals [B, k'], ids) merged in numpy: laid out
    in shard order, a stable sort by value, the first k."""
    v = np.concatenate([p[0] for p in per], axis=1)
    i = np.concatenate([p[1] for p in per], axis=1)
    order = np.argsort(v, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(v, order, 1),
            np.take_along_axis(i, order, 1).astype(np.int64))


def shard_replays(s, q: np.ndarray, acc: np.ndarray) -> list:
    """Each shard's own one-shot engine with the shared plan on the
    queries: (vals, ids, n_scanned) numpy a shard."""
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.profile.bounded_mr import bounded_oneshot_mr
    out = []
    for k, sh in enumerate(s.shards):
        dev = sh.device
        r = bounded_oneshot_mr(
            sh.arrays, s.mr[k], s.traces[k], torch.as_tensor(q, device=dev),
            torch.as_tensor(acc, device=dev),
            torch.tensor(s.multipler, dtype=torch.float32, device=dev),
            torch.tensor(s.std_m, dtype=torch.float32, device=dev),
            torch.zeros(q.shape[0], device=dev), K, MAX_TOPK, Metric.L2,
            s._mr_plan)
        out.append((r[0].cpu().numpy(), r[1].cpu().numpy(),
                    r[3].cpu().numpy()))
    return out


def sharded_bytes(s) -> dict:
    """Bytes on the card: every shard's padded codes, row codes, norms and
    ids."""
    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)
    out = {"padded codes": 0, "row codes": 0, "norms": 0, "ids": 0}
    for sh, m in zip(s.shards, s.mr):
        a = sh.arrays
        out["padded codes"] += nbytes(a.db)
        out["row codes"] += nbytes(m.rows.db)
        out["norms"] += nbytes(a.db_sq, m.rows.db_sq)
        out["ids"] += nbytes(a.vec_ids, m.rows.vec_ids)
    return out


def sharded_10m_phase(corpus: dict, card: str, sq8_window_ms: float
                      ) -> dict:
    """[sharded 10M]: build, per-shard profiles, the multi-row layouts and
    the shared plan, then the held-out window at bound 0.9 with the
    multipler doubled from 8 while the worst recall@10 misses 0.9 (up to
    64; the run fails below 0.9), timed as a median of 5, and 50 batch-1
    queries; each shard's n_scanned held to its own one-shot engine, the
    merged ids to a numpy stable merge, K1 to its plain version at the
    largest per-shard row scan; fixed-nprobe search at nprobe 32 equal to
    the per-shard results merged, K2 held at its largest call; save ->
    load equal; drop_shard(1): no id of shard 1, the survivors' n_scanned
    unchanged. Returns the saved directory (saved before the drop; the
    caller removes it) and the results [ranks 10M] is held to."""
    import tempfile
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.autotune import recall_counts
    from auncel_tpu_torch.index.scan import ivf_search_fixed
    from auncel_tpu_torch.parallel import ShardedIVF, make_mesh

    xb, xq = corpus["xb"], corpus["xq"]
    q = xq[START10M:START10M + N_TEST_Q]
    acc = np.full(N_TEST_Q, 1.0 - EPS, np.float32)
    mesh = make_mesh(SHARDS10M)
    check({str(d) for d in mesh.devices.flat} == {"cuda:0"}
          or torch.cuda.device_count() > 1, f"mesh {mesh.devices}")
    times = {}
    reset_counts()
    s = ShardedIVF(D10M, NLIST, SHARDS10M, storage="sq8", mesh=mesh)
    _, times["build"] = synced(lambda: s.build(xb))
    _, times["train_profiles"] = synced(
        lambda: s.train_profiles(xq[:PROFILE10M], MAX_TOPK))
    train = launch_counts()
    _, times["multirow"] = synced(lambda: s.enable_multirow(SHARD_ROW_CAP))
    nb = sharded_bytes(s)
    log(f"[sharded 10M] {SHARDS10M} shards of {NB10M // SHARDS10M}x{D10M} "
        f"SQ8, nlist {NLIST} each, on {len({str(d) for d in mesh.devices.flat})}"
        f" device(s): caps {[sh.arrays.cap for sh in s.shards]}, rows "
        f"{[m.rows.db.shape[0] for m in s.mr]}, row cap {s._mr_row_cap}; "
        f"on the card: " + ", ".join(f"{k} {v / 2**30:.3f} GiB"
                                     for k, v in nb.items())
        + f"; allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"[{card}]")
    with uncounted():
        (gt_D, gt_I), times["exact_search"] = synced(lambda: np_merge(
            [sh.exact_search(q, K) for sh in s.shards], K))

    def serve():
        (out, dt), n = counted(
            lambda: synced(lambda: s.search_bounded(q, acc, K)))
        return out, dt, recall_counts(out[0], gt_D, K, Metric.L2), n

    s.multipler = SHARD_MULT0
    out, dt, cnt, n = serve()
    while cnt.min() < K * (1.0 - EPS) and s.multipler < SHARD_MULT_MAX:
        s.multipler = min(s.multipler * 2.0, SHARD_MULT_MAX)
        log(f"[sharded 10M] bound violated at min_recall="
            f"{cnt.min() / K:.3f}; multipler to {s.multipler:.1f}")
        out, dt, cnt, n = serve()
    reps = [serve()[1] for _ in range(SEARCH_REPS)]
    window_ms = float(np.median(reps)) * 1e3
    with uncounted():
        dev_ms = device_ms(lambda: s.search_bounded(q, acc, K), 1)
    vals, ids, nscan = out
    check(vals.shape == (N_TEST_Q, MAX_TOPK) and np.isfinite(
        vals[:, :K]).all() and (ids[:, :K] >= 0).all(),
        f"sharded 10M: results {vals.shape}")
    min_recall = cnt.min() / K
    check(min_recall >= 1.0 - EPS,
          f"sharded 10M: worst-case recall {min_recall}")
    log(f"[sharded 10M] window times over {SEARCH_REPS} warm repeats: "
        + " ".join(f"{r * 1e3:.2f}" for r in reps) + f" ms (median "
        f"{window_ms:.2f} ms; the unsharded [sq8 10M] window "
        f"{sq8_window_ms:.2f} ms, ratio {window_ms / sq8_window_ms:.2f}); "
        "device time a window (profiler) "
        + ("not measured" if dev_ms is None else f"{dev_ms:.2f} ms"))
    log(f"[sharded 10M] {N_TEST_Q} held-out queries: worst recall@{K}="
        f"{min_recall:.3f} mean={cnt.mean() / K:.4f} multipler="
        f"{s.multipler:.1f} std_m={s.std_m} qps="
        f"{N_TEST_Q / window_ms * 1e3:.1f}; mean n_scanned a shard "
        f"{[round(float(r.mean()), 2) for r in nscan]}; launches={n} "
        f"[{card}]")
    lat = []
    for i in range(N_LATENCY_SHARDED10M):
        _, t = synced(lambda: s.search_bounded(q[i:i + 1], acc[i:i + 1], K))
        lat.append(t * 1e3)
    lat = np.asarray(lat)
    log(f"[sharded 10M latency] batch-1 over {N_LATENCY_SHARDED10M} held-out "
        f"queries: p50={np.percentile(lat, 50):.2f} ms p99="
        f"{np.percentile(lat, 99):.2f} ms max={lat.max():.2f} ms [{card}]")

    with uncounted():
        per = shard_replays(s, q, acc)
        for k, (_, _, ns) in enumerate(per):
            check(np.array_equal(ns, nscan[k]),
                  f"shard {k}'s n_scanned differs from its own engine")
        mv, mi = np_merge([p[:2] for p in per], MAX_TOPK)
        check(np.array_equal(mi, ids) and np.array_equal(mv, vals),
              "the merge differs from a numpy stable merge")
        calls = record_row_scans(lambda: s.search_bounded(q, acc, K))
        big = max(calls, key=lambda c: int((c[1][6] >= 0).sum()))
        k1 = k1_compare(f"sharded 10M window, the largest of {len(calls)} "
                        f"per-shard row scans ({big[0]})", big[1], big[2],
                        card, reps=10, terms_tol=True, codec=big[3],
                        label="k1 sharded")
    log(f"[sharded 10M] each shard's n_scanned equals its own one-shot "
        f"engine with the shared plan; the merge equals a numpy stable "
        f"merge")

    (fv, fi), t_fixed = synced(lambda: s.search(q, K, SHARD_NPROBE))
    with uncounted():
        want = np_merge([tuple(t.cpu().numpy() for t in ivf_search_fixed(
            sh.arrays, torch.as_tensor(q, device=sh.device), K,
            SHARD_NPROBE, Metric.L2)) for sh in s.shards], K)
        check(np.array_equal(fi, want[1]) and np.array_equal(fv, want[0]),
              "sharded fixed-nprobe search differs from the shards merged")
        calls = record_row_scans(lambda: s.search(q, K, SHARD_NPROBE),
                                 "scan_scores")
        big = max(calls, key=lambda c: int((c[1][6] >= 0).sum()))
        k2 = k2_compare(f"sharded 10M fixed nprobe {SHARD_NPROBE}, the "
                        f"largest of {len(calls)} per-shard calls (B x "
                        f"n_slots {tuple(big[1][6].shape)})", big[1],
                        big[2], card, reps=10, terms_tol=True,
                        codec=big[3], label="k2 sharded")
    log(f"[sharded 10M fixed] nprobe {SHARD_NPROBE}: {t_fixed * 1e3:.2f} ms "
        f"for {N_TEST_Q} queries, equal to the per-shard results merged; "
        f"recall@{K} {recall_counts(fv, gt_D, K, Metric.L2).mean() / K:.4f}"
        f" [{card}]")

    tmp = tempfile.mkdtemp(prefix="sharded10m_")
    _, times["save"] = synced(lambda: s.save(tmp))
    size = sum(os.path.getsize(os.path.join(tmp, f))
               for f in os.listdir(tmp))
    loaded, times["load"] = synced(lambda: ShardedIVF.load(tmp))
    _, li, ln = loaded.search_bounded(q, acc, K)
    check(np.array_equal(li, ids) and np.array_equal(ln, nscan),
          "sharded save -> load changed the results")
    del loaded
    torch.cuda.empty_cache()
    log(f"[sharded 10M] save {times['save']:.2f} s, {size / 2**30:.2f} GiB; "
        f"load {times['load']:.2f} s; equal ids and n_scanned")
    _, times["drop_shard"] = synced(lambda: s.drop_shard(1))
    dv, di, dn = s.search_bounded(q, acc, K)
    live = di[di >= 0]
    check(not np.any(live % SHARDS10M == 1), "shard 1's ids after the drop")
    check(np.array_equal(dn, np.delete(nscan, 1, axis=0)),
          "the survivors' n_scanned changed after drop_shard")
    launches = launch_counts()
    log(f"[sharded 10M] drop_shard(1) in {times['drop_shard']:.2f} s: no id "
        f"of shard 1, the survivors' n_scanned unchanged; worst recall@{K} "
        f"against the whole corpus now "
        f"{recall_counts(dv, gt_D, K, Metric.L2).min() / K:.3f}")
    log("[sharded 10M stages] " + " ".join(f"{k}={v:.2f}s"
                                           for k, v in times.items())
        + f" [{card}]")
    log(f"[sharded 10M] launches over the path: {launches}, profile "
        f"training {train}")
    check(train["scan_scores"] > 0, "sharded profile training never "
          "launched K2")
    check(launches["rowscan_scores"] > 0 and n["rowscan_scores"] > 0,
          "sharded bounded search never launched K1")
    check(launches["scan_scores"] > train["scan_scores"],
          "sharded fixed-nprobe search never launched K2")
    for part in (train, n, launches):
        check_merges("sharded 10M", part)
    return {"launches": launches, "kernels": {"rowscan_scores": k1,
                                              "scan_scores": k2},
            "dir": tmp, "q": q, "gt_D": gt_D, "window": out,
            "window_ms": window_ms, "latency_ms": lat, "fixed": (fv, fi),
            "drop": (dv, di, dn)}


# [ranks 10M]: the [sharded 10M] directory served by one gloo rank a shard
# (parallel/distributed.py), all four ranks on the one card; dp_kmeans on
# two ranks over the first RANKS_KM_N vectors
RANKS10M, RANKS_REPS, RANKS_TIMEOUT_S = 4, 5, 120
RANKS_KM_N, RANKS_KM_K, RANKS_KM_NITER = 1_000_000, 1024, 5
RANKS_DEVICES = None   # each rank's own card (a CPU rehearsal: ["cpu"])


def ranks_10m_phase(xb: np.ndarray, sh: dict, card: str) -> dict:
    """[ranks 10M]: spawn 4 ranks on the card with gloo, each loading only
    its shard of the saved [sharded 10M] directory; the held-out window at
    bound 0.9 (5 more windows timed from a barrier, 50 batch-1 queries),
    fixed nprobe 32 and drop_shard(1), each rank's results bitwise the
    one-process ones or the run fails, worst recall@10 >= 0.9, K1 and the
    merge kernel launched in every rank's window and K2 in its fixed
    search; then dp_kmeans on 2 ranks bitwise the one-process run with 2
    shards."""
    import shutil
    from auncel_tpu_torch import Metric
    from auncel_tpu_torch.autotune import recall_counts
    from auncel_tpu_torch.parallel import dp_kmeans, make_mesh
    from auncel_tpu_torch.parallel.distributed import serve, spawn

    tmp = sh["dir"]
    np.save(os.path.join(tmp, "q.npy"), sh["q"])
    np.save(os.path.join(tmp, "km.npy"), xb[:RANKS_KM_N])
    (km_c, km_err), t_km = synced(lambda: dp_kmeans(
        xb[:RANKS_KM_N], RANKS_KM_K, make_mesh(2, devices=RANKS_DEVICES),
        niter=RANKS_KM_NITER))
    torch.cuda.empty_cache()
    q = os.path.join(tmp, "q.npy")
    steps = [dict(op="load", dir=tmp, mesh=(RANKS10M, 1)),
             dict(op="bounded", name="window", q=q, acc=1.0 - EPS, k=K,
                  reps=RANKS_REPS, latency=N_LATENCY_SHARDED10M),
             dict(op="fixed", name="fixed", q=q, k=K, nprobe=SHARD_NPROBE),
             dict(op="drop", shard=1),
             dict(op="bounded", name="drop", q=q, acc=1.0 - EPS, k=K),
             dict(op="kmeans", name="km", x=os.path.join(tmp, "km.npy"),
                  k=RANKS_KM_K, niter=RANKS_KM_NITER, shards=2)]
    t_spawn = time.time()
    try:
        _, t_all = synced(lambda: spawn(
            serve, RANKS10M, (steps, os.path.join(tmp, "out"),
                              RANKS_DEVICES),
            backend="gloo", timeout_s=RANKS_TIMEOUT_S, join_timeout_s=900))
        ranks = [dict(np.load(os.path.join(tmp, "out", f"rank{r}.npz")))
                 for r in range(RANKS10M)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def same(r: int, name: str, want) -> bool:
        z = ranks[r]
        return all(np.array_equal(z[f"{name}/{k}"], w) for k, w in zip(
            ("vals", "ids", "n_scanned"), want))
    names = ("rowscan_scores", "scan_scores", "topk_merge")
    for r in range(RANKS10M):
        check(same(r, "window", sh["window"]),
              f"[ranks 10M] rank {r}'s window differs from one process")
        check(same(r, "fixed", sh["fixed"]),
              f"[ranks 10M] rank {r}'s fixed search differs from one "
              "process")
        if r == 1:
            check("dropped" in str(ranks[r].get("drop/refused", "")),
                  "[ranks 10M] the dropped rank served a search")
        else:
            check(same(r, "drop", sh["drop"]),
                  f"[ranks 10M] rank {r} after drop_shard(1) differs from "
                  "one process")
        lw = dict(zip(names, ranks[r]["window/launches"].tolist()))
        lf = dict(zip(names, ranks[r]["fixed/launches"].tolist()))
        check(lw["rowscan_scores"] > 0 and lw["topk_merge"] > 0,
              f"[ranks 10M] rank {r}'s window launched {lw}")
        check(lf["scan_scores"] > 0, f"[ranks 10M] rank {r}'s fixed search "
              f"launched {lf}")
        log(f"[ranks 10M] rank {r} launches: window {lw}, fixed {lf}")
    for r in (0, 1):
        check(np.array_equal(ranks[r]["km/centroids"], km_c)
              and float(ranks[r]["km/err"]) == km_err,
              f"[ranks 10M] rank {r}'s dp_kmeans differs from one process")
    cnt = recall_counts(ranks[0]["window/vals"], sh["gt_D"], K, Metric.L2)
    check(cnt.min() >= K * (1.0 - EPS),
          f"[ranks 10M] worst recall@{K} {cnt.min() / K}")
    t = np.stack([z["times"] for z in ranks])   # start, init, load, ...
    win = ranks[0]["window/window_s"] * 1e3
    lat = ranks[0]["window/latency_s"] * 1e3
    window_ms = float(np.median(win))
    log(f"[ranks 10M] {RANKS10M} gloo ranks on the one card, each loading "
        f"its shard of the [sharded 10M] directory: spawn "
        f"{t[:, 0].max() - t_spawn:.2f} s, init "
        f"{(t[:, 1] - t[:, 0]).max():.2f} s, load "
        f"{(t[:, 2] - t[:, 1]).max():.2f} s (slowest rank each); the "
        f"whole world {t_all:.2f} s [{card}]")
    log(f"[ranks 10M] window of {N_TEST_Q} at bound {1.0 - EPS:.1f}, rank "
        f"0 from a barrier to the merged result over {RANKS_REPS} repeats: "
        + " ".join(f"{w:.2f}" for w in win) + f" ms (median "
        f"{window_ms:.2f} ms; one process {sh['window_ms']:.2f} ms); worst "
        f"recall@{K} {cnt.min() / K:.3f}; ids, values and n_scanned "
        f"bitwise the one-process window on every rank [{card}]")
    log(f"[ranks 10M latency] batch-1 over {N_LATENCY_SHARDED10M} held-out "
        f"queries on rank 0: p50={np.percentile(lat, 50):.2f} ms p99="
        f"{np.percentile(lat, 99):.2f} ms max={lat.max():.2f} ms (one "
        f"process p50={np.percentile(sh['latency_ms'], 50):.2f} ms p99="
        f"{np.percentile(sh['latency_ms'], 99):.2f} ms) [{card}]")
    log(f"[ranks 10M] fixed nprobe {SHARD_NPROBE} and drop_shard(1) "
        f"bitwise one process on every rank (the dropped rank refuses "
        f"searches); dp_kmeans on 2 ranks over {RANKS_KM_N}x"
        f"{xb.shape[1]}, k {RANKS_KM_K}, {RANKS_KM_NITER} steps, bitwise "
        f"the one-process run ({t_km:.2f} s, err {km_err:.6g}); backend "
        f"gloo; four processes share one card, so these times say nothing "
        f"of four cards [{card}]")
    return {"window_ms": window_ms}


# [dp kmeans]: data-parallel k-means (parallel/kmeans_dp.py) over the
# synthDeep10M corpus split in four shards of the one card, k 1024, the
# JAX package's 25 steps from its seed
DP_KMEANS_K, DP_KMEANS_SHARDS = 1024, 4


def dp_kmeans_phase(xb: np.ndarray, card: str) -> None:
    """Two runs bitwise equal, or the run fails; the error and time
    against a one-shard run."""
    from auncel_tpu_torch.parallel import dp_kmeans, make_mesh
    runs = []
    for S in (DP_KMEANS_SHARDS, DP_KMEANS_SHARDS, 1):
        (c, err), t = synced(lambda: dp_kmeans(xb, DP_KMEANS_K,
                                               make_mesh(S)))
        runs.append((c, err, t))
        torch.cuda.empty_cache()
    (c1, e1, t1), (c2, e2, t2), (_, e0, t0) = runs
    same = bool(np.array_equal(c1, c2) and e1 == e2)
    log(f"[dp kmeans] {xb.shape[0]}x{xb.shape[1]}, k {DP_KMEANS_K}, 25 "
        f"steps: {DP_KMEANS_SHARDS} shards {t1:.2f} / {t2:.2f} s, err "
        f"{e1:.6g}, two runs bitwise equal: {same}; one shard {t0:.2f} s, "
        f"err {e0:.6g} (relative difference {abs(e1 - e0) / e0:.3g}) "
        f"[{card}]")
    check(same, "dp_kmeans on the card does not repeat bit for bit")
    check(bool(np.isfinite(c1).all()), "dp_kmeans: non-finite centroids")


def dist_phase(card: str) -> None:
    """[dist]: dist_bench.run at its defaults from a temporary directory
    (its log and figure checked), failing unless K1 and K2 launched."""
    import tempfile
    from auncel_tpu_torch.eval_harness import dist_bench
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        rows, t = synced(lambda: dist_bench.run(log_dir=tmp))
        launches = launch_counts()
        logged = np.loadtxt(os.path.join(tmp, "Dist_scaling.log"), ndmin=2)
        fig = os.path.exists(os.path.join(tmp, "fig16.png"))
    check([r[0] for r in rows] == [1, 2, 4, 8] and logged.shape == (4, 2),
          f"dist_bench rows {rows}")
    check(launches["rowscan_scores"] > 0 and launches["scan_scores"] > 0,
          f"dist_bench launches {launches}")
    check_merges("dist", launches)
    log(f"[dist] synth10K, nlist 64, 64 queries at bound 0.9: "
        + ", ".join(f"{S} shards {ms:.3f} ms/query" for S, ms in rows)
        + f"; fig16.png drawn: {fig}; {t:.1f} s; launches {launches} "
        f"[{card}]")


def c_api_phase(card: str) -> None:
    """[c api]: make and the demo with AUNCEL_C_DEVICE=cuda; a failed
    build or run fails the script where ``python3-config --includes``
    works, and the line says so where it does not."""
    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "auncel_tpu_torch", "c_api")
    try:
        cfg = subprocess.run(["python3-config", "--includes"],
                             capture_output=True, text=True, timeout=60)
        have = cfg.returncode == 0 and "-I" in cfg.stdout
    except FileNotFoundError:
        have = False
    if not have:
        log("[c api] python3-config is missing on this machine: the C API "
            "is not built here")
        return
    t0 = time.perf_counter()
    # -B: build from this checkout on this machine, whatever is in _build
    build = subprocess.run(["make", "-B", "-C", src, "demo"],
                           capture_output=True, text=True, timeout=300)
    check(build.returncode == 0, f"c_api build failed: "
          f"{build.stderr[-800:]}")
    t_build = time.perf_counter() - t0
    env = dict(os.environ, AUNCEL_C_DEVICE="cuda", AUNCEL_PY_ROOT=root)
    out = os.path.join(root, "auncel_tpu_torch", "_build", "c_api")
    t0 = time.perf_counter()
    run = subprocess.run([os.path.join(out, "demo_c")], capture_output=True,
                         text=True, timeout=600, env=env, cwd=out)
    t_run = time.perf_counter() - t0
    check(run.returncode == 0, f"c_api demo failed: {run.stdout[-500:]} "
          f"{run.stderr[-800:]}")
    lines = {ln.split(":")[0]: ln.split(":")[1].split()
             for ln in run.stdout.splitlines()
             if ln.startswith(("fixed:", "bounded:"))}
    check(sorted(lines) == ["bounded", "fixed"]
          and all(len(v) == 32 * 5 for v in lines.values()),
          f"c_api demo output: {run.stdout[-500:]}")
    log(f"[c api] built in {t_build:.2f} s; demo on the card (AUNCEL_C_"
        f"DEVICE=cuda) in {t_run:.2f} s: "
        + run.stdout.strip().splitlines()[-1] + f" [{card}]")


# [eval]: the evaluation harness's experiments on the card, as
# ``python -m auncel_tpu_torch.eval_harness.bound synthHard1M 2000 1000 10
# 0.10 --profile-size 1000`` and the same for compare (1M x 128 with the
# hard query tail, IVF1024,Flat on the multi-row layout), then
# effect_error, effect_time and overhead at the JAX package's documented
# defaults on synth100K (README.md: ts 1000, ses 1000, k 10, nlist 1024).
EVAL_DB, EVAL_SMALL_DB, EVAL_NLIST = "synthHard1M", "synth100K", 1024
EVAL_TS, EVAL_SES, EVAL_PROFILE, EVAL_LATENCY = 2000, 1000, 1000, 100
EVAL_SMALL_TS = EVAL_SMALL_SES = 1000
# Auncel's bound at synthHard1M is reported as the JAX harness reports it
# (bound_ok), not checked: the JAX package's own calibration margin study
# at this cell reads held-out worst recall@10 0.8000 in 12 of its 16
# settings (Calib_margin_synthHard1M.log), so the cell is not promised
UNPROMISED = ("reported, not checked: the JAX package's own margin study "
              "misses here (Calib_margin_synthHard1M.log)")


@contextlib.contextmanager
def last_call(cls, name: str):
    """Record the instance and arguments of the last call of cls.name made
    inside the block."""
    real = getattr(cls, name)
    seen = {}

    def wrapper(self, *args, **kw):
        seen.update(self=self, args=args, kw=kw)
        return real(self, *args, **kw)
    setattr(cls, name, wrapper)
    try:
        yield seen
    finally:
        setattr(cls, name, real)


def driven(label: str, fn):
    """fn() with every launch count set to 0 just before it; (its result,
    the launches it made, its seconds)."""
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = launch_counts()
    log(f"[eval {label}] {dt:.1f} s, launches {n}")
    return out, n, dt


def eval_phase(card: str) -> dict:
    """[eval]: the harness's experiments on the card, from a temporary
    directory that holds the quantizer cache, BENCH_CACHE and the logs;
    each run with the launch counts set to 0 before it and read after.
    bound and compare must launch K1 and K2 and effect_error must satisfy
    >= 0.9 of the mixed bounds, or the run fails; Auncel's worst
    recall@10 at synthHard1M and bound_ok are reported (``UNPROMISED``). Then K1 at a worklist recorded from
    LAET's search and K2 at LAET's feature call, against their plain
    versions. Returns the kernels' numbers and the path's launches."""
    import os
    import tempfile
    from auncel_tpu_torch.autotune import ParameterSpace
    from auncel_tpu_torch.baselines.laet import LearnedTermination
    from auncel_tpu_torch.eval_harness import (
        bound, compare, effect_error, effect_time, overhead)

    here, saved_cache = os.getcwd(), os.environ.get("BENCH_CACHE")
    totals = {}

    def add(n):
        for k, v in n.items():
            totals[k] = totals.get(k, 0) + v
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        os.chdir(tmp)
        os.environ["BENCH_CACHE"] = os.path.join(tmp, "bench_cache")
        try:
            res, n, dt = driven("bound", lambda: bound.run(
                EVAL_DB, ts=EVAL_TS, ses=EVAL_SES, input_k=K,
                error_bound=EPS, nlist=EVAL_NLIST, profile_size=EVAL_PROFILE,
                batch_latency=EVAL_LATENCY, log_dir=tmp))
            add(n)
            lat = np.loadtxt(os.path.join(
                tmp, f"Auncel_Latency_{EVAL_DB}_{K}_{round(EPS * 100)}.log"))
            log(f"[eval bound] {EVAL_DB} ts={EVAL_TS} ses={EVAL_SES} "
                f"profile={EVAL_PROFILE}: qps={res['qps']:.1f} multipler="
                f"{res['multipler']:.3f} std_m={res['std_m']} mean "
                f"n_scanned={res['mean_nscan']:.2f} worst recall@{K}="
                f"{res['min_recall']:.3f} bound_ok={res['bound_ok']}; "
                f"batch-1 over {lat.size}: mean={lat.mean() * 1e3:.2f} ms "
                f"p99={np.quantile(lat, 0.99) * 1e3:.2f} ms; multi-row "
                f"rows {res['multirow_rows']} [{card}]")
            log(f"[eval bound] worst recall@{K}={res['min_recall']:.3f} "
                f"bound_ok={res['bound_ok']}: {UNPROMISED}")
            check(n["rowscan_scores"] > 0 and n["scan_scores"] > 0,
                  f"[eval bound] launches {n}")
            check_merges("eval bound", n)

            with last_call(LearnedTermination, "search") as lt_search, \
                    last_call(LearnedTermination, "_features") as lt_feat, \
                    last_call(ParameterSpace, "tune_for_bound") as tuned:
                rows, n, dt = driven("compare", lambda: compare.run(
                    EVAL_DB, ts=EVAL_TS, ses=EVAL_SES, input_k=K,
                    error_bound=EPS, nlist=EVAL_NLIST,
                    profile_size=EVAL_PROFILE, log_dir=tmp))
            add(n)
            for r in rows:
                log(f"[eval compare] {r['system']}: qps={r['qps']:.1f} mean "
                    f"probes={r['mean_probes']:.2f} worst recall@{K}="
                    f"{r['min_recall']:.3f} mean recall@{K}="
                    f"{r['mean_recall']:.4f} [{card}]")
            ps = tuned["self"]
            n_cands = len(ps.candidate_nprobes())

            def route(batch, nprobe):
                return ("dense" if ps.index.dense_route(batch, nprobe)
                        else "gathers (K1)")
            for i, p in enumerate(ps.ops.all_pts):
                nprobe = int(p.key.split("=")[1])
                log(f"[eval compare] ELP sweep {i // n_cands + 1} {p.key}: "
                    f"worst recall@{K} on the train slice {p.perf:.3f}, "
                    f"{p.cost * 1e6:.2f} us a query at batch {EVAL_TS} "
                    f"({route(EVAL_TS, nprobe)}); at batch {EVAL_SES}: "
                    f"{route(EVAL_SES, nprobe)}")
            auncel = next(r for r in rows if r["system"] == "auncel")
            log(f"[eval compare] auncel worst recall@{K}="
                f"{auncel['min_recall']:.3f} bound_ok="
                f"{auncel['min_recall'] >= 1.0 - EPS}: {UNPROMISED}")
            check(n["rowscan_scores"] > 0 and n["scan_scores"] > 0,
                  f"[eval compare] launches {n}")
            check_merges("eval compare", n)
            with uncounted():
                kernels = eval_kernels(lt_search, lt_feat, card)

            res, n, dt = driven("effect_error", lambda: effect_error.run(
                EVAL_SMALL_DB, ts=EVAL_SMALL_TS, ses=EVAL_SMALL_SES,
                input_k=K, nlist=EVAL_NLIST, log_dir=tmp))
            add(n)
            log(f"[eval effect_error] {EVAL_SMALL_DB}: satisfaction of the "
                f"mixed bounds {res['satisfaction']:.4f} [{card}]")
            check(res["satisfaction"] >= 0.9,
                  f"[eval effect_error] satisfaction {res['satisfaction']}")

            res, n, dt = driven("effect_time", lambda: effect_time.run(
                EVAL_SMALL_DB, ts=EVAL_SMALL_TS, ses=EVAL_SMALL_SES,
                input_k=K, nlist=EVAL_NLIST, log_dir=tmp))
            add(n)
            log(f"[eval effect_time] {EVAL_SMALL_DB}: within budget by the "
                f"cost model {res['within_budget']:.4f}, measured less the "
                f"dispatch floor ({res['dispatch_floor_ms']:.3f} ms) "
                f"{res['within_budget_measured']:.4f} over "
                f"{len(res['sample_qids'])} queries; model median rel err "
                f"{res['model_rel_err']:.3f}, corr {res['model_corr']:.3f}; "
                f"refit {res['refit_per_probe_ms'] * 1e3:.2f} us a probe "
                f"(median rel err {res['refit_rel_err']:.3f}) [{card}]")

            res, n, dt = driven("overhead", lambda: overhead.run(
                EVAL_SMALL_DB, ts=EVAL_SMALL_TS, ses=EVAL_SMALL_SES,
                input_k=K, error_bound=EPS, nlist=EVAL_NLIST))
            add(n)
            log(f"[eval overhead] {EVAL_SMALL_DB}: with ELP "
                f"{res['with_elp'] * 1e3:.2f} ms, without "
                f"{res['without_elp'] * 1e3:.2f} ms a window of "
                f"{EVAL_SMALL_SES}, "
                f"overhead {res['overhead'] * 100:.1f} % [{card}]")
        finally:
            os.chdir(here)
            if saved_cache is None:
                os.environ.pop("BENCH_CACHE", None)
            else:
                os.environ["BENCH_CACHE"] = saved_cache
    log(f"[eval] launches over the phase: {totals}")
    return {"launches": totals, "kernels": kernels}


def eval_kernels(lt_search: dict, lt_feat: dict, card: str) -> dict:
    """K1 at the largest row scan of LAET's last search (the held-out
    queries at its worst-case multiplier) and K2 at LAET's feature call
    (one probe of the padded lists for each training query), each against
    its plain version within 1e-5 of q_sq + db_sq."""
    lt = lt_search["self"]
    q, k = lt_search["args"][:2]
    calls = record_row_scans(lambda: lt.search(q, k))
    big = max(calls, key=lambda c: int((c[1][6] >= 0).sum()))
    out = {"rowscan_scores": k1_compare(
        f"LAET search, the largest of {len(calls)} row scans ({big[0]})",
        big[1], big[2], card, reps=10, terms_tol=True, codec=big[3],
        label="k1 eval")}
    fq = lt_feat["args"][0]
    k2_calls = record_row_scans(lambda: lt._features(fq), "scan_scores")
    check(len(k2_calls) == 1, f"LAET's features made {len(k2_calls)} K2 "
          "calls, not 1")
    c = k2_calls[0]
    out["scan_scores"] = k2_compare(
        f"LAET features (B x n_slots {tuple(c[1][6].shape)})", c[1], c[2],
        card, reps=10, terms_tol=True, codec=c[3], label="k2 eval")
    return out


def profile_search(es, out_dir: str, card: str, label: str) -> None:
    """Kernel-time breakdown of one batched and one batch-1 search."""
    for name, size in (("batched", N_TEST_Q), ("batch1", 1)):
        profile_call(lambda: es.search(N_TRAIN_Q, size), out_dir, card,
                     f"{label} {name}")


def profile_call(fn, out_dir: str, card: str, label: str) -> None:
    """torch.profiler table of one warm call of fn, with its wall time and
    the device's busy time."""
    import os
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(out_dir, exist_ok=True)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    # the device's own events only: an operator's row repeats the time
    # of the kernels it launched
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    # the sorts' kernels and the merge kernel's, by a piece of their names
    part = {"sorts": 0.0, "merge kernel": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        if "topk_merge" in e.key:
            part["merge kernel"] += e.self_device_time_total
        elif "sort" in e.key.lower():
            part["sorts"] += e.self_device_time_total
    shares = ", ".join(f"{k} {v / 1e3:.2f} ms ({100 * v / max(dev_us, 1):.1f}"
                       f" %)" for k, v in part.items())
    name = label.replace(" ", "_")
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(f"{card}\nwall {wall * 1e3:.2f} ms, device "
                f"{dev_us / 1e3:.2f} ms; {shares}\n{table}\n")
    log(f"[profile] {label}: wall {wall * 1e3:.2f} ms, device busy "
        f"{dev_us / 1e3:.2f} ms ({100 * dev_us / 1e3 / (wall * 1e3):.1f}"
        f"%); of the device time {shares} [{card}]")


# the worklist's kernels (csrc/worklist.cuh) by a piece of their names:
# the memset of its counters, the histogram, the plan (one pass, or its
# two passes) and the scatter
WORKLIST_KERNELS = (("memset", "Memset"), ("count", "count_kernel"),
                    ("plan", "plan_"), ("scatter", "scatter_kernel"))


def device_split(fn, reps: int) -> tuple:
    """(the device's own ms per call of fn, or None when the profiler
    recorded no device event; the ms per call of each of the worklist's
    kernels), from one torch.profiler run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, split = 0.0, {k: 0.0 for k, _ in WORKLIST_KERNELS}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us += e.self_device_time_total
        for k, piece in WORKLIST_KERNELS:
            if piece in e.key:
                split[k] += e.self_device_time_total / 1e3 / reps
    return (us / 1e3 / reps if us > 0 else None), split


def worklist_line(split: dict) -> str:
    return ("worklist kernels' device time a call (profiler): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in split.items())
        + f", together {sum(split.values()):.4f} ms")


def device_ms(fn, reps: int) -> float | None:
    """The device's own time per call of fn (every kernel and copy it
    enqueues, without the host's gaps), from torch.profiler; None when the
    profiler recorded no device event."""
    return device_split(fn, reps)[0]


def ptxas_report(text: str) -> list:
    """(kernel, registers and spills) of each entry function in nvcc's
    ``-Xptxas -v`` output, the kernel named by its function and template
    arguments as they appear in the mangled name."""
    import re
    out, fn, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = re.search(r"\d+([a-z_]+_kernel)", m.group(1))
            args = re.findall(r"F32|BF16|SQ8|SQ4|SQ6|PQ|Lb[01]",
                              m.group(1))
            fn = (" ".join([name.group(1)] + args) if name
                  else m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and fn is not None:
            out.append((fn, f"{line.split(':', 1)[1].strip()}; {spill}"))
            fn = None
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from auncel_tpu_torch.kernels import build  # fails outside the repo
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    # the 10M phases' corpora, made on the host while nvcc builds and the
    # earlier phases run; --kernels stops before they are read
    corpora = None if "--kernels" in sys.argv else start_10m_corpora()
    sources = ("rowscan", "scan_scores", "topk_merge", "decide")
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        list(pool.map(build.load, sources))  # one nvcc each, all at once
    log(f"[build] {', '.join(f'{n}.cu' for n in sources)} built in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{build.BUILD_INFO[n]['seconds']:.2f} s"
                    for n in sources) + ")")
    for n in sources:
        for fn, report in ptxas_report(build.BUILD_INFO[n]["log"]):
            log(f"[build] {n}: {fn}: {report}")
    profile_dir = None
    if "--profile" in sys.argv:
        profile_dir = sys.argv[sys.argv.index("--profile") + 1]
    if "--against" in sys.argv:
        load_against(sys.argv[sys.argv.index("--against") + 1])
    count_scan_merges()

    k1 = k1_check(device, card)
    k1_dots = k1_dots_check(device, card)
    k2_check(device, card)
    codecs = codec_check(device, card)
    pq_lines = pq_check(device, card)
    sq8_10m_check(device, card)
    topk_lines = topk_check(device, card)
    decide = decide_check(device, card)
    corpus = build_corpus(card)
    if "--kernels" in sys.argv:
        kernels_on_index(corpus, device, card)
        log(f"[total] {time.perf_counter() - t0:.1f} s (kernels only)")
        return 0
    mr_launches = multirow_path(corpus, card, profile_dir)
    pad_launches, pes = padded_path(corpus, card, profile_dir)
    t_od = time.perf_counter()
    od = ondisk_phase(pes, corpus, card)
    del pes
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [ondisk], [range] "
        f"and [shards] phases {time.perf_counter() - t_od:.1f} s)")
    k2 = kernels_on_index(corpus, device, card)
    t_new = time.perf_counter()
    ivfh = ivf_hnsw_phase(corpus, card)
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [ivf hnsw] phase "
        f"{time.perf_counter() - t_new:.1f} s)")
    del corpus["idx"]
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    imi = imi_phase(corpus, card)
    torch.cuda.empty_cache()
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [imi] phase "
        f"{time.perf_counter() - t_new:.1f} s)")
    t_new = time.perf_counter()
    tl = twolayer_phase(corpus, card)
    torch.cuda.empty_cache()
    b = binary_phase(corpus, card)
    t_bh = time.perf_counter()
    bhnsw_phase(b, card)
    del b, corpus
    torch.cuda.empty_cache()
    log(f"[total] 1M phases {time.perf_counter() - t0:.1f} s (the [2layer] "
        f"and [binary] phases {t_bh - t_new:.1f} s, [bhnsw] "
        f"{time.perf_counter() - t_bh:.1f} s)")
    t_new = time.perf_counter()
    hnsw_phase(card)
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [hnsw], [hnsw sq8] "
        f"and [hnsw pq8] phases {time.perf_counter() - t_new:.1f} s)")
    t_new = time.perf_counter()
    hnsw_scale_phase(card)
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [hnsw 200k] phase "
        f"{time.perf_counter() - t_new:.1f} s)")
    t10 = time.perf_counter()
    sq8 = sq8_10m_phase(card, profile_dir, corpora)
    log(f"[total] {time.perf_counter() - t0:.1f} s (the 10M phase "
        f"{time.perf_counter() - t10:.1f} s)")
    t_ev = time.perf_counter()
    eval_10m_phase(sq8, corpora, card)
    stop_10m_corpora(corpora)
    del sq8["es"]
    corpus10m = sq8.pop("corpus")
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [eval 10M] phase "
        f"{time.perf_counter() - t_ev:.1f} s)")
    torch.cuda.empty_cache()
    t_pq = time.perf_counter()
    gt10m = float_gt_10m(corpus10m)
    pq = pq_10m_phase(corpus10m, card, profile_dir, gt10m)
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [pq 10M] phase "
        f"{time.perf_counter() - t_pq:.1f} s)")
    torch.cuda.empty_cache()
    t_pq = time.perf_counter()
    pqr = pqr_10m_phase(corpus10m, gt10m, pq["recall_ids"], card)
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [pqr 10M] phase "
        f"{time.perf_counter() - t_pq:.1f} s)")
    torch.cuda.empty_cache()
    t_sh = time.perf_counter()
    sh = sharded_10m_phase(corpus10m, card, sq8["window_ms"])
    torch.cuda.empty_cache()
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [sharded 10M] "
        f"phase {time.perf_counter() - t_sh:.1f} s)")
    t_sh = time.perf_counter()
    ranks_10m_phase(corpus10m["xb"], sh, card)
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [ranks 10M] "
        f"phase {time.perf_counter() - t_sh:.1f} s)")
    t_sh = time.perf_counter()
    dp_kmeans_phase(corpus10m["xb"], card)
    del corpus10m
    torch.cuda.empty_cache()
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [dp kmeans] phase "
        f"{time.perf_counter() - t_sh:.1f} s)")
    t_eval = time.perf_counter()
    ev = eval_phase(card)
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [eval] phase "
        f"{time.perf_counter() - t_eval:.1f} s)")
    t_new = time.perf_counter()
    dist_phase(card)
    c_api_phase(card)
    log(f"[total] {time.perf_counter() - t0:.1f} s (the [dist] and [c api] "
        f"phases {time.perf_counter() - t_new:.1f} s)")

    def launches(name):
        return mr_launches[name] + pad_launches[name]

    def numbers(res):
        return {k: res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")}
    k1_src, k2_src = ("auncel_tpu_torch/csrc/rowscan.cu",
                      "auncel_tpu_torch/csrc/scan_scores.cu")
    merge_src = "auncel_tpu_torch/csrc/topk_merge.cu"
    merge_tpu = "auncel_tpu/ops/topk.py:67"
    k1_tpu, k2_tpu = ("auncel_tpu/pallas_kernels/rowscan.py:77",
                      "auncel_tpu/pallas_kernels/scan_scores.py:89")
    kernels = [
        {"name": "rowscan_scores", "route": "cuda", "source": k1_src,
         "replaces": k1_tpu, "launches": launches("rowscan_scores"),
         "library_ms": None, **numbers(k1)},
        {"name": "rowscan_dots", "route": "cuda", "source": k1_src,
         "replaces": k1_tpu, "launches": launches("rowscan_dots"),
         "library_ms": None, **k1_dots},
        {"name": "scan_scores", "route": "cuda", "source": k2_src,
         "replaces": k2_tpu, "launches": launches("scan_scores"),
         "library_ms": None, **numbers(k2)},
        {"name": "rowscan_scores sq8", "route": "cuda", "source": k1_src,
         "replaces": k1_tpu, "launches": sq8["launches"]["rowscan_scores"],
         "library_ms": None, **numbers(sq8["kernels"]["rowscan_scores"])},
        {"name": "scan_scores ondisk", "route": "cuda", "source": k2_src,
         "replaces": k2_tpu, "launches": od["launches"]["scan_scores"],
         "library_ms": None, **numbers(od["kernels"])},
        {"name": "scan_scores sq8", "route": "cuda", "source": k2_src,
         "replaces": k2_tpu, "launches": sq8["launches"]["scan_scores"],
         "library_ms": None, **numbers(sq8["kernels"]["scan_scores"])},
        {"name": "scan_scores pq", "route": "cuda", "source": k2_src,
         "replaces": k2_tpu, "launches": pq["launches"]["scan_scores"],
         "library_ms": None, **numbers(pq["kernels"])},
        {"name": "rowscan_scores imi", "route": "cuda", "source": k1_src,
         "replaces": k1_tpu, "launches": imi["launches"]["rowscan_scores"],
         "library_ms": None, **numbers(imi["kernels"]["rowscan_scores"])},
        {"name": "scan_scores imi", "route": "cuda", "source": k2_src,
         "replaces": k2_tpu, "launches": imi["launches"]["scan_scores"],
         "library_ms": None, **numbers(imi["kernels"]["scan_scores"])},
        {"name": "scan_scores 2layer", "route": "cuda", "source": k2_src,
         "replaces": k2_tpu, "launches": tl["launches"]["scan_scores"],
         "library_ms": None, **numbers(tl["kernels"])},
        {"name": "scan_scores pqr", "route": "cuda", "source": k2_src,
         "replaces": k2_tpu, "launches": pqr["launches"]["scan_scores"],
         "library_ms": None, **numbers(pqr["kernels"])},
        {"name": "scan_scores ivf hnsw", "route": "cuda", "source": k2_src,
         "replaces": k2_tpu, "launches": ivfh["launches"]["scan_scores"],
         "library_ms": None, **numbers(ivfh["kernels"])},
        {"name": "rowscan_scores eval", "route": "cuda", "source": k1_src,
         "replaces": k1_tpu, "launches": ev["launches"]["rowscan_scores"],
         "library_ms": None, **numbers(ev["kernels"]["rowscan_scores"])},
        {"name": "scan_scores eval", "route": "cuda", "source": k2_src,
         "replaces": k2_tpu, "launches": ev["launches"]["scan_scores"],
         "library_ms": None, **numbers(ev["kernels"]["scan_scores"])},
        {"name": "rowscan_scores sharded", "route": "cuda", "source": k1_src,
         "replaces": k1_tpu, "launches": sh["launches"]["rowscan_scores"],
         "library_ms": None, **numbers(sh["kernels"]["rowscan_scores"])},
        {"name": "scan_scores sharded", "route": "cuda", "source": k2_src,
         "replaces": k2_tpu, "launches": sh["launches"]["scan_scores"],
         "library_ms": None, **numbers(sh["kernels"]["scan_scores"])}]
    # the merge kernel: the largest merge of each recorded window, beside
    # the launches of the path that window belongs to
    for name, window, n in (
            ("topk_merge", "1M 0.9 window", launches("topk_merge")),
            ("topk_merge sq8", "sq8 10M window",
             sq8["launches"]["topk_merge"]),
            ("topk_merge pq", "pq 10M window", pq["launches"]["topk_merge"])):
        rec = TOPK_RECORDS[window]
        kernels.append({"name": name, "route": "cuda", "source": merge_src,
                        "replaces": merge_tpu, "launches": n,
                        "library_ms": rec["library_ms"], **numbers(rec)})
    # k above 128: k 640 (shared memory), launched by [pqr 10M] at
    # k_factor 64, and k 6400 (scratch), in the comparisons only; the
    # numbers of their [topk k] lines
    for name, key, n in (("topk_merge k640", "k 640", pqr["k640_launches"]),
                         ("topk_merge k6400", "k 6400", 0)):
        rec = topk_lines[(key, "uniform")]
        kernels.append({"name": name, "route": "cuda", "source": merge_src,
                        "replaces": merge_tpu, "launches": n,
                        "library_ms": rec["library_ms"], **numbers(rec)})
    # the decision step: the benchmark's shape (B 1, k 10, stage 16, with
    # the state update), beside the launches of the 1M and 10M paths
    kernels.append({"name": "decide_step", "route": "cuda",
                    "source": "auncel_tpu_torch/csrc/decide.cu",
                    "replaces": "auncel_tpu/profile/bounded_mr.py:241 (XLA "
                    "ops, no pallas_call)",
                    "launches": launches("decide_step")
                    + sq8["launches"]["decide_step"], "library_ms": None,
                    **numbers(decide[(1, 10, 16, True)])})
    # K2's other PQ instances: filtered, launched by [pq 10M fixed] at each
    # Hamming threshold, with the numbers of its largest call at ht 64;
    # d 256 / M 32 at its synthetic layout, in the comparisons only
    kernels.append({"name": "scan_scores pq filter", "route": "cuda",
                    "source": k2_src, "replaces": k2_tpu,
                    "launches": pq["filter_launches"], "library_ms": None,
                    **numbers(pq["kernels"][("filter", PQ_HT10M[1])])})
    kernels.append({"name": "scan_scores pq d256", "route": "cuda",
                    "source": k2_src, "replaces": k2_tpu, "launches": 0,
                    "library_ms": None,
                    **numbers(pq_lines[("d 256 M 32", True, False)])})
    # the other codecs run only in the comparisons (no main-path launch)
    for (name, codec), res in codecs.items():
        if codec == "sq8":
            continue
        kernels.append({"name": f"{name} {codec}", "route": "cuda",
                        "source": k1_src if name == "rowscan_scores"
                        else k2_src,
                        "replaces": k1_tpu if name == "rowscan_scores"
                        else k2_tpu, "launches": 0, "library_ms": None,
                        **numbers(res)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
