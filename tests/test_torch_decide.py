"""The decision step's kernel (``csrc/decide.cu``, ``kernels/decide.py``).

On the card (marked ``cuda``, skipped without one): ``decision_step``,
which launches the kernel for CUDA tensors, bit for bit its plain version,
``decision_step_ref`` (``_decide_at_stage`` and ``_mr_update``) run on the
same card: recall, my_np, decided_at, stoped, pre_val and last_stage, for
L2 and IP, k 10 and 100, the exact mask at k + 1, batches of 1, 7 and
1000, the stage of the latency ladder and the forced stage, first and
later visits; on a degenerate trace, rows of an unfilled top-k, NaN and
+-inf values, phi placed exactly on the bins' edges, windows of every
length from 0 to 15 boundaries, and the trace set ErrorSys trains on a
small fixture. Then ``ErrorSys.search`` at batch 1 over 300 queries as
shipped against the same with the plain version swapped in: equal
results and decisions, two launches a query, the same host syncs.

On the CPU: ``decision_step`` takes the plain version for CPU tensors,
the kernel's wrapper refuses CPU and mixed devices, and its argument
block matches the kernel's.
This file imports no jax, so the card tests also run without the
suite's conftest:

    python -m pytest --noconftest tests/test_torch_decide.py
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import auncel_tpu_torch as att
from auncel_tpu_torch.index.aux import ivf_stats
from auncel_tpu_torch.index.scan import coarse_rank
from auncel_tpu_torch.kernels import decide as kd
from auncel_tpu_torch.kernels.decide import MRDecide, decide_step
from auncel_tpu_torch.profile import bounded, bounded_mr
from auncel_tpu_torch.profile.bounded import (
    FULL_OK_SLACK, decision_step, decision_step_ref, exact_topk_mask,
    stage_to_trace)
from auncel_tpu_torch.profile.geometry import (
    ANGLE_WINDOW, boundary_distances, n_boundaries, sum_angle)
from auncel_tpu_torch.profile.trace import (
    EMPTY_TRACE_U, TraceSet, make_trace_set)
from auncel_tpu_torch.types import Metric, worst_value
from torch_parity import D, K, MAX_TOPK, N_TEST, N_TRAIN, NLIST, \
    make_data

BIG_NLIST = 1024           # stages 16 (the latency ladder) and 128 (forced)
N_TRACES = 8
MAX_BINS = 300


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _traces(rng, kind: str, dev, edges=None) -> TraceSet:
    """N_TRACES traces of up to MAX_BINS bins: "random" ascending bins,
    "degenerate" (EMPTY_TRACE_U, as build_trace makes for a stage with no
    data) or "edges": the bins are ``edges`` (each candidate's exact phi)
    with U alternating between 0.01 and 1000, so that a phi one bin off
    flips its predicate."""
    per = []
    for t in range(N_TRACES):
        if kind == "degenerate":
            per.append((np.zeros(1, np.float32),
                        np.full(1, EMPTY_TRACE_U, np.float32),
                        np.zeros(1, np.float32)))
            continue
        if kind == "edges":
            phi = np.unique(edges[np.isfinite(edges)])
            phi = np.sort(rng.choice(phi, min(phi.size, MAX_BINS), False))
            u = np.where(np.arange(phi.size) % 2 == 0, 0.01, 1000.0)
        else:
            n = int(rng.randint(1, MAX_BINS + 1))
            phi = np.sort(rng.uniform(0.0, 8.0, n))
            u = rng.uniform(0.2, 3.0, n)
        per.append((phi.astype(np.float32), u.astype(np.float32),
                    rng.uniform(0.0, 0.3, phi.size).astype(np.float32)))
    return make_trace_set(per, dev)


def _vals(rng, B: int, max_topk: int, metric: Metric, edge_rows: bool):
    """A sorted running top-k a row; with ``edge_rows``, rows of an
    unfilled top-k (the metric's worst value from some position on, one
    row wholly), NaN, +-inf and zeros (the kdis guard)."""
    if metric is Metric.L2:
        v = np.sort(rng.uniform(0.05, 3.0, (B, max_topk)), axis=1)
    else:
        v = -np.sort(-rng.uniform(-1.0, 1.0, (B, max_topk)), axis=1)
    v = v.astype(np.float32)
    if edge_rows and B > 1:
        worst = worst_value(metric)
        for b in range(0, B, 3):
            v[b, rng.randint(0, max_topk):] = worst
        v[1] = worst
        for b in range(2, B, 5):
            v[b, rng.randint(0, max_topk, 2)] = np.nan
        for b in range(4, B, 7):
            v[b, rng.randint(0, max_topk)] = np.inf
            v[b, rng.randint(0, max_topk)] = -np.inf
        for b in range(5, B, 11):
            v[b, :rng.randint(1, 4)] = 0.0
    return v


def _dtb(rng, B: int, nb: int) -> np.ndarray:
    d = rng.uniform(-0.5, 2.5, (B, nb)).astype(np.float32)
    d[:, nb - rng.randint(0, 25):] = np.inf    # past the ranked centroids
    return d


def _state(rng, B: int, stage: int, later: bool, vals: np.ndarray,
           max_topk: int, mult: float, dev, nlist: int = BIG_NLIST
           ) -> MRDecide:
    """The carried state of a first visit (last_stage 0) or of a later one
    (earlier complete boundaries, some rows stagnant, some decided)."""
    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)
    S = 160
    offsets = np.cumsum(rng.randint(0, 40, (B, S)), axis=1)
    col = min(stage, S) - 1
    frontier = offsets[:, col] + rng.randint(-30, 30, B)
    acc = rng.choice([0.8, 0.9, 0.95, 0.99, 1.0], B).astype(np.float32)
    if later:
        last = rng.choice([0, 4, 8, stage // 2], B)
        pre = np.where(rng.rand(B) < 0.5, vals[:, max_topk - 1],
                       rng.uniform(0, 3, B)).astype(np.float32)
        stoped = rng.randint(0, 20, B)
        my_np = np.where(rng.rand(B) < 0.3, rng.randint(1, 300, B), 0)
        decided = np.where(my_np > 0, rng.choice([4, 8, 16], B), 0)
    else:
        last = pre = stoped = my_np = decided = np.zeros(B)
    return MRDecide(
        i32(frontier), i32(offsets)[:, col],
        torch.as_tensor(acc, device=dev),
        torch.floor(torch.as_tensor(acc, device=dev) * 12.0).to(torch.int32),
        torch.tensor(mult, dtype=torch.float32, device=dev), i32(my_np),
        i32(decided), i32(stoped),
        torch.as_tensor(np.asarray(pre, np.float32), device=dev), i32(last),
        stage, stage >= max(nlist // 8, 1), nlist)


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_same(got, want, what: str):
    names = ("recall", "my_np", "decided_at", "stoped", "pre_val",
             "last_stage")
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, name)
        gb, wb = _bits(g), _bits(w)
        bad = np.flatnonzero(gb != wb)
        assert bad.size == 0, (f"{what}: {name} differs at rows "
                               f"{bad[:8].tolist()}: {g.cpu()[bad[:8]]} "
                               f"against {w.cpu()[bad[:8]]}")


def _both(traces, dtb, vals, stage, nlist, k, max_topk, std_m, metric,
          exact, mr, what):
    before = decide_step.launches
    got = decision_step(traces, dtb, vals, stage, nlist, k, max_topk, std_m,
                        metric, exact, mr)
    want = decision_step_ref(traces, dtb, vals, stage, nlist, k, max_topk,
                             std_m, metric, exact, mr)
    torch.cuda.synchronize()
    assert decide_step.launches == before + 1
    _assert_same(got, want, what)


def _phi_edges(vals, dtb, stage, nlist, k, metric):
    """The plain version's phi of every candidate (width k + 1), on the
    card: the bins a trace puts on them."""
    tval = vals if metric is Metric.L2 else torch.arccos(
        vals.clamp(-1.0, 1.0))
    ind = stage_to_trace(stage, nlist)
    phi = sum_angle(tval[:, :k + 1], dtb, (1 << ind) - 1)
    return phi.cpu().numpy().ravel()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("B", [1, 7, 1000])
def test_kernel_is_bitwise_the_plain_version(metric, k, B):
    dev = _card()
    rng = np.random.RandomState(1000 * k + B + (metric is Metric.IP))
    max_topk = k + 10
    nb = n_boundaries(BIG_NLIST)
    vals = torch.as_tensor(_vals(rng, B, max_topk, metric, True), device=dev)
    dtb = torch.as_tensor(_dtb(rng, B, nb), device=dev)
    std_m = torch.tensor(1.5, dtype=torch.float32, device=dev)
    acc = torch.as_tensor(rng.choice([0.9, 0.95, 0.999, 1.0], B).astype(
        np.float32), device=dev)
    for stage in (16, BIG_NLIST // 8):
        edges = _phi_edges(vals, dtb, stage, BIG_NLIST, k, metric)
        for kind in ("random", "degenerate", "edges"):
            traces = _traces(rng, kind, dev, edges)
            for exact in (None, exact_topk_mask(acc, k)):
                what = (f"{metric.name} k {k} B {B} stage {stage} {kind} "
                        f"exact {exact is not None}")
                _both(traces, dtb, vals, stage, BIG_NLIST, k, max_topk,
                      std_m, metric, exact, None, what)
                for later in (False, True):
                    for mult in (2.7, 0.01):
                        mr = _state(rng, B, stage, later, vals.cpu().numpy(),
                                    max_topk, mult, dev)
                        _both(traces, dtb, vals, stage, BIG_NLIST, k,
                              max_topk, std_m, metric, exact, mr,
                              f"{what} later {later} mult {mult}")


@pytest.mark.cuda
def test_kernel_on_a_trained_profile():
    """The trace set ErrorSys trains on the parity fixture, with each
    query's true boundary distances and exact top-k values, at every
    trained stage, strided views as the dense replay passes them."""
    dev = _card()
    centers, xb, xq = make_data()
    idx = att.IVFFlatIndex(D, NLIST, device=dev)
    idx.set_centroids(centers)
    idx.add(xb)
    gt_D, gt_I = idx.exact_search(xq, MAX_TOPK)
    es = att.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    es.sys_train(N_TRAIN, xq)
    q = torch.as_tensor(xq, device=dev)
    cdis, cids = coarse_rank(idx.arrays, q, Metric.L2)
    dtb = boundary_distances(cdis, cids, idx.arrays.interdis, Metric.L2)
    snaps = torch.as_tensor(np.stack([gt_D, gt_D * 1.01], 1), device=dev)
    vals = snaps[:, 1]                     # a strided view
    every = exact_topk_mask(torch.ones(q.shape[0], device=dev), K)
    std_m = torch.tensor(1.0, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(5)
    for stage in (1, 2, NLIST // 8):
        for exact in (None, every):
            _both(es.traces, dtb, vals, stage, NLIST, K, MAX_TOPK, std_m,
                  Metric.L2, exact, None, f"trained stage {stage}")
            mr = _state(rng, q.shape[0], stage, True, vals.cpu().numpy(),
                        MAX_TOPK, 2.0, dev, NLIST)
            _both(es.traces, dtb, vals, stage, NLIST, K, MAX_TOPK, std_m,
                  Metric.L2, exact, mr, f"trained stage {stage} with state")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP])
def test_kernel_on_windows_of_every_length(metric):
    """Boundary distances that end inside the stage's window, so that
    phi sums 0 to 15 boundaries, each a length of torch's sum of its own."""
    dev = _card()
    rng = np.random.RandomState(7 + (metric is Metric.IP))
    B, stage = 1000, 16
    start = (1 << stage_to_trace(stage, BIG_NLIST)) - 1
    std_m = torch.tensor(1.5, dtype=torch.float32, device=dev)
    for k in (10, 100):
        max_topk = k + 10
        vals = torch.as_tensor(_vals(rng, B, max_topk, metric, True),
                               device=dev)
        acc = torch.as_tensor(rng.choice([0.9, 1.0], B).astype(np.float32),
                              device=dev)
        for w in range(ANGLE_WINDOW + 1):
            dtb = torch.as_tensor(rng.uniform(-0.5, 2.5, (B, start + w))
                                  .astype(np.float32), device=dev)
            edges = _phi_edges(vals, dtb, stage, BIG_NLIST, k, metric)
            for kind in ("random", "edges"):
                traces = _traces(rng, kind, dev, edges)
                mr = _state(rng, B, stage, True, vals.cpu().numpy(),
                            max_topk, 2.7, dev)
                for exact in (None, exact_topk_mask(acc, k)):
                    _both(traces, dtb, vals, stage, BIG_NLIST, k, max_topk,
                          std_m, metric, exact, mr,
                          f"{metric.name} k {k} window {w} {kind} "
                          f"exact {exact is not None}")


def _card_system(dev):
    """A small card fixture whose latency ladder decides twice a query:
    nlist 256 (stage 16 and the forced 32), 40000 vectors of d 32."""
    rng = np.random.RandomState(3)
    nlist, d, nb, n_train, n_test = 256, 32, 40000, 400, 300
    centers = rng.randn(nlist, d).astype(np.float32)
    xb = (centers[rng.randint(0, nlist, nb)]
          + 0.7 * rng.randn(nb, d)).astype(np.float32)
    nq = n_train + n_test
    xq = (centers[rng.randint(0, nlist, nq)]
          + 0.8 * rng.randn(nq, d)).astype(np.float32)
    idx = att.IVFFlatIndex(d, nlist, device=dev)
    idx.set_centroids(centers)
    idx.add(xb)
    idx.enable_multirow()
    gt_D, gt_I = idx.exact_search(xq, 20)
    es = att.ErrorSys(idx, train_num=nq, max_topk=20)
    es.set_gt(gt_D, gt_I)
    es.sys_train(n_train, xq)
    es.set_topk(10)
    es.set_queries(n_test, xq, np.full(nq, 0.9, np.float32))
    es.calibrate(0, n_train, target_bound=0.9)
    return es, n_train, n_test


def _serve(es, start: int, n: int):
    D, I = zip(*(es.search(start + i, 1) for i in range(n)))
    return (np.concatenate(D), np.concatenate(I),
            es.my_nprobe[start:start + n].copy(),
            es.n_scanned[start:start + n].copy())


@pytest.mark.cuda
def test_search_at_batch_1_equals_the_plain_version(monkeypatch):
    dev = _card()
    es, start, n = _card_system(dev)
    es.search(start, 1)                    # builds the kernel
    syncs, launches = ivf_stats.host_syncs, decide_step.launches
    got = _serve(es, start, n)
    torch.cuda.synchronize()
    syncs_kernel = ivf_stats.host_syncs - syncs
    assert decide_step.launches - launches == 2 * n

    calls = []

    def plain(*args, **kwargs):
        calls.append(1)
        return decision_step_ref(*args, **kwargs)

    monkeypatch.setattr(bounded_mr, "decision_step", plain)
    launches = decide_step.launches
    syncs = ivf_stats.host_syncs
    want = _serve(es, start, n)
    assert decide_step.launches == launches and len(calls) == 2 * n
    assert ivf_stats.host_syncs - syncs == syncs_kernel
    for name, g, w in zip(("D", "I", "my_nprobe", "n_scanned"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    calls = []
    monkeypatch.setattr(bounded, "decision_step_ref",
                        lambda *a, **kw: calls.append(1) or "plain")
    t = torch.zeros(2, 3)
    traces = make_trace_set([(np.zeros(1, np.float32),) * 3], "cpu")
    before = decide_step.launches
    assert decision_step(traces, t, t, 1, 8, 2, 3, torch.tensor(1.0),
                         Metric.L2) == "plain"
    assert calls == [1] and decide_step.launches == before


@pytest.mark.parametrize("other", ["cpu", "meta"])
def test_the_kernel_refuses_cpu_and_mixed_devices(other):
    t = torch.zeros(2, 3)
    traces = make_trace_set([(np.zeros(1, np.float32),) * 3], "cpu")
    with pytest.raises(ValueError, match="one CUDA device"):
        decide_step(traces, t, t.to(other), torch.tensor(1.0), ind=0,
                    window=ANGLE_WINDOW, query_k=2, max_topk=3,
                    slack=FULL_OK_SLACK, ip=False)


def test_argument_block_matches_the_kernel():
    """kernels/decide.py's ctypes mirror lists csrc/decide.cu's Args
    fields in order, each with a type of the C field's size."""
    src = (Path(kd.__file__).resolve().parent.parent / "csrc" /
           "decide.cu").read_text()
    body = re.search(r"struct Args \{(.*?)\n\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(?:const )?([a-z ]+?)\*?\s+(\w+);", body,
                        re.M)
    ptr = re.findall(r"^\s*(?:const )?[a-z ]+\*\s*(\w+);", body, re.M)
    assert [n for _, n in fields] == [n for n, _ in kd._Args._fields_]
    size = {"long long": 8, "int": 4, "float": 4}
    for (ctype, name), (pname, ptype) in zip(fields, kd._Args._fields_):
        want = 8 if name in ptr else size[ctype.strip()]
        assert ctypes.sizeof(ptype) == want, name


def test_iteration_count_is_the_replays():
    """The kernel replays cur_num with _simulate_cur_num's count, which
    the replay needs in full: with every predicate true it walks to
    k + 1."""
    assert [kd._iters(k) for k in (1, 2, 10, 11, 100, 1000, 2048)] == \
        [10, 10, 10, 10, 10, 11, 12]
    p = torch.ones((1, 2048), dtype=torch.bool)
    first_ok = torch.zeros(1, dtype=torch.bool)
    assert int(bounded._simulate_cur_num(p, first_ok, 2048)[0]) == 2049
