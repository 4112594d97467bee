"""The serving path's spans and counters (``auncel_tpu_torch/tracing.py``)
on a tiny port-built index on the CPU: the documented names and their
nesting under a CPU profiler, nothing entered with no profiler, and the
``ivf_stats`` counters against what the plan implies and against an
independent count of the calls that read a device value."""

import functools

import numpy as np
import pytest
import torch

from torch_parity import (ACC, D, K, MAX_TOPK, N_TEST, N_TRAIN, NLIST,
                          ROW_CAP, make_data)

import auncel_tpu_torch as att
from auncel_tpu_torch import tracing
from auncel_tpu_torch.index.aux import ivf_stats

# the five copies of ErrorSys._window and the four reads of _record
WINDOW_COPIES, RECORD_READS = 5, 4
COUNTERS = ("nq", "nlist_scanned", "waves", "waves_skipped", "rounds",
            "host_syncs")


@functools.lru_cache(maxsize=None)
def system():
    """A port-built ErrorSys on the multi-row layout (no JAX)."""
    centers, xb, xq = make_data()
    idx = att.IVFFlatIndex(D, NLIST, device="cpu")
    idx.set_centroids(centers)
    idx.add(xb)
    idx.enable_multirow(row_cap=ROW_CAP)
    gt_D, gt_I = idx.exact_search(xq, MAX_TOPK)
    es = att.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    es.sys_train(N_TRAIN, xq)
    es.set_topk(K)
    es.set_queries(N_TEST, xq, np.full(N_TRAIN + N_TEST, ACC, np.float32))
    es.set_hyper(2.0, 1.0)
    # a latency plan of seven waves, so that batch 1 skips some
    es.lat_decide_stages, es.lat_serve_base = (1, 2), 8
    return es


def deltas(call) -> dict:
    before = {f: getattr(ivf_stats, f) for f in COUNTERS}
    call()
    return {f: getattr(ivf_stats, f) - before[f] for f in COUNTERS}


def profiled_spans(call) -> list:
    """(start, end, name) of every ``auncel.*`` host event ``call`` emits
    under a CPU profiler, by start."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("auncel.")]
    return sorted(out, key=lambda s: (s[0], -s[1]))


def nesting(spans: list) -> tuple:
    """For each span, the innermost enclosing span's name (None at the
    top) and the names of all enclosing spans."""
    stack, up, anc = [], [], []
    for s in spans:
        while stack and stack[-1][1] <= s[0]:
            stack.pop()
        up.append(stack[-1][2] if stack else None)
        anc.append({a[2] for a in stack})
        stack.append(s)
    return up, anc


# the batch-1 latency engine and a window of the one-shot engine
ROUTES = {"batch1": (N_TRAIN, 1), "window": (N_TRAIN, N_TEST)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_spans_name_and_nest(route):
    es = system()
    start, size = ROUTES[route]
    spans = profiled_spans(lambda: es.search(start, size))
    names = [s[2] for s in spans]
    assert set(names) <= set(tracing.NAMES)
    assert names.count(tracing.SEARCH) == 1 and names[0] == tracing.SEARCH
    for name in (tracing.INPUTS, tracing.RANK, tracing.WAVE, tracing.SYNC,
                 tracing.SCAN, tracing.K1, tracing.MERGE, tracing.DECIDE,
                 tracing.RECORD):
        assert name in names, name
    up, anc = nesting(spans)
    for name, p, a in zip(names[1:], up[1:], anc[1:]):
        assert tracing.SEARCH in a, name
        if name in (tracing.K1, tracing.K2, tracing.MERGE):
            assert p == tracing.SCAN, (name, p)
        if name == tracing.SCAN:
            assert p in (tracing.WAVE, tracing.ROUND), p
        if name == tracing.DECIDE:
            assert p == tracing.WAVE, p
    if route == "window":
        assert tracing.ROUND in names   # the tail's compaction rounds
    # a sync is a leaf: no span opens inside one
    assert tracing.SYNC not in {p for p in up}


def test_no_profiler_enters_no_range(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    es = system()
    for start, size in ROUTES.values():
        es.search(start, size)
    assert entered == []
    assert tracing.span(tracing.WAVE) is tracing.span(tracing.SCAN)


def test_batch1_counters_follow_the_plan():
    es = system()
    plan = es._mr_latency_plan()
    got = deltas(lambda: es.search(N_TRAIN + 1, 1))
    n = es.n_scanned[N_TRAIN + 1]
    assert got["nq"] == 1 and got["nlist_scanned"] == n
    # every wave of the plan is visited: scanned or skipped by its test
    assert got["waves"] + got["waves_skipped"] == len(plan.waves)
    assert got["waves"] >= 1 and got["waves_skipped"] >= 1
    assert got["rounds"] == 0
    # the five copies, one skip test a wave, the four result reads
    assert got["host_syncs"] == WINDOW_COPIES + len(plan.waves) + \
        RECORD_READS


class ReadCounter:
    """Counts the calls that make the host read a tensor's value
    (``bool``, ``int``, ``.tolist()``, ``.cpu()``, ``.item()``): on the
    card each of them waits for the stream."""

    METHODS = ("__bool__", "__int__", "__index__", "tolist", "cpu", "item")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.METHODS:
            orig = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._wrap(orig))

    def _wrap(self, orig):
        def counted(t, *args, **kwargs):
            self.n += 1
            return orig(t, *args, **kwargs)
        return counted


@pytest.mark.parametrize("route", list(ROUTES))
def test_host_syncs_count_every_read(route, monkeypatch):
    """Every device read on the route goes through ``tracing.synced``: the
    counter equals the reads counted at the tensor, plus the window's five
    copies onto the card; a read added outside the helper breaks it."""
    es = system()
    start, size = ROUTES[route]
    reads = ReadCounter(monkeypatch)
    got = deltas(lambda: es.search(start, size))
    assert got["host_syncs"] == reads.n + WINDOW_COPIES
    assert got["nq"] == size
    assert got["nlist_scanned"] == int(es.n_scanned[start:start + size].sum())


def test_window_counters_match_the_spans():
    es = system()
    start, size = ROUTES["window"]
    got = deltas(lambda: profiled_spans(lambda: es.search(start, size)))
    names = [s[2] for s in profiled_spans(lambda: es.search(start, size))]
    assert got["waves"] + got["waves_skipped"] == names.count(tracing.WAVE)
    assert got["rounds"] == names.count(tracing.ROUND) >= 1
    assert got["host_syncs"] == names.count(tracing.SYNC)
    assert got["waves"] == names.count(tracing.SCAN)
