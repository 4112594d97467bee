"""The traced run: ``torch.profiler`` over a few windows, reduced to what
the per-layer readers take.

The profiler records host operations and device activity over ``active``
windows after one window of warm-up (``prof.step()`` after each window).
The benchmark's own spans (``record_function``) mark each window's call
into the program (``bench.window``) and the harness's bookkeeping after
it (``bench.collect``). From the trace:

* device operations: kernels, copies and fills, with their profiler names
  (the device timeline's copies of spans, user annotations, are left out);
  the layer of a kernel is the first layer file (``layers/<layer>.json``,
  a list of regular expressions over the names) that claims it, and
  ``torch_ops`` for the rest;
* busy time: the union of the device operations' intervals;
* idle gaps: the stretches with no device operation, each labelled by the
  innermost host operation running at its middle (a span of the benchmark
  when no operation of the program is).
"""

import json
import re
from pathlib import Path

import numpy as np
import torch

WINDOW_SPAN = "bench.window"
COLLECT_SPAN = "bench.collect"
UNCLAIMED = "torch_ops"
SPAN_LABELS = {WINDOW_SPAN: "python in ErrorSys.search",
               COLLECT_SPAN: "harness bookkeeping"}
TOP = 10
# characters of a profiler name kept in the breakdown (template arguments
# make some names thousands long)
NAME_CHARS = 160


def load_layers(layer_dir) -> dict:
    """{layer: [compiled patterns]} from ``<layer_dir>/*.json``, by file
    name."""
    return {path.stem: [re.compile(p)
                        for p in json.loads(path.read_text())["kernels"]]
            for path in sorted(Path(layer_dir).glob("*.json"))}


def layer_of(name: str, layers: dict) -> str:
    for layer, pats in layers.items():
        if any(p.search(name) for p in pats):
            return layer
    return UNCLAIMED


class Tracer:
    """A profiler over ``active`` windows after one of warm-up; call
    ``step()`` after each window."""

    def __init__(self, active: int):
        from torch.profiler import ProfilerActivity, profile, schedule
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.dev, self.host = [], []
        self.prof = profile(activities=acts,
                            schedule=schedule(wait=0, warmup=1,
                                              active=active, repeat=1),
                            on_trace_ready=self._ready)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def step(self) -> None:
        self.prof.step()

    def _ready(self, prof) -> None:
        self.dev, self.host = split_events(
            prof.profiler.kineto_results.events())


def split_events(events) -> tuple:
    """(device operations [(start, end, name)], host events [(start, end,
    name, thread)]) of a profiler's events. A device-side event is an
    operation (kernel, copy, fill) unless it is a user annotation: the
    device timeline's copy of a ``record_function`` span, the benchmark's
    or the program's."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        start = e.start_ns()
        rec = (start, start + e.duration_ns(), e.name())
        if e.device_type() != cuda:
            host.append(rec + (e.start_thread_id(),))
        elif not e.is_user_annotation():
            dev.append(rec)
    return dev, host


def _union(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """[m, 2] disjoint sorted intervals covering the given ones."""
    if not len(starts):
        return np.zeros((0, 2), np.int64)
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], np.maximum.accumulate(ends[o])
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    last = np.r_[first[1:] - 1, len(s) - 1]
    return np.stack([s[first], e[last]], 1)


def _covered(iv: np.ndarray, lo: int, hi: int) -> int:
    """ns of [lo, hi) that the disjoint intervals ``iv`` cover."""
    if not len(iv):
        return 0
    return int(np.clip(np.minimum(iv[:, 1], hi) - np.maximum(iv[:, 0], lo),
                       0, None).sum())


def _label_gaps(gaps: np.ndarray, host: list) -> dict:
    """{label: idle ns}: each gap to the innermost host event open at its
    middle, by one sweep over the (nested) host events."""
    ev = sorted(host, key=lambda h: (h[0], -h[1]))
    mids = sorted(((int(g0 + (g1 - g0) // 2), int(g1 - g0))
                   for g0, g1 in gaps))
    out: dict = {}
    stack, i = [], 0
    for t, length in mids:
        while i < len(ev) and ev[i][0] <= t:
            while stack and stack[-1][1] <= ev[i][0]:
                stack.pop()
            stack.append(ev[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        if not stack or stack[-1][2].startswith("ProfilerStep"):
            label = "harness between windows"
        else:
            label = SPAN_LABELS.get(stack[-1][2], stack[-1][2])
        out[label] = out.get(label, 0) + length
    return out


def reduce(tracer: Tracer, layers: dict) -> dict:
    """The traced windows' record: per-window wall and busy time, device
    seconds by layer and in all, the traced window's length and busy time,
    and the breakdown."""
    spans = sorted((h for h in tracer.host if h[2] == WINDOW_SPAN),
                   key=lambda h: h[0])
    if not spans or not tracer.dev:
        return {"n_windows": 0}
    lo, hi = spans[0][0], spans[-1][1]
    thread = spans[0][3]
    dev = [d for d in tracer.dev if d[1] > lo and d[0] < hi]
    starts = np.array([d[0] for d in dev], np.int64)
    ends = np.array([d[1] for d in dev], np.int64)
    busy = _union(starts, ends)
    by_name: dict = {}
    for s, e, name in dev:
        by_name[name] = by_name.get(name, 0) + (min(e, hi) - max(s, lo))
    layer_ns: dict = {}
    for name, ns in by_name.items():
        layer = layer_of(name, layers)
        layer_ns[layer] = layer_ns.get(layer, 0) + ns
    gaps = np.stack([np.r_[lo, busy[:, 1]], np.r_[busy[:, 0], hi]], 1) \
        if len(busy) else np.array([[lo, hi]], np.int64)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    host = [h for h in tracer.host if h[3] == thread]
    idle = _label_gaps(gaps, host)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "n_windows": len(spans),
        "window_wall_s": [(s[1] - s[0]) * 1e-9 for s in spans],
        "window_busy_s": [_covered(busy, s[0], s[1]) * 1e-9 for s in spans],
        "window_s": (hi - lo) * 1e-9,
        "busy_s": _covered(busy, lo, hi) * 1e-9,
        "kernel_s": sum(by_name.values()) * 1e-9,
        "layer_s": {k: v * 1e-9 for k, v in layer_ns.items()},
        "breakdown": {"device_ops": [[n[:NAME_CHARS], v * 1e-9]
                                     for n, v in top],
                      "idle_gaps": [[n, v * 1e-9] for n, v in top_idle]},
    }
