"""The benchmark's reduction of the program's spans (``benchmark/spans.py``)
and its readers, on a made-up profiler timeline: nested ``auncel.*`` host
spans inside ``bench.window``, device operations, and the device
timeline's copies of the spans (user annotations), which are not
operations."""

import io
import json
from pathlib import Path

import pytest

from benchmark import spans, trace
from benchmark.spec import Spec

REPO = Path(__file__).resolve().parents[1]
NEW = ("engine.syncs_per_query", "engine.waves_per_query", "engine.sync_ms",
       "engine.self_ms", "routing.host_ms", "scan.host_ms", "merge.host_ms")
CUDA = trace.torch.autograd.DeviceType.CUDA
CPU = trace.torch.autograd.DeviceType.CPU

# one window (ns), repeated at an offset of 1100; aten::sort is no span
HOST = [(0, 1000, "bench.window"), (10, 990, "auncel.search"),
        (10, 60, "auncel.inputs"), (20, 30, "auncel.sync"),
        (40, 50, "auncel.sync"), (60, 200, "auncel.rank"),
        (70, 150, "aten::sort"), (200, 600, "auncel.wave"),
        (200, 220, "auncel.sync"), (230, 500, "auncel.scan"),
        (250, 300, "auncel.k1"), (350, 450, "auncel.merge"),
        (510, 590, "auncel.decide"), (600, 650, "auncel.wave"),
        (600, 640, "auncel.sync"), (700, 980, "auncel.record"),
        (710, 800, "auncel.sync"), (1000, 1100, "bench.collect")]
DEV = [(100, 180, "void at::native::sort_kernel"),
       (260, 320, "void rowscan_scores_kernel(Params)"),
       (360, 440, "void topk_merge_kernel(Args)"),
       (720, 790, "Memcpy DtoH (Device -> Pageable)")]
# per window: self, idle in self (ns)
WANT = {"auncel.search": (60, 60), "auncel.inputs": (30, 30),
        "auncel.sync": (170, 100), "auncel.rank": (140, 60),
        "auncel.wave": (40, 40), "auncel.scan": (120, 100),
        "auncel.k1": (50, 10), "auncel.merge": (100, 20),
        "auncel.decide": (80, 80), "auncel.record": (190, 190)}


class Event:
    """A profiler event as ``trace.split_events`` reads it."""

    def __init__(self, start, end, name, device, annotation=False):
        self.start, self.end, self._name = start, end, name
        self.device, self.annotation = device, annotation

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start

    def name(self):
        return self._name

    def device_type(self):
        return self.device

    def start_thread_id(self):
        return 1

    def is_user_annotation(self):
        return self.annotation


class Timeline:
    def __init__(self, dev, host):
        self.dev, self.host = dev, host


def timeline(annotated: bool) -> Timeline:
    events = []
    for off in (0, 1100):
        events += [Event(s + off, e + off, n, CPU) for s, e, n in HOST]
        events += [Event(s + off, e + off, n, CUDA) for s, e, n in DEV]
        if annotated:
            events += [Event(s + off, e + off, n, CUDA, annotation=True)
                       for s, e, n in HOST if n.startswith("auncel.")]
    return Timeline(*trace.split_events(events))


def test_self_and_idle_per_name():
    by_name, counters = spans.summarize(timeline(True), window=1)
    assert set(by_name) == set(WANT)
    for name, (self_ns, idle_ns) in WANT.items():
        assert by_name[name]["self_s"] == pytest.approx(self_ns * 1e-9), name
        assert by_name[name]["idle_s"] == pytest.approx(idle_ns * 1e-9), name
    # the self times partition auncel.search
    assert sum(r["self_s"] for r in by_name.values()) == pytest.approx(
        by_name["auncel.search"]["wall_s"])
    assert by_name["auncel.search"]["wall_idle_s"] == pytest.approx(
        (980 - 290) * 1e-9)
    assert by_name["auncel.sync"]["count"] == 5
    assert counters == {"nq": 2, "host_syncs": 10, "waves": 2,
                        "waves_skipped": 2, "rounds": 0}


def test_program_annotations_are_not_device_operations():
    layers = trace.load_layers(REPO / "benchmark" / "layers")
    plain = trace.reduce(timeline(False), layers)
    annotated = trace.reduce(timeline(True), layers)
    for key in ("busy_s", "window_busy_s", "layer_s", "kernel_s"):
        assert annotated[key] == pytest.approx(plain[key]), key
    assert annotated["busy_s"] == pytest.approx(2 * 290e-9)
    # a gap takes the innermost host event at its middle: here a program
    # span ([440, 720) is the decision's)
    idle = dict(annotated["breakdown"]["idle_gaps"])
    assert idle["auncel.decide"] == pytest.approx(2 * 280e-9)


def test_readers_on_the_record():
    by_name, counters = spans.summarize(timeline(True), window=1)
    rec = {"n_windows": 2, "spans": by_name, "counters": counters}
    spec = Spec(REPO)
    got = {name: spec.reader(name)(rec) for name in NEW}
    ms = 1e-6   # one ns in ms
    assert got == pytest.approx({
        "engine.syncs_per_query": 5.0, "engine.waves_per_query": 1.0,
        "engine.sync_ms": 170 * ms, "engine.self_ms": 460 * ms,
        "routing.host_ms": 80 * ms, "scan.host_ms": 170 * ms,
        "merge.host_ms": 100 * ms})
    # the five span metrics partition auncel.search
    assert sum(got[n] for n in NEW[2:]) == pytest.approx(980 * ms)
    entries = {m["name"]: m for m in json.loads(
        (REPO / "BENCHMARK.json").read_text())["per_layer"]}
    assert all(entries[n]["source"] == "program_span" for n in NEW)


def test_readers_find_the_calling_run():
    """As ``run.run`` calls them: the first reader fills the record from
    the run's tracer and prints one line a name."""
    # the locals the readers look for, as run.run holds them
    tracer = trace.Tracer(1)
    tracer.dev, tracer.host = timeline(True).dev, timeline(True).host
    traffic, err = {"window": 1}, io.StringIO()
    rec = {"n_windows": 2}
    spec = Spec(REPO)
    values = {m: spec.reader(m)(rec) for m in NEW}
    assert values["engine.syncs_per_query"] == pytest.approx(5.0)
    assert rec["counters"]["host_syncs"] == 10
    lines = err.getvalue().splitlines()
    assert sum(line.startswith("[bench] span auncel.") for line in lines) \
        == len(WANT)


def test_readers_give_nothing_without_the_spans():
    spec = Spec(REPO)
    parent = Timeline(timeline(True).dev, [h for h in timeline(True).host
                                          if not h[2].startswith("auncel.")])
    assert spans.summarize(parent, window=1) == (None, None)
    for name in NEW:
        read = spec.reader(name)
        assert read({"n_windows": 0}) is None
        assert read({"n_windows": 2}) is None
        assert read({"n_windows": 2, "spans": None, "counters": None}) is None
