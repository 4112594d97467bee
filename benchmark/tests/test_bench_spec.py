"""``BENCHMARK.json``'s grammar and the files it names, and the trace
reduction on a made-up timeline."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import trace
from benchmark.spec import Spec

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
TEXT = re.compile(r"[^\n\t]{1,200}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS["top"]
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        entries = bench[kind]
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names)), kind
        for e in entries:
            extra = {"workloads"} if kind in ("end_to_end", "per_layer") \
                else set()
            assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
            assert NAME.fullmatch(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if kind != "end_to_end" and key in e:
                    assert TEXT.fullmatch(e[key]), (e["name"], key)
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_command_paths_and_time(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.fullmatch(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.fullmatch(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits in 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_cells_configs_and_metrics(bench):
    spec = Spec(REPO)
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    # set-up is reported in every cell, those that later PRs add too
    assert "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    four = sum(w["chips"] == 4 for w in cells.values())
    assert four <= max(1, len(cells) // 4)
    pairs = {(w["config"], w["traffic"]) for w in cells.values()}
    assert len(pairs) == len(cells)
    assert {w["config"] for w in cells.values()} == set(configs)
    for c in configs.values():
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    assert len({c["file"] for c in configs.values()}) == len(configs)
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        spec.reader(m["name"])           # the reader exists and loads
        layers.setdefault(m["layer"], m["layer"])
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for name, w in cells.items():
        assert w["chips"] in (1, 4) and NAME.fullmatch(w["traffic"])
        assert spec.traffic(w)["name"] == w["traffic"]
        got = spec.metrics("end_to_end", w)
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert spec.metrics("per_layer", w)


def test_layer_files_cover_every_kernel_of_the_port():
    layers = trace.load_layers(REPO / "benchmark" / "layers")
    names = set()
    for src in (REPO / "auncel_tpu_torch" / "csrc").glob("*.cu*"):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\([^)]*\)\s*)?(\w+)\s*\(",
                                src.read_text()))
    assert names, "no kernels found in csrc/"
    for n in names:
        want = "merge" if "topk_merge" in n else "scan"
        assert trace.layer_of(f"void {n}(Params)", layers) == want, n
    assert trace.layer_of("void at::native::elementwise_kernel<128, 4>",
                          layers) == trace.UNCLAIMED


class FakeTracer:
    def __init__(self, dev, host):
        self.dev, self.host = dev, host


class FakeEvent:
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


def test_reduce_on_a_made_up_timeline():
    # two windows [0, 100) and [120, 220), the bookkeeping between them
    host = [(0, 100, trace.WINDOW_SPAN, 1), (10, 40, "aten::nonzero", 1),
            (100, 120, trace.COLLECT_SPAN, 1),
            (120, 220, trace.WINDOW_SPAN, 1), (150, 200, "aten::item", 1)]
    dev = [(0, 10, "void sq_scan_kernel<8>(Params)"),
           (40, 60, "void topk_merge_kernel(Args)"),
           (50, 70, "void at::native::reduce_kernel"),
           (100, 105, "Memcpy HtoD (Pageable -> Device)"),
           (120, 150, "void rowscan_scores_kernel(Params)"),
           (200, 210, "Memcpy DtoH (Device -> Pageable)")]
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    # the device timeline's copies of spans, the benchmark's and one a
    # program might add, whatever their names, are no device operations
    annotations = [FakeEvent(0, 100, trace.WINDOW_SPAN, cuda, True),
                   FakeEvent(60, 90, "ErrorSys.search.wave", cuda, True),
                   FakeEvent(120, 220, "ProfilerStep#2", cuda, True)]
    events = ([FakeEvent(*h[:3], cpu, h[2].startswith("bench."))
               for h in host] + annotations
              + [FakeEvent(*d, cuda) for d in dev])
    got_dev, got_host = trace.split_events(events)
    assert sorted(got_dev) == sorted(dev) and sorted(got_host) == host
    layers = trace.load_layers(REPO / "benchmark" / "layers")
    rec = trace.reduce(FakeTracer(got_dev, got_host), layers)
    assert rec["n_windows"] == 2
    assert rec["window_s"] == pytest.approx(220e-9)
    assert rec["busy_s"] == pytest.approx(85e-9)
    assert rec["window_busy_s"] == pytest.approx([40e-9, 40e-9])
    assert rec["kernel_s"] == pytest.approx(95e-9)
    assert rec["layer_s"] == pytest.approx(
        {"scan": 40e-9, "merge": 20e-9, "torch_ops": 35e-9})
    idle = dict(rec["breakdown"]["idle_gaps"])
    assert idle == pytest.approx({
        "aten::nonzero": 30e-9, "python in ErrorSys.search": 40e-9,
        "harness bookkeeping": 15e-9, "aten::item": 50e-9})
    assert rec["breakdown"]["device_ops"][0] == [
        "void rowscan_scores_kernel(Params)", pytest.approx(30e-9)]
    spec = Spec(REPO)
    rec["n_scanned"] = np.array([3.0, 5.0])
    rec["scan_least_s"] = 11e-9
    got = {m["name"]: spec.reader(m["name"])(rec)
           for m in json.loads((REPO / "BENCHMARK.json").read_text())
           ["per_layer"]}
    assert got["lists_per_query"] == pytest.approx(4.0)
    assert got["engine.host_ms"] == pytest.approx(1e3 * 60e-9)
    assert got["scan.device_ms"] == pytest.approx(1e3 * 20e-9)
    assert got["merge.device_ms"] == pytest.approx(1e3 * 10e-9)
    assert got["torch_ops.device_ms"] == pytest.approx(1e3 * 17.5e-9)
    assert got["device.idle_pct"] == pytest.approx(100 * (1 - 85 / 220))
    assert got["kernels_roofline"] == pytest.approx(100 * 11 / 95)


def test_readers_give_nothing_without_a_trace():
    spec = Spec(REPO)
    for m in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]:
        if m["source"] == "device_trace":
            assert spec.reader(m["name"])({"n_windows": 0}) is None
