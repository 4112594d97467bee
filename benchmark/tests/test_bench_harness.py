"""The harness end to end at a tiny size on the CPU, on a cell that exists
only in this folder (``cell/``): a correct run, and one run for each fault
that a search cell can have, each of which ``correct`` has to refuse."""

import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import run as bench_run
from benchmark.spec import Spec
from benchmark.system import System

CELL_ROOT = Path(__file__).resolve().parent / "cell"
CELL = "tiny.k10-r90"
# the test folder's cells: windows of 100, and one query at a time
CELLS = [CELL, "tiny.b1"]
SEED = 2**31 + 11
REPO = Path(__file__).resolve().parents[2]


class Stale(System):
    """A window that hands back the previous window's answers: the state
    left unchanged."""

    def search(self, offset, size):
        got = super().search(offset, size)
        prev, self._prev = getattr(self, "_prev", None), got
        return got if prev is None else prev


class HalfServed(System):
    """Half of the queries left out: no answers for the second half of a
    window, or for every other query served one at a time."""

    def search(self, offset, size):
        D, I, ns = super().search(offset, size)
        D, I = D.copy(), I.copy()
        drop = slice(size // 2, None) if size > 1 else \
            slice(None if offset % 2 else 0)
        D[drop], I[drop] = np.inf, -1
        return D, I, ns


class Altered(System):
    """One answer altered where it is produced: an id swapped for another
    stored vector, its distance kept."""

    def search(self, offset, size):
        D, I, ns = super().search(offset, size)
        I = I.copy()
        I[0, 0] = (I[0, 0] + 1) % self.idx.ntotal
        return D, I, ns


def run_cell(system_cls=System, traced=False, cell=CELL) -> tuple:
    spec = Spec(CELL_ROOT)
    out, err = io.StringIO(), io.StringIO()
    rc = bench_run.run(spec, spec.cell(cell), SEED, 0.5, traced, "cpu",
                       system_cls=system_cls, out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]), err.getvalue()


@pytest.mark.parametrize("cell", CELLS)
def test_own_cell_runs_correct(cell):
    rc, res, err = run_cell(cell=cell)
    assert rc == 0
    assert res["correct"] is True and res["failed"] == 0
    window = 100 if cell == CELL else 1
    assert res["attempted"] > 0 and res["attempted"] % window == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"qps", "latency_p90_ms", "device_mem_gib",
                                   "setup_s"}
    assert all(m["value"] >= 0 for m in res["metrics"].values())
    tail = err.strip().splitlines()[-3:]
    assert [t.split()[2] for t in tail] == list(res["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_own_cell_traced_reads_its_own_metric(cell):
    rc, res, _ = run_cell(traced=True, cell=cell)
    assert rc == 0 and res["correct"] is True
    # the folder's only per-layer metric, a program counter: no device on
    # the CPU, so no trace to read
    assert res["metrics"] == {"queries_traced": {
        "value": res["attempted"], "unit": "queries"}}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [Stale, HalfServed, Altered],
                         ids=["state-unchanged", "half-left-out",
                              "answer-altered"])
def test_fault_makes_run_incorrect(fault, cell):
    rc, res, _ = run_cell(fault, cell=cell)
    assert rc == 0
    assert res["correct"] is False and res["failed"] > 0


def test_no_jax_after_a_run():
    """A fresh process that imports the harness and drives a run loads no
    module whose top-level name is jax, jaxlib, flax or auncel_tpu (the
    port, auncel_tpu_torch, is another name)."""
    code = (
        "import sys, io; from benchmark import run as r; "
        "from benchmark.spec import Spec; "
        f"s = Spec({str(CELL_ROOT)!r}); "
        f"rc = r.run(s, s.cell({CELL!r}), {SEED}, 0.3, False, 'cpu', "
        "out=io.StringIO(), err=io.StringIO()); "
        "tops = {m.split('.')[0] for m in sys.modules}; "
        "print(rc, sorted(tops & {'jax', 'jaxlib', 'flax', 'auncel_tpu'}), "
        "'auncel_tpu_torch' in tops)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "0 [] True"


def test_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(bench_run.torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(CELL_ROOT)
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    rc = bench_run.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                         "--trace", "0"])
    assert rc != 0 and out.getvalue() == ""
