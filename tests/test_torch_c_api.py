"""The port's C API (``auncel_tpu_torch/c_api``): the library and the demo
build into ``auncel_tpu_torch/_build/c_api`` and the demo runs on the CPU
(``AUNCEL_C_DEVICE=cpu``), its ids equal to the same calls made in Python.
Skips only when gcc, make or ``python3-config`` is missing; a failing build
with a working toolchain fails. The header keeps the JAX package's ABI."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
C_API_DIR = os.path.join(ROOT, "auncel_tpu_torch", "c_api")
OUT_DIR = os.path.join(ROOT, "auncel_tpu_torch", "_build", "c_api")
D, NB, NQ, K = 16, 4000, 32, 5   # demo.c's sizes


def _toolchain_available() -> bool:
    if shutil.which("gcc") is None or shutil.which("make") is None:
        return False
    try:
        out = subprocess.run(["python3-config", "--includes"],
                             capture_output=True, text=True, timeout=30)
    except FileNotFoundError:
        return False
    return out.returncode == 0 and "-I" in out.stdout


def demo_data():
    """demo.c's corpus: its LCG (s = s * 1103515245 + 12345 mod 2^32,
    value ((s >> 8) & 0xFFFF) / 65536) from seed 7; queries = rows."""
    s = 7
    out = np.empty(NB * D, np.float32)
    for i in range(NB * D):
        s = (s * 1103515245 + 12345) & 0xFFFFFFFF
        out[i] = ((s >> 8) & 0xFFFF) / 65536.0
    xb = out.reshape(NB, D)
    return xb, xb[:NQ].copy()


def python_ids(device="cpu"):
    """The demo's calls made in Python on ``device``: the fixed-nprobe and
    the bounded search's ids."""
    import auncel_tpu_torch as att
    xb, xq = demo_data()
    idx = att.index_factory(D, "IVF32,Flat", "l2", device=device)
    idx.train(xb)
    idx.add(xb)
    _, fixed = idx.search(xq, K, 32)
    gt_D, gt_I = idx.exact_search(xq, 20)
    es = att.ErrorSys(idx, 40, 20)
    es.set_gt(gt_D, gt_I)
    es.sys_train(NQ, xq)
    es.set_topk(K)
    es.set_queries(NQ, xq, np.full(NQ, 0.9, np.float32))
    es.set_hyper(4.0, 1.0)
    _, bounded = es.search(0, NQ)
    return fixed, bounded


def test_header_keeps_the_jax_abi():
    def prototypes(path):
        text = open(path).read()
        return sorted(re.sub(r"\s+", " ", m) for m in re.findall(
            r"^(?:int|void|const char \*)[^;{]*\);", text, re.M))
    want = prototypes(os.path.join(ROOT, "auncel_tpu", "c_api",
                                   "auncel_c.h"))
    assert len(want) == 10
    assert prototypes(os.path.join(C_API_DIR, "auncel_c.h")) == want


def run_demo(device: str) -> dict:
    """Build the library and the demo, run it with AUNCEL_C_DEVICE =
    ``device`` and return the ids it printed, {"fixed", "bounded"}: [NQ,
    K] each."""
    build = subprocess.run(["make", "-C", C_API_DIR, "demo"],
                           capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, (
        f"c_api build FAILED with a working toolchain\n"
        f"stdout: {build.stdout[-600:]}\nstderr: {build.stderr[-800:]}")
    env = dict(os.environ, AUNCEL_C_DEVICE=device, AUNCEL_PY_ROOT=ROOT)
    run = subprocess.run([os.path.join(OUT_DIR, "demo_c")],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=OUT_DIR)
    assert run.returncode == 0, (
        f"demo_c failed\nstdout: {run.stdout[-1000:]}\n"
        f"stderr: {run.stderr[-1000:]}")
    return {line.split(":")[0]: np.array(line.split(":")[1].split(),
                                         np.int64).reshape(NQ, K)
            for line in run.stdout.splitlines()
            if line.startswith(("fixed:", "bounded:"))}


@pytest.mark.skipif(not _toolchain_available(),
                    reason="no C compiler / make / python3-config")
def test_c_api_demo_matches_python():
    got = run_demo("cpu")
    fixed, bounded = python_ids()
    np.testing.assert_array_equal(got["fixed"], fixed)
    np.testing.assert_array_equal(got["bounded"], bounded)
