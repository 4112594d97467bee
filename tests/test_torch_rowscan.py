"""K1, the worklist row-scan: the port's plain version against the Pallas
kernel in interpret mode (rtol = atol = 1e-5, as tests/test_rowscan.py) and
the wrapper's contract. The CUDA kernel itself is tested on a card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parity  # noqa: F401  (single-threaded torch)
from auncel_tpu.pallas_kernels.rowscan import TCHUNK
from auncel_tpu.pallas_kernels.rowscan import rowscan_dots as jax_rowscan
from auncel_tpu_torch.kernels import build
from auncel_tpu_torch.kernels.rowscan import rowscan_dots, rowscan_dots_ref


def _inputs(rng, n_rows, row_cap, d, T):
    db = rng.randn(n_rows, row_cap, d).astype(np.float32)
    work = rng.randint(0, n_rows, T).astype(np.int32)
    qs = rng.randn(T, d).astype(np.float32)
    return db, work, qs


def test_plain_version_matches_pallas_interpret():
    rng = np.random.RandomState(3)
    db, work, qs = _inputs(rng, 24, 8, 16, 2 * TCHUNK)
    want = np.asarray(jax_rowscan(jnp.asarray(db), jnp.asarray(work),
                                  jnp.asarray(qs), interpret=True))
    got = rowscan_dots(torch.from_numpy(db), torch.from_numpy(work),
                       torch.from_numpy(qs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [0, 1, 13, 37])
def test_any_worklist_length(T):
    """No T % 16 requirement (the Pallas kernel's TCHUNK)."""
    rng = np.random.RandomState(4)
    db, work, qs = _inputs(rng, 10, 5, 12, T)
    got = rowscan_dots(torch.from_numpy(db), torch.from_numpy(work),
                       torch.from_numpy(qs)).numpy()
    assert got.shape == (T, 5)
    np.testing.assert_allclose(got, np.einsum("tcd,td->tc", db[work], qs),
                               rtol=1e-5, atol=1e-5)


def test_cpu_runs_plain_version_without_counting():
    rng = np.random.RandomState(5)
    db, work, qs = _inputs(rng, 6, 4, 8, 9)
    before = rowscan_dots.launches
    rowscan_dots(torch.from_numpy(db), torch.from_numpy(work),
                 torch.from_numpy(qs))
    assert rowscan_dots.launches == before


def test_wrapper_rejects_bad_inputs():
    db = torch.zeros(4, 3, 8)
    rows = torch.zeros(5, dtype=torch.int32)
    qs = torch.zeros(5, 8)
    with pytest.raises(TypeError):
        rowscan_dots(db.double(), rows, qs)
    with pytest.raises(TypeError):
        rowscan_dots(db, rows.long(), qs)
    with pytest.raises(ValueError):
        rowscan_dots(db, rows[:4], qs)
    with pytest.raises(ValueError):
        rowscan_dots(db[0], rows, qs)
    # a tensor off the CPU never takes the plain version
    with pytest.raises(ValueError):
        rowscan_dots(db.to("meta"), rows.to("meta"), qs.to("meta"))


def test_out_of_range_rows_clamp_like_a_gather():
    rng = np.random.RandomState(6)
    db, _, qs = _inputs(rng, 5, 3, 8, 3)
    rows = np.asarray([-4, 2, 99], np.int32)
    got = rowscan_dots(torch.from_numpy(db), torch.from_numpy(rows),
                       torch.from_numpy(qs)).numpy()
    np.testing.assert_allclose(
        got, np.einsum("tcd,td->tc", db[np.clip(rows, 0, 4)], qs),
        rtol=1e-5, atol=1e-5)


def test_build_is_keyed_by_source_and_reports_missing_nvcc(monkeypatch,
                                                          tmp_path):
    path = build.library_path("rowscan")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.library_path("rowscan")  # deterministic
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()

