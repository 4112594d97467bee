"""The port's scaling harness (``auncel_tpu_torch/eval_harness/dist_bench``)
on the CPU, as ``tests/test_eval_harness.py::test_dist_bench_scaling``
runs the JAX one: its rows, its log and figure; no shard count is skipped
on one device; without a card its default device raises."""

import numpy as np
import pytest
import torch


def test_dist_bench_scaling(tmp_path):
    from auncel_tpu_torch.eval_harness import dist_bench
    rows = dist_bench.run(db="synth10K", shard_counts=(1, 4), nq=24,
                          nlist=32, max_topk=20, log_dir=str(tmp_path),
                          device="cpu")
    assert [r[0] for r in rows] == [1, 4]
    assert all(r[1] > 0 for r in rows)
    logged = np.loadtxt(tmp_path / "Dist_scaling.log", ndmin=2)
    np.testing.assert_allclose(logged, np.asarray(rows, np.float64),
                               rtol=1e-6)
    assert (tmp_path / "fig16.png").stat().st_size > 1000


def test_dist_bench_runs_every_count_on_one_device(tmp_path):
    """Shards share one device round-robin: 8 shards run, none skipped."""
    from auncel_tpu_torch.eval_harness import dist_bench
    rows = dist_bench.run(db="synth10K", shard_counts=(2, 8), nq=16,
                          nlist=16, max_topk=10, reps=1,
                          log_dir=str(tmp_path), device="cpu")
    assert [r[0] for r in rows] == [2, 8]


def test_dist_bench_needs_a_card_by_default(tmp_path, monkeypatch):
    from auncel_tpu_torch.eval_harness import dist_bench
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_bench.run(db="synth10K", shard_counts=(1,), nq=8,
                       log_dir=str(tmp_path))
