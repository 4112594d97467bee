"""The port's evaluation harness (``auncel_tpu_torch/eval_harness``): the
dataset registry and the disk caches it shares with the JAX package's
harness, and port-only runs of the effect_error, effect_time and overhead
experiments and of the ELP tuner with the invariants of
tests/test_eval_harness.py (compare: tests/test_torch_eval_compare.py)."""

import numpy as np
import pytest

from torch_parity import DEVICE


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _fail(what):
    def f(*a, **k):
        pytest.fail(f"{what} ran: the cache was missed")
    return f


def test_load_dataset_matches_jax():
    from auncel_tpu.eval_harness import common as jc
    from auncel_tpu_torch.eval_harness import common as tc
    for name, nq in (("synth10K", 100), ("synthHard100K", 20)):
        a, b = tc.load_dataset(name, nq=nq), jc.load_dataset(name, nq=nq)
        np.testing.assert_array_equal(a.xb, b.xb)
        np.testing.assert_array_equal(a.xq, b.xq)
        assert (a.metric.value, a.cache_tag) == (b.metric.value, b.cache_tag)
    assert tc.SYNTH_PARAMS == jc.SYNTH_PARAMS
    assert (tc.SYNTH_SIZES, tc.SYNTH_HARD, tc.SYNTH_VER, tc.SYNTH_D) == \
        (jc.SYNTH_SIZES, jc.SYNTH_HARD, jc.SYNTH_VER, jc.SYNTH_D)
    assert sorted(tc.FILE_DATASETS) == sorted(jc.FILE_DATASETS)
    with pytest.raises(KeyError):
        tc.load_dataset("nope")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_corpus_and_gt_caches_shared(tmp_path, monkeypatch, writer):
    """The >= BIG_CORPUS_ROWS corpus cache and the GT cache, written by one
    package and hit by the other (the threshold scaled down to
    synth10K)."""
    from auncel_tpu.eval_harness import common as jc
    from auncel_tpu_torch.eval_harness import common as tc
    monkeypatch.setenv("BENCH_CACHE", str(tmp_path))
    for c in (jc, tc):
        monkeypatch.setattr(c, "BIG_CORPUS_ROWS", 5_000)
    w, r = (jc, tc) if writer == "jax" else (tc, jc)
    kw = {} if w is jc else {"device": DEVICE}
    d1 = w.load_dataset("synth10K", nq=60)
    assert (tmp_path / "evalds_synth10K.npz").exists()
    idx = w.build_or_load_index(d1, nlist=32, cache_dir=str(tmp_path), **kw)
    gt_D, gt_I = w.ensure_gt(d1, idx, max_topk=20)
    assert (tmp_path / "gt_synth10K_f32.npz").exists()
    monkeypatch.setattr(r, "make_clustered_dataset", _fail("the generator"))
    d2 = r.load_dataset("synth10K", nq=40)
    np.testing.assert_array_equal(d2.xb, d1.xb)
    np.testing.assert_array_equal(d2.xq, d1.xq[:40])

    class NoScan:                 # an index whose full scan must not run
        storage = "f32"
        exact_search = _fail("exact_search")
    g_D, g_I = r.ensure_gt(d2, NoScan(), max_topk=20)
    np.testing.assert_array_equal(g_D, gt_D[:40])
    np.testing.assert_array_equal(g_I, gt_I[:40])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_quantizer_cache_shared(tmp_path, monkeypatch, writer):
    """The trained_index/ cache (centroids only) written by one package and
    loaded by the other; an SQ8 build reuses the Flat file's centroids."""
    from auncel_tpu.eval_harness import common as jc
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.eval_harness import common as tc
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    w, r = (jc, tc) if writer == "jax" else (tc, jc)
    wkw, rkw = ({}, {"device": DEVICE}) if w is jc else ({"device": DEVICE},
                                                         {})
    built = w.build_or_load_index(w.load_dataset("synth10K", nq=20),
                                  nlist=32, cache_dir="ti", **wkw)
    data = r.load_dataset("synth10K", nq=20)
    assert (tmp_path / "ti" / "synth10K_IVF32,Flat_trained.npz").exists()
    for cls in (JIVF, IVFFlatIndex):
        monkeypatch.setattr(cls, "train", _fail("k-means"))
    for storage in ("f32", "sq8"):
        got = r.build_or_load_index(data, nlist=32, cache_dir="ti",
                                    storage=storage, **rkw)
        np.testing.assert_array_equal(got.centroids, built.centroids)
        assert got.storage == storage and got.ntotal == data.xb.shape[0]


def test_check_bound_and_write_log(tmp_path):
    from auncel_tpu_torch.eval_harness import common
    from auncel_tpu_torch.types import Metric
    gt = np.tile(np.arange(10, dtype=np.float32), (3, 1))
    D = gt.copy()
    D[0, 9] = 100.0                       # one neighbour missed
    assert common.check_bound(D, gt, 10, 0.1, Metric.L2) == (True, 0.9)
    assert common.check_bound(D, gt, 10, 0.05, Metric.L2)[0] is False
    common.write_log(str(tmp_path / "x.log"), [(1, 2.5), 3.0])
    assert (tmp_path / "x.log").read_text() == "1 2.5\n3.0\n"


def test_effect_error_end_to_end(tmp_path):
    from auncel_tpu_torch.eval_harness import effect_error
    res = effect_error.run(db="synth10K", ts=200, ses=100, input_k=10,
                           nlist=64, max_topk=50, log_dir=str(tmp_path),
                           device=DEVICE)
    assert res["satisfaction"] > 0.9
    assert (tmp_path / "Effective_error_synth10K.log").exists()


def test_effect_time_end_to_end(tmp_path):
    from auncel_tpu_torch.eval_harness import effect_time
    res = effect_time.run(db="synth10K", ts=200, ses=100, input_k=10,
                          nlist=64, max_topk=50, log_dir=str(tmp_path),
                          n_measure=12, device=DEVICE)
    assert res["within_budget"] >= 0.95
    assert np.all(res["model_ms"] > 0)
    assert np.all(np.isfinite(res["measured_ms"]))
    assert np.all(res["measured_ms"] > 0)
    assert res["dispatch_floor_ms"] >= 0
    assert np.isfinite(res["model_rel_err"])
    assert (tmp_path / "Effective_time_synth10K.log").exists()


def test_overhead_end_to_end():
    from auncel_tpu_torch.eval_harness import overhead
    res = overhead.run(db="synth10K", ts=200, ses=100, input_k=10,
                       nlist=64, max_topk=50, reps=2, device=DEVICE)
    assert res["with_elp"] > 0 and res["without_elp"] > 0
    assert np.isfinite(res["overhead"])


def test_autotune_worst_case_baseline():
    from auncel_tpu_torch.autotune import ParameterSpace, worst_case_recall
    from auncel_tpu_torch.eval_harness import common
    from auncel_tpu_torch.types import Metric
    data = common.load_dataset("synth10K", nq=100)
    idx = common.build_or_load_index(data, nlist=64, cache_dir="ti",
                                     device=DEVICE)
    gt_D, _ = common.ensure_gt(data, idx, 50)
    ps = ParameterSpace(idx)
    nprobe = ps.tune_for_bound(data.xq, gt_D, k=10, eps=0.10)
    assert 1 <= nprobe <= 64
    D, _ = idx.search(data.xq, 10, nprobe=nprobe)
    assert worst_case_recall(D, gt_D, 10, Metric.L2) >= 0.9
    assert ps.ops.optimal()[-1].perf >= 0.999
