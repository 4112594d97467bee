"""The generator, the reference, the control and the roofline arithmetic at
tiny sizes."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import control, data, roofline
from benchmark.check import Judge
from benchmark.reference import knn
from benchmark.spec import Spec

HERE = Path(__file__).resolve().parent
CORPUS = json.loads((HERE / "cell/benchmark/configs/tiny-sq8.json")
                    .read_text())["corpus"]


def inputs(seed, nb=3000, n_setup=50, n_pool=40, data_seed=42):
    spec = dict(CORPUS, nb=nb, seed=data_seed)
    return data.make_inputs(spec, seed, "cpu", n_setup, n_pool)


def test_generator_is_deterministic_by_seed():
    a, b = inputs(2**31 + 3), inputs(2**31 + 3)
    c, other = inputs(2**31 + 4), inputs(2**31 + 3, data_seed=43)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # the run's seed draws the pool; the configuration's seed the data set
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    assert not torch.equal(a[2], c[2])
    assert not torch.equal(a[0], other[0])
    xb, q_setup, pool = a
    assert xb.shape == (3000, 16) and q_setup.shape == (50, 16)
    assert pool.shape == (40, 16) and xb.dtype == torch.float32
    # the mixture's scale: centres in [0, 1) x 512, spread 0.13 x 512
    assert 100.0 < float(xb.mean()) < 412.0


def brute(xs: torch.Tensor, q: torch.Tensor, k: int):
    d = ((q.double()[:, None, :] - xs.double()[None]) ** 2).sum(-1)
    ids = np.lexsort((np.broadcast_to(np.arange(xs.shape[0]), d.shape),
                      d.numpy()), axis=1)[:, :k]
    return np.take_along_axis(d.numpy(), ids, 1), ids


@pytest.mark.parametrize("codec", ["f32", "sq8"])
def test_exact_topk_against_brute_force(codec, monkeypatch):
    xb, _, pool = inputs(7)
    xs = knn.stored_vectors(xb, codec)
    monkeypatch.setattr(knn, "X_BLOCK", 700)   # several blocks and cuts
    d, i = knn.exact_topk(xs, pool, 10)
    bd, bi = brute(xs, pool, 10)
    np.testing.assert_array_equal(i.numpy(), bi)
    np.testing.assert_array_equal(d.numpy(), bd)


def test_sq8_matches_the_port_decode():
    from auncel_tpu_torch.index.flat import sq_encode, sq_train_range
    from auncel_tpu_torch.ops.sq import sq_decode_dev
    xb = inputs(9)[0]
    vmin, scale = sq_train_range(xb.numpy(), "sq8", "minmax")
    codes = sq_encode(xb.numpy(), vmin, scale, "sq8")
    port = sq_decode_dev(torch.as_tensor(codes), 16, torch.as_tensor(scale),
                         torch.as_tensor(vmin))
    assert torch.equal(knn.stored_vectors(xb, "sq8"), port)


def test_control_is_refused_and_exact_answers_pass():
    spec = Spec(HERE / "cell")
    cell = spec.cell("tiny.k10-r90")
    got = control.readings(spec, cell, 2**31 + 5, "cpu")
    assert {r["control"] for r in got} == {"tf32", "sq4"}
    assert all(r["correct"] is False for r in got)
    tf32 = next(r for r in got if r["control"] == "tf32")
    assert tf32["numbers"]["dist_gap"] > 1e-5


def test_judge_counts_ties_and_bad_ids():
    xb, _, pool = inputs(3)
    xs = knn.stored_vectors(xb, "f32")
    judge = Judge(xs, knn.sqnorms64(xs), pool, 5, 0.8, 1e-5)
    D, I = judge.ref_d.float().numpy(), judge.ref_i.numpy()
    judge.add(np.arange(40), D, I)
    assert judge.correct() and judge.worst_recall == 1.0
    I2 = I.copy()
    I2[3, 1] = I2[3, 0]          # a repeated id
    judge.add(np.arange(40), D, I2)
    assert judge.bad_ids == 1 and not judge.correct()


def test_to_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-12, 3.0])
    np.testing.assert_array_equal(control.to_tf32(x).numpy(),
                                  [1.0 + 2**-10, 1.0, 1.0 + 2**-10, 3.0])


def test_scan_work_and_least_time():
    # two queries over four lists of sizes 10, 20, 30, 40 at d 8
    order = np.array([[2, 0, 1, 3], [0, 1, 2, 3]])
    sizes = np.array([10, 20, 30, 40])
    flops, nbytes = roofline.scan_work(order, np.array([2, 1]), sizes, 8, 8)
    assert flops == 2 * 8 * (30 + 10 + 10)
    assert nbytes == (10 + 30) * (8 + roofline.NORM_ID_BYTES)
    t, bound = roofline.least_time(67e12, 1.0)
    assert bound == "flops" and t == pytest.approx(1.0)
    t, bound = roofline.least_time(1.0, 3.35e12)
    assert bound == "bytes" and t == pytest.approx(1.0)
    assert roofline.roofline_pct(0.5e-3, 0.1) == pytest.approx(0.5)
    assert roofline.roofline_pct(1e-3, 0.0) is None


def test_coarse_order_ranks_by_distance():
    c = torch.tensor([[0.0, 0.0], [10.0, 0.0], [1.0, 1.0]])
    q = torch.tensor([[9.0, 0.0], [0.5, 0.5]])
    assert roofline.coarse_order(q, c).tolist() == [[1, 2, 0], [0, 2, 1]]


def imports_of(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    return names


def test_reference_and_check_import_nothing_of_the_program():
    root = HERE.parent
    files = list((root / "reference").glob("*.py")) + [
        root / "check.py", root / "control.py", root / "data.py",
        root / "roofline.py", root / "trace.py", root / "spec.py"]
    for path in files:
        for name in imports_of(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "auncel_tpu",
                               "auncel_tpu_torch"), (path.name, name)
            assert name != "benchmark.system", (path.name, name)


@pytest.mark.cuda
def test_control_on_the_card_is_refused():
    """The control with real TF32 products (and SQ4 codes) on the card, at
    the test cell's size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 runs only on the card")
    spec = Spec(HERE / "cell")
    got = control.readings(spec, spec.cell("tiny.k10-r90"), 2**31 + 5, "cuda")
    assert all(r["correct"] is False for r in got)
