"""Index files of the index layer, port against the JAX package: the
``Flat`` kind, and a PQ-stored IVF index written as its decoded vectors
with storage "f32", each read by the other package. A plain-PQ file is the
same in both packages. For residual PQ the port writes the
reconstructions (each list's centroid added back), so its reload
reconstructs the stored vectors; the JAX package writes the decoded
residuals (ROADMAP.md section 3), which the test shows."""

import numpy as np
import pytest

from auncel_tpu.index.flat import FlatIndex as JFlat
from auncel_tpu.index.io import load_index as jload, save_index as jsave
from torch_parity import D, DEVICE, jax_fixture, pq_fixture, tnp
from auncel_tpu_torch.index.flat import FlatIndex
from auncel_tpu_torch.index.io import load_index, save_index

K = 10


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_flat_files_in_both_directions(tmp_path, metric):
    f = jax_fixture()
    xb, xq = f["xb"][:800], f["xq"][:20]
    ref = JFlat(D, metric)
    ref.add(xb)
    jsave(ref, str(tmp_path / "j.npz"))
    ours = load_index(str(tmp_path / "j.npz"), device=DEVICE)
    assert isinstance(ours, FlatIndex) and ours.metric.value == metric
    np.testing.assert_array_equal(ours.xb, xb)
    save_index(ours, str(tmp_path / "t.npz"))
    back = jload(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(back.xb, xb)
    np.testing.assert_array_equal(ours.search(xq, K)[1],
                                  back.search(xq, K)[1])


@pytest.mark.parametrize("residual", [False, True])
def test_pq_ivf_files_in_both_directions(tmp_path, residual):
    jidx, idx = pq_fixture(residual)
    xq = jax_fixture()["xq"][:20]
    jsave(jidx, str(tmp_path / "j.npz"))
    save_index(idx, str(tmp_path / "t.npz"))
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    for z in (zj, zt):
        assert '"storage": "f32"' in str(z["header"])
    for name in ("centroids", "vec_ids", "list_sizes"):
        np.testing.assert_array_equal(zt[name], zj[name])
    cents = tnp(idx.arrays.centroids)[:, None, :] if residual else 0.0
    live = zt["vec_ids"] >= 0
    np.testing.assert_allclose((zt["db"] - cents)[live], zj["db"][live],
                               rtol=0, atol=1e-6)
    if not residual:
        np.testing.assert_array_equal(zt["db"], zj["db"])
    # each package reads the other's file as an f32 index of those vectors
    ours, theirs = (load_index(str(tmp_path / "j.npz"), device=DEVICE),
                    jload(str(tmp_path / "t.npz")))
    assert ours.storage == theirs.storage == "f32"
    for a, b in ((ours, jload(str(tmp_path / "j.npz"))),
                 (load_index(str(tmp_path / "t.npz"), device=DEVICE),
                  theirs)):
        np.testing.assert_array_equal(a.search(xq, K, nprobe=4)[1],
                                      b.search(xq, K, nprobe=4)[1])
    # the port's file reloads to the stored vectors' reconstructions
    back = load_index(str(tmp_path / "t.npz"), device=DEVICE)
    keys = np.array([0, 17, 1234])
    np.testing.assert_allclose(back.reconstruct_batch(keys),
                               idx.reconstruct_batch(keys), rtol=0,
                               atol=1e-6)
