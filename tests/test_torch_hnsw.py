"""The HNSW graph (``index/hnsw.py``), port against the JAX package: one
graph built by both packages on small-integer vectors (100 x 16 in
[-8, 8), M 10, efConstruction 12), where every product and sum is exact in
fp32 and distances tie everywhere, so the two builds must give the same
levels, entry point, links and row maps; search on that graph (ids and
values), the ``.npz`` file in both directions, the occlusion heuristic and
the candidate merge on tie-heavy inputs, and the port's own build quality
on clustered data (recall against Flat, the degree caps, reachability)."""

import functools
import io

import numpy as np
import pytest
import torch

from auncel_tpu.index import hnsw as jh
from torch_parity import DEVICE, hnsw_state
from auncel_tpu_torch import convert
from auncel_tpu_torch.index import hnsw as th
from auncel_tpu_torch.index.flat import FlatIndex
from auncel_tpu_torch.types import Metric

D, N, M, EFC, EF = 16, 100, 10, 12, 16


def _ints(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(-8, 8, (n, D)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _built():
    """The same integer corpus built by both packages (one JAX build)."""
    x = _ints(N, 3)
    j = jh.HNSWIndex(D, M=M, ef_construction=EFC, seed=7)
    j.add(x)
    j.build()
    t = th.HNSWIndex(D, M=M, ef_construction=EFC, seed=7, device=DEVICE)
    t.add(x)
    t.build()
    return j, t


def _graph(idx):
    return (idx.levels, idx.entry_point, idx.max_level, idx.nb_tables,
            idx.g2u)


def _same_graph(a, b):
    la, ea, ma, ta, ga = _graph(a)
    lb, eb, mb, tb, gb = _graph(b)
    np.testing.assert_array_equal(la, lb)
    assert (ea, ma) == (eb, mb)
    assert len(ta) == len(tb) == ma + 1
    for l in range(ma + 1):
        np.testing.assert_array_equal(ta[l], tb[l], err_msg=f"level {l}")
        np.testing.assert_array_equal(ga[l], gb[l], err_msg=f"level {l}")


def test_build_matches_jax_on_exact_data():
    """The level draw, the frozen-graph batches, the link surgery, the
    connectivity repair and the refinement give the JAX package's graph."""
    j, t = _built()
    assert t.max_level >= 1          # the upper levels are exercised too
    _same_graph(j, t)
    assert set(t.build_times) == {"insert", "repair", "refine"}


def test_search_matches_jax_on_exact_data():
    j, t = _built()
    q = _ints(30, 4)
    jv, ji = j.search(q, 8, ef=EF)
    tv, ti = t.search(q, 8, ef=EF)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    assert ti.dtype == np.int64 and tv.dtype == np.float32


def test_converted_graph_searches_alike():
    """convert.hnsw_from_numpy carries the JAX graph over exactly."""
    j, _ = _built()
    c = convert.hnsw_from_numpy(hnsw_state(j), device=DEVICE)
    _same_graph(j, c)
    assert c.device.type == "cpu" and c.ef_search == j.ef_search
    q = _ints(30, 4)
    np.testing.assert_array_equal(c.search(q, 8, ef=EF)[1],
                                  j.search(q, 8, ef=EF)[1])


def test_files_in_both_directions():
    """The JAX package's .npz loads in the port and the port's in the JAX
    package, graph and answers unchanged."""
    j, t = _built()
    q = _ints(30, 4)
    buf = io.BytesIO()
    j.save(buf)
    buf.seek(0)
    back = th.HNSWIndex.load(buf, device=DEVICE)
    _same_graph(j, back)
    np.testing.assert_array_equal(back.search(q, 8, ef=EF)[1],
                                  j.search(q, 8, ef=EF)[1])
    buf = io.BytesIO()
    t.save(buf)
    buf.seek(0)
    jback = jh.HNSWIndex.load(buf)
    _same_graph(t, jback)
    assert (jback.M, jback.metric.value) == (t.M, "l2")
    np.testing.assert_array_equal(jback.search(q, 8, ef=EF)[1],
                                  t.search(q, 8, ef=EF)[1])


def test_heuristic_keep_matches_jax():
    """The occlusion walk on integer candidates (ties everywhere), with
    -1 pads, under both metrics."""
    import jax.numpy as jnp
    from auncel_tpu.types import Metric as JMetric
    rng = np.random.RandomState(8)
    xb = rng.randint(-3, 3, (40, 8)).astype(np.float32)
    q = rng.randint(-3, 3, (12, 8)).astype(np.float32)
    cand = np.stack([rng.permutation(40)[:16] for _ in range(12)])
    cand[:, 13:] = -1
    for metric in ("l2", "ip"):
        tm, jm = Metric.parse(metric), JMetric.parse(metric)
        xt = torch.from_numpy(xb)
        d = th._block_dist(torch.from_numpy(q), xt[torch.from_numpy(
            np.maximum(cand, 0))], tm)
        d = torch.where(torch.from_numpy(cand) >= 0, d,
                        float("inf") if metric == "l2" else -float("inf"))
        sign = 1.0 if metric == "l2" else -1.0
        order = torch.sort(sign * d, dim=1, stable=True).indices
        c = torch.from_numpy(cand).long().gather(1, order)
        dd = d.gather(1, order)
        got = th.heuristic_keep(xt, c, dd, 4, tm).numpy()
        want = np.asarray(jh.heuristic_keep(
            jnp.asarray(xb), jnp.asarray(q), jnp.asarray(c.numpy(), jnp.int32),
            jnp.asarray(dd.numpy()), 4, jm))
        np.testing.assert_array_equal(got, want, err_msg=metric)
        assert (got.sum(1) <= 4).all()


def test_merge_ranked_matches_jax():
    """Duplicates, self-links and -1 dropped; ties keep the JAX order."""
    import jax.numpy as jnp
    from auncel_tpu.types import Metric as JMetric
    rng = np.random.RandomState(9)
    ids_a = rng.randint(-1, 20, (6, 10))
    ids_b = rng.randint(-1, 20, (6, 7))
    d_a = rng.randint(0, 4, (6, 10)).astype(np.float32)
    d_b = rng.randint(0, 4, (6, 7)).astype(np.float32)
    self_ids = rng.randint(0, 20, 6)
    for metric in ("l2", "ip"):
        ti, td = th._merge_ranked(
            torch.from_numpy(ids_a), torch.from_numpy(d_a),
            torch.from_numpy(ids_b), torch.from_numpy(d_b),
            torch.from_numpy(self_ids), 9, Metric.parse(metric))
        ji, jd = jh._merge_ranked(
            jnp.asarray(ids_a, jnp.int32), jnp.asarray(d_a),
            jnp.asarray(ids_b, jnp.int32), jnp.asarray(d_b),
            jnp.asarray(self_ids, jnp.int32), 9, JMetric.parse(metric))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_early_exit_equals_the_fixed_loop():
    """A device loop that stops once no query moves returns what all
    ``iters`` steps return."""
    _, t = _built()
    xb, tables = t._dev
    q = torch.from_numpy(_ints(30, 4))
    cur, cur_d = t._entry_dist(q)
    tb, gg = tables[0]

    def run():
        return [th.beam_search(xb, tb, gg, q, cur, cur_d, EF, iters,
                               t.metric) for iters in (EF, 4 * EF)] + [
            th.greedy_descent(xb, tb, gg, q, cur, cur_d, 64, t.metric)]
    early = run()
    exit_check = th.EXIT_CHECK
    try:
        th.EXIT_CHECK = 10 ** 9
        fixed = run()
    finally:
        th.EXIT_CHECK = exit_check
    for a, b in zip(early, fixed):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@functools.lru_cache(maxsize=None)
def _clustered():
    from auncel_tpu_torch.data import make_clustered_dataset
    ds = make_clustered_dataset(nb=2000, nq=40, d=32, n_clusters=32,
                                seed=5)
    idx = th.HNSWIndex(32, M=16, ef_construction=40, device=DEVICE)
    idx.add(ds.xb)
    idx.build()
    flat = FlatIndex(32, device=DEVICE)
    flat.add(ds.xb)
    return ds, idx, flat.search(ds.xq, 10)


def test_port_build_quality():
    """The port's build on clustered data (2000 x 32, M 16, efc 40):
    recall@10 against Flat grows with ef and reaches the JAX test's limit
    (``tests/test_hnsw.py``: 0.90 at ef 64), values sorted best-first and
    equal to the exact distances of the returned ids."""
    ds, idx, (gv, gi) = _clustered()
    recs = []
    for ef in (10, 64):
        v, i = idx.search(ds.xq, 10, ef=ef)
        recs.append(np.mean([len(set(a) & set(b)) / 10
                             for a, b in zip(i.tolist(), gi.tolist())]))
    assert recs[1] >= recs[0] and recs[1] >= 0.9, recs
    assert np.all(np.diff(v, axis=1) >= -1e-5)
    exact = ((ds.xq[:, None, :] - ds.xb[i]) ** 2).sum(-1)
    np.testing.assert_allclose(v, exact, rtol=1e-4, atol=1e-4)


def test_graph_degrees_and_reachability():
    """Rows hold at most 2M links at level 0 and M above, no self-links,
    and every node of every level is reachable from the entry point."""
    _, idx, _ = _clustered()
    for l, (t, g) in enumerate(zip(idx.nb_tables, idx.g2u)):
        assert t.shape[1] == (2 * idx.M if l == 0 else idx.M)
        members = np.where(idx.levels >= l)[0]
        rows = t[g[members]]
        assert not (rows == members[:, None]).any()
        seen = np.zeros(idx.ntotal, bool)
        frontier = np.asarray([idx.entry_point])
        seen[frontier] = True
        while frontier.size:
            nxt = np.unique(t[g[frontier]].ravel())
            nxt = nxt[nxt >= 0]
            nxt = nxt[~seen[nxt]]
            seen[nxt] = True
            frontier = nxt
        assert seen[members].all(), f"level {l}"


def test_small_and_empty_indexes():
    """An empty index answers with pads, a one-vector index with itself,
    and an add after a build rebuilds at the next search."""
    idx = th.HNSWIndex(D, M=4, device=DEVICE)
    v, i = idx.search(_ints(3, 1), 2)
    assert (i == -1).all() and np.isinf(v).all()
    x = _ints(1, 2)
    idx.add(x)
    v, i = idx.search(x, 2)
    assert i[0, 0] == 0 and v[0, 0] == 0 and i[0, 1] == -1
    idx.add(_ints(20, 3))
    assert not idx._built
    _, i = idx.search(_ints(20, 3)[:5], 1)
    assert idx.ntotal == 21 and idx._built
    assert (i[:, 0] >= 1).all()


def test_ef_search_knob():
    """efSearch (the HNSW knob of the autotuner, swept over 16 ... 512, as
    the JAX package sweeps it) sets the default beam width."""
    from auncel_tpu.autotune import ParameterSpace as JPS
    from auncel_tpu_torch.autotune import (
        ParameterSpace, set_index_parameter, set_index_parameters)
    j, t = _built()
    assert ParameterSpace(t).parameter_ranges() == \
        JPS(j).parameter_ranges() == [("efSearch",
                                       [16, 32, 64, 128, 256, 512])]
    set_index_parameter(t, "efSearch", 40)
    assert t.ef_search == 40
    q = _ints(10, 5)
    np.testing.assert_array_equal(t.search(q, 5)[1],
                                  t.search(q, 5, ef=40)[1])
    set_index_parameters(t, "efSearch=16")
    assert t.ef_search == 16
    with pytest.raises(ValueError):
        set_index_parameter(t, "nprobe", 4)
