"""The binary HNSW family, port against the JAX package: ``BinaryHNSWIndex``
built by both packages on clustered 64-bit codes (the float graph on
{0, 1} planes, where every distance is an exact integer and ties are
everywhere), so the builds must give the same graph; search on it
(Hamming distances and ids exact), the ``BHNSW`` file in both directions,
``BinaryIVFIndex(coarse_hnsw_m=...)`` (the ``BIVFn_HNSWm`` cell) on the
JAX package's centroid bits and one coarse graph, and the binary factory's
graph cells."""

import functools
import io

import numpy as np
import pytest

import auncel_tpu.index.binary as jbin
from auncel_tpu.index.io import load_index as jload
from auncel_tpu.index.io import save_index as jsave
from torch_parity import DEVICE, hnsw_state
import auncel_tpu_torch.index.binary as tbin
from auncel_tpu_torch import convert
from auncel_tpu_torch.index.io import load_index, save_index

DB, N, M, EF = 64, 120, 8, 16
INT32_MAX = np.iinfo(np.int32).max


@functools.lru_cache(maxsize=None)
def _codes():
    """Clustered codes (6 centres, 5 bits flipped each) and 25 queries."""
    rng = np.random.RandomState(4)
    centers = rng.randint(0, 2, size=(6, DB))
    bits = np.empty((N + 25, DB), np.uint8)
    for i in range(N + 25):
        c = centers[i % 6].copy()
        c[rng.choice(DB, 5, replace=False)] ^= 1
        bits[i] = c
    codes = tbin.pack_bits(bits)
    return codes[:N], codes[N:]


@functools.lru_cache(maxsize=None)
def _built():
    xb, _ = _codes()
    j = jbin.BinaryHNSWIndex(DB, M=M)
    j.add(xb)
    j.build()
    t = tbin.BinaryHNSWIndex(DB, M=M, device=DEVICE)
    t.add(xb)
    t.build()
    return j, t


def _same_graph(a, b):
    np.testing.assert_array_equal(a.levels, b.levels)
    assert (a.entry_point, a.max_level) == (b.entry_point, b.max_level)
    for l in range(a.max_level + 1):
        np.testing.assert_array_equal(a.nb_tables[l], b.nb_tables[l])
        np.testing.assert_array_equal(a.g2u[l], b.g2u[l])


def test_binary_build_matches_jax():
    j, t = _built()
    assert t._g.max_level >= 1
    _same_graph(j._g, t._g)


def test_binary_search_matches_jax():
    """Integer Hamming distances and ids equal; the distances are the true
    Hamming distances of the returned codes; k past the graph pads with
    the int32 maximum and id -1."""
    j, t = _built()
    xb, xq = _codes()
    jv, ji = j.search(xq, 6, ef=EF)
    tv, ti = t.search(xq, 6, ef=EF)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    assert tv.dtype == np.int32
    bits = tbin.unpack_bits(xb, DB)
    qb = tbin.unpack_bits(xq, DB)
    ham = (bits[ti] != qb[:, None, :]).sum(-1)
    np.testing.assert_array_equal(tv, ham)
    small = tbin.BinaryHNSWIndex(DB, M=4, device=DEVICE)
    small.add(xb[:3])
    v, i = small.search(xq[:2], 5)
    assert (i[:, 3:] == -1).all() and (v[:, 3:] == INT32_MAX).all()


def test_bhnsw_files_in_both_directions(tmp_path):
    """The JAX package's BHNSW file loads in the port, and the port's in
    the JAX package, with the graph as it was built."""
    j, t = _built()
    _, xq = _codes()
    jsave(j, str(tmp_path / "j.npz"))
    back = load_index(str(tmp_path / "j.npz"), device=DEVICE)
    assert isinstance(back, tbin.BinaryHNSWIndex)
    _same_graph(j._g, back._g)
    np.testing.assert_array_equal(back.search(xq, 6, ef=EF)[1],
                                  j.search(xq, 6, ef=EF)[1])
    save_index(t, str(tmp_path / "t.npz"))
    jback = jload(str(tmp_path / "t.npz"))
    assert isinstance(jback, jbin.BinaryHNSWIndex)
    _same_graph(t._g, jback._g)
    np.testing.assert_array_equal(jback.search(xq, 6, ef=EF)[1],
                                  t.search(xq, 6, ef=EF)[1])
    # an empty index round-trips too
    save_index(tbin.BinaryHNSWIndex(DB, M=4, device=DEVICE),
               str(tmp_path / "e.npz"))
    assert jload(str(tmp_path / "e.npz")).ntotal == 0
    assert load_index(str(tmp_path / "e.npz"), device=DEVICE).ntotal == 0


def test_binary_graph_converts():
    """convert.hnsw_from_numpy builds a BinaryHNSWIndex from the keys of
    its file."""
    j, _ = _built()
    g = j._g
    st = hnsw_state(g)
    st.update(kind="BHNSW", codes=tbin.pack_bits(np.asarray(g._xb) > 0.5))
    c = convert.hnsw_from_numpy(st, device=DEVICE)
    assert isinstance(c, tbin.BinaryHNSWIndex)
    _same_graph(g, c._g)


@pytest.mark.parametrize("nprobe", [1, 3, 8])
def test_bivf_hnsw_matches_jax(nprobe):
    """BIVF8_HNSW4: the JAX package's centroid bits and one coarse graph
    (the port's, carried into the JAX index through its file), the same
    probes, ids and distances at every nprobe; at nprobe = nlist the -1 the
    graph leaves probes cell 0 again, which is scanned once."""
    j, t = _bivf()
    _, xq = _codes()
    jv, ji = j.search(xq, 5, nprobe=nprobe)
    tv, ti = t.search(xq, 5, nprobe=nprobe)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv, jv)
    for row in ti:
        real = row[row >= 0]
        assert len(set(real.tolist())) == real.size


@functools.lru_cache(maxsize=None)
def _bivf():
    xb, _ = _codes()
    j = jbin.BinaryIVFIndex(DB, 8, coarse_hnsw_m=4)
    j.train(xb)
    j.add(xb)
    t = convert.binary_from_numpy(dict(
        d=DB, nlist=8, codes=xb, centroid_bits=j.centroid_bits), DEVICE)
    t.coarse_hnsw_m = 4
    # the first search builds the port's coarse graph
    t.search(xb[:1], 1, nprobe=1)
    buf = io.BytesIO()
    save_index(t._coarse_g, buf)
    buf.seek(0)
    j._coarse_g = jload(buf)
    return j, t


def test_binary_factory_graph_cells():
    """BHNSWn (M 32 by default) and BIVFn_HNSWm (or _BHNSWm) build as in
    the JAX package."""
    for desc, m in (("BHNSW16", 16), ("BHNSW", 32)):
        i = tbin.index_binary_factory(DB, desc, device=DEVICE)
        ji = jbin.index_binary_factory(DB, desc)
        assert isinstance(i, tbin.BinaryHNSWIndex) and i._g.M == m == ji._g.M
    for desc in ("BIVF16_HNSW8", "BIVF16_BHNSW8"):
        i = tbin.index_binary_factory(DB, desc, device=DEVICE)
        assert isinstance(i, tbin.BinaryIVFIndex)
        assert (i.nlist, i.coarse_hnsw_m) == (16, 8)
