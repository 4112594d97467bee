"""The order in which the scan kernels (K1, K2) sum a dot, modelled in
plain torch (``torch_parity.dot_order_dots``): lane partials that are FMA
chains over groups of 4 dims, added as a butterfly. The card tests
(``test_torch_cuda.py``) hold both kernels on every route to this model bit
for bit; here, on the CPU, the model is held to the kernels' plain version
and to exact arithmetic."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from auncel_tpu_torch.index.flat import sq_levels, sq_pack
from auncel_tpu_torch.kernels.scan_scores import scan_scores_ref
from auncel_tpu_torch.ops.sq import sq_decode_dev
from auncel_tpu_torch.types import Metric
from torch_parity import dot_order_dots, dot_order_scores, fma32


def _layout(codec: str, d: int, seed: int = 0):
    """A padded layout of 3 lists of 40 slots (ragged sizes, one dead id)
    stored in ``codec``, 4 queries each probing two lists (one inactive
    slot): (args, sq_scale, sq_bias, decoded slots)."""
    rng = np.random.RandomState(seed)
    nlist, cap, B = 3, 40, 4
    sizes = torch.tensor([40, 17, 33], dtype=torch.int32)
    live = torch.arange(cap)[None, :] < sizes[:, None]
    ids = torch.where(live, torch.arange(nlist * cap, dtype=torch.int32)
                      .reshape(nlist, cap), -1)
    ids[1, 3] = -1
    sc = bi = None
    if codec == "f32":
        db = torch.from_numpy(
            (rng.randn(nlist, cap, d) / d ** 0.5).astype(np.float32))
        x = db
    else:
        levels = int(sq_levels(codec))
        codes = rng.randint(0, levels + 1, (nlist * cap, d)).astype(np.uint8)
        sc = torch.from_numpy((rng.rand(d) * 4.0 / levels / d ** 0.5
                               + 1e-3).astype(np.float32))
        bi = (-0.5 * levels * sc + torch.from_numpy(
            0.1 * rng.randn(d).astype(np.float32))).contiguous()
        db = torch.from_numpy(sq_pack(codes, codec)).reshape(nlist, cap, -1)
        x = sq_decode_dev(db, d, sc, bi)
    db_sq = torch.where(live, (x * x).sum(-1), 0.0)
    q = torch.from_numpy((rng.randn(B, d) / d ** 0.5).astype(np.float32))
    lists = torch.tensor([[0, 2], [1, -1], [2, 0], [1, 1]],
                         dtype=torch.int32)
    return (db, db_sq, ids, sizes, q, (q * q).sum(-1), lists), sc, bi, x


@pytest.mark.parametrize("d", [96, 128, 256])
@pytest.mark.parametrize("codec", ["f32", "sq8", "sq4", "sq6"])
def test_model_matches_plain_version(codec, d):
    """The model's scores equal the plain version's ids and dead slots and
    lie within rtol = atol = 1e-5 of its scores (another sum order of d
    products of O(1 / d))."""
    args, sc, bi, x = _layout(codec, d, seed=d)
    for metric in (Metric.L2, Metric.IP):
        got_s, got_i = dot_order_scores(args, x, metric)
        want_s, want_i = scan_scores_ref(*args, metric, sc, bi)
        assert torch.equal(got_i, want_i)
        assert torch.equal(torch.isfinite(got_s), torch.isfinite(want_s))
        torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("codec", ["f32", "sq8", "sq4", "sq6"])
def test_model_is_exact_on_unit_queries(codec):
    """With unit queries each dot is one decoded element: the other
    products are zeros, so every order gives that element bit for bit."""
    d = 96
    _, _, _, x = _layout(codec, d, seed=3)
    x = x.reshape(-1, d)[None].expand(d, -1, d).contiguous()
    dots = dot_order_dots(x, torch.eye(d))
    assert torch.equal(dots, x[0].T)


def test_fma32_rounds_once():
    """fma32 against the exact sum of a product and an addend, rounded
    once to float32 (by Fraction), on random and cancelling triples."""
    rng = np.random.RandomState(0)
    a = rng.randn(400).astype(np.float32)
    b = rng.randn(400).astype(np.float32)
    c = rng.randn(400).astype(np.float32)
    c[:100] = -(a[:100].astype(np.float64) * b[:100]).astype(np.float32)
    c[100:200] *= np.float32(1e-8)
    got = fma32(torch.from_numpy(a), torch.from_numpy(b),
                torch.from_numpy(c)).numpy()
    for i in range(400):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        want = np.float32(float(exact))   # nearest float64, then float32
        lo, hi = np.nextafter(want, np.float32(-np.inf)), \
            np.nextafter(want, np.float32(np.inf))
        # the nearest float32 to the exact value (ties to even)
        best = min((want, lo, hi), key=lambda v: (
            abs(Fraction(float(v)) - exact),
            int(np.float32(v).view(np.int32)) & 1))
        assert got[i] == best, (i, a[i], b[i], c[i], got[i], best)
