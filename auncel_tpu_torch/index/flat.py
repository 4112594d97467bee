"""Scalar-quantizer helpers of the storage codecs (a copy of the SQ part of
``auncel_tpu/index/flat.py``; the port cannot import it without importing
jax). Numpy code: the range is trained and the codes are packed on the
host, as the JAX package does; the scans decode on the device
(``index/scan.py::sq_decode_dev`` and the kernels).
"""

import numpy as np


def sq_levels(qtype: str) -> float:
    """Code levels per scalar-quantizer type (reference ScalarQuantizer
    QT_* families, IndexScalarQuantizer.h:34-41): sq8* -> 255, sq6 -> 63,
    sq4* -> 15."""
    if qtype.startswith("sq8"):
        return 255.0
    if qtype.startswith("sq6"):
        return 63.0
    return 15.0


def sq_code_width(d: int, qtype: str) -> int:
    """Packed byte width per vector: sq4 = d/2, sq6 = 3d/4, else d."""
    if qtype.startswith("sq4"):
        assert d % 2 == 0, "SQ4 needs an even dimension"
        return d // 2
    if qtype.startswith("sq6"):
        assert d % 4 == 0, "SQ6 needs d % 4 == 0"
        return d * 3 // 4
    return d


def sq_pack(codes: np.ndarray, qtype: str) -> np.ndarray:
    """uint8 per-dimension codes [n, d] -> packed storage bytes.
    sq4: two dims per byte, low nibble first. sq6: four dims per three
    bytes, a little-endian 24-bit group. The inverse is
    ``index/scan.py::sq_decode_dev``."""
    if qtype.startswith("sq4"):
        return codes[:, 0::2] | (codes[:, 1::2] << 4)
    if qtype.startswith("sq6"):
        d = codes.shape[1]
        g = codes.reshape(-1, d // 4, 4).astype(np.uint32)
        w = g[..., 0] | (g[..., 1] << 6) | (g[..., 2] << 12) \
            | (g[..., 3] << 18)
        out = np.stack([w & 255, (w >> 8) & 255, (w >> 16) & 255], -1)
        return out.reshape(-1, d // 4 * 3).astype(np.uint8)
    return codes


def sq_train_range(x: np.ndarray, qtype: str, rangestat: str = "minmax",
                   rangestat_arg: float = 0.0):
    """Affine SQ range from a training set -> (vmin [d], scale [d]) f32.

    ``rangestat`` follows the reference ScalarQuantizer::RangeStat
    (IndexScalarQuantizer.h:51-56): "minmax" = [min-rs*(max-min),
    max+rs*(max-min)], "meanstd" = [mean-rs*std, mean+rs*std],
    "quantiles" = [Q(rs), Q(1-rs)]. Uniform qtypes ("sq8u"/"sq4u")
    compute the statistic over the flattened set (one shared range)."""
    assert rangestat in ("minmax", "meanstd", "quantiles"), rangestat
    x = np.asarray(x, np.float32)
    d = x.shape[1]
    levels = sq_levels(qtype)
    xs = x.reshape(-1, 1) if qtype.endswith("u") else x
    rs = float(rangestat_arg)
    if rangestat == "meanstd":
        mu, sd = xs.mean(0), xs.std(0)
        rs = rs if rs > 0 else 1.0   # reference uses rs*std directly
        vmin, vmax = mu - sd * rs, mu + sd * rs
    elif rangestat == "quantiles":
        q = rs if rs > 0 else 0.01
        vmin = np.quantile(xs, q, axis=0)
        vmax = np.quantile(xs, 1.0 - q, axis=0)
    else:
        vmin, vmax = xs.min(0), xs.max(0)
        vmin, vmax = vmin - rs * (vmax - vmin), vmax + rs * (vmax - vmin)
    if qtype.endswith("u"):
        vmin = np.full(d, vmin[0], np.float32)
        vmax = np.full(d, vmax[0], np.float32)
    vmin = vmin.astype(np.float32)
    scale = np.maximum((vmax - vmin) / levels, 1e-10).astype(np.float32)
    return vmin, scale


def sq_encode(x: np.ndarray, vmin: np.ndarray, scale: np.ndarray,
              qtype: str, block: int = 1 << 20) -> np.ndarray:
    """Per-dimension codes [n, d] uint8 of ``x``: clip(rint((x - vmin) /
    scale), 0, levels), in f32 as the JAX package's ``_pack`` computes
    them, ``block`` rows at a time to bound the host's temporaries."""
    levels = sq_levels(qtype)
    out = np.empty(x.shape, np.uint8)
    for i in range(0, x.shape[0], block):
        out[i:i + block] = np.clip(np.rint((x[i:i + block] - vmin) / scale),
                                   0, levels)
    return out
