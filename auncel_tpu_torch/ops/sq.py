"""Scalar-quantizer decode on tensors (port of
``auncel_tpu/index/scan.py::sq_decode_dev``): the plain version of the
decode that the scan kernels run inside their rings, and the decode of the
dense passes and of the kernels' plain versions.
"""

import torch


def sq_decode_dev(sub: torch.Tensor, d: int, sq_scale: torch.Tensor,
                  sq_bias: torch.Tensor) -> torch.Tensor:
    """Affine SQ decode [..., width] uint8 -> [..., d] float32, dispatched
    by packed width as the JAX package's ``sq_decode_dev``: d/2 bytes =
    SQ4 (two dims per byte, low nibble first), 3d/4 bytes = SQ6 (four dims
    per 24-bit little-endian group), else SQ8/SQ8u/SQ8-direct. A multiply
    then an add, each rounded (the kernels decode the same way)."""
    width = sub.shape[-1]
    if width * 2 == d:
        c = sub.to(torch.int32)
        codes = torch.stack([c & 0xF, c >> 4], dim=-1).reshape(
            sub.shape[:-1] + (d,))
    elif width * 4 == d * 3:
        g = sub.reshape(sub.shape[:-1] + (d // 4, 3)).to(torch.int32)
        w = g[..., 0] | (g[..., 1] << 8) | (g[..., 2] << 16)
        codes = torch.stack([(w >> (6 * j)) & 63 for j in range(4)],
                            dim=-1).reshape(sub.shape[:-1] + (d,))
    else:
        codes = sub
    return codes.to(torch.float32) * sq_scale + sq_bias


def sq_kind(width: int, d: int) -> str | None:
    """The SQ packing of ``width`` bytes a vector at dimension ``d``, in
    ``sq_decode_dev``'s order: "sq4" (d/2), "sq6" (3d/4), "sq8" (d), or
    None when it is none of them."""
    if width * 2 == d:
        return "sq4"
    if width * 4 == d * 3:
        return "sq6"
    return "sq8" if width == d else None
