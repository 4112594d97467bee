"""Exact nearest neighbours over the stored vectors, and the scalar
quantizer that stores them, in plain PyTorch.

The stored vectors are what an index holds: the float vectors themselves
for Flat storage, or for SQ storage the codes decoded. The SQ range is
worked out again here from the corpus (the reference's
``ScalarQuantizer::train`` with ``RS_minmax`` over the vectors added):
``vmin``, ``vmax`` per dimension, ``scale = (vmax - vmin) / levels``,
codes ``clip(rint((x - vmin) / scale), 0, levels)`` and values ``code *
scale + vmin``, each operation rounded in float32.

Distances are squared L2. The exact search selects candidates block by
block with a float32 product (``|x|^2 - 2 q.x``), keeps twice ``k`` and
some more of each block, and ranks the candidates by distances computed in
float64 from the differences, so rounding cannot reorder them. A
certificate checks for every query that no vector a block left out could
have entered its exact top k.
"""

import contextlib

import torch

LEVELS = {"sq8": 255.0, "sq4": 15.0}
# vectors a block of the selection holds, and queries a block
X_BLOCK = 1 << 21
Q_BLOCK = 1024
# the float32 selection's rounding is far below this share of |q|^2 + |x|^2
SELECT_SLACK = 1e-5


def sq_range(x: torch.Tensor, codec: str, block: int = X_BLOCK):
    """(vmin [d], scale [d]) float32 of the min-max range over ``x``."""
    lo = torch.stack([x[i:i + block].amin(0)
                      for i in range(0, x.shape[0], block)]).amin(0)
    hi = torch.stack([x[i:i + block].amax(0)
                      for i in range(0, x.shape[0], block)]).amax(0)
    # float32 (hi - lo) divided exactly: a division carried out in float64
    # and rounded once to float32 is the correctly rounded float32 quotient
    # (a tensor divided by a number may run as a product by its inverse)
    scale = ((hi - lo).double() / LEVELS[codec]).float().clamp_min(1e-10)
    return lo, scale


def sq_roundtrip(x: torch.Tensor, vmin: torch.Tensor, scale: torch.Tensor,
                 codec: str) -> torch.Tensor:
    """The stored values of ``x`` under the codec: encode, then decode."""
    codes = torch.round((x - vmin) / scale).clamp_(0.0, LEVELS[codec])
    return codes * scale + vmin


def stored_vectors(xb: torch.Tensor, codec: str,
                   block: int = X_BLOCK) -> torch.Tensor:
    """[nb, d] float32 the index stores for ``xb`` ("f32" returns ``xb``
    itself), block by block in place of a copy."""
    if codec == "f32":
        return xb
    vmin, scale = sq_range(xb, codec)
    out = torch.empty_like(xb)
    for i in range(0, xb.shape[0], block):
        out[i:i + block] = sq_roundtrip(xb[i:i + block], vmin, scale, codec)
    return out


def sqnorms64(x: torch.Tensor, block: int = X_BLOCK) -> torch.Tensor:
    """Squared norms in float64."""
    return torch.cat([x[i:i + block].double().square().sum(1)
                      for i in range(0, x.shape[0], block)])


def exact_distances(xs: torch.Tensor, q: torch.Tensor,
                    ids: torch.Tensor) -> torch.Tensor:
    """Float64 squared distances [n, m] of queries [n, d] to the stored
    vectors ``ids`` [n, m]; NaN where an id is out of range."""
    nb = xs.shape[0]
    ok = (ids >= 0) & (ids < nb)
    v = xs[ids.clamp(0, nb - 1)].double()
    d = (v - q.double()[:, None, :]).square().sum(-1)
    return torch.where(ok, d, torch.full_like(d, float("nan")))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Float32 products in TF32 (``tf32``) or in full float32, restored on
    exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def float32_topk(xs: torch.Tensor, q: torch.Tensor, k: int,
                 x_sq: torch.Tensor):
    """Top ``k`` by float32 distances ``|q|^2 + |x|^2 - 2 q.x`` in the
    matmul precision in force: (float32 distances [n, k], ids [n, k]).
    The reference in the program's place, for the control."""
    x_sq32 = x_sq.float()
    out_d, out_i = [], []
    for q0 in range(0, q.shape[0], Q_BLOCK):
        qb = q[q0:q0 + Q_BLOCK]
        q_sq = qb.square().sum(1)
        best_d, best_i = [], []
        for x0 in range(0, xs.shape[0], X_BLOCK):
            s = (qb @ xs[x0:x0 + X_BLOCK].T).mul_(-2.0)
            s.add_(x_sq32[x0:x0 + X_BLOCK]).add_(q_sq[:, None])
            v, i = torch.topk(s, min(k, s.shape[1]), dim=1, largest=False)
            best_d.append(v)
            best_i.append(i + x0)
            del s
        v, i = torch.cat(best_d, 1), torch.cat(best_i, 1)
        o = torch.topk(v, k, dim=1, largest=False).indices
        out_d.append(v.gather(1, o))
        out_i.append(i.gather(1, o))
    return torch.cat(out_d), torch.cat(out_i)


def exact_topk(xs: torch.Tensor, q: torch.Tensor, k: int,
               x_sq: torch.Tensor | None = None):
    """Exact top ``k`` of queries ``q`` [n, d] over the stored vectors
    ``xs`` [nb, d]: (float64 distances [n, k], ids [n, k] int64), ties
    broken by the smaller id. Raises ``ArithmeticError`` when the
    certificate fails (a block's cut lies within rounding of the k-th
    distance), which no sane input does."""
    if x_sq is None:
        x_sq = sqnorms64(xs)
    with matmul_precision(False):
        return _exact_topk(xs, q, k, x_sq)


def _exact_topk(xs, q, k, x_sq):
    nb = xs.shape[0]
    x_sq32 = x_sq.float()
    x_sq_max = float(x_sq.max())
    keep = min(2 * k + 16, nb)
    out_d, out_i = [], []
    for q0 in range(0, q.shape[0], Q_BLOCK):
        qb = q[q0:q0 + Q_BLOCK]
        q_sq = qb.double().square().sum(1)
        cand, cuts = [], []
        for x0 in range(0, nb, X_BLOCK):
            xblk = xs[x0:x0 + X_BLOCK]
            s = (qb @ xblk.T).mul_(-2.0).add_(x_sq32[x0:x0 + X_BLOCK])
            m = min(keep, xblk.shape[0])
            v, i = torch.topk(s, m, dim=1, largest=False, sorted=True)
            cand.append(i + x0)
            cut = v[:, -1].double() if m < xblk.shape[0] else \
                torch.full((qb.shape[0],), float("inf"), dtype=torch.float64,
                           device=q.device)
            cuts.append(cut)
            del s, v, i
        cand = torch.cat(cand, 1)
        d = exact_distances(xs, qb, cand)
        # sort by (distance, id): ids first, then a stable sort by distance
        by_id = torch.argsort(cand, dim=1)
        cand, d = cand.gather(1, by_id), d.gather(1, by_id)
        order = torch.argsort(d, dim=1, stable=True)[:, :k]
        dk, ik = d.gather(1, order), cand.gather(1, order)
        slack = SELECT_SLACK * (q_sq + x_sq_max)
        floor = torch.stack(cuts, 1).min(1).values + q_sq - slack
        if bool((dk[:, -1] >= floor).any()):
            raise ArithmeticError(
                "exact_topk: a block's cut lies within rounding of the k-th "
                "distance; widen the candidates")
        out_d.append(dk)
        out_i.append(ik)
    return torch.cat(out_d), torch.cat(out_i)
