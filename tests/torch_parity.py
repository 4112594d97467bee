"""Shared fixture of the parity tests between auncel_tpu (JAX, the
reference) and auncel_tpu_torch (the PyTorch port).

A small skewed IVF index (d=16, nlist=32, ~4000 vectors, max_topk=20, 80
training and 20 held-out queries) is built ONCE per process with the JAX
package: centroids, multi-row layout, ground truth and trained profile.
``port_state`` hands the same state to the port through
``auncel_tpu_torch.convert``, so both packages compute on identical data.
``padded_systems`` gives both packages an ErrorSys on the same index
without the multi-row layout, serving the fixture's saved profile.
"""

import functools
import os
import tempfile

import numpy as np
import torch

torch.set_num_threads(1)  # the suite runs several test processes at once

# the port's entry points default to the card; its parity tests run on the
# CPU, where every kernel's plain version runs
DEVICE = "cpu"

D, NLIST, NB = 16, 32, 4000
N_TRAIN, N_TEST, MAX_TOPK, K = 80, 20, 20, 10
ROW_CAP = 64
ACC = 0.9


def make_data(seed: int = 11):
    """Clustered corpus with skewed list sizes (share ~ 1/sqrt(rank): the
    largest lists span several rows) and queries near the clusters.
    Centred data keeps distances comparable to the norms, so the L2
    expansion stays accurate to ~1e-6 relative in both packages."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(NLIST, D).astype(np.float32)
    pops = 1.0 / np.sqrt(np.arange(1, NLIST + 1))
    pops /= pops.sum()
    which = rng.choice(NLIST, size=NB, p=pops)
    xb = (centers[which] + 0.5 * rng.randn(NB, D)).astype(np.float32)
    nq = N_TRAIN + N_TEST
    xq = (centers[rng.choice(NLIST, nq)]
          + 0.6 * rng.randn(nq, D)).astype(np.float32)
    return centers, xb, xq


def as_numpy(nt) -> dict:
    """A JAX NamedTuple's fields as numpy arrays (nested NamedTuples as
    dicts, None kept)."""
    out = {}
    for f, v in nt._asdict().items():
        if hasattr(v, "_asdict"):
            out[f] = as_numpy(v)
        else:
            out[f] = None if v is None else np.asarray(v)
    return out


@functools.lru_cache(maxsize=None)
def jax_fixture():
    """The JAX reference: index with the multi-row layout, GT and a
    trained ErrorSys (bounds ACC, query_k K)."""
    import auncel_tpu as at
    from auncel_tpu.index.ivf import IVFFlatIndex
    centers, xb, xq = make_data()
    idx = IVFFlatIndex(D, NLIST)
    idx.set_centroids(centers)
    idx.add(xb)
    idx.enable_multirow(row_cap=ROW_CAP)
    gt_D, gt_I = idx.exact_search(xq, MAX_TOPK)
    es = at.ErrorSys(idx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es.set_gt(gt_D, gt_I)
    es.sys_train(N_TRAIN, xq)
    es.set_topk(K)
    es.set_queries(N_TEST, xq, np.full(N_TRAIN + N_TEST, ACC, np.float32))
    es.set_hyper(2.0, 1.0)
    return dict(idx=idx, es=es, centers=centers, xb=xb, xq=xq, gt_D=gt_D,
                gt_I=gt_I)


@functools.lru_cache(maxsize=None)
def codec_fixture(storage: str):
    """A JAX index on the fixture's centroids and vectors with the given
    storage codec and the multi-row layout."""
    from auncel_tpu.index.ivf import IVFFlatIndex
    f = jax_fixture()
    idx = IVFFlatIndex(D, NLIST, storage=storage)
    idx.set_centroids(f["centers"])
    idx.add(f["xb"])
    idx.enable_multirow(row_cap=ROW_CAP)
    return idx


@functools.lru_cache(maxsize=None)
def pq_fixture(residual: bool = True, metric: str = "l2", M: int = 4):
    """A JAX index with PQ storage ("pqM", residual or plain) on the
    fixture's centroids and vectors, without the multi-row layout (which
    refuses PQ), and the same state carried into the port: (JAX index,
    port index), the port's on the CPU."""
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu_torch.convert import ivf_arrays_from_numpy
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    jidx = JIVF(D, NLIST, metric=metric, storage=f"pq{M}",
                pq_residual=residual)
    jidx.set_centroids(f["centers"])
    jidx.add(f["xb"])
    arrays = ivf_arrays_from_numpy(as_numpy(jidx.arrays), DEVICE)
    return jidx, IVFFlatIndex.from_state(f["centers"], arrays, metric=metric)


@functools.lru_cache(maxsize=None)
def port_state():
    """The fixture's JAX state carried into the port: (index, arrays,
    multirow, traces), all on the CPU."""
    from auncel_tpu_torch.convert import (
        ivf_arrays_from_numpy, multirow_from_numpy, traces_from_numpy)
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    f = jax_fixture()
    arrays = ivf_arrays_from_numpy(as_numpy(f["idx"].arrays), DEVICE)
    mr = multirow_from_numpy(as_numpy(f["idx"].multirow), DEVICE)
    traces = traces_from_numpy(as_numpy(f["es"].traces), DEVICE)
    index = IVFFlatIndex.from_state(f["centers"], arrays, multirow=mr)
    return index, arrays, mr, traces


@functools.lru_cache(maxsize=None)
def padded_systems():
    """(port ErrorSys, JAX ErrorSys) on the fixture's index WITHOUT the
    multi-row layout, so both run their padded engines. The JAX index is
    built on the fixture's centroids and vectors; the port's shares the
    carried padded arrays. Both load the fixture's saved profile instead of
    training again."""
    import auncel_tpu as at
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    import auncel_tpu_torch as att
    f = jax_fixture()
    jidx = JIVF(D, NLIST)
    jidx.set_centroids(f["centers"])
    jidx.add(f["xb"])
    _, arrays, _, _ = port_state()
    index = att.IVFFlatIndex.from_state(f["centers"], arrays)
    jes = at.ErrorSys(jidx, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    es = att.ErrorSys(index, train_num=N_TRAIN + N_TEST, max_topk=MAX_TOPK)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.npz")
        f["es"].save_profile(path)
        for e in (es, jes):
            e.set_gt(f["gt_D"], f["gt_I"])
            e.load_profile(path)
    return es, jes


def tnp(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def hnsw_state(jidx) -> dict:
    """A JAX HNSW index's state under its file's keys (the graph, the
    vectors or the storage codes and codec, and the reconstruct-from-
    neighbours state when set), for ``convert.hnsw_from_numpy``."""
    st = dict(kind=type(jidx).__name__, d=jidx.d, M=jidx.M,
              ef_search=jidx.ef_search, metric=jidx.metric.value,
              levels=np.asarray(jidx.levels), entry=jidx.entry_point,
              max_level=jidx.max_level,
              **{f"table{l}": np.asarray(t)
                 for l, t in enumerate(jidx.nb_tables)},
              **{f"g2u{l}": np.asarray(g) for l, g in enumerate(jidx.g2u)},
              **{k: np.asarray(v) for k, v in jidx._io_extra().items()})
    if not jidx._io_stores_codes():
        st["xb"] = np.asarray(jidx._xb)
    rfn = jidx.reconstruct_from_neighbors
    if rfn is not None:
        st["recons"] = dict(k=rfn.k, nsq=rfn.nsq, codebook=rfn.codebook,
                            codes=rfn.codes)
        if hasattr(rfn, "k_reorder"):
            st["recons"]["k_reorder"] = rfn.k_reorder
    return st


def jax_hnsw_from_port(tidx):
    """The port's HNSW index as the JAX package loads it from the port's
    ``.npz`` (the JAX package builds a graph with one XLA compile a batch
    bucket and level, about 40 s on the CPU, so most parity tests carry a
    graph the port built)."""
    import io
    from auncel_tpu.index.hnsw import HNSWIndex
    buf = io.BytesIO()
    tidx.save(buf)
    buf.seek(0)
    return HNSWIndex.load(buf)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) on float32 tensors, rounded once: the product is exact
    in float64, the sum is rounded to odd there (TwoSum's error term picks
    the direction) and then to float32, which is a single rounding."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def dot_order_dots(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The kernels' dots of decoded slots ``x [T, C, d]`` with queries ``q
    [T, d]`` (float32, d % 4 == 0), summed in their order: the partial of
    lane j is an FMA chain over the groups of 4 dims j, j + 32, ... from 0,
    and the 32 partials add as a butterfly (j with j + 16, then 8, 4, 2,
    1 apart). Both scans give every slot these bits on their float4
    routes, whatever the chunk of queries around it."""
    T, C, d = x.shape
    ng = d // 4
    xg = x.reshape(T, C, ng, 4)
    qg = q.reshape(T, 1, ng, 4).expand(T, C, ng, 4)
    part = torch.zeros((T, C, 32), dtype=torch.float32, device=x.device)
    for g in range(ng):
        a = part[:, :, g % 32]
        for i in range(4):
            a = fma32(xg[:, :, g, i], qg[:, :, g, i], a)
        part[:, :, g % 32] = a
    h = 16
    while h >= 1:
        part = part[..., :h] + part[..., h:2 * h]
        h //= 2
    return part[..., 0]


def dot_order_scores(args, x: torch.Tensor, metric) -> tuple:
    """Scores and ids of the scans' contract (K2's args, rows or lists)
    with ``dot_order_dots`` for the dots: ``x`` is ``db`` decoded to
    float32; the L2 score ``(q_sq + db_sq) - 2 dot`` rounded step by step
    and clamped at 0, dead slots at the metric's worst value and id -1."""
    db, db_sq, ids, sizes, q, q_sq, lists = args
    B, S = lists.shape
    cap = db.shape[1]
    sel = lists.long().clamp(0, db.shape[0] - 1)
    dots = dot_order_dots(x[sel].reshape(B * S, cap, -1),
                          q.repeat_interleave(S, 0)).reshape(B, S, cap)
    if metric.name == "L2":
        sc = ((q_sq[:, None, None] + db_sq[sel]) - 2.0 * dots).clamp_min(0)
    else:
        sc = dots
    live = ((lists[:, :, None] >= 0)
            & (torch.arange(cap, device=db.device)[None, None, :]
               < sizes[sel][:, :, None])
            & (ids[sel] >= 0))
    worst = float("inf") if metric.name == "L2" else float("-inf")
    return (torch.where(live, sc, worst).reshape(B, -1),
            torch.where(live, ids[sel], -1).reshape(B, -1))


def order_keys(v: torch.Tensor, ip: bool) -> torch.Tensor:
    """The merge kernel's order-preserving keys of float32 values, as int64
    holding a uint32: -0.0 as +0.0, every NaN as larger than +inf,
    inverted for IP; a smaller key is a better value."""
    u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where((u & 0x7FFFFFFF) > 0x7F800000, 0x7FC00000, u)
    u = torch.where(u == 0x80000000, 0, u)
    u = torch.where((u & 0x80000000) != 0, ~u & 0xFFFFFFFF, u | 0x80000000)
    return ~u & 0xFFFFFFFF if ip else u


# The kernel's 64-bit composite keys (key << 32) | position are unsigned;
# the model keeps each as that value less 2^63, an int64 in the same order.
_MIN64 = -(1 << 63)
_NONE = (1 << 63) - 1     # the kernel's ~0: no threshold


def radix_bound(keys: torch.Tensor, k: int) -> int:
    """The kernel's radix select over more than k unique composite keys:
    8-bit digits of the unsigned key from the top, each a histogram of the
    keys that match the digits so far, until the digit's bucket is taken
    whole. Returns the bound T (in the model's domain) with exactly the k
    smallest keys at or below it."""
    u = keys ^ _MIN64                       # the unsigned bits
    prefix, want = 0, k
    for shift in range(56, -1, -8):
        top = prefix - (1 << 64) if prefix >= 1 << 63 else prefix
        match = (u >> (shift + 8)) == (top >> (shift + 8)) if shift < 56 \
            else torch.ones_like(u, dtype=torch.bool)
        hist = torch.bincount((u[match] >> shift) & 0xFF, minlength=256)
        cum = torch.cumsum(hist, 0)
        digit = int(torch.searchsorted(cum, want))
        want -= int(cum[digit - 1]) if digit > 0 else 0
        prefix |= digit << shift
        if int(hist[digit]) == want:
            return (prefix | ((1 << shift) - 1)) - (1 << 63)
    raise AssertionError("unique keys end at a bucket of one")


def topk_merge_model(rvals, rids, scores, ids, k: int, metric, n_seg: int,
                     step: int = 2048, cap: int = 4096,
                     max_smem_k: int = 1024, head: int = 0,
                     rank_max: int = 256) -> tuple:
    """The merge kernel's selection (``csrc/topk_merge.cu``) in plain
    torch, row by row, its ``n_seg`` segments one after another (one order
    the card may run them in). Each composite key (order key, position) is
    unique. A segment starts from the bound of the row's k-th that the
    running result's first k keys give and the row's shared threshold;
    segment 0 streams the running result and the chunk's ``head`` and tail
    values (``head`` unaligned values before the 16-byte vectors, 0 to 3
    on the card) as one sequence, every segment an equal share of the
    chunk's vectors, in steps of ``step`` positions, keeping the keys at
    or below its bound in
    a buffer of ``cap`` (``3k + step`` above ``max_smem_k``); a step that
    leaves more than ``cap - step`` keys (above ``max_smem_k``: 2k) selects
    k, tightens the bound and publishes it to the row's threshold, which
    every step reads back. With several segments, each then puts its keys
    at or below the row's threshold into the row's pool and its j-th best
    key (j = ceil(k / n_seg)) into the row's maximum; the last streams the
    pool under the row's threshold (and that maximum, once k / j segments
    published one) the same way. A stream's last keys are cut to the best
    k, by the select when there are more than ``rank_max`` (and k), else
    by their ranks. The winners are ranked
    by key, their values and ids gathered by position (a metric-worst
    value with id -1) and slots past the row filled with the worst value
    and -1."""
    ip = metric.name == "IP"
    worst = float("-inf") if ip else float("inf")
    vals = torch.cat([rvals, scores], dim=-1)
    all_ids = torch.cat([rids, ids], dim=-1)
    B, total = vals.shape
    kr, n = rvals.shape[-1], scores.shape[-1]
    trig = cap - step if k <= max_smem_k else 2 * k
    pos = torch.arange(total, dtype=torch.int64)
    comp = ((order_keys(vals, ip) << 32) | pos) ^ _MIN64
    h = min(head, n)
    nv = (n - h) // 4
    per = -(-nv // n_seg)
    jth = -(-k // n_seg)
    out_v = torch.full((B, k), worst, dtype=torch.float32)
    out_i = torch.full((B, k), -1, dtype=torch.int32)
    for b in range(B):
        row = comp[b]
        shared = {"thr": _NONE, "tmax": _MIN64, "contrib": 0}

        def stream(keys_steps, T, publish):
            buf = torch.empty(0, dtype=torch.int64)
            for sk in keys_steps:
                buf = torch.cat([buf, sk[sk <= T]])
                if buf.numel() > trig:
                    t = radix_bound(buf, k)
                    buf = buf[buf <= t]
                    assert buf.numel() == k
                    T = min(T, t)
                    if publish:
                        shared["thr"] = min(shared["thr"], T)
                if publish:
                    T = min(T, shared["thr"])
            if buf.numel() > max(k, rank_max):
                t = radix_bound(buf, k)
                buf = buf[buf <= t]
                T = min(T, t)
            return torch.sort(buf).values[:k], T

        pool = []
        for seg in range(n_seg):
            T = int(row[:k].max()) if kr >= k else _NONE
            T = min(T, shared["thr"])
            steps = []
            if seg == 0:  # running, head and tail: one sequence
                vpos = torch.cat([torch.arange(kr + h),
                                  torch.arange(kr + h + 4 * nv, total)])
                steps += [vpos[q:q + step]
                          for q in range(0, vpos.numel(), step)]
            v_lo, v_hi = min(nv, seg * per), min(nv, (seg + 1) * per)
            steps += [torch.arange(kr + h + 4 * v,
                                   kr + h + 4 * min(v_hi, v + step // 4))
                      for v in range(v_lo, v_hi, step // 4)]
            buf, T = stream((row[ix] for ix in steps), T, n_seg > 1)
            if n_seg == 1:
                break
            pool.append(buf[buf <= min(T, shared["thr"])])
            if buf.numel() >= jth:  # buf is sorted
                shared["tmax"] = max(shared["tmax"], int(buf[jth - 1]))
                shared["contrib"] += 1
        if n_seg > 1:
            pool = torch.cat(pool)
            T = shared["thr"]
            if shared["contrib"] * jth >= k:
                T = min(T, shared["tmax"])
            buf, _ = stream((pool[i:i + step]
                             for i in range(0, pool.numel(), step)), T, False)
        win = (buf ^ _MIN64) & 0xFFFFFFFF
        v = vals[b, win]
        out_v[b, :win.numel()] = v
        out_i[b, :win.numel()] = torch.where(v == worst, -1, all_ids[b, win])
    return out_v, out_i


def _tensors(obj, seen=None) -> dict:
    """Every tensor reachable from obj's attributes: data_ptr -> tensor."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return {}
    seen.add(id(obj))
    if torch.is_tensor(obj):
        return {obj.data_ptr(): obj} if obj.numel() else {}
    out = {}
    if isinstance(obj, (list, tuple)):
        items = obj
    elif isinstance(obj, dict):
        items = obj.values()
    elif hasattr(obj, "__dict__"):
        items = vars(obj).values()
    else:
        return {}
    for v in items:
        out.update(_tensors(v, seen))
    return out


def check_clone(device):
    """Mutating one copy (add, then reset) leaves the other's search as it
    was, and the copies share no tensor."""
    from auncel_tpu_torch.index.io import clone_index
    from auncel_tpu_torch.index.ivf import IVFFlatIndex
    rng = np.random.RandomState(0)
    x = rng.randn(3000, 16).astype(np.float32)
    idx = IVFFlatIndex(16, 16, device=device, storage="sq8")
    idx.train(x)
    idx.add(x)
    idx.enable_multirow(64)
    want = idx.search(x[:20], 5, nprobe=4)
    copy = clone_index(idx)
    assert not set(_tensors(idx)) & set(_tensors(copy))
    assert copy.device == idx.device
    for a, b in zip(copy.search(x[:20], 5, nprobe=4), want):
        np.testing.assert_array_equal(a, b)
    copy.add(x[:500] + 0.01)
    assert copy.ntotal == 3500 and idx.ntotal == 3000
    for a, b in zip(idx.search(x[:20], 5, nprobe=4), want):
        np.testing.assert_array_equal(a, b)
    copy.reset()
    assert copy.ntotal == 0
    for a, b in zip(idx.search(x[:20], 5, nprobe=4), want):
        np.testing.assert_array_equal(a, b)
