"""ErrorSys over IMI product cells (or k-means lists) in both packages,
on the CPU, at more cells than the tier-1 tests use: the JAX package
(auncel_tpu) and its PyTorch port (auncel_tpu_torch) on the same
centroids, vectors, ground truth and calibration, then the held-out
window; prints each package's calibrated multipler and std_m, the
window's worst and mean recall@10 and mean n_scanned, and whether ids,
my_nprobe and n_scanned agree. Where they part, the stages before the
window say where values first differ: the ground truth (exact_search),
the coarse distances behind phi (coarse_rank) and a fixed-nprobe scan's
distances, each as the largest relative difference and the number of
queries whose ids differ.

    JAX_PLATFORMS=cpu python scripts/torch_imi_parity.py --cells 1024 \
        --data centred --layout multirow
    JAX_PLATFORMS=cpu python scripts/torch_imi_parity.py --coarse kmeans \
        --cells 256 --data clustered --layout padded

``--coarse kmeans`` trains the lists with the JAX package's k-means (the
flagship's quantizer) instead of IMI product cells.

``--data centred`` draws 64 clusters around N(0, 1) centres (distances of
the order of the norms); ``clustered`` is make_clustered_dataset's corpus,
whose distances are small against the norms, so the two packages' fp32
distances differ by more than the 1e-5 the profile matches by. About 2-7
minutes a run (the JAX package's scans run in interpret mode).
"""

import argparse
import time

import numpy as np
import torch


def data(kind: str, nb: int, nq: int, d: int):
    if kind == "clustered":
        from auncel_tpu.data.synthetic import make_clustered_dataset
        ds = make_clustered_dataset(nb=nb, nq=nq, d=d, n_clusters=64,
                                    cluster_std=0.22, query_mode="perturb",
                                    seed=42)
        return ds.xb, ds.xq
    rng = np.random.RandomState(5)
    c = rng.randn(64, d).astype(np.float32)
    xb = c[rng.randint(0, 64, nb)] + 0.5 * rng.randn(nb, d)
    xq = c[rng.randint(0, 64, nq)] + 0.6 * rng.randn(nq, d)
    return xb.astype(np.float32), xq.astype(np.float32)


def main() -> None:
    import auncel_tpu as at
    from auncel_tpu.index.imi import train_imi_centroids
    from auncel_tpu.index.ivf import IVFFlatIndex as JIVF
    from auncel_tpu.types import Metric as JMetric
    import auncel_tpu_torch as att
    from auncel_tpu_torch import convert
    from auncel_tpu_torch.autotune import recall_counts

    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=1024)
    ap.add_argument("--data", choices=("centred", "clustered"),
                    default="centred")
    ap.add_argument("--layout", choices=("padded", "multirow"),
                    default="multirow")
    ap.add_argument("--nb", type=int, default=30_000)
    ap.add_argument("--nq", type=int, default=400)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--coarse", choices=("imi", "kmeans"), default="imi")
    args = ap.parse_args()
    torch.set_num_threads(4)
    t0 = time.time()
    xb, xq = data(args.data, args.nb, args.nq, args.d)
    half = args.nq // 2
    if args.coarse == "imi":
        cents = train_imi_centroids(xb[:20_000], args.cells, JMetric.L2)
        jidx = JIVF(args.d, args.cells, coarse="imi")
        idx = convert.imi_from_numpy(cents, device="cpu")
    else:
        from auncel_tpu.ops.kmeans import kmeans
        cents = kmeans(xb[:20_000], args.cells).centroids
        jidx = JIVF(args.d, args.cells)
        idx = att.IVFFlatIndex(args.d, args.cells, device="cpu")
        idx.set_centroids(cents)
    jidx.set_centroids(cents)
    jidx.add(xb)
    idx.add(xb)
    if args.layout == "multirow":
        jidx.enable_multirow()
        idx.enable_multirow()
    gt_D, gt_I = jidx.exact_search(xq, 100)
    pD, pI = idx.exact_search(xq, 100)
    print(f"{args.cells} {args.coarse} cells, {args.data} data, "
          f"{args.layout}: {stage('exact_search (ground truth)', (pD, pI), (gt_D, gt_I))}",
          flush=True)
    print(terms(jidx, idx, xq), flush=True)
    print(stage("coarse_rank (phi)", idx.coarse_rank_np(xq),
                jidx.coarse_rank_np(xq)), flush=True)
    print(stage("fixed scan at nprobe 16", idx.search(xq, 100, nprobe=16),
                jidx.search(xq, 100, nprobe=16)), flush=True)
    out = []
    for name, cls, index in (("jax", at.ErrorSys, jidx),
                             ("port", att.ErrorSys, idx)):
        es = cls(index, train_num=args.nq, max_topk=100)
        es.set_gt(gt_D, gt_I)
        es.sys_train(half, xq)
        es.set_topk(10)
        es.set_queries(half, xq, np.full(args.nq, 0.9, np.float32))
        es.calibrate(0, half, target_bound=0.9)
        D, I = es.search(half, half)
        cnt = recall_counts(D, gt_D[half:], 10, att.Metric.L2)
        ns = es.n_scanned[half:].copy()
        out.append((I, ns, np.asarray(es.my_nprobe)[half:].copy()))
        print(f"{name}: multipler {es.multipler:.6g} std_m {es.std_m}; "
              f"recall@10 worst {cnt.min() / 10:.3f} mean "
              f"{cnt.mean() / 10:.4f}; mean n_scanned {ns.mean():.2f} "
              f"({time.time() - t0:.0f} s)", flush=True)
    print(f"ids equal {np.array_equal(out[0][0], out[1][0])} (queries "
          f"differing {int((out[0][0] != out[1][0]).any(1).sum())}), "
          f"my_nprobe equal {np.array_equal(out[0][2], out[1][2])}, "
          f"n_scanned equal {np.array_equal(out[0][1], out[1][1])} "
          f"(queries differing {int((out[0][1] != out[1][1]).sum())})")


def terms(jidx, idx, xq: np.ndarray, n_q: int = 50) -> str:
    """Each term of the L2 scores q_sq + db_sq - 2 dot in both packages:
    how many query norms and stored norms differ (and by how much), and
    the fp32 dots of the first ``n_q`` queries with every stored vector,
    each package's against the same dots in float64."""
    import jax.numpy as jnp
    ja, pa = jidx.arrays, idx.arrays
    jq = np.asarray(jnp.sum(jnp.square(jnp.asarray(xq)), -1))
    pq = (torch.from_numpy(xq) ** 2).sum(-1).numpy()
    live = np.asarray(ja.vec_ids) >= 0
    same = np.array_equal(np.asarray(ja.vec_ids), pa.vec_ids.numpy())
    jdb, pdb = np.asarray(ja.db_sq)[live], pa.db_sq.numpy()[live]
    db = np.asarray(ja.db)[live]
    jd = np.asarray(jnp.einsum("nd,bd->bn", jnp.asarray(db),
                               jnp.asarray(xq[:n_q]),
                               precision="highest"))
    pd = (torch.from_numpy(xq[:n_q]) @ torch.from_numpy(db).T).numpy()
    exact = xq[:n_q].astype(np.float64) @ db.astype(np.float64).T

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    return (f"terms: query norms differ in {int((jq != pq).sum())} of "
            f"{jq.size} (max rel {rel(pq, jq):.3g}); same packing "
            f"{same}, stored norms differ in {int((jdb != pdb).sum())} of "
            f"{jdb.size} (max rel {rel(pdb, jdb):.3g}); dots of {n_q} "
            f"queries differ in {int((jd != pd).sum())} of {jd.size}, "
            f"max abs {float(np.abs(jd - pd).max()):.3g}; against float64 "
            f"max abs err: jax {float(np.abs(jd - exact).max()):.3g}, port "
            f"{float(np.abs(pd - exact).max()):.3g}; largest |dot| "
            f"{float(np.abs(exact).max()):.4g}")


def stage(name: str, port, ref) -> str:
    """The largest relative difference of two (values, ids) results and
    the number of queries whose ids differ."""
    pv, pi = (np.asarray(a) for a in port)
    rv, ri = (np.asarray(a) for a in ref)
    fin = np.isfinite(rv) & np.isfinite(pv)
    r = np.where(fin, np.abs(pv - rv) / np.maximum(np.abs(rv), 1e-6), 0.0)
    w = np.unravel_index(np.argmax(r), r.shape)
    return (f"{name}: values differ by {float(r[w]):.3g} relative at most "
            f"(query {w[0]}, rank {w[1]}: jax {rv[w]!r}, port {pv[w]!r}), "
            f"ids differ in {int((pi != ri).any(1).sum())} of {len(ri)} "
            "queries")


if __name__ == "__main__":
    main()
