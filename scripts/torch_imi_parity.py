"""ErrorSys over IMI product cells in both packages, on the CPU, at more
cells than the tier-1 tests use: the JAX package (auncel_tpu) and its
PyTorch port (auncel_tpu_torch) on the same product centroids, vectors,
ground truth and calibration, then the held-out window; prints each
package's calibrated multipler and std_m, the window's worst and mean
recall@10 and mean n_scanned, and whether ids and n_scanned agree.

    JAX_PLATFORMS=cpu python scripts/torch_imi_parity.py --cells 1024 \
        --data centred --layout multirow

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
    args = ap.parse_args()
    torch.set_num_threads(4)
    t0 = time.time()
    xb, xq = data(args.data, args.nb, args.nq, args.d)
    half = args.nq // 2
    cents = train_imi_centroids(xb[:20_000], args.cells, JMetric.L2)
    jidx = JIVF(args.d, args.cells, coarse="imi")
    jidx.set_centroids(cents)
    jidx.add(xb)
    idx = convert.imi_from_numpy(cents, device="cpu")
    idx.add(xb)
    if args.layout == "multirow":
        jidx.enable_multirow()
        idx.enable_multirow()
    gt_D, gt_I = jidx.exact_search(xq, 100)
    pD, _ = idx.exact_search(xq, 100)
    rel = float(np.max(np.abs(pD - gt_D) / np.maximum(np.abs(gt_D), 1e-6)))
    print(f"{args.cells} cells, {args.data} data, {args.layout}: ground "
          f"truth distances differ by {rel:.3g} relative at most", flush=True)
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
        out.append((I, ns))
        print(f"{name}: multipler {es.multipler:.6g} std_m {es.std_m}; "
              f"recall@10 worst {cnt.min() / 10:.3f} mean "
              f"{cnt.mean() / 10:.4f}; mean n_scanned {ns.mean():.2f} "
              f"({time.time() - t0:.0f} s)", flush=True)
    print(f"ids equal {np.array_equal(out[0][0], out[1][0])}, n_scanned "
          f"equal {np.array_equal(out[0][1], out[1][1])}")


if __name__ == "__main__":
    main()
