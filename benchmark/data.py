"""The corpus and the queries, made on the device from the run's seed.

A torch copy of the clustered Gaussian mixture that
``auncel_tpu_torch/data/synthetic.py::make_clustered_dataset`` draws with
``query_mode="perturb"`` (the generator of the synthDeep10M corpus): cluster
centres uniform in [0, 1)^d, points at ``cluster_std`` around a centre,
everything scaled by ``scale``; a query is a corpus point perturbed by
``pert_easy`` (the first half) or ``pert_hard`` (the hard fraction) times
the cluster spread, the two kinds shuffled together. The draws come from
one ``torch.Generator`` on the device in a few large calls, so the same
seed gives the same tensors on the same device, and nothing goes through
the host. It is not bitwise the numpy generator's corpus: the benchmark
needs the shape and the seed, not that corpus.
"""

import torch

# rows drawn per call: bounds the transient of the gathered centres
ROW_BLOCK = 1 << 21


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def make_corpus(spec: dict, gen: torch.Generator, device) -> torch.Tensor:
    """[nb, d] float32 on ``device``: ``spec`` is a configuration's
    ``corpus`` entry."""
    nb, d = int(spec["nb"]), int(spec["d"])
    centers = torch.rand(int(spec["n_clusters"]), d, generator=gen,
                         device=device)
    which = torch.randint(0, centers.shape[0], (nb,), generator=gen,
                          device=device)
    xb = torch.randn(nb, d, generator=gen, device=device)
    std, scale = float(spec["cluster_std"]), float(spec["scale"])
    for i in range(0, nb, ROW_BLOCK):
        blk = xb[i:i + ROW_BLOCK]
        blk.mul_(std).add_(centers[which[i:i + ROW_BLOCK]]).mul_(scale)
    return xb


def make_queries(xb: torch.Tensor, spec: dict, n: int,
                 gen: torch.Generator) -> torch.Tensor:
    """[n, d] float32 queries: perturbed corpus points, ``hard_frac`` of
    them perturbed by ``pert_hard`` and the rest by ``pert_easy``, in an
    order drawn from ``gen``."""
    nb, d = xb.shape
    n_hard = int(n * float(spec["hard_frac"]))
    spread = float(spec["cluster_std"]) * float(spec["scale"])
    pert = torch.full((n, 1), float(spec["pert_easy"]), device=xb.device)
    pert[n - n_hard:] = float(spec["pert_hard"])
    base = torch.randint(0, nb, (n,), generator=gen, device=xb.device)
    noise = torch.randn(n, d, generator=gen, device=xb.device)
    q = xb[base] + noise * (pert * spread)
    order = torch.randperm(n, generator=gen, device=xb.device)
    return q[order].contiguous()


def make_inputs(spec: dict, seed: int, device, n_setup: int, n_pool: int):
    """(corpus, set-up queries, pool) of one run. The corpus and the
    set-up queries (profile, calibration) come from the configuration's
    own ``seed``: they are the deployment's data set and its set-up, the
    same in every run. The pool the window serves comes from the run's
    ``seed``. A run and the control make the same tensors from a seed."""
    gen = generator(spec["seed"], device)
    xb = make_corpus(spec, gen, device)
    q_setup = make_queries(xb, spec, n_setup, gen)
    return xb, q_setup, make_queries(xb, spec, n_pool,
                                     generator(seed, device))
