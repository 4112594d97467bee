from auncel_tpu_torch.parallel.sharded import ShardedIVF, make_mesh, split_round_robin
from auncel_tpu_torch.parallel.kmeans_dp import dp_kmeans, make_dp_kmeans_step

__all__ = ["ShardedIVF", "make_mesh", "split_round_robin",
           "dp_kmeans", "make_dp_kmeans_step"]
