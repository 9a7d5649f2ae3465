"""Multi-device execution of the port: head-sharded tensor parallelism and
sequence-parallel prefill on ``torch.distributed`` (one process a rank).
Port of ``kvzip_tpu/parallel``."""

from kvzip_tpu_torch.parallel.mesh import (cache_sharding, make_mesh, param_sharding,
                                           shard_cache, shard_params)
from kvzip_tpu_torch.parallel.ring_prefill import reshard_to_cache, ring_prefill

__all__ = ["make_mesh", "param_sharding", "cache_sharding", "shard_params",
           "shard_cache", "ring_prefill", "reshard_to_cache"]
