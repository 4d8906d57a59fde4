"""Distribution over torch.distributed: the (dp, fsdp, tp, sp) mesh
(`mesh.py`), the host collectives (`collectives.py`) and the rules that
shard the frozen base with FSDP2 (`partitioning.py`).  Counterpart of
qflux_tpu/parallel/."""

from qflux_tpu_torch.parallel.mesh import MeshConfig, build_mesh, local_batch_size
from qflux_tpu_torch.parallel.partitioning import PartitionRules, shard_base

__all__ = ["MeshConfig", "build_mesh", "local_batch_size", "PartitionRules", "shard_base"]
