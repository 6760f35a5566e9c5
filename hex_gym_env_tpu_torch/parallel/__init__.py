"""Data-parallel training on ``torch.distributed``: the bootstrap
(``bootstrap.init_distributed``), the layout of ranks and devices
(``mesh``), and the data-parallel learner with its sharded eval
(``distributed.DistributedSelfplayPPO``)."""

from hex_gym_env_tpu_torch.parallel.bootstrap import init_distributed, is_main_process
from hex_gym_env_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    gather_batch_tree,
    make_mesh,
    replicate_tree,
    shard_batch_tree,
)
from hex_gym_env_tpu_torch.parallel.distributed import DistributedSelfplayPPO

__all__ = [
    "DATA_AXIS", "Mesh", "gather_batch_tree", "make_mesh", "replicate_tree",
    "shard_batch_tree", "init_distributed", "is_main_process", "DistributedSelfplayPPO",
]
