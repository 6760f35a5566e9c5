from hex_gym_env_tpu_torch.core.topology import HexTopology, get_topology
from hex_gym_env_tpu_torch.core.state import HexState, Winner
from hex_gym_env_tpu_torch.core import env

__all__ = ["HexTopology", "get_topology", "HexState", "Winner", "env"]
