from hex_gym_env_tpu_torch.compat.gym_env import HexEnv, HexEnvV0, register_envs
from hex_gym_env_tpu_torch.compat.selfplay_wrapper import (
    BaseRandomPolicy,
    OpponentPolicy,
    TorchOpponentPolicy,
    selfplay_wrapper,
)

__all__ = [
    "HexEnv", "HexEnvV0", "register_envs",
    "BaseRandomPolicy", "OpponentPolicy", "TorchOpponentPolicy", "selfplay_wrapper",
]
