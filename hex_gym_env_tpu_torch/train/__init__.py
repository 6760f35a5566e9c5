from hex_gym_env_tpu_torch.train.bank import OpponentBank, init_bank, sample_opponents, replace_member
from hex_gym_env_tpu_torch.train.rollout import SelfplayRunner, RolloutCarry, Transition

__all__ = [
    "OpponentBank", "init_bank", "sample_opponents", "replace_member",
    "SelfplayRunner", "RolloutCarry", "Transition",
]
