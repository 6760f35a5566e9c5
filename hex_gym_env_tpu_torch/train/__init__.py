from hex_gym_env_tpu_torch.train.bank import OpponentBank, init_bank, sample_opponents, replace_member
from hex_gym_env_tpu_torch.train.gae import compute_gae
from hex_gym_env_tpu_torch.train.rollout import SelfplayRunner, RolloutCarry, Transition
from hex_gym_env_tpu_torch.train.evaluate import Evaluator, EvalResult
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO, TrainState, TrainMetrics
from hex_gym_env_tpu_torch.train.trainer import Trainer
from hex_gym_env_tpu_torch.train import ppo

__all__ = [
    "OpponentBank", "init_bank", "sample_opponents", "replace_member",
    "compute_gae", "SelfplayRunner", "RolloutCarry", "Transition",
    "Evaluator", "EvalResult", "SelfplayPPO", "TrainState", "TrainMetrics",
    "Trainer", "ppo",
]
