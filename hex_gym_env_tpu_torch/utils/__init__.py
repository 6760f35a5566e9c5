from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig

__all__ = ["PPOConfig", "SelfplayConfig", "TrainConfig"]
