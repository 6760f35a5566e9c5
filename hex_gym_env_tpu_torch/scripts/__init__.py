"""The package's command-line entry points, run as
``python -m hex_gym_env_tpu_torch.scripts.<name>``."""
