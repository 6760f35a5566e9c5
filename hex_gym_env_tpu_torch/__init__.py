"""hex_gym_env_tpu_torch — the Hex selfplay-RL framework in PyTorch on CUDA.

The port of the JAX package ``hex_gym_env_tpu`` to PyTorch, with the TPU
kernels of its selfplay rollout, its learner (GAE, the fused PPO sweep) and
its env-throughput benchmark (the random-legal rollout) rewritten by hand in
CUDA C++ for Hopper (``csrc/``).  Module paths mirror
the JAX package.  Every kernel has a plain PyTorch twin beside it: a CUDA
tensor goes to the kernel, a CPU tensor to the twin.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, and raise where no CUDA device exists.
"""

__version__ = "0.1.0"

from hex_gym_env_tpu_torch.core.topology import HexTopology
from hex_gym_env_tpu_torch.core.state import HexState, Winner
from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.compat.gym_env import random_policy

__all__ = ["HexTopology", "HexState", "Winner", "hex_env", "random_policy", "__version__"]
