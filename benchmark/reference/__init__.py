"""The benchmark's plain reference: Hex rules with win detection, the
MLP-default and CNN forwards, GAE, the PPO loss and the optax-style clip and
Adam step, and the opponent-pool update rule.

Plain PyTorch, written from the rules and the published model definitions.
It imports nothing of the measured package or of JAX, and takes nothing the
program made: the harness hands it the same inputs it hands the program
(weights, boards, random words, minibatch order) and the program's outputs
only to judge them.
"""

from benchmark.reference import env, models, pool, ppo

__all__ = ["env", "models", "pool", "ppo"]
