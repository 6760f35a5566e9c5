"""Learning-curve regression of the port (``tests/test_learning_curve.py``
ported).

A fixed-seed, small-budget run on the CPU must still LEARN against a frozen
all-random pool (zero params play exactly the reference's
``BaseRandomPolicy``): the mean episode reward climbs from ~0 to clearly
positive within 24 PPO iterations.  Every iteration goes through the twins
of the whole-rollout kernel K4, GAE K5 and the PPO sweep K6, so a sign flip
in any of them, in the rewards or in the masking fails here.
"""

import numpy as np
import pytest
import torch

from hex_gym_env_tpu_torch.ops import ppo_kernel
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO
from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel worker processes, and
    small CPU ops gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def test_learning_curve_regression():
    cfg = TrainConfig(
        ppo=PPOConfig(n_steps=32, minibatch_size=512, n_epochs=4),
        selfplay=SelfplayConfig(board_size=4, n_envs=64, buffer_size=4),
    )
    algo = SelfplayPPO(cfg, device="cpu")
    # the path under test: K4, K5 and K6 dispatch (their twins on the CPU)
    assert algo.runner.fused_pol is not None and algo.runner.fused_pol.impl == "auto"
    assert cfg.ppo.gae_impl == "auto"
    assert algo.update_fn.__qualname__.startswith(ppo_kernel.make_kernel_update_fn.__name__)
    state = algo.init_state(0)

    rews = []
    for _ in range(24):  # no eval_step: the pool stays all-zeros == random
        state, m = algo.train_step(state)
        rews.append(float(m.mean_episode_reward))

    rews = np.asarray(rews)
    assert np.isfinite(rews).all()
    early = rews[:3].mean()
    late = rews[-5:].mean()
    assert abs(early) < 0.25, f"unexpected early reward {early}"
    assert late > 0.15, f"no learning: late mean reward {late} (curve {rews})"
    assert late - early > 0.2, f"no improvement: {early} -> {late}"
