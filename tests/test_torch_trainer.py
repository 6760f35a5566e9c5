"""The port's ``Trainer`` on the CPU: logging, eval/checkpoint cadence,
resume on an exactly equal trajectory (counterparts of the JAX package's
``tests/test_trainer.py``), and the optax Adam state carried across by
``models/convert.py``."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hex_gym_env_tpu.models import MlpPolicy as JaxMlpPolicy
from hex_gym_env_tpu.train import ppo as jppo
from hex_gym_env_tpu.utils.config import PPOConfig as JaxPPOConfig
from tests.test_torch_ppo import _batch

from hex_gym_env_tpu_torch.models.convert import flax_state_dict, optax_adam_to_torch
from hex_gym_env_tpu_torch.train.trainer import Trainer
from hex_gym_env_tpu_torch.utils import checkpoint as ckpt_lib
from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig
from hex_gym_env_tpu_torch.utils.metrics import MetricsLogger


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel worker processes, and
    small CPU ops gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _cfg(tmp_path, total=4 * 16 * 8, ckpt_every=10_000_000, name="trainer_test"):
    return TrainConfig(
        ppo=PPOConfig(n_steps=8, minibatch_size=32, n_epochs=2),
        selfplay=SelfplayConfig(board_size=4, n_envs=16, buffer_size=2, eval_freq=256,
                                n_eval_episodes=2),
        total_timesteps=total,
        model_name=name,
        checkpoint_every=ckpt_every,
        log_dir=str(tmp_path / "log"),
        model_dir=str(tmp_path / "models"),
    )


def _records(cfg):
    path = os.path.join(cfg.log_dir, cfg.model_name, "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def _eval_steps(cfg):
    return [r["step"] for r in _records(cfg) if "eval/mean_reward" in r]


def _same_state(a, b):
    assert a.iteration == b.iteration and a.eval_accum == b.eval_accum
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k]), k
        assert torch.equal(a.bank.params[k], b.bank.params[k]), k
    assert a.opt_state.count == b.opt_state.count
    assert torch.equal(a.bank.scores, b.bank.scores)
    assert torch.equal(a.carry.env.labels, b.carry.env.labels)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_fit_logs_every_iteration_and_evals_on_cadence(tmp_path):
    cfg = _cfg(tmp_path)  # 4 iterations of 128 transitions
    trainer = Trainer(cfg, device="cpu")
    state = trainer.fit()
    assert trainer.algo.timesteps(state) == cfg.total_timesteps
    train_recs = [r for r in _records(cfg) if "rollout/ep_rew_mean" in r]
    assert [r["step"] for r in train_recs] == [128, 256, 384, 512]
    assert _eval_steps(cfg) == [256, 512]  # eval_freq 256
    for r in train_recs:
        assert np.isfinite(r["train/policy_loss"]) and r["perf/steps_per_s"] > 0


def test_fit_fused_logs_every_iteration_with_the_same_cadence_and_result(tmp_path):
    total = 6 * 16 * 8
    states = {}
    for name, k in (("cad_unfused", 1), ("cad_fused", 3)):
        cfg = dataclasses.replace(_cfg(tmp_path, total=total, name=name), iters_per_dispatch=k)
        states[name] = Trainer(cfg, device="cpu").fit()
        train_recs = [r for r in _records(cfg) if "rollout/ep_rew_mean" in r]
        assert [r["step"] for r in train_recs] == [128 * i for i in range(1, 7)]
        assert _eval_steps(cfg) == [256, 512, 768]
    # toggling iters_per_dispatch changes neither the curriculum nor the stream
    _same_state(states["cad_unfused"], states["cad_fused"])


def test_fit_checkpoints_and_resumes_the_exact_trajectory(tmp_path):
    straight = Trainer(_cfg(tmp_path, total=3 * 128, name="straight"), device="cpu").fit()

    cfg = _cfg(tmp_path, total=2 * 128, ckpt_every=128)
    trainer = Trainer(cfg, device="cpu")
    trainer.fit()
    assert trainer._ckpt_mgr().latest_step() == 256

    cfg2 = dataclasses.replace(cfg, total_timesteps=3 * 128)
    trainer2 = Trainer(cfg2, logger=MetricsLogger(cfg2.log_dir, "resumed"), device="cpu")
    state = trainer2.resume()
    assert trainer2.algo.timesteps(state) == 256
    state = trainer2.fit(state)
    assert trainer2.algo.timesteps(state) == 384
    _same_state(state, straight)


def test_timesteps_counter_supports_past_int32(tmp_path):
    trainer = Trainer(_cfg(tmp_path), device="cpu")
    state = dataclasses.replace(trainer.init_state(), iteration=40_000_000)
    got = trainer.algo.timesteps(state)
    assert got == 40_000_000 * 128 and got > 2**31


def test_checkpoint_manager_keeps_the_newest_and_params_round_trip(tmp_path):
    trainer = Trainer(_cfg(tmp_path), device="cpu")
    state = trainer.init_state()
    mgr = ckpt_lib.CheckpointManager(str(tmp_path / "ck"), keep=2)
    for step in (10, 20, 30):
        mgr.save(step, dataclasses.replace(state, iteration=step))
    assert mgr.latest_step() == 30
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_20.pt", "step_30.pt"]
    assert mgr.restore(step=20).iteration == 20
    path = str(tmp_path / "best" / "p.pt")
    ckpt_lib.save_params(path, state.params)
    loaded = ckpt_lib.load_params(path)
    assert all(torch.equal(loaded[k], state.params[k]) for k in state.params)


def test_optax_adam_state_round_trip():
    """JAX's optimizer state after two updates, carried into the port: the
    count and both moments equal the optax leaves exactly (kernels
    transposed to nn.Linear's layout)."""
    A, N = 25, 5
    model = JaxMlpPolicy(n_actions=A)
    variables = model.init(jax.random.key(0), jnp.zeros((1, N, N), jnp.float32))
    cfg = JaxPPOConfig(minibatch_size=64, n_epochs=1)
    optimizer = jppo.make_optimizer(cfg)
    opt = optimizer.init(variables["params"])
    update = jax.jit(jppo.make_update_fn(model, cfg, optimizer))
    for i in range(2):
        variables, opt, _ = update(variables, opt, _batch(128, seed=i), jax.random.key(i))
    opt_np = jax.tree.map(np.asarray, opt)
    got = optax_adam_to_torch(opt_np)
    assert got.count == int(opt_np[1][0].count) == 4
    for field in ("mu", "nu"):
        want = flax_state_dict(getattr(opt_np[1][0], field))
        tree = getattr(opt_np[1][0], field)
        for k, v in want.items():
            assert torch.equal(getattr(got, field)[k], v), k
        np.testing.assert_array_equal(getattr(got, field)["pi.0.weight"].numpy().T,
                                      tree["pi_0"]["kernel"])
