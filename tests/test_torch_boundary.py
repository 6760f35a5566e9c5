"""The port's boundary: it imports no JAX and nothing of the JAX package,
it never falls back from the card to the CPU quietly, and a pinned kernel
refuses a CPU tensor."""

import os
import re
import subprocess
import sys

import pytest
import torch

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core.topology import get_topology
from hex_gym_env_tpu_torch.models import make_policy
from hex_gym_env_tpu_torch.ops import policy_kernel, rollout_kernel, step_kernel
from hex_gym_env_tpu_torch.train.bank import init_bank
from hex_gym_env_tpu_torch.train.rollout import SelfplayRunner
from hex_gym_env_tpu_torch.utils.config import SelfplayConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "hex_gym_env_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax"}


def test_package_imports_no_jax():
    code = (
        "import sys, hex_gym_env_tpu_torch, hex_gym_env_tpu_torch.train, "
        "hex_gym_env_tpu_torch.ops.rollout_kernel, hex_gym_env_tpu_torch.ops.step_kernel, "
        "hex_gym_env_tpu_torch.ops.gae_kernel, hex_gym_env_tpu_torch.ops.ppo_kernel, "
        "hex_gym_env_tpu_torch.train.trainer, hex_gym_env_tpu_torch.utils.checkpoint, "
        "hex_gym_env_tpu_torch.utils.metrics, hex_gym_env_tpu_torch.parallel.bootstrap, "
        "hex_gym_env_tpu_torch.models.convert, hex_gym_env_tpu_torch.experiments, "
        "hex_gym_env_tpu_torch.bench, hex_gym_env_tpu_torch.core.random_board, "
        "hex_gym_env_tpu_torch.ops.connectivity, hex_gym_env_tpu_torch.utils.roofline, "
        "hex_gym_env_tpu_torch.utils.profiling, hex_gym_env_tpu_torch.models.cnn, "
        "hex_gym_env_tpu_torch.models.loading, hex_gym_env_tpu_torch.models.sb3_import, "
        "hex_gym_env_tpu_torch.compat, hex_gym_env_tpu_torch.compat.selfplay_wrapper, "
        "hex_gym_env_tpu_torch.native.engine, hex_gym_env_tpu_torch.interactive.interactive, "
        "hex_gym_env_tpu_torch.utils.settings, hex_gym_env_tpu_torch.scripts.match, "
        "hex_gym_env_tpu_torch.scripts.tournament, hex_gym_env_tpu_torch.parallel, "
        "hex_gym_env_tpu_torch.parallel.mesh, hex_gym_env_tpu_torch.parallel.distributed, "
        "hex_gym_env_tpu_torch.scripts.train, hex_gym_env_tpu_torch.scripts.export_agent, "
        "hex_gym_env_tpu_torch.scripts.train_legacy, hex_gym_env_tpu_torch.scripts.play_cli, "
        "hex_gym_env_tpu_torch.scripts.play_gui, hex_gym_env_tpu_torch.__graft_entry__, "
        "hex_gym_env_tpu_torch.scripts.selftest, hex_gym_env_tpu_torch.scripts.verify_train, "
        "hex_gym_env_tpu_torch.scripts.breakdown_bench, "
        "hex_gym_env_tpu_torch.scripts.scaling_bench\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r "
        "or m == 'hex_gym_env_tpu' or m.startswith('hex_gym_env_tpu.'))\n"
        "assert not bad, bad\n" % (FORBIDDEN,)
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


def test_no_source_names_the_jax_package():
    pattern = re.compile(r"\bhex_gym_env_tpu\.|^\s*(import|from)\s+(jax|flax|optax|orbax)\b", re.M)
    offenders = []
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                with open(os.path.join(root, name)) as f:
                    if pattern.search(f.read()):
                        offenders.append(name)
    assert not offenders


def test_runner_without_device_needs_cuda():
    """No device asked for means cuda; where CUDA is absent, that raises."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    topo = get_topology(3)
    with pytest.raises(RuntimeError, match="CUDA"):
        SelfplayRunner(topo, make_policy("MLP-default", 9), SelfplayConfig(board_size=3))
    with pytest.raises(RuntimeError, match="CUDA"):
        hex_env.initial_state(topo, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        hex_env.make_ops(topo)


def test_learner_without_device_needs_cuda():
    """``SelfplayPPO`` and ``Trainer`` with no device run on cuda or raise."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from hex_gym_env_tpu_torch.train import SelfplayPPO, Trainer
    from hex_gym_env_tpu_torch.utils.config import PPOConfig, TrainConfig

    cfg = TrainConfig(ppo=PPOConfig(n_steps=4, minibatch_size=8),
                      selfplay=SelfplayConfig(board_size=3, n_envs=2, buffer_size=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        SelfplayPPO(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg)


def test_surfaces_without_device_need_cuda():
    """``HexEnv`` and ``run_match`` with no device run on cuda or raise."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from hex_gym_env_tpu_torch.compat import HexEnv, HexEnvV0
    from hex_gym_env_tpu_torch.scripts.match import run_match

    with pytest.raises(RuntimeError, match="CUDA"):
        HexEnv()
    with pytest.raises(RuntimeError, match="CUDA"):
        HexEnvV0()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_match(5, 8, "random", "random")


def test_entry_points_without_device_need_cuda(tmp_path, monkeypatch):
    """The training, export, legacy, CLI and GUI entry points, the verify
    and measure tools and the graft entry run on cuda unless asked for the
    CPU, and raise where it is absent."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    from hex_gym_env_tpu_torch.__graft_entry__ import dryrun_multichip, entry
    from hex_gym_env_tpu_torch.parallel import make_mesh
    from hex_gym_env_tpu_torch.scripts import (breakdown_bench, export_agent, play_cli, play_gui,
                                               scaling_bench, selftest, train, train_legacy,
                                               verify_train)

    monkeypatch.chdir(tmp_path)
    tiny = ["--experiment", "3x3_MLP-default_lr-0.0003", "--n-envs", "2", "--n-steps", "4",
            "--minibatch-size", "8"]
    for call in (lambda: train.main(tiny), lambda: train.main(tiny + ["--multichip"]),
                 lambda: export_agent.main(["--experiment", "3x3_MLP-default_lr-0.0003"]),
                 lambda: train_legacy.main(["--bursts", "1"]), lambda: play_cli.CliGame(3),
                 lambda: play_gui.build(3, "random"), entry, make_mesh,
                 lambda: dryrun_multichip(1), lambda: selftest.main([]),
                 lambda: verify_train.main([]), lambda: breakdown_bench.main([]),
                 lambda: scaling_bench.main(["--devices", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_orbax_spec_without_tensorstore_raises(monkeypatch):
    """Without ``tensorstore`` an ``orbax:`` spec is an ImportError that
    names the ``params:`` copy, never made-up parameters."""
    from hex_gym_env_tpu_torch.models.loading import load_policy_params

    monkeypatch.setitem(sys.modules, "tensorstore", None)
    path = os.path.join(REPO, "models", "5x5_strict_sb3", "agent_9437184")
    with pytest.raises(ImportError, match="params:"):
        load_policy_params(f"orbax:{path}", 5, device="cpu")


def test_main_process_without_torch_distributed():
    from hex_gym_env_tpu_torch.parallel.bootstrap import is_main_process

    assert is_main_process()


def test_pinned_kernels_refuse_cpu_tensors():
    topo = get_topology(3)
    state = hex_env.initial_state(topo, 2, device="cpu")
    actions = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        step_kernel.step_cuda(topo, state, actions)
    with pytest.raises(ValueError, match="CUDA"):
        hex_env.make_ops(topo, impl="pallas", device="cpu").step(state, actions)

    model = make_policy("MLP-default", 9)
    params = dict(model.state_dict())
    pol = policy_kernel.PolicyOps(model, impl="pallas")
    obs = hex_env.observe(topo, state)
    legal = hex_env.legal_mask(topo, state)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="pallas"):
        pol.agent_act(pol.agent_operand(params), obs, legal, g)
    bank = init_bank(params, 2)
    with pytest.raises(ValueError, match="pallas"):
        pol.bank_act(pol.bank_operand(bank), torch.zeros(2, dtype=torch.bool),
                     torch.zeros(2, dtype=torch.int32), obs, legal, g)

    cfg = SelfplayConfig(board_size=3, n_envs=2, buffer_size=2, policy_impl="pallas",
                         rollout_impl="fused")
    runner = SelfplayRunner(topo, model, cfg, device="cpu")
    with pytest.raises(ValueError, match="pallas"):
        runner.run(params, bank, runner_carry_cpu(runner, bank), g, 2)
    with pytest.raises(ValueError):
        rollout_kernel.fused_rollout(
            topo, runner.fused_pol, None, None, None, state, None, None, None, 1, 0.8, True)


def runner_carry_cpu(runner, bank):
    """A carry built without the kernels (the policy passes pinned to the
    card would refuse the CPU)."""
    from hex_gym_env_tpu_torch.train.rollout import RolloutCarry

    B = runner.cfg.n_envs
    return RolloutCarry(
        env=runner.fresh_envs(),
        agent_seat=torch.zeros(B, dtype=torch.int32),
        use_best=torch.zeros(B, dtype=torch.bool),
        opp_idx=torch.zeros(B, dtype=torch.int32),
    )
