"""The benchmark's plain reference held against the port's plain PyTorch
paths on the CPU, at small sizes, and kept free of the port and of JAX."""

import dataclasses
import subprocess
import sys

import pytest
import torch

from benchmark import weights, work
from benchmark.reference import env as ref_env
from benchmark.reference import models as ref_models
from benchmark.reference import pool as ref_pool
from benchmark.reference import ppo as ref_ppo
from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core.topology import get_topology
from hex_gym_env_tpu_torch.models import make_policy
from hex_gym_env_tpu_torch.train import ppo as port_ppo
from hex_gym_env_tpu_torch.train.bank import init_bank
from hex_gym_env_tpu_torch.train.evaluate import Evaluator
from hex_gym_env_tpu_torch.train.gae import compute_gae
from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig

MLP = {"family": "MLP", "name": "MLP-default", "hidden": [64, 64], "activation": "tanh"}
CNN = {"family": "CNN", "name": "CNN", "hidden": [128, 128], "activation": "relu",
       "filters": 64, "conv_layers": 5, "features": 128}


def model(spec: dict, board: int) -> work.Model:
    return work.model_of({"model": {**spec, "board_size": board}})


def port_policy(spec: dict, board: int, params: dict):
    m = make_policy(spec["name"], board * board)
    m.load_state_dict(params)
    return m


@pytest.mark.parametrize("n", [5, 7])
def test_env_matches_port_games(n):
    """Random games of the port's plain env end when and as the reference's
    rules say, move for move."""
    topo = get_topology(n)
    B = 64
    g = torch.Generator().manual_seed(n)
    st = hex_env.initial_state(topo, B, "cpu")
    world = torch.zeros((B, n, n), dtype=torch.int8)
    to_move = torch.zeros(B, dtype=torch.long)
    done = torch.zeros(B, dtype=torch.bool)
    for _ in range(n * n):
        legal = hex_env.legal_mask(topo, st)
        obs = hex_env.observe(topo, st)
        assert torch.equal(obs, ref_env.mover_frame(world, to_move))
        a = torch.multinomial(legal.float() + 1e-9 * (~legal).float(), 1, generator=g)[:, 0]
        st, _ = hex_env.step(topo, st, a)
        live = ~done
        cell = ref_env.world_cell(a.long(), to_move, n)
        flat = world.reshape(B, -1)
        stone = torch.where(to_move == 0, -1, 1).to(torch.int8)
        flat[live, cell[live]] = stone[live]
        won = torch.where(to_move == 0, ref_env.connects(world == -1, 0),
                          ref_env.connects(world == 1, 1))
        done = done | (live & won)
        assert torch.equal(st.done, done)
        to_move = torch.where(live, 1 - to_move, to_move)
    assert bool(done.all())
    winners = torch.where(ref_env.connects(world == -1, 0), 0, 1)
    assert torch.equal(st.winner.long(), winners)


def test_winning_cells_complete_a_connection():
    board = torch.zeros((1, 5, 5), dtype=torch.int8)
    board[0, 2, :] = 1
    board[0, 2, 3] = 0
    cells = ref_env.winning_cells(board, 1)
    assert cells.sum() == 1 and bool(cells[0, 2, 3])
    assert not bool(ref_env.winning_cells(board, -1).any())


@pytest.mark.parametrize("spec,n", [(MLP, 5), (MLP, 7), (CNN, 5)])
def test_forward_matches_port(spec, n):
    m = model(spec, n)
    params, _ = weights.make(m, 3, "cpu", action_gain=1.0, bias_std=0.1)
    policy = port_policy(spec, n, params)
    obs = torch.randint(-1, 2, (32, n, n), generator=torch.Generator().manual_seed(1))
    want_logits, want_value = policy(obs.float())
    if m.family == "CNN":
        logits, value = ref_models.cnn_forward(params, obs, len(m.hidden))
        _, _, want_stats = policy(obs.float(), train=True)
        _, _, stats = ref_models.cnn_forward(params, obs, len(m.hidden), train=True)
        for k, v in want_stats.items():
            torch.testing.assert_close(stats[k], v, rtol=1e-5, atol=1e-6)
    else:
        logits, value = ref_models.mlp_forward(params, obs, len(m.hidden), m.activation)
    torch.testing.assert_close(logits, want_logits, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(value, want_value, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spec,n", [(MLP, 5), (MLP, 7), (CNN, 5), (CNN, 9)])
def test_policy_logits_match_port(spec, n):
    """The match's reference forward: the MLP's is ``mlp_policy_logits`` bit
    for bit; the CNN's, with BatchNorm drawn (``bn_std``) and on its running
    statistics, the port's ``CnnPolicy`` logits."""
    m = model(spec, n)
    params, _ = weights.make(m, 9, "cpu", action_gain=2.0, bias_std=0.1, bn_std=0.1)
    obs = torch.randint(-1, 2, (32, n, n), generator=torch.Generator().manual_seed(2))
    with ref_models.full_float32():
        logits = ref_models.policy_logits(m, params, obs)
    if m.family == "MLP":
        assert torch.equal(logits, ref_models.mlp_policy_logits(params, obs, len(m.hidden),
                                                                m.activation))
        return
    assert not torch.equal(params["conv_in.bn.var"], torch.ones_like(params["conv_in.bn.var"]))
    want, _ = port_policy(spec, n, params)(obs.float())
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bn_std", [None, 0.1])
def test_batch_norm_draw(bn_std):
    """Without ``bn_std`` BatchNorm keeps the start values; with it every
    one of its tensors is drawn, the variance positive, and the draw is the
    same from the same seed; every other tensor is as without it."""
    m = model(CNN, 5)
    params, trained = weights.make(m, 4, "cpu", action_gain=2.0, bias_std=0.1, bn_std=bn_std)
    again, _ = weights.make(m, 4, "cpu", action_gain=2.0, bias_std=0.1, bn_std=bn_std)
    start, _ = weights.make(m, 4, "cpu", action_gain=2.0, bias_std=0.1)
    bn = {k: v for k, v in params.items() if ".bn." in k}
    assert len(bn) == 4 * m.conv_layers and "conv_in.bn.mean" not in trained
    assert all(torch.equal(v, start[k]) for k, v in params.items() if k not in bn)
    for k, v in bn.items():
        assert torch.equal(v, again[k])
        fill = 1.0 if k.endswith((".scale", ".var")) else 0.0
        assert torch.equal(v, torch.full_like(v, fill)) is (bn_std is None), k
        if k.endswith(".var"):
            assert bool((v > 0).all())


def test_gae_matches_port():
    g = torch.Generator().manual_seed(4)
    T, B = 16, 8
    r = torch.randint(-1, 2, (T, B), generator=g).float()
    v = torch.randn((T, B), generator=g)
    d = torch.rand((T, B), generator=g) < 0.2
    last = torch.randn(B, generator=g)
    want = compute_gae(r, v, d, last, 0.99, 0.95)
    got = ref_ppo.gae(r, v, d, last, 0.99, 0.95)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spec,n", [(MLP, 5), (MLP, 7), (CNN, 5)])
def test_sweep_matches_port(spec, n):
    """One sweep of the reference and of the port's autograd path from the
    same weights, batch and minibatch order."""
    m = model(spec, n)
    params, trained = weights.make(m, 5, "cpu", action_gain=1.0, bias_std=0.1)
    policy = port_policy(spec, n, params)
    cfg = PPOConfig(n_steps=8, minibatch_size=16, n_epochs=2)
    g = torch.Generator().manual_seed(6)
    rows = 64
    obs = torch.randint(-1, 2, (rows, n, n), generator=g).to(torch.int8)
    legal = obs.reshape(rows, -1) == 0
    logits, value = policy(obs.float())
    action = torch.multinomial(legal.float(), 1, generator=g)[:, 0].int()
    logp = ref_models.masked_log_softmax(logits.detach(), legal).gather(1, action[:, None].long())[:, 0]
    adv, ret = torch.randn(rows, generator=g), torch.randn(rows, generator=g)
    perms = ref_ppo.epoch_permutations(torch.Generator().manual_seed(7), rows, cfg.n_epochs)
    batch = port_ppo.PPOBatch(obs, legal, action, logp, value.detach(), adv, ret)
    want_p, want_opt, _ = port_ppo.make_update_fn(policy, cfg)(
        params, port_ppo.init_adam({k: params[k] for k in trained}), batch, perms=perms)
    hyper = ref_ppo.Hyper(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(ref_ppo.Hyper)})
    L = len(m.hidden)
    if m.family == "CNN":
        def fwd(p, x):
            return ref_models.cnn_forward(p, x, L, train=True)
    else:
        def fwd(p, x):
            return (*ref_models.mlp_forward(p, x, L, m.activation), {})
    got_p, got_opt, _, _ = ref_ppo.sweep(
        fwd, params, trained, ref_ppo.zero_adam({k: params[k] for k in trained}),
        {"obs": obs, "legal": legal, "action": action, "log_prob_old": logp, "advantage": adv,
         "ret": ret}, perms, hyper)
    for k in params:
        torch.testing.assert_close(got_p[k], want_p[k], rtol=1e-4, atol=1e-6)
    for k in trained:
        torch.testing.assert_close(got_opt.m[k], want_opt.mu[k], rtol=1e-4, atol=1e-7)
        torch.testing.assert_close(got_opt.v[k], want_opt.nu[k], rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("rewards", [[1.0, 1.0, -1.0], [-1.0, -1.0, 1.0], [1.0, 1.0, 1.0]])
def test_pool_rule_matches_port(rewards):
    n = 5
    m = model(MLP, n)
    agent, _ = weights.make(m, 8, "cpu", action_gain=1.0)
    cfg = SelfplayConfig(board_size=n, buffer_size=4, n_eval_episodes=3)
    ev = Evaluator(get_topology(n), make_policy("MLP-default", n * n), cfg, "cpu")
    bank = init_bank(agent, 4)
    bank = dataclasses.replace(bank, scores=torch.tensor([0.3, 0.1, 0.1, 0.5]))
    r = torch.tensor(rewards)
    new, _ = ev.apply_pool_update(agent, bank, r, torch.Generator().manual_seed(0))
    changed = [i for i in range(4) if not torch.equal(new.params["pi.0.weight"][i],
                                                      bank.params["pi.0.weight"][i])]
    slot = changed[0] if changed else None
    member = slot is not None and torch.equal(new.params["pi.0.weight"][slot], agent["pi.0.weight"])
    best = torch.equal(new.best_params["pi.0.weight"], agent["pi.0.weight"])
    args = (r, bank.scores, bank.best_score, new.scores, new.best_score)
    assert ref_pool.faults(*args, slot, member, best, len(changed) <= 1) == 0
    wrong_slot = None if slot is not None else 0
    assert ref_pool.faults(*args, wrong_slot, True, best, True) > 0


def test_reference_imports_neither_the_port_nor_jax(root):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import benchmark.reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True, text=True,
                         check=True, cwd=str(root))
    loaded = set(eval(out.stdout))
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "hex_gym_env_tpu",
                         "hex_gym_env_tpu_torch"}


def test_gumbel_noise_is_finite_for_every_word():
    """The reference's draw: the words' map ``u = k * 2**-24 + 2**-25`` of
    the program's draw, in float32, with ``u`` kept below 1, so the top
    words (24 bits set) get the largest finite noise and a masked cell
    (the float32 minimum) never wins."""
    words = torch.arange(-(2 ** 31), 2 ** 31, 4099, dtype=torch.int64)
    words = torch.cat([words, torch.tensor([-1, -256, 2 ** 31 - 1])]).to(torch.int32)
    noise = ref_models.gumbel(words)
    assert torch.isfinite(noise).all()
    top = ((words >> 8) & 0xFFFFFF) == 0xFFFFFF
    assert top.sum() >= 2 and bool((noise[top] == noise.max()).all())
    below = ~top
    k = ((words[below] >> 8) & 0xFFFFFF).double()
    u = (k * 2.0 ** -24 + 2.0 ** -25).float()
    assert torch.equal(noise[below], -torch.log(-torch.log(u)))
    assert float(ref_models.MASKED + noise.max()) < -1e38
