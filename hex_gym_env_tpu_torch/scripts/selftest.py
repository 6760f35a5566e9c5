"""On-card selftest: the checks that only the card can make.

The counterpart of the JAX package's ``scripts/tpu_selftest.py``.  The CPU
tests hold every kernel's twin against the JAX package on injected random
bits; the kernels' own Philox streams, and their compiled code, are
exercised only on the card.  Run on a card:

    python -m hex_gym_env_tpu_torch.scripts.selftest [--repeats N] [--cpu]

Checks, each on the production kernels (their twins with ``--cpu``):

  1. the env step K1 equals the plain step bitwise over 30-move playouts
     (7x7, 512 games), both sides taking the same uniform-legal actions;
  2. on K2 (the agent pass), K3 (the bank pass) and K4 (the whole rollout)
     with a zero agent and a zero bank on 5x5 empty boards, each on its own
     Philox stream: every action legal, one generator seed twice gives the
     same actions and seeds 1 and 2 different ones (2a); the opening cells
     are uniform by a chi-square test, also for K4's opponent openings
     drawn from its opening-move table at a reset (2b);
  3. after one K4 transition from empty boards every game holds 2 stones;
  4. a K4 rollout (5x5, 128 games, 16 steps) replays exactly through
     ``ops/rollout_kernel.verify_rollout_trajectory``;
  5. K5 equals the plain GAE recurrence bitwise (T = 128, B = 256);
  6. K6 fed the ``pallas-fast`` schedule against its twin and against the
     autograd replay of the same schedule;
  7. the match's forward kernel (``ops/mlp_forward``) against its twin on
     every MLP family at boards 5 to 11 (4,096 boards), its image against
     the twin's exactly, a 7x7 match's launches, and a parameter changed in
     place after binding, which the module must not read stale.

The seeds are fixed, so a run on the card repeats exactly: a chi-square
below its 0.001 critical value is a property of the kernels' streams at
these seeds, not a coin tossed anew each run.  ``--repeats N`` then runs the
env-throughput benchmark (``hex_gym_env_tpu_torch.bench``) with N samples a
route.  Every check raises ``AssertionError`` on a mismatch; ``selftest
PASSED`` is printed only when all of them passed.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core.topology import get_topology
from hex_gym_env_tpu_torch.models import make_policy
from hex_gym_env_tpu_torch.models.loading import agent_path
from hex_gym_env_tpu_torch.ops import cuda_lib, gae_kernel, mlp_forward, ppo_kernel
from hex_gym_env_tpu_torch.ops import rollout_kernel, step_kernel
from hex_gym_env_tpu_torch.ops import policy_kernel as pk
from hex_gym_env_tpu_torch.scripts.match import run_match
from hex_gym_env_tpu_torch.train import gae, ppo
from hex_gym_env_tpu_torch.train.bank import init_bank
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO
from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig
from hex_gym_env_tpu_torch.utils.device import resolve_device

DRAW_N = 5  # the board of the draw checks: 25 opening cells
CHI2_DOF = DRAW_N * DRAW_N - 1
CHI2_CRIT = 51.2  # chi-square with 24 degrees of freedom at p = 0.001
DRAW_BANK = 2  # pool slots of the zero bank
REPLAY_ATOL = 2e-5  # K4's floats against the plain model: float32 sums in another order
# K6 against its twin (the kernel's own tolerances, ``chip_smoke.py``): the
# largest error over the largest value of each of the params, the Adam
# moments (each packed into one vector) and the mean stats
K6_STEP_REL = 1e-5  # after one grad step
K6_SWEEP_REL = 1e-4  # after the sweep
# K6 against the autograd replay of its schedule, per element: the bound
# that tests/test_torch_ppo.py holds the sweeps to against optax's (the
# backward and Adam in another order of operations)
REPLAY_RTOL, REPLAY_ATOL_SWEEP = 2e-4, 1e-6
# the forward kernel against its twin: the largest error over the largest
# output (at least 1), float32 sums in another order than cuBLAS's
FWD_REL = 1e-5


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def chi_square(actions: torch.Tensor, k: int = DRAW_N * DRAW_N) -> float:
    """Pearson's statistic of ``actions``' counts over ``k`` cells against
    the uniform."""
    counts = torch.bincount(actions.long().cpu(), minlength=k).double()
    expected = counts.sum() / k
    return float(((counts - expected) ** 2 / expected).sum())


def require_uniform(name: str, actions: torch.Tensor) -> float:
    """The chi-square of ``actions`` over the 25 cells, which must stay
    below ``CHI2_CRIT``; printed and returned."""
    stat = chi_square(actions)
    print(f"2b. {name} opening-move chi-square: {stat:.2f} over {actions.numel()} draws "
          f"(dof {CHI2_DOF}, critical value at p = 0.001: {CHI2_CRIT})")
    _require(stat < CHI2_CRIT, f"{name}: opening moves not uniform, chi-square {stat:.2f}")
    return stat


# ---------------------------------------------------------------------------
# 1. K1 against the plain step
# ---------------------------------------------------------------------------


def check_step(device, n: int = 7, batch: int = 512, plies: int = 30) -> None:
    topo = get_topology(n)
    g = torch.Generator().manual_seed(7)
    kern = hex_env.initial_state(topo, batch, device)
    plain = hex_env.initial_state(topo, batch, device)
    for ply in range(plies):
        u = torch.rand((batch, topo.num_cells), generator=g).to(device)

        def uniform_legal(state):
            return torch.where(hex_env.legal_mask(topo, state), u, -1.0).argmax(-1).to(torch.int32)

        kern, rew_k = step_kernel.step(topo, kern, uniform_legal(kern))
        plain, rew_p = hex_env.step(topo, plain, uniform_legal(plain))
        for f in dataclasses.fields(plain):
            _require(torch.equal(getattr(kern, f.name), getattr(plain, f.name)),
                     f"K1 {f.name} differs from the plain step at ply {ply}")
        _require(torch.equal(rew_k, rew_p), f"K1 rewards differ from the plain step at ply {ply}")
    print(f"1. K1 == plain step bitwise over {plies}-move playouts ({n}x{n}, {batch} games, "
          f"{int(plain.done.sum())} finished): OK")


# ---------------------------------------------------------------------------
# 2-3. the kernels' own draws from a zero agent and a zero bank
# ---------------------------------------------------------------------------


class _ZeroPolicy:
    """A zero agent and a zero bank at 5x5: constant logits, so every pass
    samples uniformly over the legal cells."""

    def __init__(self, device):
        self.topo = get_topology(DRAW_N)
        self.device = device
        model = make_policy("MLP-default", self.topo.num_cells)
        self.params = {k: torch.zeros_like(v, device=device) for k, v in model.state_dict().items()}
        self.bank = init_bank(self.params, DRAW_BANK)
        self.pol = pk.PolicyOps(model, "auto")
        self.stacked = self.pol.stack_bank(self.bank)

    def empty(self, batch: int):
        return hex_env.initial_state(self.topo, batch, self.device)

    def k4(self, state, agent_seat: int, seed: int):
        """One K4 transition (``fused_rollout``, T = 1) on its Philox stream
        seeded from a generator at ``seed``; the opponent is pool slot 0 and
        the seats stay fixed."""
        B, dev = state.batch_size, self.device
        return rollout_kernel.fused_rollout(
            self.topo, self.pol, self.pol.pack_agent(self.params), self.stacked,
            rollout_kernel.first_move_table(self.stacked, self.pol.dims), state,
            torch.full((B,), agent_seat, dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.bool, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
            1, 0.8, False, generator=torch.Generator().manual_seed(seed))

    def k2(self, state, seed: int) -> torch.Tensor:
        obs, legal = hex_env.observe(self.topo, state), hex_env.legal_mask(self.topo, state)
        res = self.pol.agent_act(self.pol.agent_operand(self.params), obs, legal,
                                 torch.Generator().manual_seed(seed))
        return res.action

    def k3(self, state, seed: int) -> torch.Tensor:
        B, dev = state.batch_size, self.device
        obs, legal = hex_env.observe(self.topo, state), hex_env.legal_mask(self.topo, state)
        action, _ = self.pol.bank_act(
            self.pol.bank_operand(self.bank), torch.zeros((B,), dtype=torch.bool, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev), obs, legal,
            torch.Generator().manual_seed(seed))
        return action


def check_draws(device, batch: int = 4096) -> dict:
    """2a and 2b on K2, K3 and K4 (the agent's openings and the opponent's
    openings at a reset).  Returns each draw's chi-square."""
    z = _ZeroPolicy(device)
    F = z.topo.num_cells
    # The opponent's openings come from K4's opening-move table, drawn where
    # a game resets.  The carry arrives with every game done, the agent in
    # seat 1 and the seats fixed: the step plays no move, every game resets,
    # and the opponent, holding seat 0, opens every fresh board.
    done = dataclasses.replace(z.empty(batch),
                               done=torch.ones((batch,), dtype=torch.bool, device=device))

    def opp_openings(seed):
        out = z.k4(done, 1, seed)
        first = out.ints[0, :, rollout_kernel.I_FIRST_ACTION]
        board = hex_env.world_boards(z.topo, out.state).reshape(batch, F)
        _require(bool((board != 0).sum(1).eq(1).all()), "K4: a reset game holds other than "
                 "the opponent's one opening stone")
        _require(torch.equal((board != 0).to(torch.int32).argmax(1).to(torch.int32), first),
                 "K4: the recorded opening is not the stone on the board")
        return first

    draws = {
        "K2 agent pass": lambda seed: z.k2(z.empty(batch), seed),
        "K3 bank pass": lambda seed: z.k3(z.empty(batch), seed),
        "K4 agent openings": lambda seed: z.k4(z.empty(batch), 0, seed).ints[
            0, :, rollout_kernel.I_ACTION],
        "K4 opponent openings": opp_openings,
    }
    stats = {}
    for name, draw in draws.items():
        a1, a2, again = draw(1), draw(2), draw(1)
        _require(a1.shape == (batch,), f"{name}: {tuple(a1.shape)} actions for {batch} games")
        _require(bool(((a1 >= 0) & (a1 < F)).all()), f"{name}: an action off the empty board")
        _require(torch.equal(a1, again), f"{name}: one seed gave two streams")
        _require(not torch.equal(a1, a2), f"{name}: seeds 1 and 2 gave the same stream")
        stats[name] = a1
    print(f"2a. K2, K3, K4 (agent and opponent openings): every draw legal, one seed repeats, "
          f"two seeds diverge ({batch} empty {DRAW_N}x{DRAW_N} boards each): OK")
    agent_draws = [stats[k] for k in ("K2 agent pass", "K3 bank pass", "K4 agent openings")]
    if all(torch.equal(agent_draws[0], a) for a in agent_draws[1:]):
        print("2b. K2, K3 and K4 drew the same actions from seed 1 on the empty boards: each "
              "keys its streams by (seed, game, lane) and maps words to samples alike")
    return {name: require_uniform(name, a) for name, a in stats.items()}


def check_reply(device, batch: int = 4096) -> None:
    """3: one K4 transition from empty boards, the agent in seat 0: the
    agent's move and the opponent's reply, so 2 stones in every game."""
    z = _ZeroPolicy(device)
    out = z.k4(z.empty(batch), 0, 3)
    stones = (hex_env.world_boards(z.topo, out.state) != 0).reshape(batch, -1).sum(1)
    _require(bool((stones == 2).all()),
             f"K4: expected 2 stones in every game, got {sorted(set(stones.tolist()))}")
    print("3. K4's opponent replied legally inside the same launch (2 stones in every game): OK")


# ---------------------------------------------------------------------------
# 4. a K4 rollout replayed through the plain env
# ---------------------------------------------------------------------------


def check_replay(device, n_envs: int = 128, n_steps: int = 16) -> None:
    cfg = TrainConfig(
        ppo=PPOConfig(n_steps=n_steps, minibatch_size=256),
        selfplay=SelfplayConfig(board_size=5, n_envs=n_envs, buffer_size=4,
                                policy="MLP-default", rollout_impl="fused", seed=0),
    )
    algo = SelfplayPPO(cfg, device)
    st = algo.init_state(4)
    runner = algo.runner
    runner.run_fused(st.params, st.bank, st.carry, torch.Generator().manual_seed(44), n_steps)
    out = runner.last_record
    rollout_kernel.verify_rollout_trajectory(
        algo.topo, algo.model, st.params, st.carry, out, n_steps, "per_episode",
        algo.cfg.selfplay.buffer_size, atol=REPLAY_ATOL)
    finished = int(out.ints[..., rollout_kernel.I_DONE].sum())
    _require(finished > 0, "K4's rollout finished no game")
    print(f"4. a K4 rollout ({n_envs} games, {n_steps} steps, {finished} games finished) replays "
          f"exactly through the plain env (floats within {REPLAY_ATOL}): OK")


# ---------------------------------------------------------------------------
# 5. K5 against the plain recurrence
# ---------------------------------------------------------------------------


def check_gae(device, T: int = 128, B: int = 256) -> None:
    g = torch.Generator().manual_seed(5)
    noise = torch.randn((T, B), generator=g)
    rewards = torch.where(torch.rand((T, B), generator=g) < 0.1, torch.sign(noise), 0.0)
    values = noise * 0.5  # the JAX check's recipe draws both from one key
    dones = torch.rand((T, B), generator=g) < 0.15
    last = torch.randn((B,), generator=g) * 0.5
    args = [t.to(device) for t in (rewards, values, dones, last)] + [0.99, 0.95]
    adv_k, ret_k = gae_kernel.compute_gae(*args)
    adv_p, ret_p = gae.compute_gae(*args)
    _require(torch.equal(adv_k, adv_p) and torch.equal(ret_k, ret_p),
             "K5 differs from the plain GAE recurrence")
    print(f"5. K5 == the plain GAE recurrence bitwise (T = {T}, B = {B}): OK")


# ---------------------------------------------------------------------------
# 6. K6 on the pallas-fast schedule
# ---------------------------------------------------------------------------


def _sweep_batch(n: int, n_cells: int, device) -> ppo.PPOBatch:
    """The JAX check's batch: random boards with at least one empty cell, a
    uniform legal action, old log-probs near -2.5."""
    side = int(round(n_cells ** 0.5))
    rng = np.random.default_rng(0)
    boards = rng.choice(np.array([-1, 0, 1], np.int8), size=(n, side, side))
    boards.reshape(n, -1)[np.arange(n), rng.integers(0, n_cells, n)] = 0
    legal = boards.reshape(n, -1) == 0
    u = rng.random((n, n_cells))
    fields = dict(
        obs=boards,
        legal=legal,
        action=np.argmax(np.where(legal, u, -1.0), axis=1).astype(np.int32),
        log_prob_old=rng.normal(-2.5, 0.3, n).astype(np.float32),
        value_old=np.zeros(n, np.float32),
        advantage=rng.normal(0, 1, n).astype(np.float32),
        ret=rng.normal(0, 0.7, n).astype(np.float32),
    )
    return ppo.PPOBatch(**{k: torch.as_tensor(v, device=device) for k, v in fields.items()})


def _rel_errors(pol: pk.PolicyOps, got, want) -> dict:
    """K6's measure: the largest error over the largest value of each of
    the params, the two Adam moments (each packed into one vector) and the
    mean stats."""
    (p, opt, st), (p0, opt0, st0) = got, want
    pairs = {"params": (p, p0), "mu": (opt.mu, opt0.mu), "nu": (opt.nu, opt0.nu)}
    out = {}
    for name, (a, b) in pairs.items():
        a, b = pol.pack_agent(a), pol.pack_agent(b)
        out[name] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    sa, sb = torch.stack(list(st)), torch.stack(list(st0))
    out["stats"] = float((sa - sb).abs().max()) / max(float(sb.abs().max()), 1e-30)
    return out


def check_fast_sweep(device, n: int = 256, mbs: int = 64, n_epochs: int = 2) -> dict:
    """6: ``make_kernel_fast_update_fn`` (K6 on a CUDA batch) against its
    twin on the same ``rowperm``/``order`` (after one grad step and after
    the sweep) and against the autograd replay of the schedule through
    ``train/ppo.make_update_fn``.  Returns the largest errors."""
    topo = get_topology(5)
    cfg = PPOConfig(minibatch_size=mbs, n_epochs=n_epochs)
    model = make_policy("MLP-default", topo.num_cells, generator=torch.Generator().manual_seed(4))
    params = {k: v.detach().to(device) for k, v in model.state_dict().items()}
    opt0 = ppo.init_adam(params)
    batch = _sweep_batch(n, topo.num_cells, device)
    rowperm, order = ppo_kernel.fast_schedule(torch.Generator().manual_seed(66), n, mbs, n_epochs)
    G = order.shape[0]
    kernel = ppo_kernel.make_kernel_fast_update_fn(model, cfg, "auto")
    twin = ppo_kernel.make_kernel_fast_update_fn(model, cfg, "lax")

    pol = pk.PolicyOps(model)
    one = _rel_errors(pol, kernel(params, opt0, batch, rowperm=rowperm, order=order[:1]),
                      twin(params, opt0, batch, rowperm=rowperm, order=order[:1]))
    worst = max(one, key=one.get)
    _require(one[worst] <= K6_STEP_REL,
             f"K6 one grad step: {worst} relative error {one[worst]:.3g} > {K6_STEP_REL}")
    got = kernel(params, opt0, batch, rowperm=rowperm, order=order)
    _require(got[1].count == G, f"K6's Adam count {got[1].count} after {G} steps")
    sweep = _rel_errors(pol, got, twin(params, opt0, batch, rowperm=rowperm, order=order))
    worst_s = max(sweep, key=sweep.get)
    _require(sweep[worst_s] <= K6_SWEEP_REL,
             f"K6 {G}-step sweep: {worst_s} relative error {sweep[worst_s]:.3g} > {K6_SWEEP_REL}")

    # the schedule replayed through autograd: epoch e visits the blocks
    # order[e * n_mb:(e + 1) * n_mb] of the one row shuffle
    perms = rowperm.reshape(-1, mbs)[order.long()].reshape(n_epochs, -1)
    p_r, opt_r, _ = ppo.make_update_fn(model, cfg)(params, opt0, batch, perms=perms)
    worst_r = 0.0
    for part, a, b in (("params", got[0], p_r), ("mu", got[1].mu, opt_r.mu),
                       ("nu", got[1].nu, opt_r.nu)):
        for k in b:
            excess = (a[k] - b[k]).abs() - (REPLAY_ATOL_SWEEP + REPLAY_RTOL * b[k].abs())
            _require(bool((excess <= 0).all()),
                     f"K6 against the autograd replay: {part}.{k} beyond rtol {REPLAY_RTOL}, "
                     f"atol {REPLAY_ATOL_SWEEP} (worst by {float(excess.max()):.3g})")
            worst_r = max(worst_r, float((a[k] - b[k]).abs().max()))
    _require(opt_r.count == G, "the autograd replay took another number of steps")
    print(f"6. pallas-fast sweep (n {n}, minibatch {mbs}, {n_epochs} epochs, {G} steps): K6 vs "
          f"twin relative error {one[worst]:.3g} after one step ({worst}), {sweep[worst_s]:.3g} "
          f"after the sweep ({worst_s}); K6 vs the autograd replay of its schedule: largest "
          f"error {worst_r:.3g} (within rtol {REPLAY_RTOL}, atol {REPLAY_ATOL_SWEEP}): OK")
    return {"twin_step_rel": one[worst], "twin_sweep_rel": sweep[worst_s], "replay_abs": worst_r}


# ---------------------------------------------------------------------------
# 7. the match's forward kernel
# ---------------------------------------------------------------------------


def _forward_err(got, want) -> float:
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


def check_mlp_forward(device, batch: int = 4096, boards=(5, 7, 9, 11), match_games: int = 512,
                      families=("MLP-default", "MLP-deep", "MLP-wide-deep")) -> float:
    """7: on every family and board, a module bound on ``device`` (its twin's
    image on the CPU, where ``bind`` builds none): the image equals the
    twin's, and the module's call equals the twin's forward; a 7x7 match
    takes the kernel for every forward of both sides; after a parameter is
    changed in place, the module gives the plain path's output exactly, and
    bound again, the twin's on the new parameter.  Returns the largest
    error (``_forward_err``)."""
    g = torch.Generator().manual_seed(7)
    cuda = device.type == "cuda"
    worst = 0.0
    for family in families:
        for n in boards:
            model = make_policy(family, n * n, generator=g)
            with torch.no_grad():
                model.action_head.weight.mul_(100.0)  # O(1) logits, as a trained head
            params = {k: v.detach().to(device) for k, v in model.state_dict().items()}
            d = pk.mlp_dims(model)
            twin = mlp_forward.image_twin(params, d)
            model.bind(params)
            _require((model.bound_forward is not None) == cuda,
                     f"{family} {n}x{n}: an image built {not cuda} on {device.type}")
            if not cuda:
                mlp_forward.bind_twin(model, params)
            _require(torch.equal(model.bound_forward.image, twin),
                     f"{family} {n}x{n}: the image differs from the twin's")
            x = torch.randint(-1, 2, (batch, n, n), generator=g).to(device, torch.float32)
            with torch.no_grad():
                got = model(x)
            want = mlp_forward.forward_twin(twin, d, x.reshape(batch, -1))
            err = _forward_err(got, want)
            _require(err <= FWD_REL, f"{family} {n}x{n}: the forward is off its twin by {err}")
            worst = max(worst, err)
            if family == families[0] and n == boards[0]:
                with torch.no_grad():
                    model.action_head.bias.add_(0.5)  # in place, after binding
                    stale = model(x)
                    unbound = make_policy(family, n * n, generator=torch.Generator()).to(device)
                    unbound.load_state_dict(model.state_dict())
                    plain = unbound(x)
                _require(all(torch.equal(a, b) for a, b in zip(stale, plain)),
                         "a parameter changed after binding was read stale")
                if cuda:
                    model.bind(dict(model.state_dict()))
                    _require(model.bound_forward is not None, "no rebind")
                    with torch.no_grad():
                        again = model(x)
                    twin = mlp_forward.image_twin(model.state_dict(), d)
                    err = _forward_err(again, mlp_forward.forward_twin(
                        twin, d, x.reshape(batch, -1)))
                    _require(err <= FWD_REL, f"bound again, the forward is off by {err}")
    n = 7
    # the match's own launches, leaving the caller's counts as they stand
    before = dict(cuda_lib.launches)
    run_match(n, match_games, f"params:{agent_path(n)}", "random", mode="deterministic",
              device=device)
    want = 2 * (n * n + 1) if cuda else 0
    got = tuple(cuda_lib.launches[k] - before[k] for k in ("mlp_forward", "mlp_image"))
    _require(got == (want, 2 if cuda else 0),
             f"a {n}x{n} match launched the forward and image kernels {got} times")
    print(f"7. the match's forward kernel against its twin on {', '.join(families)} at "
          f"{', '.join(f'{b}x{b}' for b in boards)} ({batch} boards): largest error {worst:.3g} "
          f"of the largest output (bound {FWD_REL}); images exact; a {n}x{n} match launched "
          f"it {got[0]} times; a parameter changed after binding is not read stale: OK")
    return worst


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repeats", type=int, default=0,
                    help="after the checks, run the env-throughput benchmark with this many "
                         "timed samples per route (0: checks only)")
    ap.add_argument("--cpu", action="store_true", help="run the kernels' twins on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")

    check_step(device)
    chi2 = check_draws(device)
    check_reply(device)
    check_replay(device)
    check_gae(device)
    sweep = check_fast_sweep(device)
    forward_err = check_mlp_forward(device)
    print("selftest PASSED")
    if args.repeats > 0:
        from hex_gym_env_tpu_torch import bench

        bench.main(repeats=args.repeats, device=device)
    return {"chi_square": chi2, "fast_sweep": sweep, "mlp_forward": forward_err}


if __name__ == "__main__":
    main()
