"""Driver of the training cells: ``Trainer.fit`` of
``hex_gym_env_tpu_torch.train.trainer`` on the cell's preset, as
``scripts.train`` runs it.

Set-up builds one ``SelfplayPPO`` and one state: the agent's weights from
the seed (``benchmark/weights.py``), the program's own bank, rollout carry
and generator from ``init_state(seed)``.  It drives that state through the
first ``WARM_ITERS`` iterations with one ``fit`` (which loads the kernels and
warms every shape the window uses), capturing the inputs and outputs of the
rollout, the sweep and the evaluation of each, and hands the same objects
to the window: a second ``fit`` whose ``total_timesteps`` lies far ahead.
The program's own ``MetricsLogger``, wrapped to timestamp each record,
closes the window at the first record after ``--seconds``; the device is
then waited for, so the window holds every iteration dispatched in it.

After the window the plain reference follows the three captured
iterations (``judge``), each from the state it started from: the env
transitions and both sides' moves against the rules, the agent's
log-probabilities and values, GAE, the sweep (parameters, Adam moments and
losses, on the same minibatch order) and the pool update.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import time

import numpy as np
import torch

from benchmark import harness, weights, work
from benchmark.reference import env as ref_env
from benchmark.reference import models as ref_models
from benchmark.reference import pool as ref_pool
from benchmark.reference import ppo as ref_ppo
from hex_gym_env_tpu_torch.experiments import get_config
from hex_gym_env_tpu_torch.train import ppo as prog_ppo
from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO
from hex_gym_env_tpu_torch.train.trainer import Trainer
from hex_gym_env_tpu_torch.utils.metrics import MetricsLogger

WARM_ITERS = 3
SPANS = {"rollout": ("runner", "run"), "sweep": (None, "update_fn"),
         "eval": ("evaluator", "eval_and_update")}
# where each key of a configuration's "train" block sits in the program's TrainConfig
FIELDS = {
    "n_envs": "selfplay", "n_steps": "ppo", "minibatch_size": "ppo", "n_epochs": "ppo",
    "learning_rate": "ppo", "gamma": "ppo", "gae_lambda": "ppo", "clip_range": "ppo",
    "ent_coef": "ppo", "vf_coef": "ppo", "max_grad_norm": "ppo", "adam_eps": "ppo",
    "buffer_size": "selfplay", "best_prob": "selfplay", "eval_freq": "selfplay",
    "n_eval_episodes": "selfplay", "sample_board": "selfplay", "checkpoint_every": None,
}


class WindowClosed(Exception):
    """Raised by the logger at the first record past the window's end."""


class TimedLogger:
    """The program's logger, with a host-clock stamp for each iteration's
    record; ``deadline`` closes the window and ``on_record`` is called with
    the count of records."""

    def __init__(self, inner: MetricsLogger):
        self.inner = inner
        self.stamps: list = []
        self.deadline = None
        self.on_record = None

    def log(self, step: int, scalars: dict) -> None:
        self.inner.log(step, scalars)
        if "perf/total_steps_per_s" in scalars:  # fit's closing record, not an iteration
            return
        now = time.perf_counter()
        self.stamps.append(now)
        if self.on_record is not None:
            self.on_record(len(self.stamps))
        if self.deadline is not None and now >= self.deadline:
            raise WindowClosed

    def close(self) -> None:
        self.inner.close()


# -- the cell's program ------------------------------------------------------------


def hyper_of(ctx) -> dict:
    """The configuration's training block with the cell's overrides."""
    h = dict(ctx.config["train"])
    for k, v in {**ctx.config.get("overrides", {}), **ctx.workload.get("overrides", {})}.items():
        if k in h:
            h[k] = v
    return h


def program_config(ctx, hyper: dict):
    overrides = {**ctx.config.get("overrides", {}), **ctx.workload.get("overrides", {})}
    cfg = get_config(ctx.config["preset"], **overrides)
    cfg = dataclasses.replace(cfg, log_dir=os.path.join(ctx.run_dir, "log"),
                              model_dir=os.path.join(ctx.run_dir, "models"))
    for k, where in FIELDS.items():
        got = getattr(cfg if where is None else getattr(cfg, where), k)
        if got != hyper[k]:
            raise harness.HarnessError(f"preset {ctx.config['preset']} has {k}={got!r}, "
                                       f"the configuration file {hyper[k]!r}")
    if cfg.selfplay.board_size != ctx.config["model"]["board_size"] or \
            cfg.selfplay.policy != ctx.config["model"]["name"]:
        raise harness.HarnessError("the preset's model differs from the configuration file's")
    return cfg


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _bank(bank) -> dict:
    return {f.name: _clone(getattr(bank, f.name)) for f in dataclasses.fields(bank)}


def agent_board(env_state, seat, n: int) -> torch.Tensor:
    """The boards of a program ``HexState`` as the agent in ``seat`` sees them."""
    A = n * n
    world = env_state.stones[:, 1, :A].to(torch.int8) - env_state.stones[:, 0, :A].to(torch.int8)
    return ref_env.mover_frame(world.reshape(-1, n, n), seat)


class Capture:
    """The inputs and outputs of the rollout, the sweep and the evaluation of
    each iteration, while installed."""

    def __init__(self, algo: SelfplayPPO, n: int):
        self.iters: list = []
        self.n = n
        self._undo = [
            harness.wrap_call(algo.runner, "run", self._before_run, self._after_run),
            harness.wrap_call(algo, "update_fn", self._before_update, self._after_update),
            harness.wrap_call(algo.evaluator, "eval_and_update", self._before_eval,
                              self._after_eval),
        ]

    def remove(self) -> None:
        for undo in self._undo:
            undo()

    def _before_run(self, params, bank, carry, generator, n_steps):
        self.iters.append({"params_in": _clone(params)})

    def _after_run(self, out):
        carry, tr, _ = out
        cur = self.iters[-1]
        cur["tr"] = {f: _clone(getattr(tr, f)) for f in tr._fields}
        cur["next_board"] = agent_board(carry.env, carry.agent_seat, self.n).clone()

    def _before_update(self, params, opt_state, batch, generator=None, **_):
        cur = self.iters[-1]
        cur["gen_state"] = generator.get_state().clone()
        cur["count_in"] = opt_state.count
        cur["m_in"], cur["v_in"] = _clone(opt_state.mu), _clone(opt_state.nu)
        cur["adv"], cur["ret"] = _clone(batch.advantage), _clone(batch.ret)

    def _after_update(self, out):
        params, opt, stats = out
        cur = self.iters[-1]
        cur["params_out"] = _clone(params)
        cur["m"], cur["v"] = _clone(opt.mu), _clone(opt.nu)
        cur["loss"] = (float(stats.policy_loss), float(stats.value_loss))

    def _before_eval(self, params, bank, generator, fixed_seats=None):
        cur = self.iters[-1]
        cur["eval_params"] = _clone(params)
        cur["bank_in"] = _bank(bank)

    def _after_eval(self, out):
        bank, result = out
        cur = self.iters[-1]
        cur["bank_out"] = _bank(bank)
        cur["rewards"] = _clone(result.rewards)


@dataclasses.dataclass
class Session:
    """One cell's program after set-up's first iterations, and what the
    reference needs to follow them."""

    cfg: object
    algo: SelfplayPPO
    state: object
    logger: TimedLogger
    captured: list
    w: dict
    trained: tuple
    model: work.Model
    hyper: dict


def start(ctx) -> Session:
    """Build the program from the seed and drive it through the first
    ``WARM_ITERS`` iterations with one ``fit``, capturing each."""
    wl, conf = ctx.workload, ctx.config
    hyper = hyper_of(ctx)
    cfg = program_config(ctx, hyper)
    model = work.model_of(conf)
    algo = SelfplayPPO(cfg, ctx.device)
    w, trained = weights.make(model, ctx.seed, ctx.device, wl["init"]["action_gain"])
    template = algo.model.state_dict()
    if {k: tuple(v.shape) for k, v in template.items()} != {k: tuple(v.shape) for k, v in w.items()}:
        raise harness.HarnessError("the weights' layout differs from the program's model")
    state = algo.init_state(ctx.seed)
    state = dataclasses.replace(
        state, params=_clone(w),
        opt_state=prog_ppo.init_adam({k: w[k].clone() for k in prog_ppo.trainable_keys(algo.model)}))
    if ctx.hook is not None:
        ctx.hook(algo)
    logger = TimedLogger(MetricsLogger(cfg.log_dir, cfg.model_name))
    capture = Capture(algo, model.board)
    t_built = time.perf_counter()
    state = Trainer(dataclasses.replace(cfg, total_timesteps=WARM_ITERS * algo.per_iter),
                    logger=logger, algo=algo).fit(state)
    capture.remove()
    stamps = [t_built] + logger.stamps
    ctx.log(f"set-up: built at {t_built - ctx.t0:.3f} s; warm-up iterations "
            + ", ".join(f"{b - a:.3f}" for a, b in zip(stamps, stamps[1:])) + " s")
    return Session(cfg, algo, state, logger, capture.iters, w, trained, model, hyper)


def run(ctx) -> harness.Outcome:
    wl = ctx.workload
    s = start(ctx)
    cfg, algo, state, logger, model, hyper = s.cfg, s.algo, s.state, s.logger, s.model, s.hyper
    per_iter = algo.per_iter
    trainer = Trainer(dataclasses.replace(cfg, total_timesteps=10 ** 15), logger=logger, algo=algo)
    if wl.get("warm_checkpoint"):
        trainer._save_checkpoint(algo.timesteps(state), state, float(state.bank.best_score))

    cuda = ctx.device.type == "cuda"
    spans = harness.Spans(cuda)
    trace = harness.Trace(ctx.run_dir, list(SPANS)) if ctx.trace else None
    if ctx.trace:
        trace.warm()
        for name, (owner, attr) in SPANS.items():
            spans.wrap(algo if owner is None else getattr(algo, owner), attr, name)
        spans.wrap(trainer, "_save_checkpoint", "ckpt")
        limit = int(wl["trace_iters"])

        def on_record(count):
            if count >= limit:
                trace.stop()

        logger.on_record = on_record
    harness.check_imports()
    if cuda:
        torch.cuda.synchronize()
    # set-up's second iteration, unprofiled: the iteration time where the
    # profiled part leaves no whole iteration in the window after it
    warm = logger.stamps[1] - logger.stamps[0]
    logger.stamps = []
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    logger.deadline = t_start + ctx.seconds
    if trace is not None:
        trace.start()
    try:
        trainer.fit(state)
    except WindowClosed:
        pass
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    if trace is not None:
        trace.stop()
    logger.deadline = logger.on_record = None
    spans.unwrap_all()
    logger.close()
    stamps = logger.stamps
    iters = len(stamps) + 1
    wall = t_end - t_start
    iter_ms = np.diff(np.array(stamps)) * 1e3
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx.log(f"setup {setup_s:.3f} s, {iters} iterations in {wall:.3f} s")

    end_to_end = {"setup_s": setup_s, "transitions_per_s": iters * per_iter / wall}
    if len(iter_ms) >= 20:
        end_to_end["iter_ms_p95"] = float(np.percentile(iter_ms, 95))
    # the spans' calls outside the profiled part, whose profiler slows the host
    after = trace.t_stop if trace is not None else None
    readings = harness.Readings(kind="train", cuda_ms=spans.cuda_ms(after),
                                host_ms=spans.host_ms(after))
    h = hyper
    readings.unit_flops = work.iteration(model, h["n_envs"], h["n_steps"], h["n_epochs"],
                                         h["minibatch_size"], h["n_eval_episodes"])
    # iteration times outside the profiled part (the first after it pays its stop)
    clean = [b - a for a, b in zip(stamps, stamps[1:])
             if trace is None or trace.after_stop(a)][1 if trace is not None else 0:]
    readings.unit_s = statistics.median(clean) if clean else warm
    readings.least_s = {
        "rollout": work.least_seconds(*work.rollout(model, h["n_envs"], h["n_steps"],
                                                    h["buffer_size"])),
        "sweep": work.least_seconds(*work.sweep(model, h["n_envs"] * h["n_steps"],
                                                h["n_epochs"], h["minibatch_size"])),
        "eval": work.least_seconds(work.evaluation(model, h["n_eval_episodes"]), 0.0),
    }
    breakdown = busy = window = None
    if trace is not None:
        red = trace.result
        ctx.log(f"trace: {red['device_events']} device events, {red['attributed']} "
                f"tied to a launch; spans {red['calls']}")
        readings.device_s, readings.traced_calls = red["device_s"], red["calls"]
        readings.busy_s = busy = red["busy_s"]
        readings.traced_units = red["calls"]["rollout"]
        readings.window_s = window = red["window_s"]
        breakdown = red["breakdown"]

    del state, trainer
    s.state = s.algo = algo = None
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = judge(s.captured, s.trained, model, hyper)
    ctx.log(f"reference check {time.perf_counter() - t:.3f} s")
    limits = wl.get("limits", {})
    checks = harness.compared(ctx, numbers, limits)
    failed = sum(1 for v, lim in checks.values() if lim is not None and not harness.within(v, lim))
    return harness.Outcome(end_to_end=end_to_end, readings=readings, checks=checks,
                           attempted=iters, failed=failed, memory_peak_bytes=memory_peak,
                           busy_s=busy, window_s=window, breakdown=breakdown)


# -- the comparison with the reference ------------------------------------------------


def forwards(model: work.Model):
    """The reference's acting forward ``(logits, value)`` and its training
    forward ``(logits, value, new running statistics)``."""
    L = len(model.hidden)
    if model.family == "CNN":
        return (lambda p, obs: ref_models.cnn_forward(p, obs, L),
                lambda p, obs: ref_models.cnn_forward(p, obs, L, train=True))
    return (lambda p, obs: ref_models.mlp_forward(p, obs, L, model.activation),
            lambda p, obs: (*ref_models.mlp_forward(p, obs, L, model.activation), {}))


def hyper_ref(h: dict) -> ref_ppo.Hyper:
    return ref_ppo.Hyper(**{f.name: h[f.name] for f in dataclasses.fields(ref_ppo.Hyper)})


def _blocks(fn, obs, rows: int = 4096):
    outs = [fn(obs[i:i + rows]) for i in range(0, obs.shape[0], rows)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def follow(caps: list, trained: tuple, model: work.Model, h: dict, allow_tf32: bool,
           half_batch: bool = False):
    """The reference's run through each captured iteration from the state it
    started from: the log-probabilities and values of the recorded moves,
    GAE, and the sweep on the same minibatch order.  The first iteration
    starts from the seed's weights and zero moments, which both sides were
    handed; each later one from the program's own parameters and moments,
    since the recorded moves were drawn by the program's policy.  With
    ``half_batch`` each sweep sees only the first half of the rows (a planted
    fault).  Returns dicts shaped as ``program_outputs`` gives them, and each
    sweep's first gradient."""
    act, train = forwards(model)
    hp = hyper_ref(h)
    outs, firsts = [], []
    with ref_models.precision(allow_tf32):
        for cap in caps:
            p = cap["params_in"]
            opt = ref_ppo.Adam(cap["count_in"], cap["m_in"], cap["v_in"])
            tr = cap["tr"]
            T, B = tr["action"].shape
            obs = tr["obs"].reshape(T * B, -1)
            legal = obs == 0
            with torch.no_grad():
                logits, values = _blocks(lambda x: act(p, x), obs)
                last_v = act(p, cap["next_board"])[1]
            logp = ref_models.masked_log_softmax(logits, legal).gather(
                1, tr["action"].reshape(-1, 1).long())[:, 0]
            adv, ret = ref_ppo.gae(tr["reward"], values.reshape(T, B), tr["done"], last_v,
                                   h["gamma"], h["gae_lambda"])
            batch = {"obs": obs, "legal": legal, "action": tr["action"].reshape(-1),
                     "log_prob_old": logp, "advantage": adv.reshape(-1), "ret": ret.reshape(-1)}
            g = torch.Generator()
            g.set_state(cap["gen_state"])
            perms = ref_ppo.epoch_permutations(g, T * B, h["n_epochs"])
            if half_batch:
                half = T * B // 2
                batch = {k: v[:half] for k, v in batch.items()}
                perms = ref_ppo.epoch_permutations(g, half, h["n_epochs"])
            p, opt, stats, grad = ref_ppo.sweep(train, p, trained, opt, batch, perms, hp)
            mean = stats.mean(0)
            outs.append({"logp": logp.reshape(T, B), "value": values.reshape(T, B),
                         "adv": adv, "ret": ret, "loss": (float(mean[0]), float(mean[1])),
                         "params_out": {k: v.detach() for k, v in p.items()},
                         "m": opt.m, "v": opt.v})
            firsts.append(grad)
    return outs, firsts


def program_outputs(caps: list) -> list:
    return [{"logp": c["tr"]["log_prob"], "value": c["tr"]["value"],
             "adv": c["adv"].reshape(c["tr"]["value"].shape),
             "ret": c["ret"].reshape(c["tr"]["value"].shape), "loss": c["loss"],
             "params_out": c["params_out"], "m": c["m"], "v": c["v"]} for c in caps]


def _leaf_gap(got: dict, ref: dict, keys, base: dict = None) -> float:
    """The worst leaf's gap between the two sides' norms (of the change from
    ``base``), over the larger of the reference's norm of that leaf and of
    the median leaf."""
    if not keys:
        return 0.0

    def norm(d, k):
        x = d[k].double() - (base[k].double() if base is not None else 0.0)
        return float(torch.linalg.vector_norm(x))

    ref_n = {k: norm(ref, k) for k in keys}
    med = statistics.median(ref_n.values())
    return max(abs(norm(got, k) - ref_n[k]) / max(ref_n[k], med, 1e-30) for k in keys)


def median_gaps(got: list, ref: list, caps: list, firsts: list) -> dict:
    """The median leaf's gap of the sweep's change, worst over the
    iterations: a steadier reading than the worst leaf's."""
    out = {}
    for g, r, cap, first in zip(got, ref, caps, firsts):
        base = cap["params_in"]
        for name, keys in (("delta", moved_leaves(first)),
                           ("stats", [k for k in base if k not in first])):
            if not keys:
                continue
            per = [_leaf_gap(g["params_out"], r["params_out"], [k], base) for k in keys]
            out[name] = max(out.get(name, 0.0), statistics.median(per))
    return out


def moved_leaves(first_grad: dict) -> list:
    """The trained leaves whose first gradient in the reference is at least
    a thousandth of the median leaf's: the others (a conv bias under
    BatchNorm) move under Adam by round-off alone."""
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in first_grad.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def compare(got: list, ref: list, caps: list, firsts: list, h: dict) -> dict:
    """The numbers that decide ``correct``, of outputs ``got`` against the
    reference's ``ref`` (both shaped as ``program_outputs`` gives), each the
    worst over the iterations: the largest gaps of every move's
    log-probability, of values and of GAE; the sweep's mean loss relative
    to the reference's; by the worst leaf, the norms of the sweep's change
    of the parameters and of the Adam moments (``moved_leaves``), and of
    BatchNorm's running statistics; and by the median leaf, the gaps of the
    parameters' change and of the running statistics' (``median_gaps``)."""
    def gap(a, b):
        return float((a.double() - b.double()).abs().max())

    vf = h["vf_coef"]
    out = {
        "logp_gap": max(gap(g["logp"], r["logp"]) for g, r in zip(got, ref)),
        "value_gap": max(gap(g["value"], r["value"]) for g, r in zip(got, ref)),
        "gae_gap": max(max(gap(g["adv"], r["adv"]), gap(g["ret"], r["ret"]))
                       for g, r in zip(got, ref)),
        "loss_gap": max(abs((g["loss"][0] + vf * g["loss"][1]) - (r["loss"][0] + vf * r["loss"][1]))
                        / abs(r["loss"][0] + vf * r["loss"][1]) for g, r in zip(got, ref)),
        "delta_gap": 0.0, "moment_gap": 0.0,
    }
    medians = median_gaps(got, ref, caps, firsts)
    out["delta_median"] = medians["delta"]
    if "stats" in medians:
        out["stats_median"] = medians["stats"]
    for g, r, cap, first in zip(got, ref, caps, firsts):
        moved = moved_leaves(first)
        base = cap["params_in"]
        out["delta_gap"] = max(out["delta_gap"],
                               _leaf_gap(g["params_out"], r["params_out"], moved, base))
        out["moment_gap"] = max(out["moment_gap"], _leaf_gap(g["m"], r["m"], moved),
                                _leaf_gap(g["v"], r["v"], moved))
        buffers = [k for k in base if k not in first]
        if buffers:
            out["stats_gap"] = max(out.get("stats_gap", 0.0),
                                   _leaf_gap(g["params_out"], r["params_out"], buffers, base))
    return out


def env_moves(caps: list, sample_board: bool):
    """Check every transition of the record against the rules of Hex, each
    move from the board before it.  The record's legal mask is the empty
    cells.  A move onto a stone ends the game with reward 0 (the env's rule
    for an invalid move).  Otherwise a move that connects ends the game
    with reward +1; else the opponent plays one empty cell and the game goes
    on with reward 0, or the game ends with reward -1 and the opponent had a
    connecting cell, or with reward 0 after the opponent's invalid move.
    A finished game is followed by a fresh start.  Returns the count of
    transitions that break a rule and the count of invalid moves: a masked
    policy never draws a stone's cell, so each is a fault of the draw."""
    faults, invalid = 0, 0
    for i, cap in enumerate(caps):
        tr = cap["tr"]
        obs = tr["obs"].to(torch.int8)
        T, B, n, _ = obs.shape
        A = n * n
        nxt = torch.cat([obs[1:], cap["next_board"][None].to(torch.int8)])
        flat = obs.reshape(T, B, A)
        a = tr["action"].long()
        bad = (tr["legal"].reshape(T, B, A) != (flat == 0)).any(-1)
        bad |= (a < 0) | (a >= A)
        a = a.clamp(0, A - 1)
        r, done = tr["reward"], tr["done"]
        fresh = _fresh(nxt, sample_board)
        onto_stone = flat.gather(-1, a[..., None])[..., 0] != 0
        bad |= onto_stone & ~(done & (r == 0.0) & fresh)
        b1 = flat.clone()
        b1.scatter_(-1, a[..., None], -1)
        b1 = b1.reshape(T, B, n, n)
        legal_move = ~onto_stone
        won = legal_move & ref_env.connects(b1 == -1, 0)
        bad |= won & ~(done & (r == 1.0))
        diff = (nxt - b1).reshape(T, B, A)
        one_new = ((diff != 0).sum(-1) == 1) & ((diff == 1).sum(-1) == 1)
        one_new &= ((diff == 1) & (b1.reshape(T, B, A) == 0)).any(-1)
        cont = legal_move & ~won & ~done
        bad |= cont & ~(one_new & ~ref_env.connects(nxt == 1, 1) & (r == 0.0))
        ended = legal_move & ~won & done
        can_win = ref_env.winning_cells(b1, 1).reshape(T, B, A).any(-1)
        opp_invalid = ended & (r == 0.0) & fresh
        bad |= ended & ~(((r == -1.0) & can_win) | opp_invalid)
        bad |= done & ~fresh
        bad |= ~_balanced(obs)
        if i == 0:
            bad[0] |= ~_fresh(obs[0], sample_board)
        faults += int(bad.sum())
        invalid += int((onto_stone | opp_invalid).sum())
    return faults, invalid


def _balanced(board) -> torch.Tensor:
    d = (board == 1).flatten(-2).sum(-1) - (board == -1).flatten(-2).sum(-1)
    return (d == 0) | (d == 1)


def _fresh(board, sample_board: bool) -> torch.Tensor:
    """A start position: balanced, nobody connected, and off a sampled
    board at most the opponent's opening stone."""
    ok = _balanced(board) & ~ref_env.connects(board == -1, 0) & ~ref_env.connects(board == 1, 1)
    if not sample_board:
        ok &= ((board == -1).flatten(-2).sum(-1) == 0) & ((board == 1).flatten(-2).sum(-1) <= 1)
    return ok


def pool_faults(caps: list) -> int:
    total = 0
    for cap in caps:
        if "bank_out" not in cap:
            continue
        before, after, agent = cap["bank_in"], cap["bank_out"], cap["eval_params"]
        keys = list(before["params"])
        P = before["scores"].shape[0]
        changed = [i for i in range(P)
                   if any(not torch.equal(after["params"][k][i], before["params"][k][i])
                          for k in keys)
                   or float(after["scores"][i]) != float(before["scores"][i])]
        slot = changed[0] if len(changed) == 1 else None
        member = slot is not None and all(torch.equal(after["params"][k][slot], agent[k])
                                          for k in keys)
        best = all(torch.equal(after["best_params"][k], agent[k]) for k in keys)
        total += ref_pool.faults(cap["rewards"], before["scores"], before["best_score"],
                                 after["scores"], after["best_score"], slot, member, best,
                                 len(changed) <= 1)
    return total


def judge(caps: list, trained: tuple, model: work.Model, h: dict) -> dict:
    ref, firsts = follow(caps, trained, model, h, allow_tf32=False)
    faults, invalid = env_moves(caps, h["sample_board"])
    numbers = {"env_faults": faults, "invalid_moves": invalid, "pool_faults": pool_faults(caps)}
    numbers.update(compare(program_outputs(caps), ref, caps, firsts, h))
    return numbers


def control(ctx) -> dict:
    """The readings that the limits are set from, for one seed: the
    program's numbers; the control's (the reference in TF32 put in the
    program's place); and those of the planted faults: each sweep on half
    of the rows, a sweep that hands back its state unchanged, and one
    recorded move altered."""
    s = start(ctx)
    caps, trained, model, h = s.captured, s.trained, s.model, s.hyper
    s.state = s.algo = None
    ref, firsts = follow(caps, trained, model, h, allow_tf32=False)
    out = {"program": judge(caps, trained, model, h)}
    tf32, _ = follow(caps, trained, model, h, allow_tf32=True)
    out["control"] = compare(tf32, ref, caps, firsts, h)
    half, _ = follow(caps, trained, model, h, allow_tf32=False, half_batch=True)
    out["half_batch"] = compare(half, ref, caps, firsts, h)
    stale = program_outputs(caps)
    for c, cap in zip(stale, caps):
        c["params_out"], c["m"], c["v"] = cap["params_in"], cap["m_in"], cap["v_in"]
    out["unchanged"] = compare(stale, ref, caps, firsts, h)
    prog = program_outputs(caps)
    out["median_leaf"] = {name: median_gaps(got, ref, caps, firsts) for name, got in
                          (("program", prog), ("control", tf32), ("half_batch", half),
                           ("unchanged", stale))}
    tr = caps[1]["tr"]
    tr["action"][5, 3] = (tr["action"][5, 3] + 1) % tr["legal"].shape[-1]
    out["token"] = dict(zip(("env_faults", "invalid_moves"), env_moves(caps, h["sample_board"])))
    return out
