"""Driver of the match cells: ``scripts.match.run_match`` of
``hex_gym_env_tpu_torch``, called back to back, as ``scripts.tournament``
rates agents.

Set-up makes the two agents' weights from the seed and writes them as
``params:`` files under the run's directory; every match loads them by
spec.  Where the cell's mode draws, each match gets its own random words,
drawn by the harness from a seed derived from ``--seed`` and handed to
``run_match`` as its ``bits`` (the same draw ``run_match`` makes from a
seed), so the reference sees the same words.  One match before the window
warms every shape.  The window closes at the first match that ends after
``--seconds``.

A sample of the matches, drawn from the seed before the window among its
first ``check_from``, is recorded as it is played: each game's moves and
winner (``run_match``'s ``record``) and the logits of every forward of
both policies (a forward hook on each policy that ``run_match`` loads).
A sampled match that the window did not reach is played, recorded alike,
after it, outside its numbers.  The other matches run as users call
``run_match``, with no record.  After the window the plain reference
replays the sampled matches with the configuration's policy family: every
game's moves and winner, at every ply the gap by which the mover's chosen
move scores below the best one (its logit, plus the Gumbel noise of its
word where the mode draws), and the gap between the program's logits and
the reference's.  A run that judges fewer than ``check_matches`` matches,
or none, reads as failed on every number.

A traced run (``--trace 1``) profiles the window's first ``trace_matches``
matches on the device and, after the window, plays ``SPAN_MATCHES`` more
inside the program's own ``tracing(True)``, outside every other number, for
the ``program_span`` readers.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
import types

import torch

from benchmark import harness, weights, work
from benchmark.reference import env as ref_env
from benchmark.reference import models as ref_models
from hex_gym_env_tpu_torch.scripts import match as match_script
from hex_gym_env_tpu_torch.utils import profiling

SPAN_MATCHES = 10
# The std of the agents' drawn BatchNorm (``weights.make``): at its start
# values BatchNorm is all but the identity, and the check could not see a
# program that ignored its running statistics.
AGENT_BN_STD = 0.1


def words(seed: int, shape, device) -> torch.Tensor:
    """One match's random words: uniform int32 bit patterns from a
    generator on ``device`` seeded by ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-(2 ** 31), 2 ** 31, tuple(shape), dtype=torch.int32, generator=g,
                         device=device)


def draws(mode: str) -> tuple:
    """Which sides draw (A, B) in ``run_match``'s ``mode``."""
    return (mode in ("stochastic", "b-det"), mode in ("stochastic", "a-det"))


@contextlib.contextmanager
def logit_tap():
    """While open, every policy that ``run_match`` loads keeps the logits of
    each of its forwards: yields a list that gets one list per loaded
    policy, in load order (A, then B)."""
    inner = match_script.load_policy_params
    taps, handles = [], []

    def load(*args, **kwargs):
        model, params = inner(*args, **kwargs)
        kept = []
        taps.append(kept)
        handles.append(model.register_forward_hook(
            lambda module, inputs, out: kept.append(out[0].detach())))
        return model, params

    match_script.load_policy_params = load
    try:
        yield taps
    finally:
        match_script.load_policy_params = inner
        for h in handles:
            h.remove()


def make_agents(ctx, model) -> list:
    """``[(weights, spec)]`` of agents A and B, drawn from the seed and
    written as ``params:`` files under the run's directory."""
    wl = ctx.workload
    agents = []
    for side in ("a", "b"):
        w, _ = weights.make(model, harness.derive_seed(ctx.seed, "agent", side), ctx.device,
                            wl["init"]["action_gain"], wl["init"]["bias_std"], AGENT_BN_STD)
        path = os.path.join(ctx.run_dir, f"agent_{side}.pt")
        torch.save({k: v.cpu() for k, v in w.items()}, path)
        agents.append((w, f"params:{path}"))
    return agents


def program_spans(play, matches: int) -> dict:
    """The program's span table (``profiling.span_table``) over ``matches``
    calls of ``play`` inside its ``tracing(True)``."""
    profiling.take_spans()
    with profiling.tracing(True):
        for _ in range(matches):
            play()
    return profiling.span_table(profiling.take_spans())


def run(ctx) -> harness.Outcome:
    wl, conf = ctx.workload, ctx.config
    model = work.model_of(conf)
    family = conf["model"]["name"]
    n, games, mode = model.board, int(wl["games"]), wl["mode"]
    sut = types.SimpleNamespace(run_match=match_script.run_match)
    if ctx.hook is not None:
        ctx.hook(sut)
    (wa, spec_a), (wb, spec_b) = make_agents(ctx, model)
    shape = match_script.bits_shape(n, games)
    drawn = any(draws(mode))
    cuda = ctx.device.type == "cuda"
    g = torch.Generator().manual_seed(harness.derive_seed(ctx.seed, "check"))
    picks = set(torch.randperm(int(wl["check_from"]), generator=g)[: int(wl["check_matches"])]
                .tolist())

    def match_bits(i: int):
        if not drawn:
            return None
        return words(harness.derive_seed(ctx.seed, "match", i), shape, ctx.device)

    def play(i: int, record=None) -> None:
        sut.run_match(n, games, spec_a, spec_b, mode=mode, family_a=family, family_b=family,
                      device=ctx.device, bits=match_bits(i), record=record)

    def checked(i: int) -> dict:
        rec = {}
        with logit_tap() as taps:
            play(i, rec)
        rec["logits"] = taps
        return rec

    play(-1, {})
    spans = harness.Spans(cuda)
    trace = harness.Trace(ctx.run_dir, ["match"]) if ctx.trace and cuda else None
    if trace is not None:
        trace.warm()
        spans.wrap(sut, "run_match", "match")
    harness.check_imports()
    if cuda:
        torch.cuda.synchronize()
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    if trace is not None:
        trace.start()
    recorded, spans_s = {}, []
    while True:
        i = len(spans_s)
        t = time.perf_counter()
        if i in picks:
            recorded[i] = checked(i)
        else:
            play(i)
        spans_s.append((t, time.perf_counter()))
        if trace is not None and len(spans_s) >= int(wl["trace_matches"]):
            trace.stop()
        if time.perf_counter() >= t_start + ctx.seconds:
            break
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    if trace is not None:
        trace.stop()
    spans.unwrap_all()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx.log(f"setup {setup_s:.3f} s, {len(spans_s)} matches in {wall:.3f} s")
    late = sorted(picks - set(recorded))
    if late:
        ctx.log(f"matches {late} picked for the check are played after the window")
    for i in late:
        recorded[i] = checked(i)
    table = program_spans(lambda: play(-1), SPAN_MATCHES) if ctx.trace else None

    readings = harness.Readings(kind="match", program_spans=table)
    readings.unit_flops = work.match(model, games)
    clean = [b - a for a, b in spans_s if trace is None or trace.after_stop(a)]
    readings.unit_s = statistics.median(clean) if clean else None
    breakdown = busy = window = None
    if trace is not None:
        red = trace.result
        ctx.log(f"trace: {red['device_events']} device events, {red['attributed']} "
                f"tied to a launch; spans {red['calls']}")
        readings.busy_s = busy = red["busy_s"]
        readings.traced_units = red["calls"]["match"]
        readings.window_s = window = red["window_s"]
        breakdown = red["breakdown"]

    t = time.perf_counter()
    numbers = {"gap": 0.0, "winner_mismatch": 0, "logit_gap": 0.0}
    for i, rec in sorted(recorded.items()):
        got = judge(wa, wb, model, mode, games, match_bits(i), rec["actions"].to(ctx.device),
                    rec["winners"].to(ctx.device), rec["logits"])
        numbers = {k: (numbers[k] + got[k]) if k == "winner_mismatch" else max(numbers[k], got[k])
                   for k in numbers}
    ctx.log(f"reference check of matches {sorted(recorded)} {time.perf_counter() - t:.3f} s")
    if not recorded or len(recorded) < int(wl["check_matches"]):
        ctx.log(f"{len(recorded)} matches judged of {wl['check_matches']}: failed")
        numbers = {"gap": float("inf"), "winner_mismatch": games, "logit_gap": float("inf")}
    limits = wl.get("limits", {})
    checks = harness.compared(ctx, numbers, limits)
    failed = sum(1 for v, lim in checks.values() if lim is not None and not harness.within(v, lim))
    return harness.Outcome(
        end_to_end={"setup_s": setup_s, "games_per_s": len(spans_s) * games / wall},
        readings=readings, checks=checks, attempted=len(spans_s), failed=failed,
        memory_peak_bytes=memory_peak, busy_s=busy, window_s=window, breakdown=breakdown)


# -- the comparison with the reference ------------------------------------------------


def replay(wa: dict, wb: dict, model: work.Model, mode: str, games: int, bits=None,
           actions=None, taps=None, allow_tf32: bool = False) -> dict:
    """Play one match on plain boards: policy A holds seat ``game mod 2``,
    every ply the side to move picks over its masked logits, by argmax
    where it plays deterministically and by Gumbel-max with that ply's words
    (``bits[ply, side]``) where it draws; a move onto a stone ends the game
    with no winner (code 3, the env's rule for an invalid move), and a
    finished game stays as it is.  With ``actions`` (plies, games) the
    recorded moves are played instead and judged: ``gap`` is the largest
    amount by which a live game's recorded move scores below the best move.
    With ``taps`` (A's and B's logits of each ply, as ``logit_tap`` keeps
    them) ``logit_gap`` is the largest gap between those logits and the
    reference's.  Returns ``actions``, ``winners`` (seat, 3, or -1 while
    live), ``logits`` (A's and B's of each ply), ``gap`` and
    ``logit_gap``."""
    n, A = model.board, model.cells
    plies = A + 1
    dev = wa[next(iter(wa))].device
    noisy = draws(mode)
    world = torch.zeros((games, n, n), dtype=torch.int8, device=dev)
    to_move = torch.zeros(games, dtype=torch.long, device=dev)
    winner = torch.full((games,), -1, dtype=torch.long, device=dev)
    seat_a = torch.arange(games, device=dev) % 2
    played, kept, gap, logit_gap = [], ([], []), 0.0, 0.0
    with ref_models.precision(allow_tf32), torch.no_grad():
        for t in range(plies):
            live = winner < 0
            obs = ref_env.mover_frame(world, to_move)
            legal = obs.reshape(games, A) == 0
            a_moves = to_move == seat_a
            scores = []
            for side, w in enumerate((wa, wb)):
                logits = ref_models.policy_logits(model, w, obs)
                if taps is not None:
                    logit_gap = max(logit_gap, float((taps[side][t].double() - logits.double())
                                                     .abs().max()))
                kept[side].append(logits)
                s = torch.where(legal, logits, torch.full_like(logits, ref_models.MASKED))
                scores.append(s + ref_models.gumbel(bits[t, side]) if noisy[side] else s)
            score = torch.where(a_moves[:, None], scores[0], scores[1])
            if actions is None:
                act = torch.argmax(score, -1)
            else:
                bad = (actions[t] < 0) | (actions[t] >= A)
                act = actions[t].long().clamp(0, A - 1)
                best = score.max(-1).values
                mine = score.gather(1, act[:, None])[:, 0]
                g = torch.where(mine == best, torch.zeros_like(best), best - mine).double()
                g = torch.where(bad, torch.full_like(g, float("inf")), g)
                if bool(live.any()):
                    gap = max(gap, float(g[live].max()))
            played.append(act)
            cell = ref_env.world_cell(act, to_move, n)
            stone = torch.where(to_move == 0, -1, 1).to(torch.int8)
            flat = world.reshape(games, A)
            empty = flat.gather(1, cell[:, None])[:, 0] == 0
            place = live & empty
            flat.scatter_(1, cell[:, None],
                          torch.where(place, stone, flat.gather(1, cell[:, None])[:, 0])[:, None])
            won = torch.where(to_move == 0, ref_env.connects(world == -1, 0),
                              ref_env.connects(world == 1, 1))
            winner = torch.where(place & won, to_move, winner)
            winner = torch.where(live & ~empty, torch.full_like(winner, 3), winner)
            to_move = torch.where(live, 1 - to_move, to_move)
    return {"actions": torch.stack(played), "winners": winner, "logits": kept, "gap": gap,
            "logit_gap": logit_gap}


def judge(wa, wb, model, mode, games, bits, actions, winners, taps) -> dict:
    """The numbers of one recorded match against the reference's replay."""
    if any(len(side) != model.cells + 1 for side in taps) or len(taps) != 2:
        return {"gap": float("inf"), "winner_mismatch": games, "logit_gap": float("inf")}
    ref = replay(wa, wb, model, mode, games, bits, actions, taps)
    return {"gap": ref["gap"], "winner_mismatch": int((ref["winners"] != winners.long()).sum()),
            "logit_gap": ref["logit_gap"]}


def control(ctx) -> dict:
    """The readings that the limits are set from, for one seed and one
    match at the cell's size: the program's numbers; the control's (the
    reference in TF32 put in the program's place: its own moves, winners
    and logits, judged by the reference in float32); and those of a
    recorded move, a winner and a logit altered where they are produced."""
    wl = ctx.workload
    model = work.model_of(ctx.config)
    family = ctx.config["model"]["name"]
    n, games, mode = model.board, int(wl["games"]), wl["mode"]
    (wa, spec_a), (wb, spec_b) = make_agents(ctx, model)
    bits = words(harness.derive_seed(ctx.seed, "match", 0), match_script.bits_shape(n, games),
                 ctx.device) if any(draws(mode)) else None
    rec = {}
    with logit_tap() as taps:
        match_script.run_match(n, games, spec_a, spec_b, mode=mode, family_a=family,
                               family_b=family, device=ctx.device, bits=bits, record=rec)
    actions, winners = rec["actions"].to(ctx.device), rec["winners"].to(ctx.device)
    out = {"program": judge(wa, wb, model, mode, games, bits, actions, winners, taps)}
    ctl = replay(wa, wb, model, mode, games, bits, allow_tf32=True)
    out["control"] = judge(wa, wb, model, mode, games, bits, ctl["actions"], ctl["winners"],
                           ctl["logits"])
    altered = actions.clone()
    altered[3, 7] = (altered[3, 7] + 1) % (n * n)
    out["token"] = judge(wa, wb, model, mode, games, bits, altered, winners, taps)
    flipped = winners.clone()
    flipped[11] = 1 - flipped[11]
    out["answer"] = judge(wa, wb, model, mode, games, bits, actions, flipped, taps)
    nudged = [list(side) for side in taps]
    nudged[1][5] = nudged[1][5].clone()
    nudged[1][5][9, 4] += 1e-2
    out["logit"] = judge(wa, wb, model, mode, games, bits, actions, winners, nudged)
    return out
