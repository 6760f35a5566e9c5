#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the CUDA kernels from ``hex_gym_env_tpu_torch/csrc`` (nvcc, sm_90a);
2. holds each kernel against its plain PyTorch twin at the main path's
   shapes (7x7, 256 games, H = 64, 31 bank members, 128 steps), fed the same
   random bits: env ints and actions exactly equal, floats within ``TOL``;
   the env step K1 also at the eval opening's 30 games and at 13x13 (256
   lanes), from states with done, inactive and invalid rows and off-board
   actions; the random-legal rollout K7 at the benchmark's 8192 games,
   exactly equal to its twin over 64 steps with the same bits from the
   initial state and from a mid-game state with finished rows and a full
   board, the same at 13x13 and 3x3, and on its own Philox streams over 512
   steps: the invariants of the JAX package's test of the kernel, and mean
   games per env within 3 standard errors of the twin's on generator bits;
   the agent pass K2 on its agent image (built once per rollout, held
   exactly against its twin) at 7x7 with 256 and 30 games, at 13x13 and at
   9x9 on MLP-wide-deep, and on its own Philox streams (every action legal);
   the bank pass K3 on its bank image (built once per rollout, held exactly
   against its twin) at 7x7 with 256 and 30 games and at 13x13; the
   whole-rollout K4 with its opponent's logits held against the twin's too,
   and on its bf16 bank (``rollout_bank_bf16``) at the preset's and at a
   trained-scale bank, replayed exactly, with a control that the float32
   instance in the bf16 instance's place is refused; GAE (K5) exactly at
   (T, B) = (128, 256), (128, 30), (2048, 8) and (128, 4096);
   every kernel's call time (CUDA events around its wrapper's calls) and
   device time (its own kernels' self device time under ``torch.profiler``);
3. drives the main path: ``SelfplayRunner.run`` of the
   ``7x7_MLP-default_lr-0.0003`` preset three times through the
   whole-rollout kernel, replays the first rollout's record through the
   plain env ops, and prints transitions/s;
4. drives the scan path (env-step, agent and bank kernels) for 8 steps,
   the agent image built once and the bank image twice (asserted);
5. holds the learner's kernels against their twins on the main path's data:
   GAE (K5) exactly on a preset rollout, the PPO sweep (K6) for one grad
   step and for the preset's whole 80-step sweep from non-zero Adam moments,
   and for 8 steps on each other MLP tower of the preset grid (deeper,
   wider, ReLU); then prints the phase clocks of K4 and K6 at the preset
   (``[split this tree]``);
6. drives the training main path: ``Trainer.fit`` of the preset for three
   PPO iterations (rollout, GAE, sweep, eval + pool update each), with the
   launches of every iteration asserted, a checkpoint after iteration 2 that
   ``resume`` continues to bitwise the same parameters, and ``fit_fused``
   with the same eval cadence and result; prints seconds per iteration and
   the split by stage; then two iterations with ``rollout_bank_bf16`` (the
   bf16-bank K4 instance in the rollout and the eval), launches asserted;
7. trains the small config of ``tests/test_learning_curve.py`` for 24
   iterations on the card and asserts that test's thresholds;
8. profiles one preset iteration;
9. runs the env-throughput benchmark ``hex_gym_env_tpu_torch.bench`` (K7,
   K1 per step, the plain step; 3 samples each), which prints its JSON
   record, and asserts that every route reported a rate through its kernel;
10. runs one preset iteration with ``sample_board=True`` (the scan path:
   K1-K3 every step, K5, K6, and the plain eval loop through K1), with
   every launch count asserted and sampled boards checked;
11. runs the CNN preset ``CNN_lr-0.0003`` (``[cnn]``, 9x9, full width; see
   ``cnn_phase``): its gates, its forward at trained magnitudes against
   float64 on the CPU, its gathered opponent bank against the dense one,
   the bf16 bank layer by layer against the CPU's emulation with a float32
   control, the grouped conv against unfold + bmm, then three
   ``Trainer.fit`` iterations on the scan path (K1, K5; K2-K4 and K6 at 0
   launches, asserted), the BatchNorm statistics moving in every sweep, a
   bitwise resume, the stage split, the sweep's and the rollout's float32
   roofline and a profiled iteration;
12. plays the trained 7x7 agent (``models/agents/7x7_strict_sb3.pt``,
   held bitwise against the orbax snapshot where ``tensorstore`` imports)
   against a random player through ``scripts/match.run_match`` (``[match]``:
   4096 games in ``a-det`` and ``stochastic`` mode on the same words on the
   card and on the CPU, winners equal but for near ties, K1 at 50 launches a
   match and both sides' forwards through the forward kernel at 100, seconds
   and games/s), runs a three-player tournament, holds the match's forward
   kernel against its twin and the benchmark's check (``[mlp forward]``,
   ``--mlp-only`` below), and plays
   64 random games through ``compat.HexEnv`` on the card (K1 at one game a
   step) against the native engine, every step equal, plus one
   ``HexEnvV0`` and one selfplay-wrapper episode (``[compat]``);
13. drives the training entry points (``[train cli]``): ``python -m
   hex_gym_env_tpu_torch.scripts.train`` at the preset for 2 iterations in a
   subprocess (its printed line, ``metrics.jsonl``, the checkpoint), then
   ``--resume`` to a third, bitwise equal to a 3-iteration run in one go,
   ``scripts.export_agent`` to a ``params:`` file (bitwise the checkpoint's
   params) and a 1024-game ``scripts.match`` of that agent against
   ``random``; data-parallel training (``[distributed]``): ``scripts.train
   --multichip`` in its own NCCL group of one process, the same run in this
   process over an NCCL group of one (bitwise equal to it) with the launches
   of each iteration (K4 1, K5 1, K1 53, K6 0) and the sweep's all-reduces
   (one a grad step) asserted, the stage split by CUDA events, a profiled
   iteration and a bitwise resume, the sharded eval on the card against the
   CPU on the same words, and two ranks on the one card over gloo with CUDA
   tensors (params bitwise replicated, the eval's rewards at D = 2 equal
   D = 1's); and the other scripts (``[scripts]``): a ``play_cli`` session
   with the trained 7x7 agent, the port's graft ``entry()`` actor step 8
   times at batch 1024 (K1 8 launches) and ``dryrun_multichip(1)`` over
   NCCL, and ``play_gui`` built headless where ``pygame`` is installed;
14. runs the port's verify and measure tools (``[tools]``, each through
   its ``main``): ``scripts.selftest`` (K1 against the plain step; the
   Philox draws of K2, K3 and K4, its opponent openings too, legal, seeded
   and uniform by a chi-square; K4's opponent reply; a K4 record replayed;
   K5 bitwise; K6 on the ``pallas-fast`` schedule against its twin and the
   autograd replay), the 5x5 learning probe ``scripts.verify_train`` with
   ``pallas-fast`` and ``pallas`` (each above +0.5 against random),
   ``scripts.breakdown_bench`` at its defaults and at the 7x7 MLP preset's
   shape (every stage and its roofline), and ``scripts.scaling_bench
   --devices 1 --predict`` in an NCCL group of one (its collectives a train
   step and an eval asserted); a tool's non-zero exit fails the run;
15. prints the card, a JSON line of per-kernel numbers (with each kernel's
   launches per CNN iteration, per match, over the 64 ``HexEnv`` games, per
   distributed iteration, over the 8 graft actor steps and in the
   ``[tools]`` phase), and the final line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  It exits non-zero, printing no result, when no
CUDA device is present or the port's sources are not beside it.

    python3 chip_smoke.py --split-only LABEL

only builds the kernels and prints, on lines tagged ``[split LABEL]``, the
phase clocks of K6 (the preset's 80-step sweep) and K4 (the preset's
rollout) with their times: run from an unpacked older tree in the same call,
it gives the split before a change beside the split after it.

    python3 chip_smoke.py --env-kernels LABEL ROOT

only builds the kernels of the port found in the directory ROOT and prints,
on lines tagged ``[env LABEL]``, the call and device times of K7 (its
Philox streams at the benchmark's shape), K1 (7x7, 256 games), K5 (the
preset's T = 128, B = 256, on the rollout record's strided lanes), K3
and K2 (7x7, 256 games): with ROOT an unpacked older tree, the same measurement of
the kernels before a change.

    python3 chip_smoke.py --cnn-only

only builds the kernels and runs the ``[cnn]`` phase.

    python3 chip_smoke.py --match-only

only builds the kernels and runs the ``[match]`` and ``[compat]`` phases.

    python3 chip_smoke.py --train-only

only builds the kernels and runs the ``[train cli]``, ``[distributed]`` and
``[scripts]`` phases.  Their subprocesses load the kernels this process
built (``_build/``, keyed by the sources' hash).

    python3 chip_smoke.py --tools-only

only builds the kernels and runs the ``[tools]`` phase.

    python3 chip_smoke.py --mlp-only

only builds the kernels and runs the ``[mlp forward]`` phase: the match's
forward kernel against its twin, its times, the benchmark's own check of
4,096-game 7x7 matches, and a match's host time by span with and without
the kernel.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-5  # kernel vs twin: float32 sums in another order (FMA loops vs cuBLAS)
# K4 on the bf16 bank, held on the opponent's logits (which the kernel
# writes where asked) against its bf16 twin.  Both sum the same bf16
# products in float32, in other orders, so a logit row agrees within TOL,
# except where a hidden unit whose tanh lands an ulp or so apart on the card
# and in torch rounds to the neighbouring bf16 value: that row moves by
# about one bf16 ulp of the unit times the weights after it.  Such rows are
# rare: at most BF16_FLIP_SHARE of the rows may differ by more than TOL,
# and none by more than BF16_FLIP_REL (one bf16 ulp) of the largest logit.
# The float32 bank moves every row past TOL, so the float32 instance in the
# bf16 instance's place fails this check (a control asserts it).  An
# opponent's action may differ from the twin's only where the twin's two
# best scores lie within twice that row's logit error.
BF16_FLIP_SHARE = 0.01
BF16_FLIP_REL = 2.0**-8
# K5 exactly equal to its twin at these (T, B): the preset, the eval
# batch's 30 (a warp partly empty), the strict presets' T = 2048, and 4096
K5_SHAPES = ((128, 256), (128, 30), (2048, 8), (128, 4096))
# K3 against its twin at these (n, games): the scan path at the preset, the
# eval batch, and 13x13 (256 lanes), a board only the scan path takes
K3_SHAPES = ((7, 256), (7, 30), (13, 256))
# K2 against its twin at these (n, tower, games): the scan path at the
# preset, the eval batch, 13x13 (256 lanes), a board only the scan path
# takes, and the grid's widest tower (H 128, 4 layers, ReLU)
K2_SHAPES = ((7, "MLP-default", 256), (7, "MLP-default", 30), (13, "MLP-default", 256),
             (9, "MLP-wide-deep", 256))

N, B, H, POOL, T = 7, 256, 64, 30, 128
# K7 at the env-throughput benchmark's shape (hex_gym_env_tpu_torch/bench.py);
# against its twin with the same injected bits at K7_T_BITS steps (the bits
# are K7_T_BITS * K7_B * 128 words, 268 MB)
K7_B, K7_T, K7_T_BITS = 8192, 512, 64
# K7 also at 13x13 (256 lanes) and 3x3 with injected bits: (n, games, steps,
# plies of the mid-game start)
K7_OTHER_BOARDS = ((13, 512, 200, 149), (3, 4096, 64, 6))


def k7_ops_per_game_step(F: int) -> int:
    """K7's integer operations per game and step (its note in hex_kernels.cu):
    the score and the max over the F cells, and the relabel's 8 compares and
    8 ors and the select over the F + 4 real lanes."""
    return 2 * F + 17 * (F + 4)


K7_OLD_OPS_PER_LANE_STEP = 19  # the earlier count: 19 operations on each of the L lanes, padding too
# the kernels' names in torch.profiler's device events, for their device time
KERNEL_NAMES = {
    "k1_step": ("step_kernel",), "k2_agent": ("agent_kernel",),
    "k2_agent_image": ("tower_image_kernel",), "k3_bank": ("bank_kernel",),
    "k3_bank_image": ("tower_image_kernel",),
    "k4_rollout": ("tower_image_kernel", "rollout_kernel"),
    "k4_rollout_bf16": ("tower_image_kernel", "rollout_kernel"), "k5_gae": ("gae_kernel",),
    "k6_ppo": ("ppo_kernel",), "k7_random_rollout": ("random_rollout_kernel",),
}
PRESET = "7x7_MLP-default_lr-0.0003"
# K6 vs its twin: float32 sums in another order (fmaf loops and a fixed
# slot-order reduction vs cuBLAS); measured ~2e-7 relative after one grad
# step and ~6e-8 abs on params after the whole preset sweep (H100 80GB HBM3, 700 W).
# Each of p, m, v and the stats is held relative to its own largest value, so
# an error in v (whose values are ~1e-5) cannot hide under an absolute bound.
K6_STEP_REL = 1e-5  # one grad step: max abs error / max abs value, each of p, m, v, stats
K6_SWEEP_REL = 1e-4  # a multi-step sweep: the same, with stats averaged over the steps
OTHER_MLPS = ("MLP-deep", "MLP-wide-deep")  # the other presets' towers that take K6
CNN_PRESET = "CNN_lr-0.0003"
# the CNN's float32 on the card against the same module in float64 on the
# CPU, and its gathered opponent pass against the dense pass and a
# selection: the largest error over the largest logit (float32 sums in
# another order; at trained magnitudes the logits run to 1e5)
CNN_REL = 1e-5
CNN_POSITIONS = 512  # boards of the forward check, each after its own number of random plies
# The CNN's bf16 bank, layer by layer from the same input, against the
# CPU's emulation: every activation equal but at most this share, each one
# bf16 ulp apart (a float32 sum in another order across a rounding
# boundary).  End to end no logit beyond BF16_FLIP_REL of the largest; K4's
# BF16_FLIP_SHARE of rows does not apply: a flipped activation moves the
# next layer's sums, which flip others, through five rounded layers.
CNN_BF16_LAYER_SHARE = 1e-3


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Host-clock microseconds per call of ``fn`` over ``reps`` calls, after
    one warm-up, not counting the wait for the work they queue."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def device_ms(fn, names, reps: int) -> float:
    """The device time per call of ``fn`` of the kernels ``names``: their
    self device time under ``torch.profiler`` over ``reps`` calls, after one
    warm-up, so the host's work between launches is not in it.  A session
    has come back once without the device's records for a kernel that the
    next sessions traced (H100 machine), so up to three sessions are taken;
    fails where none shows device time."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    pattern = re.compile(r"(?:^|[\s:])(?:%s)[(<]" % "|".join(names))
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = 0.0
        for ev in prof.key_averages():
            if pattern.search(ev.key):
                t = getattr(ev, "self_device_time_total", None)
                us += t if t is not None else getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            return us / reps / 1e3
        print(f"chip_smoke: a torch.profiler session showed no device time for {names}",
              file=sys.stderr)
    fail(f"torch.profiler shows no device time for {names}")


def k1_inputs(topo, B: int, plies: int, g):
    """A K1 input on the card: ``plies`` random legal plies of the plain env
    from the empty board, then a tenth of the rows ended by an invalid move;
    actions over [-8, L + 8), so occupied cells, padding and virtual lanes,
    cells off the board and negative ones; a fifth of the rows inactive.
    ``g`` is a CPU generator."""
    import torch
    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.ops import masked

    dev = torch.device("cuda")
    A = topo.num_cells
    state = hex_env.initial_state(topo, B, dev)
    for _ in range(plies):
        legal = hex_env.legal_mask(topo, state)
        a = masked.sample(masked.draw_bits(g, (B, A), dev), torch.zeros((B, A), device=dev), legal)
        state, _ = hex_env.step(topo, state, a)
    end = (torch.rand((B,), generator=g) < 0.1).to(dev)
    state, _ = hex_env.step(topo, state, torch.full((B,), -1, dtype=torch.int32, device=dev), end)
    actions = torch.randint(-8, topo.lanes + 8, (B,), generator=g).to(dev, torch.int32)
    active = (torch.rand((B,), generator=g) < 0.8).to(dev)
    return state, actions, active


def k7_mid_state(topo, B: int, plies: int, gen):
    """``plies`` random legal plies of the plain env on the card (finished
    games stay done), then row 0 replaced by a full board (no empty cell)."""
    import dataclasses

    import torch
    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.ops import masked

    dev = torch.device("cuda")
    state = hex_env.initial_state(topo, B, dev)
    for _ in range(plies):
        legal = hex_env.legal_mask(topo, state)
        a = masked.sample(masked.draw_bits(gen, legal.shape, dev),
                          torch.zeros(legal.shape, device=dev), legal)
        state, _ = hex_env.step(topo, state, a)
    n = topo.n
    yy, xx = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    full_board = torch.where((yy + xx) % 2 == 0, -1, 1).to(torch.int8)[None].to(dev)
    full = hex_env.state_from_boards(topo, full_board)
    state = dataclasses.replace(state, **{
        name: torch.cat([getattr(full, name), getattr(state, name)[1:]])
        for name in ("stones", "labels", "to_move", "done", "winner", "empty", "move_count")})
    n_done = int(state.done.sum())
    if not 0 < n_done < B or int(state.empty[0]) != 0:
        fail(f"the K7 {n}x{n} mid-game state has {n_done} finished rows and row 0 empty "
             f"{state.empty[0]}")
    return state


def k7_exact(topo, start, T: int, bits, label: str) -> None:
    """K7 from ``start`` on injected ``bits`` must give exactly its twin's
    state and games, and a full-board row 0 must reset."""
    import torch
    from hex_gym_env_tpu_torch.ops import step_kernel

    k_out, k_games = step_kernel.random_rollout_cuda(topo, start, T, bits=bits)
    t_out, t_games = step_kernel.random_rollout_twin(topo, start, T, bits=bits)
    torch.cuda.synchronize()
    B, n = start.batch_size, topo.n
    for name in ("stones", "labels", "to_move", "done", "winner", "empty", "move_count"):
        k, tw = getattr(k_out, name), getattr(t_out, name)
        if not torch.equal(k, tw):
            rows = int((k != tw).reshape(B, -1).any(-1).sum())
            fail(f"K7 {n}x{n} from the {label} state: {name} differs from the twin in {rows} games")
    if not torch.equal(k_games, t_games):
        fail(f"K7 {n}x{n} from the {label} state: games differ from the twin")
    if int(start.empty[0]) == 0 and int(k_games[0]) < 1:
        fail(f"K7 {n}x{n} did not reset the full-board row")
    print(f"[K7 random rollout] {n}x{n} (L {topo.lanes}) from the {label} state "
          f"({int(start.done.sum())} done rows): state and games exactly the twin's over {T} "
          f"steps x {B} games; {int(k_games.sum())} games finished, row 0 reset "
          f"{int(k_games[0])} times")


def k3_case(n: int, b: int, g) -> dict:
    """K3's inputs on the card at n x n with b games, from the CPU generator
    ``g``: the preset's tower (MLP-default) with POOL random members and a
    best, positions after random legal plies of the plain env (some games
    over), members drawn over all P1 with the best also by ``use_best``,
    and injected bits.  ``op`` and ``twin_op`` are the kernel's and the
    twin's bank operands: ``pk.bank_operand`` where the port has it, else
    (an older tree, whose K3 reads the stacked bank) the stack itself."""
    import torch
    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.core.topology import get_topology
    from hex_gym_env_tpu_torch.models import make_policy
    from hex_gym_env_tpu_torch.ops import masked
    from hex_gym_env_tpu_torch.ops import policy_kernel as pk
    from hex_gym_env_tpu_torch.train.bank import OpponentBank, init_bank

    dev = torch.device("cuda")
    topo = get_topology(n)
    A = topo.num_cells
    model = make_policy("MLP-default", A, generator=g)
    snaps = [make_policy("MLP-default", A, generator=g).state_dict() for _ in range(POOL + 1)]
    params = {k: v.detach().to(dev) for k, v in model.state_dict().items()}
    bank = OpponentBank(
        params={k: torch.stack([s[k] for s in snaps[:POOL]]).to(dev) for k in params},
        scores=init_bank(params, POOL).scores,
        best_params={k: v.to(dev) for k, v in snaps[POOL].items()},
        best_score=torch.zeros(()))
    pol, twin = pk.PolicyOps(model, "pallas"), pk.PolicyOps(model, "lax")
    stacked = pol.stack_bank(bank)
    state = hex_env.initial_state(topo, b, dev)
    for _ in range(24 if n <= 7 else 60):
        legal = hex_env.legal_mask(topo, state)
        a = masked.sample(masked.draw_bits(g, (b, A), dev), torch.zeros((b, A), device=dev), legal)
        state, _ = hex_env.step(topo, state, a)
    member = torch.randint(0, POOL + 1, (b,), generator=g).to(dev, torch.int32)
    operand = hasattr(pk, "bank_operand")
    return dict(
        topo=topo, pol=pol, twin=twin, stacked=stacked,
        op=pk.bank_operand(stacked, pol.dims, "pallas") if operand else stacked,
        twin_op=pk.BankOperand(stacked) if operand else stacked,
        obs=hex_env.observe(topo, state), legal=hex_env.legal_mask(topo, state),
        use_best=torch.rand((b,), generator=g).to(dev) < 0.3, member=member,
        bits=masked.draw_bits(g, (b, A), dev), done=int(state.done.sum()))


def k3_call(c: dict, pol=None, generator=None):
    """A closure of one K3 pass on case ``c`` (its injected bits, or the
    Philox streams seeded from ``generator``) by ``pol`` (the kernel's by
    default; the twin's with ``c["twin"]``)."""
    op = c["op"] if pol is None else c["twin_op"]
    pol = c["pol"] if pol is None else pol
    bits = None if generator is not None else c["bits"]
    return lambda: pol.bank_act(op, c["use_best"], c["member"], c["obs"], c["legal"],
                                generator, bits)


def k2_case(n: int, family: str, b: int, g) -> dict:
    """K2's inputs on the card at n x n with b games, from the CPU generator
    ``g``: a random ``family`` agent with its action head widened 100x (the
    orthogonal init's gain of 0.01 gives near-equal logits, which no check
    bites on), positions after random legal plies of the plain env (some
    games over), and injected bits.  ``op`` and ``twin_op`` are the kernel's
    and the twin's agent operands: ``pk.agent_operand`` where the port has
    it, else (an older tree, whose K2 reads the packed agent) the packing."""
    import torch
    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.core.topology import get_topology
    from hex_gym_env_tpu_torch.models import make_policy
    from hex_gym_env_tpu_torch.ops import masked
    from hex_gym_env_tpu_torch.ops import policy_kernel as pk

    dev = torch.device("cuda")
    topo = get_topology(n)
    A = topo.num_cells
    model = make_policy(family, A, generator=g)
    params = {k: v.detach().to(dev) * (100.0 if k.startswith("action_head") else 1.0)
              for k, v in model.state_dict().items()}
    pol, twin = pk.PolicyOps(model, "pallas"), pk.PolicyOps(model, "lax")
    packed = pol.pack_agent(params)
    state = hex_env.initial_state(topo, b, dev)
    for _ in range(24 if n <= 7 else 60):
        legal = hex_env.legal_mask(topo, state)
        a = masked.sample(masked.draw_bits(g, (b, A), dev), torch.zeros((b, A), device=dev), legal)
        state, _ = hex_env.step(topo, state, a)
    operand = hasattr(pk, "agent_operand")
    return dict(
        topo=topo, pol=pol, twin=twin, packed=packed,
        op=pk.agent_operand(packed, pol.dims, "pallas") if operand else packed,
        twin_op=pk.AgentOperand(packed) if operand else packed,
        obs=hex_env.observe(topo, state), legal=hex_env.legal_mask(topo, state),
        bits=masked.draw_bits(g, (b, A), dev), done=int(state.done.sum()))


def k2_call(c: dict, pol=None, generator=None):
    """A closure of one K2 pass on case ``c`` (its injected bits, or the
    Philox streams seeded from ``generator``) by ``pol`` (the kernel's by
    default; the twin's with ``c["twin"]``)."""
    op = c["op"] if pol is None else c["twin_op"]
    pol = c["pol"] if pol is None else pol
    bits = None if generator is not None else c["bits"]
    return lambda: pol.agent_act(op, c["obs"], c["legal"], generator, bits)


def k2_check(n: int, family: str, b: int, g, gen_k):
    """K2 on ``k2_case(n, family, b, g)`` against its twin: the agent image
    exactly the twin's (one launch), every action equal but at near ties,
    masked logits, values and log-probs within TOL; on its Philox streams
    (seeded from ``gen_k``) every action legal.  Returns (max error,
    near-tie rows, the case)."""
    import torch
    from hex_gym_env_tpu_torch.ops import cuda_lib, masked
    from hex_gym_env_tpu_torch.ops import policy_kernel as pk

    c = k2_case(n, family, b, g)
    d = c["pol"].dims
    tag = f"K2 {n}x{n} {family} B {b}"
    cuda_lib.reset_launches()
    image = pk.agent_operand(c["packed"], d, "pallas").image
    if cuda_lib.launches["k2_agent_image"] != 1 or not torch.equal(
            image, pk.agent_image_twin(c["packed"], d)):
        fail(f"{tag}: the agent image differs from its twin")
    kr = k2_call(c)()
    tr = k2_call(c, c["twin"])()
    torch.cuda.synchronize()
    top2 = torch.topk(tr.masked_logits + masked.gumbel(c["bits"]), 2, dim=-1).values
    ties = check_actions(tag, kr.action, tr.action, top2[:, 0] - top2[:, 1])
    ok = kr.action == tr.action
    err = max(max_err(kr.masked_logits, tr.masked_logits), max_err(kr.value, tr.value),
              max_err(kr.log_prob[ok], tr.log_prob[ok]))
    if err > TOL:
        fail(f"{tag}: floats differ by {err}")
    kp = k2_call(c, generator=gen_k)()
    picked = torch.take_along_dim(c["legal"], kp.action.long()[:, None], -1)
    if not bool(picked.all()) or not bool(torch.isfinite(kp.log_prob).all()):
        fail(f"{tag} (Philox): an illegal action or a non-finite log-prob")
    print(f"[K2 agent] {tag}: image exact, max err {err:.3g}, near-tie rows {ties}, "
          f"{c['done']} games over; Philox actions legal")
    return err, ties, c


def k5_case(T: int, B: int, g):
    """K5's inputs on the card, as the rollout record gives them: rewards
    and values strided lanes of a (T, B, 8) float32 record, rewards in
    {-1, 0, 1} where a tenth of the rows end, dones there."""
    import torch

    dev = torch.device("cuda")
    flts = torch.randn((T, B, 8), generator=g).to(dev)
    dones = (torch.rand((T, B), generator=g) < 0.1).to(dev)
    flts[..., 2] = torch.where(dones, torch.sign(flts[..., 2]), 0.0)
    return (flts[..., 2], flts[..., 1], dones, torch.randn((B,), generator=g).to(dev), 0.99, 0.95)


def env_kernel_times(label: str) -> dict:
    """Call time (CUDA events around the wrapper's calls) and device time
    (``device_ms``) of K7 on its Philox streams at the benchmark's shape,
    seeded from a CPU generator, of K1 at 7x7, B = 256, of K5 at the
    preset's shape, and of K3 and K2 at 7x7, B = 256 (Philox), through the
    package first on ``sys.path``; prints them on lines tagged ``[env
    LABEL]``."""
    import torch
    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.core.topology import get_topology
    from hex_gym_env_tpu_torch.ops import gae_kernel, step_kernel

    topo = get_topology(N)
    init7 = hex_env.initial_state(topo, K7_B, torch.device("cuda"))
    gen = torch.Generator().manual_seed(77)

    def k7():
        return step_kernel.random_rollout_cuda(topo, init7, K7_T, generator=gen)

    state, actions, active = k1_inputs(topo, B, 24, torch.Generator().manual_seed(31))

    def k1():
        return step_kernel.step_cuda(topo, state, actions, active)

    gae_args = k5_case(T, B, torch.Generator().manual_seed(41))

    def k5():
        return gae_kernel.compute_gae_cuda(*gae_args)

    k3 = k3_call(k3_case(N, B, torch.Generator().manual_seed(43)),
                 generator=torch.Generator().manual_seed(44))
    k2 = k2_call(k2_case(N, "MLP-default", B, torch.Generator().manual_seed(45)),
                 generator=torch.Generator().manual_seed(46))
    out = {"k7": (cuda_ms(k7, 10), device_ms(k7, KERNEL_NAMES["k7_random_rollout"], 10)),
           "k1": (cuda_ms(k1, 200), device_ms(k1, KERNEL_NAMES["k1_step"], 200)),
           "k5": (cuda_ms(k5, 200), device_ms(k5, KERNEL_NAMES["k5_gae"], 200)),
           "k3": (cuda_ms(k3, 200), device_ms(k3, KERNEL_NAMES["k3_bank"], 200)),
           "k2": (cuda_ms(k2, 200), device_ms(k2, KERNEL_NAMES["k2_agent"], 200))}
    print(f"[env {label}] K7 Philox {K7_T} steps x {K7_B} games: call {out['k7'][0]:.4f} ms, "
          f"device {out['k7'][1]:.4f} ms; K1 7x7 B {B}: call {out['k1'][0]:.5f} ms, "
          f"device {out['k1'][1]:.5f} ms")
    print(f"[env {label}] K5 T {T} B {B}: call {out['k5'][0]:.5f} ms, device {out['k5'][1]:.5f} ms; "
          f"K3 7x7 B {B}: call {out['k3'][0]:.5f} ms, device {out['k3'][1]:.5f} ms")
    print(f"[env {label}] K2 7x7 B {B}: call {out['k2'][0]:.5f} ms, device {out['k2'][1]:.5f} ms")
    from hex_gym_env_tpu_torch.ops import cuda_lib

    if hasattr(cuda_lib, "env_plan"):  # trees whose K1 and K7 run a warp per game
        print(f"[env {label}] launch shape (games per CTA, CTAs per SM, registers): K7 "
              f"{cuda_lib.env_plan('k7_random_rollout', K7_B, topo.lanes)}, K1 "
              f"{cuda_lib.env_plan('k1_step', B, topo.lanes)}")
    return out


def bound_ms(n_bytes: float, flops: float):
    """The least time for the work: bytes over the card's memory rate or
    operations over its float32 rate (``utils/roofline.py``), the larger."""
    from hex_gym_env_tpu_torch.utils import roofline

    t_bytes = n_bytes / roofline.PEAK_HBM_BPS * 1e3
    t_ops = flops / roofline.PEAK_FLOPS_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_actions(name, got, want, margins, tol=TOL):
    """Actions must be equal, except where the twin's two best scores lie
    within ``tol`` of each other (a float-order near tie).  Returns the
    number of such rows."""
    diff = (got != want).nonzero().flatten()
    if len(diff) and not bool((margins[diff] < tol).all()):
        fail(f"{name}: {len(diff)} actions differ, not all at near ties")
    return len(diff)


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def rel_errs(got, want):
    """Max abs error over max abs value of each of (p, m, v, stats); stats
    are averaged over the grad steps first when there are several."""
    pairs = list(zip(got[:3], want[:3]))
    pairs.append((got[3].mean(0), want[3].mean(0)) if got[3].shape[0] > 1 else (got[3], want[3]))
    return [max_err(k, t) / max(float(t.abs().max()), 1e-30) for k, t in pairs]


def device_profile(fn):
    """Run ``fn`` once under ``torch.profiler``; returns (wall us, device-busy
    us, top kernels by device time, top host ops by self CPU time).  Busy
    time is the union of the device's own events' intervals (kernels,
    copies): a host op that launches a library's kernels
    (``aten::cudnn_convolution``) carries their device time too, and cuDNN
    runs some convolutions as kernels that overlap, so a sum would count
    time twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_us, host_us = {}, {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            us = getattr(ev, "self_device_time_total", None)
            device_us[ev.key] = us if us is not None else getattr(ev, "self_cuda_time_total", 0.0)
        else:
            host_us[ev.key] = ev.self_cpu_time_total
    busy, end = 0.0, float("-inf")
    for a, b in sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                       if ev.device_type == DeviceType.CUDA):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    top_host = sorted(host_us.items(), key=lambda kv: -kv[1])[:5]
    return wall_us, busy, top, top_host


def phase_splits(label: str) -> dict:
    """Time K4's preset rollout (Philox) and K6's preset sweep on that
    rollout's record, each once more with its phase clock on, and print
    the per-phase split; returns {kernel: (ms, split rows)}."""
    import torch
    from hex_gym_env_tpu_torch.core.topology import get_topology
    from hex_gym_env_tpu_torch.experiments import get_config
    from hex_gym_env_tpu_torch.models import make_policy
    from hex_gym_env_tpu_torch.ops import cuda_lib
    from hex_gym_env_tpu_torch.ops import policy_kernel as pk
    from hex_gym_env_tpu_torch.ops import ppo_kernel as pkk
    from hex_gym_env_tpu_torch.ops import rollout_kernel as rk
    from hex_gym_env_tpu_torch.train import ppo
    from hex_gym_env_tpu_torch.train.bank import OpponentBank, init_bank
    from hex_gym_env_tpu_torch.train.rollout import SelfplayRunner
    from hex_gym_env_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    tcfg = get_config(PRESET)
    cfg, pcfg = tcfg.selfplay, tcfg.ppo
    topo = get_topology(N)
    A = topo.num_cells
    g = torch.Generator().manual_seed(4321)
    model = make_policy(cfg.policy, A, generator=g)
    params = {k: v.detach().to(dev) for k, v in model.state_dict().items()}
    snaps = [make_policy(cfg.policy, A, generator=g).state_dict() for _ in range(POOL + 1)]
    bank0 = init_bank(params, POOL)
    bank = OpponentBank(
        params={k: torch.stack([s[k] for s in snaps[:POOL]]).to(dev) for k in params},
        scores=bank0.scores, best_params={k: v.to(dev) for k, v in snaps[POOL].items()},
        best_score=bank0.best_score)
    pol = pk.PolicyOps(model, "pallas")
    d = pol.dims
    packed = pol.pack_agent(params)
    stacked = pol.stack_bank(bank)
    table = rk.first_move_table(stacked, d)
    carry = SelfplayRunner(topo, model, cfg, device=dev).init_carry(bank, g)
    gk = torch.Generator().manual_seed(5)

    def rollout(timers=None):
        return rk.fused_rollout(topo, pol, packed, stacked, table, carry.env, carry.agent_seat,
                                carry.use_best, carry.opp_idx, T, cfg.best_prob, True,
                                generator=gk, timers=timers)

    def timed_once(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    out = {}
    k4_ms = cuda_ms(rollout, 10)
    timers = torch.zeros((B, T, rk.ROLLOUT_MARKS), dtype=torch.int64, device=dev)
    rec, total = timed_once(lambda: rollout(timers))
    rows = profiling.phase_split(timers.cpu().numpy(), rk.ROLLOUT_PHASES, total)
    out["k4_rollout"] = (k4_ms, rows)
    print(f"[split {label}] K4 preset rollout ({T} steps x {B} games): {k4_ms:.4f} ms "
          f"({total:.4f} ms clocked); per step, median (max) over games: "
          + profiling.format_split(rows))

    n, mbs = T * B, pcfg.minibatch_size
    g6 = torch.Generator().manual_seed(11)
    obs6 = rec.obs.reshape(n, A).contiguous()
    flt6 = torch.stack([
        rec.ints[..., rk.I_ACTION].reshape(n).to(torch.float32), rec.flts[..., rk.F_LOGP].reshape(n),
        torch.randn(n, generator=g6).to(dev), torch.randn(n, generator=g6).to(dev)], 1).contiguous()
    mu = {k: (torch.randn(v.shape, generator=g6) * 1e-3).to(dev) for k, v in params.items()}
    nu = {k: (torch.rand(v.shape, generator=g6) * 1e-5).to(dev) for k, v in params.items()}
    packed3 = (pol.pack_agent(params), pol.pack_agent(mu), pol.pack_agent(nu))
    idx = ppo.minibatch_indices(ppo.epoch_permutations(g6, n, pcfg.n_epochs), n, mbs)
    idx = idx.to(dev, torch.int32).contiguous()
    G = idx.shape[0]
    bias = ppo.bias_corrections(37, G, dev)

    def sweep(timers=None):
        return pkk.sweep(pol, pcfg, *packed3, obs6, flt6, idx, bias, timers=timers)

    k6_ms = cuda_ms(sweep, 3)
    grid = cuda_lib.ppo_plan(d.F, d.H, d.A, d.n_layers, mbs)[0]
    timers = torch.zeros((grid, G, pkk.PPO_MARKS), dtype=torch.int64, device=dev)
    _, total = timed_once(lambda: sweep(timers))
    rows = profiling.phase_split(timers.cpu().numpy(), pkk.PPO_PHASES, total)
    out["k6_ppo"] = (k6_ms, rows)
    print(f"[split {label}] K6 preset sweep ({G} steps, {grid} CTAs): {k6_ms:.4f} ms "
          f"({total:.4f} ms clocked), {1000 * k6_ms / G:.2f} us per grad step; per step, median "
          "(max) over CTAs: " + profiling.format_split(rows))
    return out


def cnn_trained_scale(model, g) -> dict:
    """A ``CnnPolicy`` state dict at trained magnitudes, on the CPU: conv and
    dense weights and biases N(0, 0.3^2), BatchNorm scale 1 + N(0, 0.05^2)
    and bias N(0, 0.05^2), running mean N(0, 0.3^2), variance U(0.5, 1.5)."""
    import torch

    out = {}
    for k, v in model.state_dict().items():
        z = torch.randn(v.shape, generator=g)
        if k.endswith(".bn.var"):
            out[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith(".bn.mean"):
            out[k] = 0.3 * z
        elif k.endswith(".bn.scale"):
            out[k] = 1.0 + 0.05 * z
        elif k.endswith(".bn.bias"):
            out[k] = 0.05 * z
        else:
            out[k] = 0.3 * z
    return out


def random_positions(topo, n_pos: int, max_plies: int, g, dev):
    """``n_pos`` mover-frame boards on ``dev``, board b after its own number
    of random legal plies, uniform in [0, ``max_plies``) (a game that ends
    first keeps its final board)."""
    import torch
    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.ops import masked

    state = hex_env.initial_state(topo, n_pos, dev)
    stop = torch.randint(0, max_plies, (n_pos,), generator=g).to(dev)
    out = torch.zeros((n_pos, topo.n, topo.n), dtype=torch.int8, device=dev)
    zeros = torch.zeros((n_pos, topo.num_cells), device=dev)
    for t in range(max_plies):
        out = torch.where((stop == t)[:, None, None], hex_env.observe(topo, state), out)
        legal = hex_env.legal_mask(topo, state)
        a = masked.sample(masked.draw_bits(g, legal.shape, dev), zeros, legal)
        state, _ = hex_env.step(topo, state, a)
    return out


def unfold_conv_stack(filters, obs, n: int):
    """The gathered conv stack as ``F.unfold`` + ``torch.bmm``: the same
    function as ``models/cnn.gathered_conv_stack`` (one grouped conv per
    layer), the other way of computing it, timed beside it."""
    import torch
    import torch.nn.functional as F

    B = obs.shape[0]
    x = obs.to(torch.float32).reshape(B, 1, n, n)
    for w, b in filters:
        cout = w.shape[0] // B
        y = torch.baddbmm(b.reshape(B, cout, 1), w.reshape(B, cout, -1),
                          F.unfold(x, 3, padding=1))
        x = torch.relu(y).reshape(B, cout, n, n)
    return x.permute(0, 2, 3, 1).reshape(B, -1)


def bf16_layer_check(got, want):
    """(share of activations that differ, True if each difference is at most
    one bf16 ulp, or a ReLU zero against a value within float32 rounding of
    zero)."""
    got, want = got.double().cpu(), want.double().cpu()
    diff = (got - want).abs()
    ok = diff <= 2.0**-7 * got.abs().maximum(want.abs()) + 1e-6 * float(want.abs().max())
    return float((diff > 0).double().mean()), bool(ok.all())


def cnn_phase(dev) -> dict:
    """[cnn]: the CNN preset ``CNN_lr-0.0003`` (9x9, full width) on the card.

    Its path takes no kernel of its own: the scan rollout with the env step
    K1 three times a step, GAE K5 once an iteration, the plain eval loop
    with K1, and the model's convolutions and products through cuDNN and
    cuBLAS in full float32 (the package's ``models/cnn.full_float32``; the
    phase restores cuDNN's defaults, TF32 allowed and autotuning on, so
    nothing but that scope keeps it there).  Gates; the forward against
    float64 on the CPU; the gathered bank against the dense one, the bf16
    bank against the CPU's emulation with a float32 control, the two ways
    of computing the gathered convs; then ``Trainer.fit`` for three
    iterations with the launches of each asserted, the BatchNorm statistics
    moving in each sweep, a bitwise resume from the iteration-2 checkpoint,
    the split by stage and a profiled iteration.  Returns the launches of
    each kernel per iteration, as asserted."""
    import dataclasses

    import numpy as np
    import torch
    from hex_gym_env_tpu_torch.core.topology import get_topology
    from hex_gym_env_tpu_torch.experiments import get_config
    from hex_gym_env_tpu_torch.models import cnn
    from hex_gym_env_tpu_torch.ops import cuda_lib
    from hex_gym_env_tpu_torch.train.bank import sample_opponents
    from hex_gym_env_tpu_torch.train.rollout import SelfplayRunner
    from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO
    from hex_gym_env_tpu_torch.train.trainer import Trainer
    from hex_gym_env_tpu_torch.utils import roofline
    from hex_gym_env_tpu_torch.utils.metrics import MetricsLogger

    t_phase = time.perf_counter()

    def stamp(section):
        print(f"[cnn] {section} done, {time.perf_counter() - t_phase:.1f} s into the phase")

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = True, True
    tcfg0 = get_config(CNN_PRESET)
    cfg, pcfg = tcfg0.selfplay, tcfg0.ppo
    topo = get_topology(cfg.board_size)
    n, F, Bn, T, P = topo.n, topo.num_cells, cfg.n_envs, pcfg.n_steps, cfg.buffer_size
    print(f"[cnn] {CNN_PRESET}: {n}x{n}, n_envs {Bn}, n_steps {T}, minibatch "
          f"{pcfg.minibatch_size}, {pcfg.n_epochs} epochs, pool {P} + best, "
          f"{cfg.eval_episodes} eval episodes; cuDNN {torch.backends.cudnn.version()}, global "
          "cudnn.allow_tf32 True and benchmark True in this phase")

    # ---- gates: the scan path and the autograd sweep; the kernels refuse a CNN
    algo0 = SelfplayPPO(tcfg0, device=dev)
    model = algo0.model
    if (not isinstance(model, cnn.CnnPolicy) or algo0.runner.fused_pol is not None
            or algo0.runner.pol is not None or algo0.evaluator.fused_pol is not None
            or not algo0.update_fn.__qualname__.startswith("make_update_fn")):
        fail("the CNN preset does not take the scan path, the plain eval and the autograd sweep")
    for bad in (dict(policy_impl="pallas"), dict(rollout_impl="fused")):
        try:
            SelfplayRunner(topo, model, dataclasses.replace(cfg, **bad), device=dev)
        except ValueError:
            continue
        fail(f"a CNN runner with {bad} does not raise")
    try:
        SelfplayPPO(dataclasses.replace(tcfg0, ppo=dataclasses.replace(pcfg, update_impl="pallas")),
                    device=dev)
        fail("a CNN with update_impl='pallas' does not raise")
    except ValueError:
        pass

    stamp("gates")

    # ---- the forward at trained magnitudes against float64 on the CPU ----------
    g = torch.Generator().manual_seed(77)
    sd = cnn_trained_scale(model, g)
    p_dev = {k: v.to(dev) for k, v in sd.items()}
    p64 = {k: v.double() for k, v in sd.items()}
    obs = random_positions(topo, CNN_POSITIONS, F, g, dev)
    fwd = {}
    for train in (False, True):
        got = torch.func.functional_call(model, p_dev, (obs,), {"train": train})
        ref = torch.func.functional_call(model, p64, (obs.cpu(),), {"train": train})
        scale = float(ref[0].abs().max())
        errs = [max_err(got[0].cpu().double(), ref[0]) / scale,
                max_err(got[1].cpu().double(), ref[1]) / float(ref[1].abs().max())]
        if train:
            errs.append(max(max_err(got[2][k].cpu().double(), ref[2][k])
                            / float(ref[2][k].abs().max()) for k in ref[2]))
        if max(errs) > CNN_REL:
            fail(f"CNN forward (train={train}) against float64: relative errors {errs} > {CNN_REL}")
        fwd[train] = (errs, scale)
    print(f"[cnn] forward on {CNN_POSITIONS} boards at trained magnitudes against float64 on "
          "the CPU, errors over the largest value (logits, values[, running stats]): "
          + "; ".join(f"train={t} {', '.join(f'{e:.3g}' for e in errs)} (logits up to {sc:.4g})"
                      for t, (errs, sc) in fwd.items()))

    stamp("forward")

    # ---- the opponent bank: gathered against dense, bf16, the conv variants -----
    members = [cnn_trained_scale(model, g) for _ in range(P)]
    stacked = {k: torch.stack([m[k] for m in members]).to(dev) for k in sd}
    best = {k: v.to(dev) for k, v in cnn_trained_scale(model, g).items()}
    boards = obs[:Bn].contiguous()
    use_best, opp_idx = sample_opponents(g, P, Bn, cfg.best_prob, dev)
    ar = torch.arange(Bn, device=dev)
    gathered = cnn.gathered_bank_logits(model, stacked, best, use_best, opp_idx, boards)
    best_rows = torch.func.functional_call(model, best, (boards,))[0]
    dense = torch.where(use_best[:, None], best_rows,
                        cnn.bank_logits(model, stacked, boards)[opp_idx.long(), ar])
    scale = float(dense.abs().max())
    gd_rel = max_err(gathered, dense) / scale
    paired = cnn.bank_logits(model, stacked, obs[:P], paired=True)
    diag = cnn.bank_logits(model, stacked, obs[:P])[torch.arange(P), torch.arange(P)]
    pd_rel = max_err(paired, diag) / float(diag.abs().max())
    if gd_rel > CNN_REL or pd_rel > CNN_REL:
        fail(f"CNN bank: gathered vs dense {gd_rel}, paired vs dense {pd_rel} > {CNN_REL}")
    print(f"[cnn bank] B {Bn}, {P} members + best, {int(use_best.sum())} rows on the best: "
          f"gathered against dense and a selection {gd_rel:.3g} of the largest logit "
          f"({scale:.4g}); the eval's paired pass against dense {pd_rel:.3g}")

    filters = cnn.gathered_filters(cnn.fold_bn(stacked), cnn.fold_bn(best), use_best, opp_idx)
    h = boards.to(torch.float32).reshape(1, Bn, n, n)
    shares, refused = [], []
    for w, b in filters:
        want = cnn.conv_relu(h.cpu(), w.cpu(), b.cpu(), Bn, bf16=True)
        with cnn.full_float32():
            got = cnn.conv_relu(h, w, b, Bn, bf16=True)
            got32 = cnn.conv_relu(h, w, b, Bn, bf16=False)
        share, ok = bf16_layer_check(got, want)
        if not ok or share > CNN_BF16_LAYER_SHARE:
            fail(f"CNN bf16 bank layer {len(shares)}: {share:.3g} of the activations differ "
                 f"(at most {CNN_BF16_LAYER_SHARE}), within one bf16 ulp: {ok}")
        share32, ok32 = bf16_layer_check(got32, want)
        refused.append(share32 > CNN_BF16_LAYER_SHARE or not ok32)
        shares.append((share, share32))
        h = want.to(dev)
    if not all(refused):
        fail("the CNN bf16 layer check passes the float32 layer in the bf16 one's place")
    cpu = {k: v.cpu() for k, v in stacked.items()}
    want = cnn.gathered_bank_logits(model, cpu, {k: v.cpu() for k, v in best.items()},
                                    use_best.cpu(), opp_idx.cpu(), boards.cpu(), bf16=True)
    got = cnn.gathered_bank_logits(model, stacked, best, use_best, opp_idx, boards, bf16=True)
    row = (got.cpu() - want).abs().amax(-1) / float(want.abs().max())
    ctrl = float((gathered.cpu() - want).abs().max()) / float(want.abs().max())
    if float(row.max()) > BF16_FLIP_REL:
        fail(f"CNN bf16 bank logits: max error {float(row.max())} of the largest logit "
             f"(at most {BF16_FLIP_REL})")
    print("[cnn bank bf16] gathered, layer by layer against the CPU's emulation: share of "
          "activations one bf16 ulp apart " + ", ".join(f"{a:.3g}" for a, _ in shares)
          + "; the float32 layer in its place: " + ", ".join(f"{c:.3g}" for _, c in shares)
          + f" (refused); logits: max error {float(row.max()):.3g} of the largest, "
          f"{float((row > 2e-5).double().mean()):.2%} of rows beyond 2e-5 of it; the float32 "
          f"bank against the bf16 emulation {ctrl:.3g}")

    grouped = cnn.gathered_conv_stack(model, filters, boards)
    with cnn.full_float32():
        unfolded = unfold_conv_stack(filters, boards, n)
    uf_rel = max_err(unfolded, grouped) / float(grouped.abs().max())
    if uf_rel > CNN_REL:
        fail(f"the unfold + bmm conv stack differs from the grouped conv by {uf_rel}")

    def unfold_scoped():
        with cnn.full_float32():
            return unfold_conv_stack(filters, boards, n)

    times = {
        "grouped conv stack (kept)": cuda_ms(lambda: cnn.gathered_conv_stack(model, filters,
                                                                           boards), 20),
        "unfold + bmm conv stack": cuda_ms(unfold_scoped, 20),
        "gathered opponent pass": cuda_ms(lambda: cnn.gathered_bank_logits(
            model, stacked, best, use_best, opp_idx, boards), 20),
        "gathered opponent pass, bf16": cuda_ms(lambda: cnn.gathered_bank_logits(
            model, stacked, best, use_best, opp_idx, boards, bf16=True), 20),
        "dense bank pass": cuda_ms(lambda: cnn.bank_logits(model, stacked, boards), 5),
        "agent forward": cuda_ms(lambda: torch.func.functional_call(model, p_dev, (boards,)), 20),
    }
    print(f"[cnn bank] ms per call at B {Bn} (CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f"; unfold + bmm against the grouped conv {uf_rel:.3g}")
    # the other ways measured once: the grouped conv in channels_last and
    # with cuDNN's autotuning (whose pick, by timing, can change from run to
    # run and with it the sums' order), and a grad step at the sweep's
    # minibatch in TF32 against full float32
    def with_flags(fn, **flags):
        def run():
            with torch.backends.cudnn.flags(enabled=True, **flags):
                return fn()
        return run

    filters_cl = [(w.contiguous(memory_format=torch.channels_last), b) for w, b in filters]
    x_cl = boards.to(torch.float32).reshape(1, Bn, n, n).contiguous(
        memory_format=torch.channels_last)

    def grouped_cl():
        x = x_cl
        for w, b in filters_cl:
            x = cnn.conv_relu(x, w, b, Bn)
        return x

    strict = dict(benchmark=False, deterministic=True, allow_tf32=False)
    mb_obs = random_positions(topo, pcfg.minibatch_size, F, g, dev)
    keys = [k for k, _ in model.named_parameters()]

    def grad_step():
        leaves = {k: p_dev[k].detach().requires_grad_() for k in keys}
        logits, value, _ = torch.func.functional_call(model, {**p_dev, **leaves}, (mb_obs,),
                                                      {"train": True})
        return torch.autograd.grad(logits.square().mean() + value.square().mean(),
                                   list(leaves.values()))

    @contextlib.contextmanager
    def tf32_scope():  # the package's scope, TF32 allowed (a measurement only)
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=True):
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                yield
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False

    variants = {
        "grouped conv stack, channels_last": cuda_ms(with_flags(grouped_cl, **strict), 20),
        "grouped conv stack, cuDNN autotuning": cuda_ms(with_flags(
            lambda: cnn.gathered_conv_stack(model, filters, boards), benchmark=True,
            deterministic=True, allow_tf32=False), 20),
        f"grad step at B {pcfg.minibatch_size}, full float32 (kept)": cuda_ms(grad_step, 5),
    }
    scope, cnn.full_float32 = cnn.full_float32, tf32_scope
    try:
        variants[f"grad step at B {pcfg.minibatch_size}, TF32"] = cuda_ms(grad_step, 5)
    finally:
        cnn.full_float32 = scope
    print("[cnn variants] ms per call (CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in variants.items()))
    for name, fn in (("gathered opponent pass", lambda: cnn.gathered_bank_logits(
            model, stacked, best, use_best, opp_idx, boards)),
            ("agent forward", lambda: torch.func.functional_call(model, p_dev, (boards,)))):
        wall_us, busy, top, _ = device_profile(fn)
        print(f"[cnn profile] one {name} at B {Bn}: wall {wall_us:.1f} us, device busy "
              f"{busy:.1f} us; top kernels (us): " + "; ".join(f"{k[:70]} {v:.1f}" for k, v in top))

    stamp("bank")

    # ---- training: Trainer.fit, three iterations ---------------------------------
    per_iter = Bn * T
    work = tempfile.mkdtemp(prefix="chip_smoke_cnn_")
    tcfg = get_config(CNN_PRESET, total_timesteps=3 * per_iter, checkpoint_every=2 * per_iter,
                      log_dir=os.path.join(work, "log"), model_dir=os.path.join(work, "models"))
    trainer = Trainer(tcfg, device=dev)
    algo = trainer.algo
    stage_events = {"rollout": [], "gae": [], "sweep": [], "eval + pool update": []}

    def timed(stage, fn):
        def run(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            res = fn(*args, **kwargs)
            end.record()
            stage_events[stage].append((start, end))
            return res
        return run

    bn_keys = [k for k, _ in model.named_buffers()]
    moved = []
    update = algo.update_fn

    def update_spy(params, *args, **kwargs):
        res = update(params, *args, **kwargs)
        moved.append(all(not torch.equal(res[0][k], params[k]) for k in bn_keys))
        return res

    algo.update_fn = update_spy
    algo.runner.run = timed("rollout", algo.runner.run)
    algo.gae_fn = timed("gae", algo.gae_fn)
    algo.update_fn = timed("sweep", algo.update_fn)
    algo.evaluator.eval_and_update = timed("eval + pool update", algo.evaluator.eval_and_update)
    marks = []
    train_step = algo.train_step

    def marked_train_step(state):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), dict(cuda_lib.launches)))
        return train_step(state)

    algo.train_step = marked_train_step
    cuda_lib.reset_launches()
    state_a = trainer.fit()
    torch.cuda.synchronize()
    marks.append((time.perf_counter(), dict(cuda_lib.launches)))
    want = dict.fromkeys(cuda_lib.KERNELS, 0)
    want.update(k1_step=3 * T + 1 + 2 * (F // 2 + 2), k5_gae=1)
    for i in range(3):
        got = {k: marks[i + 1][1][k] - marks[i][1][k] for k in cuda_lib.KERNELS}
        if got != want:
            fail(f"CNN iteration {i + 1} launched {got}, expected {want}")
    if moved != [True] * 3:
        fail(f"the BatchNorm running statistics did not move in every sweep: {moved}")
    with open(os.path.join(tcfg.log_dir, tcfg.model_name, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    eval_steps = [r["step"] for r in recs if "eval/mean_reward" in r]
    if eval_steps != [per_iter, 2 * per_iter, 3 * per_iter]:
        fail(f"CNN eval did not fire every iteration: {eval_steps}")
    if not all(np.isfinite(v) for r in recs for v in r.values()):
        fail("non-finite logged CNN metrics")
    if not all(bool(torch.isfinite(v).all()) for v in state_a.params.values()):
        fail("non-finite CNN parameters after training")
    if trainer._ckpt_mgr().latest_step() != 2 * per_iter:
        fail("no CNN checkpoint after iteration 2")
    trainer_r = Trainer(tcfg, logger=MetricsLogger(tcfg.log_dir, "resumed"), device=dev)
    state_r = trainer_r.fit(trainer_r.resume())
    for k in state_a.params:
        if not torch.equal(state_r.params[k], state_a.params[k]):
            fail(f"the resumed CNN iteration 3 differs from the uninterrupted one at {k}")
        if not torch.equal(state_r.bank.params[k], state_a.bank.params[k]):
            fail(f"the resumed CNN iteration 3's bank differs at {k}")
    iter_s = [marks[i + 1][0] - marks[i][0] for i in range(3)]
    stage_ms = {k: [round(a.elapsed_time(b), 3) for a, b in v] for k, v in stage_events.items()}
    print(f"[cnn train] 3 iterations of {per_iter} transitions; launches per iteration {want}; "
          f"eval at steps {eval_steps}; running statistics moved in every sweep; resume from "
          "iteration 2 -> iteration 3 params, running statistics and bank bitwise equal")
    print(f"[cnn train] s per iteration {[round(x, 4) for x in iter_s]}; "
          f"{per_iter / (sum(iter_s[1:]) / 2):.0f} transitions/s (iterations 2-3)")
    print("[cnn train] stage ms of iterations 1-3 (CUDA events): "
          + "; ".join(f"{k} {v}" for k, v in stage_ms.items()))
    last = recs[-2]
    print("[cnn train] iteration 3: " + ", ".join(
        f"{k} {last[k]:.4g}" for k in ("rollout/ep_rew_mean", "train/policy_loss",
                                        "train/value_loss", "train/entropy", "eval/score")))
    G = (per_iter // pcfg.minibatch_size) * pcfg.n_epochs
    sweep_flops = 3.0 * G * pcfg.minibatch_size * roofline.cnn_forward_flops(F)
    sweep_s = float(np.mean(stage_ms["sweep"][1:])) / 1e3
    roll_flops = per_iter * (roofline.cnn_forward_flops(F) + roofline.cnn_gathered_bank_flops(F, P))
    roll_s = float(np.mean(stage_ms["rollout"][1:])) / 1e3
    for name, fl, sec in (("sweep", sweep_flops, sweep_s), ("rollout", roll_flops, roll_s)):
        bound = fl / roofline.PEAK_FLOPS_FP32
        print(f"[cnn roofline] {name}: {fl / 1e12:.3f} TFLOP in {sec:.4f} s (iterations 2-3), "
              f"{fl / sec / 1e12:.3f} TFLOP/s, float32 bound {bound:.4f} s "
              f"({100 * bound / sec:.1f}% of it)"
              + (f"; {1e3 * sec / T:.3f} ms per rollout step" if name == "rollout" else ""))

    stamp("training")

    # ---- one profiled iteration ----------------------------------------------------
    def iteration():
        st, _ = algo.train_step(state_a)
        algo.eval_step(st)

    iteration()
    wall_us, busy, top, top_host = device_profile(iteration)
    print(f"[cnn profile] one iteration (train + eval): wall {wall_us:.1f} us, device busy "
          f"{busy:.1f} us ({100 * busy / wall_us:.1f}%); top kernels (us): "
          + "; ".join(f"{k[:60]} {v:.1f}" for k, v in top))
    print("[cnn profile] top host ops by self CPU time (us): "
          + "; ".join(f"{k[:40]} {v:.1f}" for k, v in top_host))
    stamp("profile")
    shutil.rmtree(work, ignore_errors=True)
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = flags
    return want


# ---- the match and compat surfaces -------------------------------------------------------

MATCH_N = 7  # the trained MLP-default agent's board
MATCH_GAMES = 4096
TOURNEY_GAMES = 512  # games a pair


def match_split_is_near_tie(topo, model, params_cpu, rec_k, rec_c, bits, a_det, game):
    """Where the card's and the CPU's winners of ``game`` differ, the first
    ply at which their actions differ must be a near tie of the side to
    move: the top two of the scores it compares (masked logits, plus Gumbel
    noise where it samples) within TOL of the row's largest logit."""
    import torch

    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.ops import masked

    t = int((rec_k["actions"][:, game] != rec_c["actions"][:, game]).nonzero()[0])
    st = hex_env.initial_state(topo, 1, "cpu")
    for u in range(t):
        st, _ = hex_env.step(topo, st, rec_c["actions"][u, game:game + 1])
    if int(st.to_move[0]) != game % 2:  # policy A holds seat game mod 2
        return False  # the random side's zero logits cannot split
    legal = hex_env.legal_mask(topo, st)
    with torch.no_grad():
        logits = torch.func.functional_call(
            model, params_cpu, (hex_env.observe(topo, st).to(torch.float32),))[0]
    scores = masked.mask_logits(logits, legal)[0]
    if not a_det:
        scores = scores + masked.gumbel(bits[t, 0, game])
    top = scores.topk(2).values
    return float(top[0] - top[1]) <= TOL * float(logits[legal].abs().max())


def match_phase(dev) -> dict:
    """``[match]``: the trained 7x7 agent against a random player at 4096
    games through ``scripts/match.run_match`` on the card (K1 every ply),
    with the same words on the CPU (the plain step), and a three-player
    tournament.  Returns the launches of one match."""
    import numpy as np
    import torch

    from hex_gym_env_tpu_torch.core.topology import get_topology
    from hex_gym_env_tpu_torch.models.loading import agent_path, load_policy_params
    from hex_gym_env_tpu_torch.ops import cuda_lib, masked
    from hex_gym_env_tpu_torch.scripts.match import bits_shape, run_match
    from hex_gym_env_tpu_torch.scripts.tournament import run_tournament

    n, games = MATCH_N, MATCH_GAMES
    topo = get_topology(n)
    agent = f"params:{agent_path(n)}"
    orbax = f"orbax:{os.path.join(REPO, 'models', f'{n}x{n}_strict_sb3', 'agent_9437184')}"
    model, params_cpu = load_policy_params(agent, n, device="cpu")
    _, params_dev = load_policy_params(agent, n, device=dev)
    if not all(torch.equal(params_dev[k].cpu(), params_cpu[k]) for k in params_cpu):
        fail("[match] the params: agent loads differently on the card")
    try:
        import tensorstore  # noqa: F401
        has_ts = True
    except ImportError:
        has_ts = False
    if has_ts:
        _, params_ob = load_policy_params(orbax, n, device=dev)
        if not all(torch.equal(params_ob[k], params_dev[k]) for k in params_dev):
            fail("[match] the orbax: snapshot and its params: copy differ")
        print(f"[match] {orbax} and {agent} load bitwise equal")
    else:
        print("[match] tensorstore is not installed here, so the orbax: snapshot is not "
              f"read; {agent} is played")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(f"[match] card: {smi.stdout.strip().splitlines()[0]}")
    bits = masked.draw_bits(torch.Generator().manual_seed(2024), bits_shape(n, games), "cpu")
    bits_dev = bits.to(dev)
    run_match(n, 256, agent, "random", device=dev)  # warm-up: cuBLAS, the kernel library
    torch.cuda.synchronize()
    want = dict.fromkeys(cuda_lib.KERNELS, 0)
    want["k1_step"] = topo.num_cells + 1
    want["mlp_forward"] = 2 * (topo.num_cells + 1)  # both sides bound: one a side each ply
    want["mlp_image"] = 2
    counts = None
    for mode in ("a-det", "stochastic"):
        rec_k, rec_c = {}, {}
        cuda_lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_match(n, games, agent, "random", mode=mode, device=dev, bits=bits_dev,
                        record=rec_k)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(cuda_lib.launches)
        if counts != want:
            fail(f"[match] {mode} launched {counts}, expected {want}")
        t0 = time.perf_counter()
        out_cpu = run_match(n, games, agent, "random", mode=mode, device="cpu", bits=bits,
                            record=rec_c)
        cpu_secs = time.perf_counter() - t0
        split = (rec_k["winners"] != rec_c["winners"]).nonzero().flatten().tolist()
        ties = [g for g in split if match_split_is_near_tie(
            topo, model, params_cpu, rec_k, rec_c, bits, mode == "a-det", g)]
        if len(ties) != len(split):
            fail(f"[match] {mode}: {len(split) - len(ties)} games end otherwise on the card "
                 "than on the CPU, not at a near tie")
        if out["undecided"] or not out["a_winrate"] > 0.9:
            fail(f"[match] {mode}: the trained agent does not beat the random player: {out}")
        same_actions = int((rec_k["actions"] == rec_c["actions"]).all(0).sum())
        print(f"[match] {n}x{n} {mode}, {games} games, trained agent (A) vs random, the same "
              f"words on the card and the CPU: A winrate {out['a_winrate']} (CPU "
              f"{out_cpu['a_winrate']}), A wins as seat 0 {out['a_wins_as_seat0']}, as seat 1 "
              f"{out['a_wins_as_seat1']}; card {secs:.4f} s ({games / secs:.1f} games/s), CPU "
              f"{cpu_secs:.3f} s; winners equal in {games - len(split)} games, {len(ties)} "
              f"differ at near ties; every action equal in {same_actions} games; K1 "
              f"{counts['k1_step']} launches")
    # what a user pays: run_match with its own seeded draws, on the card
    times = []
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_match(n, games, agent, "random", seed=rep, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    print(f"[match] stochastic, seeded draws on the card, 3 matches of {games} games: s "
          f"{[round(x, 4) for x in times]}, median {med:.4f} s ({games / med:.1f} games/s); "
          f"A winrate {out['a_winrate']}")
    wall_us, busy, top, top_host = device_profile(
        lambda: run_match(n, games, agent, "random", seed=0, device=dev))
    print(f"[match profile] one seeded match: wall {wall_us:.1f} us, device busy {busy:.1f} us "
          f"({100 * busy / wall_us:.1f}%); top kernels (us): "
          + "; ".join(f"{k[:60]} {v:.1f}" for k, v in top))
    print("[match profile] top host ops by self CPU time (us): "
          + "; ".join(f"{k[:40]} {v:.1f}" for k, v in top_host))

    players = [agent, "random", orbax if has_ts else agent]
    t0 = time.perf_counter()
    results, elo = run_tournament(players, board_size=n, games=TOURNEY_GAMES, device=dev)
    torch.cuda.synchronize()
    for r in results:
        print(f"[tournament] {r['a']} vs {r['b']}: A winrate {r['a_winrate']}")
    print(f"[tournament] {TOURNEY_GAMES} games a pair, Elo anchored at player 0: "
          + "; ".join(f"{p} {e:.1f}" for p, e in zip(players, elo))
          + f"; {time.perf_counter() - t0:.2f} s")
    # 4 binomial standard errors of an Elo gap at p = 0.5
    se4 = 4 * 400 / math.log(10) / 0.25 * math.sqrt(0.25 / TOURNEY_GAMES)
    if not (abs(elo[2] - elo[0]) < se4 and elo[1] < elo[0] - 400):
        fail(f"[tournament] the Elo table is off: {elo} (self-pair gap bound {se4:.1f})")
    return counts


# the match's forward kernel at the match's shape, and the benchmark's own
# check of a 4,096-game 7x7 match on these seeds (benchmark/drivers/match.py)
FWD_N, FWD_B = 7, 4096
FWD_JUDGE_SEEDS = (3000001701, 3000001702, 3000001703, 3000001704)
FWD_SPAN_MATCHES = 10


def _match_split(play, matches: int) -> dict:
    """A match's host time by span, with spans on, no profiler and one torch
    thread: the means over ``matches`` matches of the match, its plies,
    loads and binds (ms), and of a ply, its forwards, observe, step, picks
    and own code (us)."""
    import torch

    from hex_gym_env_tpu_torch.utils import profiling

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the benchmark runs the match (benchmark/run.py)
    play()
    profiling.take_spans()
    with profiling.tracing(True):
        for _ in range(matches):
            play()
    torch.set_num_threads(threads)
    t = profiling.span_table(profiling.take_spans())
    plies = t["match.ply"]["calls"]
    per_ply = {k: 1e3 * t[k]["total_ms"] / plies
               for k in ("match.ply", "ply.forward", "ply.observe", "ply.step", "ply.pick")}
    per_ply["own"] = 1e3 * t["match.ply"]["self_ms"] / plies
    per_match = {k: t[k]["total_ms"] / matches
                 for k in ("match", "match.ply", "match.load", "match.bind") if k in t}
    return {"match_ms": per_match, "ply_us": per_ply}


def mlp_forward_phase(dev) -> dict:
    """``[mlp forward]``: the match's forward kernel (``ops/mlp_forward``):
    ``scripts.selftest``'s check 7 (against its twin on every MLP family at
    5x5 to 11x11 on 4,096 boards, the image exact, a 7x7 match's launches,
    no stale read); its launch shape and times at the match's shape (7x7
    MLP-default, 4,096 boards) beside its bound, its twin and the eager
    forward it displaces (``functional_call``: cuBLAS and ATen ops), and
    the host's time of one forward on each path; the benchmark's own check
    (``logit_tap`` and ``judge``) of a 4,096-game 7x7 match on each of
    ``FWD_JUDGE_SEEDS``, 100 launches a match; and a match's host time by
    span with the kernel and with every side left on ``functional_call``
    (the path before the kernel).  Returns the kernel table's row."""
    import types
    from unittest import mock

    import torch

    from benchmark import harness, work
    from hex_gym_env_tpu_torch.models import make_policy
    from hex_gym_env_tpu_torch.ops import cuda_lib, mlp_forward
    from hex_gym_env_tpu_torch.ops import policy_kernel as pk
    from hex_gym_env_tpu_torch.scripts import selftest
    from hex_gym_env_tpu_torch.scripts.match import run_match

    worst = selftest.check_mlp_forward(dev)
    n, B = FWD_N, FWD_B
    g = torch.Generator().manual_seed(77)
    model = make_policy("MLP-default", n * n, generator=g)
    with torch.no_grad():
        model.action_head.weight.mul_(100.0)
    params = {k: v.detach().to(dev) for k, v in model.state_dict().items()}
    eager = make_policy("MLP-default", n * n)
    d = pk.mlp_dims(model)
    if not mlp_forward.bind(model, params):
        fail("[mlp forward] the MLP-default module did not bind on the card")
    image = model.bound_forward.image
    x = torch.randint(-1, 2, (B, n, n), generator=g).to(dev, torch.float32)
    xf = x.reshape(B, -1)
    plan = cuda_lib.mlp_forward_plan(d.F, d.H, d.A, d.n_layers, B)
    flops = 2 * B * (2 * d.F * d.H + 2 * (d.n_layers - 1) * d.H * d.H + d.H * (d.A + 1))
    nbytes = 4 * (B * d.F + B * (d.A + 1) + mlp_forward.image_floats(d))
    bound, by = bound_ms(nbytes, flops)
    with torch.no_grad():
        def kernel():
            return mlp_forward.forward(image, d, xf)

        def library():
            return torch.func.functional_call(eager, params, (x,))

        call = cuda_ms(kernel, 200)
        dev_ms = device_ms(kernel, ["mlp_forward_kernel"], 50)
        image_ms = device_ms(lambda: mlp_forward._image_cuda(model, d), ["mlp_image_kernel"], 20)
        twin = cuda_ms(lambda: mlp_forward.forward_twin(image, d, xf), 200)
        lib_call = cuda_ms(library, 200)
        _, lib_busy, lib_top, _ = device_profile(lambda: [library() for _ in range(20)])
        host_kernel = host_us(lambda: model(x), 500)
        host_library = host_us(library, 500)
        err = max(max_err(a, b) for a, b in zip(kernel(), library()))
    print(f"[mlp forward] plan at {n}x{n}, {B} boards: RT {plan[0]} ({8 * plan[0]} boards a "
          f"CTA), image in shared memory {bool(plan[1])}, {plan[2]} shared bytes, {plan[3]} CTAs")
    lib_ops = "; ".join(f"{k[:48]} {v / 20:.2f} us" for k, v in lib_top)
    print(f"[mlp forward] {n}x{n} MLP-default, {B} boards: call {call:.5f} ms, device "
          f"{dev_ms:.5f} ms, bound {bound:.5f} ms ({by}: {flops / 1e6:.1f} MFLOP, "
          f"{nbytes / 1e6:.3f} MB), {100 * bound / dev_ms:.1f}% of it; twin {twin:.5f} ms; the "
          f"eager forward it displaces (functional_call) {lib_call:.5f} ms a call, device "
          f"{lib_busy / 20 / 1e3:.5f} ms ({lib_ops}); largest gap to it {err:.3g}; image "
          f"{image_ms:.5f} ms device")
    print(f"[mlp forward] host us a forward: module call on the kernel {host_kernel:.1f}, "
          f"functional_call on the eager path {host_library:.1f}")

    wl = harness.load_json(harness.workload_file("mlp7-match-det"))
    conf = harness.load_json(harness.HERE / "configs" / "7x7_MLP-default_lr-0.0003.json")
    drv = harness.load_module(harness.driver_file(wl["driver"]), "smoke_bench_match")
    bench_model, family = work.model_of(conf), conf["model"]["name"]
    games, mode, limits = int(wl["games"]), wl["mode"], wl["limits"]
    judged = {"gap": 0.0, "winner_mismatch": 0, "logit_gap": 0.0}
    with tempfile.TemporaryDirectory() as tmp:
        specs = None
        for seed in FWD_JUDGE_SEEDS:
            ctx = types.SimpleNamespace(workload=wl, seed=seed, device=dev, run_dir=tmp)
            (wa, spec_a), (wb, spec_b) = drv.make_agents(ctx, bench_model)
            specs = specs or (spec_a, spec_b)
            rec = {}
            cuda_lib.reset_launches()
            with drv.logit_tap() as taps:
                run_match(n, games, spec_a, spec_b, mode=mode, family_a=family, family_b=family,
                          device=dev, record=rec)
            launched = cuda_lib.launches["mlp_forward"]
            if launched != 2 * (n * n + 1) or any(len(t) != n * n + 1 for t in taps):
                fail(f"[mlp forward] seed {seed}: {launched} launches, taps "
                     f"{[len(t) for t in taps]}")
            got = drv.judge(wa, wb, bench_model, mode, games, None, rec["actions"].to(dev),
                            rec["winners"].to(dev), taps)
            print(f"[mlp forward] benchmark check, seed {seed}: {got}")
            if not all(harness.within(v, limits[k]) for k, v in got.items()):
                fail(f"[mlp forward] seed {seed} fails the benchmark's limits {limits}: {got}")
            judged = {k: judged[k] + got[k] if k == "winner_mismatch" else max(judged[k], got[k])
                      for k in judged}

        def play():
            run_match(n, games, *specs, mode=mode, family_a=family, family_b=family, device=dev)

        after = _match_split(play, FWD_SPAN_MATCHES)
        with mock.patch.object(mlp_forward, "bind", lambda model, params: False):
            before = _match_split(play, FWD_SPAN_MATCHES)
    print(f"[mlp forward] benchmark check over {len(FWD_JUDGE_SEEDS)} seeds: {judged} "
          f"(limits {limits})")
    for label, split in (("functional_call (before)", before), ("kernel (after)", after)):
        match_ms = json.dumps({k: round(v, 3) for k, v in split["match_ms"].items()})
        ply_us = json.dumps({k: round(v, 1) for k, v in split["ply_us"].items()})
        print(f"[mlp forward] match split, {label}, means of {FWD_SPAN_MATCHES} matches with "
              f"spans on: a match (ms) {match_ms}; a ply (us) {ply_us}")
    return {"name": "mlp_forward", "route": "cuda",
            "source": "hex_gym_env_tpu_torch/csrc/hex_kernels.cu",
            "replaces": None, "launches": 2 * (n * n + 1), "max_abs_err": err,
            "ms": call, "device_ms": dev_ms, "plain_ms": twin, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_call, "library_device_ms": lib_busy / 20 / 1e3,
            "image_device_ms": image_ms, "twin_rel_err": worst, "judged": judged,
            "host_us": {"kernel": host_kernel, "functional_call": host_library},
            "split": {"before": before, "after": after}}


def mlp_only() -> int:
    import torch

    if not preflight(torch):
        return 1
    from hex_gym_env_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False  # the twins in full float32
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}")
    t0 = time.perf_counter()
    cuda_lib.build(verbose=True)
    cuda_lib.lib()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    row = mlp_forward_phase(torch.device("cuda"))
    print(f"[mlp forward] phase {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"mlp_forward": row}))
    return 0


def compat_phase(dev) -> dict:
    """``[compat]``: 64 random 7x7 games through ``HexEnv`` on the card (K1
    at one game a step) and the native engine, every step equal; one
    ``HexEnvV0`` episode and one selfplay-wrapper episode against the
    trained agent on the card.  Returns the launches of the 64 games."""
    import numpy as np

    from hex_gym_env_tpu_torch.compat import (HexEnv, HexEnvV0, TorchOpponentPolicy,
                                              selfplay_wrapper)
    from hex_gym_env_tpu_torch.models.loading import agent_path, load_policy_params
    from hex_gym_env_tpu_torch.native.engine import NativeHexEnv
    from hex_gym_env_tpu_torch.ops import cuda_lib

    n = MATCH_N
    rng = np.random.default_rng(9)
    env = HexEnv(board_size=n, device=dev)
    steps, wins = 0, [0, 0]
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    for game in range(64):
        nat = NativeHexEnv(n)
        obs, _ = env.reset()
        if not np.array_equal(obs, nat.observation):
            fail(f"[compat] game {game}: reset observations differ")
        done = False
        while not done:
            legal = env.legal_actions()
            if not np.array_equal(legal, nat.legal_actions()):
                fail(f"[compat] game {game}: legal masks differ at step {steps}")
            a = int(rng.choice(np.flatnonzero(legal)))
            obs, reward, done, _ = env.step(a)
            nobs, nreward, ndone, _ = nat.step(a)
            steps += 1
            if not (np.array_equal(obs, nobs) and reward == nreward and done == ndone):
                fail(f"[compat] game {game}: the step differs from the native engine")
        if env.winner != nat.winner or env.winner not in (0, 1):
            fail(f"[compat] game {game}: winner {env.winner}, native {nat.winner}")
        wins[env.winner] += 1
    secs = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    want = dict.fromkeys(cuda_lib.KERNELS, 0)
    want["k1_step"] = steps
    if counts != want:
        fail(f"[compat] HexEnv launched {counts}, expected one K1 a step ({steps})")
    print(f"[compat] HexEnv on the card = native engine over 64 {n}x{n} games, {steps} steps "
          f"(seat 0 won {wins[0]}, seat 1 {wins[1]}): observations, masks, rewards, done flags, "
          f"winners equal; K1 {counts['k1_step']} launches (1 a step); {secs:.2f} s "
          f"({1e3 * secs / steps:.3f} ms a step, both engines and the checks)")

    v0 = HexEnvV0(board_size=n, opponent_policy="random", seed=2, device=dev)
    v0.reset()
    done = False
    while not done:
        _, reward, done, _, _ = v0.step(int(rng.choice(np.flatnonzero(v0.legal_actions()))))
    if reward not in (1.0, -1.0):
        fail(f"[compat] HexEnvV0 episode ended with reward {reward}")
    model, params = load_policy_params(f"params:{agent_path(n)}", n, device=dev)
    sp = selfplay_wrapper(HexEnv)(board_size=n, buffer_size=4, agent_player_num=0,
                                  base_model=TorchOpponentPolicy(model, params, seed=3),
                                  device=dev)
    sp.reset()
    done, moves = False, 0
    while not done:
        _, sp_reward, done, _, _ = sp.step(int(rng.choice(np.flatnonzero(sp.legal_actions()))))
        moves += 1
    if sp_reward not in (1.0, -1.0):
        fail(f"[compat] selfplay-wrapper episode ended with reward {sp_reward}")
    print(f"[compat] HexEnvV0 episode: reward {reward}; selfplay wrapper against the trained "
          f"agent (TorchOpponentPolicy on the card): the random agent's reward {sp_reward} "
          f"after {moves} moves")
    return counts


# ---------------------------------------------------------------------------
# slice 10: the training entry points, data-parallel training, the scripts
# ---------------------------------------------------------------------------

PER_ITER = B * T  # the preset's transitions per iteration
DIST_SEED = 3  # the seed of the [distributed] runs


def run_module(args, cwd, stdin=None, timeout=600) -> str:
    """``python -m <args>`` from ``cwd`` with this checkout on the path;
    fails on a non-zero exit and returns the standard output."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, input=stdin, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        fail(f"python -m {' '.join(args)} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return proc.stdout


def read_metrics(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def iteration_seconds(recs) -> list:
    """Seconds per iteration of the train records (``perf/steps_per_s``)."""
    return [round(PER_ITER / r["perf/steps_per_s"], 4) for r in recs if "perf/steps_per_s" in r]


def train_cli_phase(dev) -> None:
    """``[train cli]``: ``scripts.train`` at the preset for 2 iterations in a
    subprocess, ``--resume`` to a third, against a 3-iteration run in one go
    (params bitwise equal), ``export_agent`` to a ``params:`` file, and a
    1024-game ``scripts.match`` of the exported agent against ``random``."""
    import torch

    from hex_gym_env_tpu_torch.utils.checkpoint import CheckpointManager, load_params

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    train = ["hex_gym_env_tpu_torch.scripts.train", "--experiment", PRESET,
             "--checkpoint-every", str(PER_ITER)]
    t0 = time.perf_counter()
    out = run_module(train + ["--total-timesteps", str(2 * PER_ITER)], work)
    secs_a = time.perf_counter() - t0
    line = f"training {PRESET}: {2 * PER_ITER} transitions on 1 device(s)"
    if line not in out.splitlines():
        fail(f"[train cli] the script did not print {line!r}: {out[-500:]}")
    recs = read_metrics(os.path.join(work, "log", PRESET, "metrics.jsonl"))
    evals = [r["step"] for r in recs if "eval/mean_reward" in r]
    if evals != [PER_ITER, 2 * PER_ITER]:
        fail(f"[train cli] evals at {evals}")
    run_dir = os.path.join(work, "models", PRESET)
    if CheckpointManager(run_dir).latest_step() != 2 * PER_ITER:
        fail("[train cli] no checkpoint at step 65536")
    t0 = time.perf_counter()
    run_module(train + ["--total-timesteps", str(3 * PER_ITER), "--resume"], work)
    secs_r = time.perf_counter() - t0
    run_module(train + ["--total-timesteps", str(3 * PER_ITER), "--model-name", "one_go"], work)
    resumed = CheckpointManager(run_dir).restore(map_location="cpu")
    one_go = CheckpointManager(os.path.join(work, "models", "one_go")).restore(map_location="cpu")
    if resumed.iteration != 3 or not all(
            torch.equal(resumed.params[k], one_go.params[k]) for k in one_go.params):
        fail("[train cli] the resumed third iteration differs from a 3-iteration run in one go")
    agent = os.path.join(work, "agent.pt")
    run_module(["hex_gym_env_tpu_torch.scripts.export_agent", "--experiment", PRESET,
                "--out", agent], work)
    exported = load_params(agent)
    if not all(torch.equal(exported[k], resumed.params[k]) for k in resumed.params):
        fail("[train cli] the exported params: file differs from the checkpoint's params")
    t0 = time.perf_counter()
    res = json.loads(run_module(["hex_gym_env_tpu_torch.scripts.match", "--board-size", str(N),
                                 "--games", "1024", "--a", f"params:{agent}", "--b", "random"],
                                work).splitlines()[-1])
    secs_m = time.perf_counter() - t0
    if res["games"] != 1024 or not 0.0 <= res["a_winrate"] <= 1.0:
        fail(f"[train cli] the match of the exported agent: {res}")
    one_go_recs = read_metrics(os.path.join(work, "log", "one_go", "metrics.jsonl"))
    print(f"[train cli] scripts.train {PRESET}: 2 iterations {secs_a:.1f} s wall (the process "
          f"and the first iteration's set-up included), resume to 3 {secs_r:.1f} s; s per "
          f"iteration from metrics.jsonl: 2-iteration run {iteration_seconds(recs)}, one-go run "
          f"{iteration_seconds(one_go_recs)}; the resumed iteration 3 bitwise equals the one-go "
          f"run's; export_agent -> params: bitwise; exported agent vs random over 1024 games on "
          f"the card: A winrate {res['a_winrate']} ({secs_m:.1f} s with the process)")
    shutil.rmtree(work, ignore_errors=True)


def _gloo_rank(rank: int, n: int, port: int, outdir: str) -> None:
    """One of the ranks of ``[distributed]``'s gloo run: both on ``cuda:0``."""
    import torch
    import torch.distributed as dist

    from hex_gym_env_tpu_torch.experiments import get_config
    from hex_gym_env_tpu_torch.parallel import DistributedSelfplayPPO, bootstrap, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    bootstrap.init_distributed(f"localhost:{port}", n, rank, backend="gloo")
    try:
        mesh = make_mesh(torch.device("cuda", 0))
        algo = DistributedSelfplayPPO(get_config(PRESET), mesh)
        state = algo.init_sharded_state(DIST_SEED)
        _, res0 = algo.eval_step(state)  # the initial state's eval, at D = n
        state = algo.init_sharded_state(DIST_SEED)
        for _ in range(2):
            state, _ = algo.train_step(state)
            state, _ = algo.eval_step(state)
        torch.cuda.synchronize()
        torch.save({"rewards0": res0.rewards.cpu(), "grad_reduces": algo.grad_reduces,
                    "params": {k: v.cpu() for k, v in state.params.items()}},
                   os.path.join(outdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def eval_split_is_near_tie(topo, model, params, served, words, seat, rec_k, rec_c, e) -> bool:
    """Where the card's and the CPU's sharded eval end episode ``e``
    otherwise, the first ply at which their actions differ must be a near
    tie of the side to move (as in ``[match]``): replay the CPU's actions up
    to it, then the top two of the scores it compares (masked logits, plus
    Gumbel noise for the opponent) within TOL of the row's largest logit."""
    import torch

    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.models.mlp import stacked_pi_logits
    from hex_gym_env_tpu_torch.ops import masked

    A = topo.num_cells
    t = int((rec_k["actions"][:, e] != rec_c["actions"][:, e]).nonzero()[0])
    st = hex_env.initial_state(topo, 1, "cpu")
    for u in range(t):
        agent = u % 2 == 1
        active = torch.tensor([(seat == 1) if u == 0 else (agent or not bool(st.done[0]))])
        st, _ = hex_env.step(topo, st, rec_c["actions"][u, e:e + 1], active)
    legal = hex_env.legal_mask(topo, st)
    with torch.no_grad():
        if t % 2 == 1:  # the agent's argmax
            logits = torch.func.functional_call(
                model, params, (hex_env.observe(topo, st).to(torch.float32),))[0][0]
            scores = masked.mask_logits(logits, legal[0])
        else:  # the served member's Gumbel-max draw
            obs_f = hex_env.observe(topo, st).reshape(1, -1).to(torch.float32)
            one = {k: v[e:e + 1] for k, v in served.items()}
            logits = stacked_pi_logits(one, len(model.pi_layers), model.activation, obs_f)[0, 0]
            ply = words[e, 1 + (t // 2) * A:1 + (t // 2 + 1) * A]
            scores = masked.mask_logits(logits, legal[0]) + masked.gumbel(ply)
    top = scores.topk(2).values
    return float(top[0] - top[1]) <= TOL * float(logits[legal[0]].abs().max())


def distributed_phase(dev) -> dict:
    """``[distributed]``: ``scripts.train --multichip`` at the preset in a
    subprocess (its own NCCL group of one process); the same run in this
    process over an NCCL group of one, with the launches of each iteration,
    the sweep's all-reduces and the stage split, equal to the subprocess's
    and resumed bitwise; the sharded eval on the card against the CPU on the
    same words; and two ranks on the one card over gloo with CUDA tensors
    (NCCL refuses two ranks on one GPU): params bitwise replicated, the
    eval's rewards at D = 2 equal D = 1's.  Returns the launches of one
    iteration (train + eval)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from hex_gym_env_tpu_torch.core.topology import get_topology
    from hex_gym_env_tpu_torch.experiments import get_config
    from hex_gym_env_tpu_torch.ops import cuda_lib, masked
    from hex_gym_env_tpu_torch.parallel import DistributedSelfplayPPO, bootstrap, make_mesh
    from hex_gym_env_tpu_torch.ops.cuda_lib import philox_seed
    from hex_gym_env_tpu_torch.parallel.mesh import tree_map
    from hex_gym_env_tpu_torch.train.evaluate import Evaluator, episode_words
    from hex_gym_env_tpu_torch.train.trainer import Trainer
    from hex_gym_env_tpu_torch.utils.checkpoint import CheckpointManager

    work = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    topo = get_topology(N)
    E = get_config(PRESET).selfplay.eval_episodes
    k1_eval = 1 + 2 * (topo.num_cells // 2 + 2)

    # (a) the script's --multichip path in its own process
    t0 = time.perf_counter()
    out = run_module(["hex_gym_env_tpu_torch.scripts.train", "--experiment", PRESET,
                      "--multichip", "--seed", str(DIST_SEED), "--total-timesteps",
                      str(2 * PER_ITER), "--checkpoint-every", str(PER_ITER),
                      "--model-name", "dist_cli"], work)
    secs_cli = time.perf_counter() - t0
    if f"training dist_cli: {2 * PER_ITER} transitions on 1 device(s)" not in out.splitlines():
        fail(f"[distributed] scripts.train --multichip printed {out[-500:]}")
    cli_state = CheckpointManager(os.path.join(work, "models", "dist_cli")).restore(
        map_location="cpu")

    # (b) the same run here, over an NCCL group of one process
    bootstrap.init_distributed(f"localhost:{bootstrap.free_port()}", 1, 0, backend="nccl")
    mesh = make_mesh()
    if mesh.group is None or dist.get_backend() != "nccl" or mesh.world_size != 1:
        fail(f"[distributed] not an NCCL group of one: {mesh}")
    tcfg = get_config(PRESET, seed=DIST_SEED, total_timesteps=2 * PER_ITER,
                      checkpoint_every=PER_ITER, log_dir=os.path.join(work, "log"),
                      model_dir=os.path.join(work, "models"), model_name="dist")
    algo = DistributedSelfplayPPO(tcfg, mesh)
    trainer = Trainer(tcfg, algo=algo)
    stages = {"rollout": [], "gae": [], "sweep": [], "all-reduce in sweep": [], "eval": [],
              "pool update": []}
    in_sweep = [False]

    def timed(stage, fn):
        def run(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            in_sweep[0] = stage == "sweep"
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            in_sweep[0] = False
            stages[stage].append((start, end))
            return out
        return run

    all_reduce = dist.all_reduce

    def timed_all_reduce(*args, **kwargs):
        if not in_sweep[0]:
            return all_reduce(*args, **kwargs)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = all_reduce(*args, **kwargs)
        end.record()
        stages["all-reduce in sweep"].append((start, end))
        return out

    algo.local_runner.run = timed("rollout", algo.local_runner.run)
    algo.gae_fn = timed("gae", algo.gae_fn)
    algo.dist_update_fn = timed("sweep", algo.dist_update_fn)
    algo.evaluator.play_vs_pool_sharded = timed("eval", algo.evaluator.play_vs_pool_sharded)
    algo.evaluator.apply_pool_update = timed("pool update", algo.evaluator.apply_pool_update)
    marks = []
    train_step = algo.train_step

    def marked_train_step(state):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), dict(cuda_lib.launches), algo.grad_reduces))
        return train_step(state)

    algo.train_step = marked_train_step
    dist.all_reduce = timed_all_reduce
    try:
        state_a = trainer.fit()
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = all_reduce
    marks.append((time.perf_counter(), dict(cuda_lib.launches), algo.grad_reduces))
    want = dict.fromkeys(cuda_lib.KERNELS, 0)
    want.update(k4_rollout=1, k5_gae=1, k1_step=k1_eval)
    G = tcfg.ppo.n_epochs * (PER_ITER // tcfg.ppo.minibatch_size)
    per_iter_counts = []
    for i in range(2):
        got = {k: marks[i + 1][1][k] - marks[i][1][k] for k in cuda_lib.KERNELS}
        reduces = marks[i + 1][2] - marks[i][2]
        if got != want or reduces != G:
            fail(f"[distributed] iteration {i + 1} launched {got} with {reduces} gradient "
                 f"all-reduces: expected {want} and {G}")
        per_iter_counts.append(got)
    if not all(torch.equal(state_a.params[k].cpu(), cli_state.params[k]) for k in cli_state.params):
        fail("[distributed] the run in this process differs from scripts.train --multichip's")
    iter_s = [round(marks[i + 1][0] - marks[i][0], 4) for i in range(2)]
    split = {k: [round(s.elapsed_time(e), 3) for s, e in v] for k, v in stages.items()}
    split["all-reduce in sweep"] = [
        round(sum(split["all-reduce in sweep"][i * G:(i + 1) * G]), 3) for i in range(2)]
    trainer_r = Trainer(dataclasses.replace(tcfg, model_name="dist_resumed"),
                        algo=DistributedSelfplayPPO(tcfg, mesh))
    start = trainer_r.algo.shard_state(trainer._ckpt_mgr().restore(step=PER_ITER,
                                                                   map_location=dev))
    state_r = trainer_r.fit(start)
    if not all(torch.equal(state_r.params[k], state_a.params[k]) for k in state_a.params):
        fail("[distributed] the resumed iteration 2 differs from the uninterrupted one")
    algo_r = trainer_r.algo
    wall_us, busy, top, top_host = device_profile(
        lambda: algo_r.eval_step(algo_r.train_step(state_r)[0]))
    print(f"[distributed] scripts.train --multichip, NCCL group of one: 2 iterations "
          f"{secs_cli:.1f} s wall with the process; in this process (NCCL group of one) the "
          f"same run bitwise; launches per iteration {per_iter_counts[0]}; {G} gradient "
          f"all-reduces per iteration (one a grad step); resume from iteration 1 bitwise")
    print(f"[distributed] s per iteration {iter_s}; stage ms of iterations 1-2 (CUDA events): "
          + "; ".join(f"{k} {v}" for k, v in split.items()))
    print(f"[distributed profile] one iteration (train + eval): wall {wall_us:.1f} us, device "
          f"busy {busy:.1f} us ({100 * busy / wall_us:.1f}%); top kernels (us): "
          + "; ".join(f"{k[:60]} {v:.1f}" for k, v in top))
    print("[distributed profile] top host ops by self CPU time (us): "
          + "; ".join(f"{k[:40]} {v:.1f}" for k, v in top_host))

    # the sharded eval on the card (D = 1, the group of one) against the CPU on the same words
    state0 = algo.init_sharded_state(DIST_SEED)
    g = torch.Generator()
    g.set_state(state0.generator.get_state())
    eval_seed = philox_seed(g)  # the eval seed eval_step draws first
    eids = torch.arange(E)
    rec_k, rec_c = {}, {}
    rewards_k = algo.evaluator.play_vs_pool_sharded(state0.params, state0.bank, eval_seed, eids,
                                                    None, record=rec_k)
    _, res1 = algo.eval_step(state0)
    if not torch.equal(res1.rewards, rewards_k):
        fail("[distributed] eval_step's rewards differ from the sharded eval on its seed")
    params_c, bank_c = tree_map(lambda t: t.cpu(), (state0.params, state0.bank))
    ev_c = Evaluator(topo, algo.model, tcfg.selfplay, device="cpu")
    rewards_c = ev_c.play_vs_pool_sharded(params_c, bank_c, eval_seed, eids, None, record=rec_c)
    split_eps = (rewards_k.cpu() != rewards_c).nonzero().flatten().tolist()
    words = episode_words(eval_seed, eids, topo.num_cells, topo.num_cells // 2 + 3)
    seat = (masked.unit_uniform(words[:, 0]) < 0.5).to(torch.int32)
    served = {k: v[torch.clamp(eids, max=bank_c.size - 1)] for k, v in bank_c.params.items()}
    ties = [e for e in split_eps if eval_split_is_near_tie(
        topo, algo.model, params_c, served, words, int(seat[e]), rec_k, rec_c, e)]
    if len(ties) != len(split_eps):
        fail(f"[distributed] {len(split_eps) - len(ties)} eval episodes end otherwise on the "
             "card than on the CPU, not at a near tie")
    same = int((rec_k["actions"] == rec_c["actions"]).all(0).sum())
    dist.destroy_process_group()

    # (c) two ranks on the one card over gloo, CUDA tensors
    t0 = time.perf_counter()
    bootstrap.spawn(_gloo_rank, 2, (2, bootstrap.free_port(), work), timeout=600)
    secs_gloo = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True) for r in range(2)]
    if not all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in ranks[0]["params"]):
        fail("[distributed] the two gloo ranks' params differ after 2 iterations")
    if not all(torch.equal(r["rewards0"], res1.rewards.cpu()) for r in ranks):
        fail(f"[distributed] the eval's rewards at D = 2 {ranks[0]['rewards0']} differ from "
             f"D = 1's {res1.rewards}")
    print(f"[distributed] sharded eval, {E} episodes, the card (D = 1) against the CPU on the "
          f"same words: rewards equal in {E - len(split_eps)}, {len(ties)} differ at near ties; "
          f"every action equal in {same}; two ranks on the card over gloo (CUDA tensors): "
          f"params bitwise equal after 2 iterations ({ranks[0]['grad_reduces']} gradient "
          f"all-reduces a rank), the initial eval's rewards at D = 2 equal D = 1's; "
          f"{secs_gloo:.1f} s with the processes")
    shutil.rmtree(work, ignore_errors=True)
    return per_iter_counts[0]


CLI_SESSION = ("boardsize 7\nplay b d4\ngenmove w\nplay b c5\ngenmove w\nshowboard\n"
               "final_score\nname\nquit\n")


def scripts_phase(dev) -> dict:
    """``[scripts]``: a ``play_cli`` session on the card with the trained
    7x7 agent, the graft ``entry()`` actor step 8 times at batch 1024 (K1
    launches asserted), ``dryrun_multichip(1)`` (NCCL), and ``play_gui``
    built headless where ``pygame`` is installed.  Returns the launches of
    the 8 actor steps."""
    import torch

    from hex_gym_env_tpu_torch.__graft_entry__ import dryrun_multichip, entry
    from hex_gym_env_tpu_torch.models.loading import agent_path
    from hex_gym_env_tpu_torch.ops import cuda_lib

    agent = f"params:{agent_path(MATCH_N)}"
    t0 = time.perf_counter()
    out = run_module(["hex_gym_env_tpu_torch.scripts.play_cli", "--board-size", "7",
                      "--checkpoint", agent], REPO, stdin=CLI_SESSION)
    secs = time.perf_counter() - t0
    replies = [line for line in out.splitlines() if line.startswith(("=", "?"))]
    moves = [r.split()[1] for r, c in zip(replies, CLI_SESSION.splitlines())
             if c.startswith("genmove")]
    board = [line for line in out.splitlines() if line.strip() and set(line.strip()) <= set("BW. ")]
    if any(r.startswith("?") for r in replies) or len(moves) != 2 or len(board) != 7:
        fail(f"[scripts] play_cli session: {out}")
    print(f"[scripts] play_cli on the card with {agent}: genmove answered {moves}, board of "
          f"{sum(line.count('B') + line.count('W') for line in board)} stones, final_score "
          f"{replies[6][2:]}; {secs:.1f} s with the process")

    fn, (params, state, gen) = entry()
    fn(params, state, gen)  # warm-up
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    for _ in range(8):
        state, (action, rewards, value) = fn(params, state, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 8 * 1e3
    counts = dict(cuda_lib.launches)
    want = dict.fromkeys(cuda_lib.KERNELS, 0)
    want["k1_step"] = 8
    if counts != want or action.shape != (1024,) or not bool(torch.isfinite(value).all()):
        fail(f"[scripts] entry()'s actor step launched {counts} (expected {want})")
    t0 = time.perf_counter()
    dryrun_multichip(1)
    print(f"[scripts] graft entry(): 8 eager actor steps at batch 1024, {ms:.3f} ms a step, "
          f"K1 {counts['k1_step']} launches; dryrun_multichip(1) (NCCL) ok in "
          f"{time.perf_counter() - t0:.1f} s")

    try:
        import pygame  # noqa: F401
    except ImportError:
        print("[scripts] play_gui not run on the card: pygame is not installed here (the "
              "GUI's tests run on the CPU)")
        return counts
    os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
    os.environ.setdefault("SDL_AUDIODRIVER", "dummy")
    from hex_gym_env_tpu_torch.scripts.play_gui import build

    env, act = build(MATCH_N, agent, agent_seat=0, device=dev)
    obs, _ = env.reset()
    legal = env.legal_actions()
    a = act(obs, legal)
    if not legal[a]:
        fail("[scripts] play_gui's agent chose an illegal move")
    env.opponent_model.gui.update_board(env.world_board())
    pygame.quit()
    print(f"[scripts] play_gui built headless on the card (SDL_VIDEODRIVER=dummy): the agent opens "
          f"at {a}")
    return counts


# ---------------------------------------------------------------------------
# slice 11: the repo's verify and measure tools
# ---------------------------------------------------------------------------

# the 7x7 MLP preset's shape for the breakdown (its per-stage yardstick)
BREAKDOWN_PRESET = ["--board-size", "7", "--n-envs", "256", "--n-steps", "128",
                    "--minibatch-size", "4096", "--buffer-size", "30", "--repeats", "3"]
BREAKDOWN_STAGES = ["null_dispatch", "rollout", "gae", "update", "update_lax", "perm_gather",
                    "train_step", "superstep_per_iter"]


def tools_phase(dev) -> dict:
    """``[tools]``: the port's verify and measure tools on the card, each
    through its ``main``: ``scripts.selftest`` (``--repeats 0``), the 5x5
    learning probe ``scripts.verify_train`` with ``pallas-fast`` and with
    ``pallas``, ``scripts.breakdown_bench`` at its defaults and at the 7x7
    MLP preset's shape, and ``scripts.scaling_bench --devices 1 --predict``
    in an NCCL group of one.  A tool's non-zero exit or failed check fails
    the run.  Returns the launches of each kernel in the phase."""
    from hex_gym_env_tpu_torch.ops import cuda_lib
    from hex_gym_env_tpu_torch.scripts import breakdown_bench, scaling_bench, selftest, verify_train

    def tool(module, argv):
        name = module.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        try:
            out = module.main(argv)
        except SystemExit as e:
            fail(f"[tools] {name} {' '.join(argv)} exited {e.code}")
        except AssertionError as e:
            fail(f"[tools] {name} {' '.join(argv)} failed its check: {e}")
        print(f"[tools] {name} {' '.join(argv)}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    cuda_lib.reset_launches()
    st = tool(selftest, ["--repeats", "0"])
    chi2 = st["chi_square"]
    if len(chi2) != 4 or max(chi2.values()) >= selftest.CHI2_CRIT:
        fail(f"[tools] selftest chi-squares {chi2}")
    probes = [tool(verify_train, [impl]) for impl in ("pallas-fast", "pallas")]
    if not all(p["pass"] and p["transitions"] == 128 * 256 * 64 for p in probes):
        fail(f"[tools] verify_train: {probes}")
    tables = {}
    for label, argv in (("defaults", []), ("7x7 preset", BREAKDOWN_PRESET)):
        recs = tool(breakdown_bench, argv)
        stages = [r["stage"] for r in recs[:-1]]
        summary = recs[-1].get("summary", {})
        if (stages != BREAKDOWN_STAGES or summary.get("peak") != "fp32"
                or len(summary.get("roofline", [])) != len(BREAKDOWN_STAGES) - 1
                or summary.get("sustained_mfu_pct") is None):
            fail(f"[tools] breakdown_bench {label}: stages {stages}, summary {summary}")
        tables[label] = {r["stage"]: r["ms"] for r in recs[:-1]}
        print(f"[tools] breakdown at {label}: " + ", ".join(
            f"{k} {v} ms" for k, v in tables[label].items())
            + f"; update_lax / update {tables[label]['update_lax'] / tables[label]['update']:.1f}"
            + f"; sustained {summary['sustained_transitions_per_s']} transitions/s, "
            f"{summary['sustained_mfu_pct']}% of the fp32 peak")
    rows = tool(scaling_bench, ["--devices", "1", "--predict"])
    row, pred = rows[0], rows[1]["predicted_scaling"]
    grads = row["grad_allreduces_per_iter"]
    want = {"train_step": {"all_reduce": grads + 2, "broadcast": 0},
            "eval_step": {"all_reduce": 1, "broadcast": 0}}
    if (row["devices"] != 1 or row["platform"] != "cuda" or row["collectives"] != want
            or grads != 80 or pred["model"]["grad_allreduces_per_iter"] != grads
            or len(pred["hosts"]) != 3):
        fail(f"[tools] scaling_bench: {row}, {pred}")
    st_ = row["stages"]
    print(f"[tools] scaling D = 1 (NCCL group of one): iter {row['iter_ms']:.3f} ms, "
          f"{row['transitions_per_s']:.1f} transitions/s, collectives a train step "
          f"{row['collectives']['train_step']}, an eval {row['collectives']['eval_step']}; "
          f"rollout + GAE {st_['rollout_gae_ms']:.3f} ms, sweep {st_['update_allreduce_ms']:.3f} "
          f"ms with its all-reduces, {st_['update_local_ms']:.3f} ms without, delta "
          f"{st_['collective_delta_ms']:.3f} ms; eval sharded {row['eval_sharded_ms']:.3f} ms, "
          f"replicated {row['eval_replicated_ms']:.3f} ms; predicted efficiency at 1, 2, 4 hosts "
          f"{[h['predicted_efficiency'] for h in pred['hosts']]}")
    counts = dict(cuda_lib.launches)
    ran = ("k1_step", "k2_agent", "k2_agent_image", "k3_bank", "k3_bank_image", "k4_rollout",
           "k5_gae", "k6_ppo")
    if not all(counts[k] > 0 for k in ran):
        fail(f"[tools] the tools launched {counts}: a kernel of their paths did not run")
    print(f"[tools] launches in the phase: {counts}")
    return counts


def tools_only() -> int:
    import torch

    if not preflight(torch):
        return 1
    from hex_gym_env_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_lib.build(verbose=False)
    cuda_lib.lib()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tools_phase(torch.device("cuda"))
    print(f"[tools] phase {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


def train_only() -> int:
    import torch

    if not preflight(torch):
        return 1
    from hex_gym_env_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_lib.build(verbose=False)
    cuda_lib.lib()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda")
    for phase in (train_cli_phase, distributed_phase, scripts_phase):
        t0 = time.perf_counter()
        phase(dev)
        print(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


def cnn_only() -> int:
    import torch

    if not preflight(torch):
        return 1
    from hex_gym_env_tpu_torch.ops import cuda_lib

    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_lib.build(verbose=False)
    cuda_lib.lib()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
    cnn_phase(torch.device("cuda"))
    return 0


def match_only() -> int:
    import torch

    if not preflight(torch):
        return 1
    from hex_gym_env_tpu_torch.ops import cuda_lib

    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_lib.build(verbose=False)
    cuda_lib.lib()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    match_phase(torch.device("cuda"))
    compat_phase(torch.device("cuda"))
    print(f"[match + compat] phases {time.perf_counter() - t0:.1f} s")
    return 0


def preflight(torch, root: str = REPO) -> bool:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return False
    if not os.path.exists(os.path.join(root, "hex_gym_env_tpu_torch", "csrc", "hex_kernels.cu")):
        print(f"chip_smoke: the port's sources are not in {root}", file=sys.stderr)
        return False
    sys.path.insert(0, os.path.abspath(root))
    return True


def split_only(label: str) -> int:
    import torch

    if not preflight(torch):
        return 1
    from hex_gym_env_tpu_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_lib.build(verbose=True)
    cuda_lib.lib()
    print(f"[split {label}] kernels built in {time.perf_counter() - t0:.1f} s")
    phase_splits(label)
    return 0


def env_only(label: str, root: str) -> int:
    import torch

    if not preflight(torch, root):
        return 1
    from hex_gym_env_tpu_torch.ops import cuda_lib

    print(f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_lib.lib()
    print(f"[env {label}] kernels built in {time.perf_counter() - t0:.1f} s from "
          f"{os.path.dirname(cuda_lib.__file__)}")
    env_kernel_times(label)
    return 0


def main() -> int:
    import numpy as np
    import torch

    if not preflight(torch):
        return 1

    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.core.topology import get_topology
    from hex_gym_env_tpu_torch.experiments import get_config
    from hex_gym_env_tpu_torch.models import make_policy
    from hex_gym_env_tpu_torch.ops import cuda_lib, masked
    from hex_gym_env_tpu_torch.ops import labels as torch_labels
    from hex_gym_env_tpu_torch.ops import policy_kernel as pk
    from hex_gym_env_tpu_torch.ops import rollout_kernel as rk
    from hex_gym_env_tpu_torch.ops import step_kernel
    from hex_gym_env_tpu_torch.train.bank import OpponentBank, init_bank
    from hex_gym_env_tpu_torch.train.rollout import SelfplayRunner
    import dataclasses

    torch.backends.cuda.matmul.allow_tf32 = False  # the twins in full float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_lib.build(verbose=True)
    cuda_lib.lib()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")

    # ---- shared inputs at the main path's shapes -----------------------------
    cfg = get_config("7x7_MLP-default_lr-0.0003").selfplay
    assert (cfg.board_size, cfg.n_envs, cfg.buffer_size, cfg.policy) == (N, B, POOL, "MLP-default")
    topo = get_topology(N)
    F = A = topo.num_cells
    L = topo.lanes
    g = torch.Generator().manual_seed(1234)
    model = make_policy(cfg.policy, A, generator=g)
    params = {k: v.detach().to(dev) for k, v in model.state_dict().items()}
    snaps = [make_policy(cfg.policy, A, generator=g).state_dict() for _ in range(POOL + 1)]
    bank0 = init_bank(params, POOL)
    bank = OpponentBank(
        params={k: torch.stack([s[k] for s in snaps[:POOL]]).to(dev) for k in params},
        scores=bank0.scores, best_params={k: v.to(dev) for k, v in snaps[POOL].items()},
        best_score=bank0.best_score)
    pol = pk.PolicyOps(model, "pallas")
    twin = pk.PolicyOps(model, "lax")
    d = pol.dims
    P1 = POOL + 1
    packed = pol.pack_agent(params)
    stacked = pol.stack_bank(bank)
    table = rk.first_move_table(stacked, d)

    # mid-game states: random legal plies with the plain env, some games over
    state = hex_env.initial_state(topo, B, dev)
    for _ in range(24):
        legal = hex_env.legal_mask(topo, state)
        a = masked.sample(masked.draw_bits(g, (B, A), dev), torch.zeros((B, A), device=dev), legal)
        state, _ = hex_env.step(topo, state, a)
    print(f"[inputs] {int(state.done.sum())} of {B} games over")

    kernels = {}

    # ---- 2a. K1 env step -------------------------------------------------------
    actions = torch.randint(0, A, (B,), generator=g).to(dev, torch.int32)
    active = (torch.rand((B,), generator=g) < 0.8).to(dev)
    k_state, k_rew = step_kernel.step_cuda(topo, state, actions, active)
    t_state, t_rew = hex_env.step(topo, state, actions, active)
    torch.cuda.synchronize()
    for name in ("stones", "labels", "to_move", "done", "winner", "empty", "move_count"):
        if not torch.equal(getattr(k_state, name), getattr(t_state, name)):
            fail(f"K1 {name} differs from the twin")
    if not torch.equal(k_rew, t_rew):
        fail("K1 rewards differ from the twin")
    # the eval opening's B = 30, the scan path's 256 and 13x13 (256 lanes),
    # with done, inactive and invalid rows and off-board actions
    gk1 = torch.Generator().manual_seed(31)
    for n1, b1, plies in ((N, B, 24), (N, 30, 24), (13, B, 60)):
        topo1 = get_topology(n1)
        s1, a1, act1 = k1_inputs(topo1, b1, plies, gk1)
        ks, kr = step_kernel.step_cuda(topo1, s1, a1, act1)
        ts, tr = hex_env.step(topo1, s1, a1, act1)
        torch.cuda.synchronize()
        for name in ("stones", "labels", "to_move", "done", "winner", "empty", "move_count"):
            if not torch.equal(getattr(ks, name), getattr(ts, name)):
                fail(f"K1 {n1}x{n1} B {b1}: {name} differs from the twin")
        if not torch.equal(kr, tr):
            fail(f"K1 {n1}x{n1} B {b1}: rewards differ from the twin")
        played = act1 & ~s1.done
        print(f"[K1 env step] {n1}x{n1} B {b1} (L {topo1.lanes}): exact; {int(s1.done.sum())} done, "
              f"{int((~act1).sum())} inactive rows, {int((played & (ts.winner == 3)).sum())} invalid "
              f"moves, {int((played & (ts.winner < 2) & (ts.winner >= 0)).sum())} wins; "
              f"launch shape {cuda_lib.env_plan('k1_step', b1, topo1.lanes)}")
    k_ms = cuda_ms(lambda: step_kernel.step_cuda(topo, state, actions, active), 200)
    k_dev = device_ms(lambda: step_kernel.step_cuda(topo, state, actions, active),
                      KERNEL_NAMES["k1_step"], 200)
    p_ms = cuda_ms(lambda: hex_env.step(topo, state, actions, active), 50)
    n_bytes = B * (6 * L + 5 * 4 + 2) + B * (6 * L + 4 * 4 + 1 + 8)  # in + out
    bnd, by = bound_ms(n_bytes, 0)
    kernels["k1_step"] = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, max_abs_err=0.0,
                              bound_ms=bnd, bound_by=by)
    print(f"[K1 env step] exact; call {k_ms:.5f} ms, device {k_dev:.5f} ms, twin {p_ms:.4f} ms")
    # where the call's host time goes: the whole wrapper, its two output
    # buffers and their views, and the bare C entry on the same arguments
    _, _, ints1, bytes1 = step_kernel.carve_outputs(B, L, dev, 2 * B)
    c_args = [cuda_lib.ptr(t) for t in (state.stones, state.labels, state.to_move, state.done,
                                         state.winner, state.empty, state.move_count, actions,
                                         active, ints1, bytes1)]
    c_args += [B, N, L, torch.cuda.current_stream().cuda_stream]
    hex_step = cuda_lib.lib().hex_step
    print("[K1 env step] host us per call: " + ", ".join(f"{name} {host_us(fn, 2000):.2f}" for name, fn in (
        ("step_cuda", lambda: step_kernel.step_cuda(topo, state, actions, active)),
        ("carve_outputs", lambda: step_kernel.carve_outputs(B, L, dev, 2 * B)),
        ("bare C entry", lambda: hex_step(*c_args)))))

    # ---- 2b. K2 agent pass on its agent image -----------------------------------------
    k2_err, k2_ties, k2_cases = 0.0, 0, {}
    g2 = torch.Generator().manual_seed(22)
    gen_k = torch.Generator().manual_seed(1)
    for n2, fam2, b2 in K2_SHAPES:
        err, ties, c2 = k2_check(n2, fam2, b2, g2, gen_k)
        k2_err, k2_ties, k2_cases[(n2, fam2, b2)] = max(k2_err, err), k2_ties + ties, c2
    c2 = k2_cases[(N, cfg.policy, B)]
    k2_k = k2_call(c2, generator=gen_k)
    k_ms = cuda_ms(k2_k, 200)
    k_dev = device_ms(k2_k, KERNEL_NAMES["k2_agent"], 200)
    p_ms = cuda_ms(k2_call(c2, c2["twin"]), 50)
    image_dev = device_ms(lambda: pk.agent_operand(c2["packed"], d, "pallas"),
                          KERNEL_NAMES["k2_agent_image"], 50)
    # the bound: the function's own work, the packed float32 agent as its
    # input (the image is the kernel's layout of it)
    flops = 2 * B * (pk.tower_size(d, A) + pk.tower_size(d, 1) - (2 * d.H * d.n_layers + A + 1))
    n_bytes = 4 * c2["packed"].numel() + B * F + B * A + B * 12 + B * A * 4
    bnd, by = bound_ms(n_bytes, flops)
    kernels["k2_agent"] = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, max_abs_err=k2_err,
                               bound_ms=bnd, bound_by=by, image_device_ms=image_dev)
    print(f"[K2 agent] max err {k2_err:.3g}, near-tie rows {k2_ties}; 7x7 B {B}: call {k_ms:.4f} ms, "
          f"device {k_dev:.5f} ms, twin {p_ms:.4f} ms; the agent image, once per rollout: device "
          f"{image_dev:.5f} ms")
    # where the call's host time goes: the whole wrapper and the bare C entry
    # on the same arguments and output buffer
    out2 = torch.empty((B * (A + 3),), dtype=torch.float32, device=dev)
    c_args = [cuda_lib.ptr(c2["op"].image), d.F, d.H, A, d.n_layers, int(d.relu),
              cuda_lib.ptr(c2["obs"]), cuda_lib.ptr(c2["legal"]), None, 5,
              *(out2.data_ptr() + 4 * B * k for k in (0, A, A + 1, A + 2)), B,
              torch.cuda.current_stream().cuda_stream]
    hex_agent = cuda_lib.lib().hex_agent
    print("[K2 agent] host us per call: " + ", ".join(f"{name} {host_us(fn, 2000):.2f}" for name, fn in (
        ("agent_act", k2_k), ("bare C entry", lambda: hex_agent(*c_args)))))

    # ---- 2c. K3 bank pass on its bank image ----------------------------------------
    k3_err, k3_ties, k3_cases = 0.0, 0, {}
    g3 = torch.Generator().manual_seed(33)
    for n3, b3 in K3_SHAPES:
        c3 = k3_case(n3, b3, g3)
        d3 = c3["pol"].dims
        cuda_lib.reset_launches()
        image3 = pk.bank_operand(c3["stacked"], d3, "pallas").image
        if cuda_lib.launches["k3_bank_image"] != 1 or not torch.equal(
                image3, pk.bank_image_twin(c3["stacked"], d3)):
            fail(f"K3's bank image at {n3}x{n3} differs from its twin")
        ka, km = k3_call(c3)()
        ta, tm = k3_call(c3, c3["twin"])()
        torch.cuda.synchronize()
        top2 = torch.topk(tm + masked.gumbel(c3["bits"]), 2, dim=-1).values
        ties = check_actions(f"K3 {n3}x{n3} B {b3}", ka, ta, top2[:, 0] - top2[:, 1])
        err = float((km - tm).abs().max())
        if err > TOL:
            fail(f"K3 {n3}x{n3} B {b3}: logits differ by {err}")
        k3_err, k3_ties, k3_cases[(n3, b3)] = max(k3_err, err), k3_ties + ties, c3
        print(f"[K3 bank] {n3}x{n3} B {b3}: image exact, max err {err:.3g}, near-tie rows {ties}, "
              f"{c3['done']} games over, {int(c3['use_best'].sum())} rows on the best")
    c3 = k3_cases[(N, B)]
    k3_k = k3_call(c3, generator=gen_k)
    k_ms = cuda_ms(k3_k, 200)
    k_dev = device_ms(k3_k, KERNEL_NAMES["k3_bank"], 200)
    p_ms = cuda_ms(k3_call(c3, c3["twin"]), 50)
    image_dev = device_ms(lambda: pk.bank_operand(c3["stacked"], d, "pallas"),
                          KERNEL_NAMES["k3_bank_image"], 50)
    members = torch.where(c3["use_best"], P1 - 1, c3["member"])
    used = int(members.unique().numel())
    flops = 2 * B * (pk.tower_size(d, A) - (d.H * d.n_layers + A))
    n_bytes = 4 * used * pk.tower_size(d, A) + B * F + B * A + B * 4 + B * 4 + B * A * 4
    bnd, by = bound_ms(n_bytes, flops)
    kernels["k3_bank"] = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, max_abs_err=k3_err,
                              bound_ms=bnd, bound_by=by, image_device_ms=image_dev)
    print(f"[K3 bank] max err {k3_err:.3g}, near-tie rows {k3_ties}; 7x7 B {B}: call {k_ms:.4f} ms, "
          f"device {k_dev:.5f} ms, twin {p_ms:.4f} ms; the bank image, once per rollout: device "
          f"{image_dev:.5f} ms")

    # ---- 2d. K4 whole rollout, training and eval mode ------------------------------
    setup = SelfplayRunner(topo, model, dataclasses.replace(
        cfg, rollout_impl="scan", policy_impl="lax", env_step_impl="lax"), device=dev)
    carry = setup.init_carry(bank, g)
    rbits = rk.draw_rollout_bits(g, T, B, A, dev)
    # a bank at trained magnitudes (members N(0, 0.3^2), logits of a few
    # units), where the bf16 bank moves every row's logits far past TOL
    stacked_w = (torch.randn(stacked.shape, generator=g) * 0.3).to(dev)
    table_w = rk.first_move_table(stacked_w, d)

    def k4_against_twin(bank_s, table_s, eval_mode, bank_bf16, kernel_bf16=None):
        """K4's ``kernel_bf16`` instance (``bank_bf16``'s by default) against
        the twin on ``bank_bf16``'s bank, the same bits: (problems, stats)."""
        kernel_bf16 = bank_bf16 if kernel_bf16 is None else kernel_bf16
        klog = torch.full((T, B, A), float("nan"), device=dev)
        tlog = torch.full_like(klog, float("nan"))
        kout = rk.fused_rollout(topo, pol, packed, bank_s, table_s, carry.env, carry.agent_seat,
                                carry.use_best, carry.opp_idx, T, cfg.best_prob, True, bits=rbits,
                                eval_mode=eval_mode, bank_bf16=kernel_bf16, opp_logits=klog)
        tout, margins = rk.fused_rollout_twin(
            topo, d, packed, bank_s, table_s, carry.env, carry.agent_seat, carry.use_best,
            carry.opp_idx, T, cfg.best_prob, True, rbits, eval_mode=eval_mode,
            with_margins=True, bank_bf16=bank_bf16, opp_logits=tlog)
        torch.cuda.synchronize()
        problems = []
        if not bool(torch.isfinite(klog).all()):
            problems.append("opponent logits left unwritten")
        same_obs = (kout.obs == tout.obs).all(-1)
        same = (kout.ints == tout.ints).all(-1) & same_obs  # (T, B)
        # the opponent's logits compare where the game was the same up to its reply
        before = torch.cat([torch.ones_like(same[:1]), same[:-1]]).int().cumprod(0).bool()
        at_opp = before & same_obs & (kout.ints[..., rk.I_ACTION] == tout.ints[..., rk.I_ACTION])
        row_err = (klog - tlog).abs().amax(-1)  # (T, B)
        errs = row_err[at_opp]
        logit_err = float(errs.max())
        share = float((errs > TOL).float().mean())
        if bank_bf16:
            if share > BF16_FLIP_SHARE:
                problems.append(f"{share:.2%} of the opponent's logit rows differ by more than {TOL}")
            if logit_err > BF16_FLIP_REL * float(tlog[at_opp].abs().max()):
                problems.append(f"opponent logits differ by {logit_err}")
        elif logit_err > TOL:
            problems.append(f"opponent logits differ by {logit_err}")
        row_ok = same.all(0)
        for b in (~row_ok).nonzero().flatten().tolist():
            t = int((~same[:, b]).nonzero()[0])
            lanes = (kout.ints[t, b] != tout.ints[t, b]).nonzero().flatten().tolist()
            # an opponent's draw may flip only within twice its row's logit error
            tie = TOL + (2 * float(row_err[t, b]) if bank_bf16 and lanes[:1] == [1] else 0.0)
            if not lanes or lanes[0] > 2 or float(margins[t, b, lanes[0]]) >= tie:
                problems.append(f"row {b} diverges at step {t}, lanes {lanes}")
                break
        for name in ("stones", "labels", "to_move", "done", "empty", "move_count"):
            if not torch.equal(getattr(kout.state, name)[row_ok], getattr(tout.state, name)[row_ok]):
                problems.append(f"final {name} differs")
        for k, tw in ((kout.agent_seat, tout.agent_seat), (kout.use_best, tout.use_best),
                      (kout.opp_idx, tout.opp_idx)):
            if not torch.equal(k[row_ok], tw[row_ok]):
                problems.append("final seat/opponent differs")
        ferr = float((kout.flts - tout.flts)[:, row_ok].abs().max())
        if ferr > TOL:
            problems.append(f"floats differ by {ferr}")
        return problems, dict(kout=kout, rows=int(row_ok.sum()), ferr=ferr, logit_err=logit_err,
                              share=share, compared=int(at_opp.sum()),
                              logit_max=float(tlog[at_opp].abs().max()))

    k4_err = {False: 0.0, True: 0.0}
    for bank_bf16, label, bank_s, table_s in ((False, "preset bank", stacked, table),
                                              (True, "preset bank", stacked, table),
                                              (True, "trained-scale bank", stacked_w, table_w)):
        for eval_mode in (False, True):
            tag = f"eval={eval_mode}, {'bf16' if bank_bf16 else 'float32'} {label}"
            problems, st = k4_against_twin(bank_s, table_s, eval_mode, bank_bf16)
            if problems:
                fail(f"K4 ({tag}): " + "; ".join(problems))
            k4_err[bank_bf16] = max(k4_err[bank_bf16], st["ferr"], st["logit_err"])
            if bank_bf16 and not eval_mode:  # the kernel's own record replays exactly
                rk.verify_rollout_trajectory(topo, model, params, carry, st["kout"], T,
                                             cfg.seat_mode, POOL)
            print(f"[K4 rollout {tag}] {st['rows']}/{B} rows identical, {B - st['rows']} near-tie "
                  f"rows, agent floats max err {st['ferr']:.3g}; opponent logits (up to "
                  f"{st['logit_max']:.3g}) on {st['compared']} rows: max err {st['logit_err']:.3g}, "
                  f"{st['share']:.3%} of rows beyond {TOL}; "
                  f"{int(st['kout'].ints[..., rk.I_DONE].sum())} done flags"
                  + ("; replayed exactly" if bank_bf16 and not eval_mode else ""))
    # the control: the float32 instance in the bf16 instance's place must fail
    problems, st = k4_against_twin(stacked_w, table_w, False, True, kernel_bf16=False)
    if not problems or st["share"] <= BF16_FLIP_SHARE:
        fail("K4's bf16 check passes the float32 instance in the bf16 instance's place")
    print(f"[K4 rollout, control] the float32 instance against the bf16 twin on the trained-scale "
          f"bank is refused: opponent logits max err {st['logit_err']:.3g}, {st['share']:.3%} of "
          f"{st['compared']} rows beyond {TOL}; {st['rows']}/{B} rows identical")

    per_game_step = 2 * (pk.tower_size(d, A) + pk.tower_size(d, 1) - (2 * d.H * d.n_layers + A + 1)) \
        + 2 * (pk.tower_size(d, A) - (d.H * d.n_layers + A))
    flops = T * B * per_game_step
    n_bytes = (4 * (packed.numel() + stacked.numel() + table.numel())
               + 2 * B * (6 * L + 5 * 4 + 2)
               + T * B * F + 2 * T * B * 8 * 4)
    bnd, by = bound_ms(n_bytes, flops)
    for bank_bf16, name in ((False, "k4_rollout"), (True, "k4_rollout_bf16")):
        def k4_call():
            return rk.fused_rollout(topo, pol, packed, stacked, table, carry.env, carry.agent_seat,
                                    carry.use_best, carry.opp_idx, T, cfg.best_prob, True,
                                    generator=gen_k, bank_bf16=bank_bf16)

        k_ms = cuda_ms(k4_call, 10)
        k_dev = device_ms(k4_call, KERNEL_NAMES[name], 10)
        p_ms = cuda_ms(lambda: rk.fused_rollout_twin(
            topo, d, packed, stacked, table, carry.env, carry.agent_seat, carry.use_best,
            carry.opp_idx, T, cfg.best_prob, True, rbits, bank_bf16=bank_bf16), 2)
        # the bf16 bank moves half the members' bytes; the bound counts the
        # float32 bank as the function's input all the same.  max_abs_err is
        # the larger of the agent's floats' and the opponent's logits' errors
        kernels[name] = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, max_abs_err=k4_err[bank_bf16],
                             bound_ms=bnd, bound_by=by)
        print(f"[K4 rollout{', bf16 bank' if bank_bf16 else ''}] call {k_ms:.3f} ms, device "
              f"{k_dev:.4f} ms (both kernels), twin {p_ms:.3f} ms for {T} steps x {B} games")
    print("[K4 rollout] plan (games per CTA, agent / members in shared memory, bytes): float32 "
          f"{cuda_lib.rollout_plan(d.F, d.H, A, d.n_layers, N, L, B)}, bf16 bank "
          f"{cuda_lib.rollout_plan(d.F, d.H, A, d.n_layers, N, L, B, True)}")

    # ---- 2e. K7 random-legal rollout vs its twin, the same bits ---------------------
    gen_c = torch.Generator(device=dev).manual_seed(77)
    init7 = hex_env.initial_state(topo, K7_B, dev)
    mid7 = k7_mid_state(topo, K7_B, 30, gen_c)
    bits7 = masked.draw_bits(gen_c, (K7_T_BITS, K7_B, L), dev)
    for label, start in (("initial", init7), ("mid-game", mid7)):
        k7_exact(topo, start, K7_T_BITS, bits7, label)
    k_ms = cuda_ms(lambda: step_kernel.random_rollout_cuda(topo, mid7, K7_T_BITS, bits=bits7), 10)
    p_ms = cuda_ms(lambda: step_kernel.random_rollout_twin(topo, mid7, K7_T_BITS, bits=bits7), 1)
    print(f"[K7 random rollout] with injected bits, {K7_T_BITS} steps: kernel {k_ms:.3f} ms, "
          f"twin {p_ms:.3f} ms")
    del bits7
    for n7, b7, t7, plies in K7_OTHER_BOARDS:  # 256 lanes, and the smallest board of the tests
        topo7 = get_topology(n7)
        bits_o = masked.draw_bits(gen_c, (t7, b7, topo7.lanes), dev)
        for label, start in (("initial", hex_env.initial_state(topo7, b7, dev)),
                             ("mid-game", k7_mid_state(topo7, b7, plies, gen_c))):
            k7_exact(topo7, start, t7, bits_o, label)
        del bits_o

    # ---- 2f. K7 on its own Philox streams at the benchmark's shape ---------------------
    # seeded from a CPU generator: a CUDA one's seed is read back with a
    # synchronising .item() before each launch (the twin's bits stay on the card)
    gen_p = torch.Generator().manual_seed(78)
    k_out, k_games = step_kernel.random_rollout_cuda(topo, init7, K7_T, generator=gen_p)
    torch.cuda.synchronize()
    s0, s1 = k_out.stones[:, 0], k_out.stones[:, 1]
    if bool((s0 & s1).any()) or bool(s0[:, F:].any()) or bool(s1[:, F:].any()):
        fail("K7 (Philox): stones overlap or sit on padding lanes")
    if not torch.equal(k_out.empty, F - (s0 | s1)[:, :F].sum(-1).to(torch.int32)):
        fail("K7 (Philox): empty disagrees with the boards")
    lo, hi = K7_T // 49, K7_T // 13 + 1
    if int(k_games.min()) < lo or int(k_games.max()) > hi:
        fail(f"K7 (Philox): games per env in [{int(k_games.min())}, {int(k_games.max())}], "
             f"not in [{lo}, {hi}]")
    fresh7 = torch_labels.labels_from_stones(topo, k_out.stones)
    for r0 in range(0, K7_B, 1024):
        got, want = k_out.labels[r0:r0 + 1024], fresh7[r0:r0 + 1024]
        if not torch.equal(got[:, :, None] == got[:, None, :], want[:, :, None] == want[:, None, :]):
            fail("K7 (Philox): labels do not partition as labels_from_stones")
    for seat in range(2):
        if bool(torch_labels.seat_wins(topo, k_out.labels, seat).any()):
            fail(f"K7 (Philox): seat {seat} holds a win")
    start_ev, end_ev = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start_ev.record()
    t_out, t_games = step_kernel.random_rollout_twin(topo, init7, K7_T, generator=gen_c)
    end_ev.record()
    torch.cuda.synchronize()
    k7_plain_ms = start_ev.elapsed_time(end_ev)
    kg, tg = k_games.double(), t_games.double()
    se = float((kg.var() / K7_B + tg.var() / K7_B).sqrt())
    if abs(float(kg.mean() - tg.mean())) >= 3 * se:
        fail(f"K7 (Philox) mean games {float(kg.mean())} vs the twin's {float(tg.mean())} "
             f"(3 standard errors {3 * se})")

    def k7_call():
        return step_kernel.random_rollout_cuda(topo, init7, K7_T, generator=gen_p)

    k7_ms = cuda_ms(k7_call, 10)
    k7_dev = device_ms(k7_call, KERNEL_NAMES["k7_random_rollout"], 10)
    k7_bytes = K7_B * (6 * L + 2 * 4) + K7_B * (6 * L + 4 * 4 + 1 + 4)  # state in; out + games
    bnd, by = bound_ms(k7_bytes, K7_T * K7_B * k7_ops_per_game_step(F))
    old_bnd, _ = bound_ms(k7_bytes, K7_T * K7_B * L * K7_OLD_OPS_PER_LANE_STEP)
    kernels["k7_random_rollout"] = dict(ms=k7_ms, device_ms=k7_dev, plain_ms=k7_plain_ms,
                                        max_abs_err=0.0, bound_ms=bnd, bound_by=by)
    gpc, ctas_per_sm, regs = cuda_lib.env_plan("k7_random_rollout", K7_B, L)
    print(f"[K7 philox] {K7_T} steps x {K7_B} games: invariants hold; games per env "
          f"[{int(k_games.min())}, {int(k_games.max())}], mean {float(kg.mean()):.4f} vs the twin's "
          f"{float(tg.mean()):.4f} on generator bits (3 SE {3 * se:.4f}); call {k7_ms:.4f} ms, "
          f"device {k7_dev:.4f} ms ({K7_T * K7_B / k7_ms / 1e3:.0f} M env-steps/s by call time), "
          f"twin {k7_plain_ms:.1f} ms, bound {bnd:.4f} ms ({by}; {k7_ops_per_game_step(F)} "
          f"operations per game-step, the earlier count over all {L} lanes gave {old_bnd:.4f} ms); "
          f"{gpc} games per CTA, {ctas_per_sm} CTAs resident per SM ({gpc * ctas_per_sm} games), "
          f"{regs} registers a thread")

    # ---- 3. main path: the preset's fused rollout ----------------------------------
    runner = SelfplayRunner(topo, model, cfg, device=dev)
    if runner.fused_pol is None or runner.fused_pol.impl != "auto":
        fail("the preset does not resolve to the whole-rollout kernel")
    gen = torch.Generator().manual_seed(7)
    cuda_lib.reset_launches()
    carry0 = runner.init_carry(bank, gen)
    c, times, record = carry0, [], None
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, tr, last_values = runner.run(params, bank, c, gen, T)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            record = runner.last_record
            if not bool(torch.isfinite(tr.value).all() and torch.isfinite(last_values).all()):
                fail("non-finite values in the rollout")
    main_counts = dict(cuda_lib.launches)
    if main_counts["k4_rollout"] != 3:
        fail(f"the main path launched the rollout kernel {main_counts['k4_rollout']} times, not 3")
    rk.verify_rollout_trajectory(topo, model, params, carry0, record, T, cfg.seat_mode, POOL)
    tps = B * T / (sum(times[1:]) / len(times[1:]))
    print(f"[main path] launches {main_counts}; first rollout replayed exactly; "
          f"{int(record.ints[..., rk.I_DONE].sum())} episodes ended in it")
    print(f"[main path] rollout s {[round(x, 5) for x in times]}; {tps:.0f} transitions/s at n_envs {B}")

    # where one rollout's time goes: device time by kernel over the wall time
    wall_us, busy, top, _ = device_profile(lambda: runner.run(params, bank, c, gen, T))
    print(f"[profile] one rollout: wall {wall_us:.1f} us, device busy {busy:.1f} us "
          f"({100 * busy / wall_us:.1f}%); top kernels (us): "
          + "; ".join(f"{k[:60]} {v:.1f}" for k, v in top))

    big = SelfplayRunner(topo, model, dataclasses.replace(cfg, n_envs=4096), device=dev)
    cb = big.init_carry(bank, gen)
    cb, _, _ = big.run(params, bank, cb, gen, T)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big.run(params, bank, cb, gen, T)
    torch.cuda.synchronize()
    print(f"[main path] {4096 * T / (time.perf_counter() - t0):.0f} transitions/s at n_envs 4096")

    # ---- 4. scan path -----------------------------------------------------------------
    scan = SelfplayRunner(topo, model, dataclasses.replace(cfg, rollout_impl="scan"), device=dev)
    if scan.pol is None or scan.fused_pol is not None:
        fail("the scan path does not resolve to the per-step kernels")
    cuda_lib.reset_launches()
    cs = scan.init_carry(bank, gen)
    cs, trs, lvs = scan.run(params, bank, cs, gen, 8)
    torch.cuda.synchronize()
    scan_counts = dict(cuda_lib.launches)
    for name in ("k1_step", "k2_agent", "k3_bank"):
        if scan_counts[name] == 0:
            fail(f"the scan path never launched {name}")
    if scan_counts["k3_bank_image"] != 2:  # init_carry's bank, then the rollout's
        fail(f"the scan path built the bank image {scan_counts['k3_bank_image']} times, not 2")
    if scan_counts["k2_agent_image"] != 1:  # once per rollout
        fail(f"the scan path built the agent image {scan_counts['k2_agent_image']} times, not 1")
    picked = torch.take_along_dim(trs.legal, trs.action.long()[..., None], -1)
    if not bool(picked.all()) or not bool(torch.isfinite(lvs).all()):
        fail("the scan path produced illegal actions or non-finite values")
    print(f"[scan path] launches {scan_counts}")

    # ---- 5a. K5 GAE vs its twin, on the preset rollout's data ---------------------------
    from hex_gym_env_tpu_torch.ops import gae_kernel
    from hex_gym_env_tpu_torch.ops import ppo_kernel as pkk
    from hex_gym_env_tpu_torch.train import ppo
    from hex_gym_env_tpu_torch.train.selfplay import SelfplayPPO
    from hex_gym_env_tpu_torch.train.trainer import Trainer
    from hex_gym_env_tpu_torch.utils.config import PPOConfig, SelfplayConfig, TrainConfig
    from hex_gym_env_tpu_torch.utils.metrics import MetricsLogger

    tcfg_ppo = get_config(PRESET).ppo
    gae_args = (tr.reward, tr.value, tr.done, last_values, tcfg_ppo.gamma, tcfg_ppo.gae_lambda)
    k_adv, k_ret = gae_kernel.compute_gae_cuda(*gae_args)
    t_adv, t_ret = gae_kernel.compute_gae_twin(*gae_args)
    torch.cuda.synchronize()
    if not (torch.equal(k_adv, t_adv) and torch.equal(k_ret, t_ret)):
        fail(f"K5 differs from its twin by {max(max_err(k_adv, t_adv), max_err(k_ret, t_ret))}")
    g5 = torch.Generator().manual_seed(55)
    for T5, B5 in K5_SHAPES:
        args5 = k5_case(T5, B5, g5)
        k_adv5, k_ret5 = gae_kernel.compute_gae_cuda(*args5)
        t_adv5, t_ret5 = gae_kernel.compute_gae_twin(*args5)
        torch.cuda.synchronize()
        if not (torch.equal(k_adv5, t_adv5) and torch.equal(k_ret5, t_ret5)):
            fail(f"K5 at T {T5} B {B5} differs from its twin")
        print(f"[K5 gae] T {T5} B {B5}: exactly the twin's ({int(args5[2].sum())} dones)")
    k_ms = cuda_ms(lambda: gae_kernel.compute_gae_cuda(*gae_args), 200)
    k_dev = device_ms(lambda: gae_kernel.compute_gae_cuda(*gae_args), KERNEL_NAMES["k5_gae"], 200)
    p_ms = cuda_ms(lambda: gae_kernel.compute_gae_twin(*gae_args), 10)
    bnd, by = bound_ms(T * B * (4 + 4 + 1) + 4 * B + 2 * T * B * 4, 0)
    kernels["k5_gae"] = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, max_abs_err=0.0,
                             bound_ms=bnd, bound_by=by)
    long5 = k5_case(2048, B, g5)
    long_dev = device_ms(lambda: gae_kernel.compute_gae_cuda(*long5), KERNEL_NAMES["k5_gae"], 20)
    print(f"[K5 gae] exact on {T}x{B} rollout data ({int(tr.done.sum())} dones); "
          f"call {k_ms:.4f} ms, device {k_dev:.5f} ms, twin {p_ms:.4f} ms; T 2048 B {B}: device "
          f"{long_dev:.5f} ms")

    # ---- 5b. K6 PPO sweep vs its twin at the preset's shapes ---------------------------
    n, mbs = T * B, tcfg_ppo.minibatch_size
    batch = ppo.PPOBatch(
        obs=tr.obs.reshape(n, N, N), legal=tr.legal.reshape(n, A), action=tr.action.reshape(n),
        log_prob_old=tr.log_prob.reshape(n), value_old=tr.value.reshape(n),
        advantage=k_adv.reshape(n), ret=k_ret.reshape(n))
    obs6, flt6 = pkk.batch_streams(batch)
    g6 = torch.Generator().manual_seed(11)
    mu = {k: (torch.randn(v.shape, generator=g6) * 1e-3).to(dev) for k, v in params.items()}
    nu = {k: (torch.rand(v.shape, generator=g6) * 1e-5).to(dev) for k, v in params.items()}
    count0 = 37
    packed3 = (pol.pack_agent(params), pol.pack_agent(mu), pol.pack_agent(nu))

    def k6_both(cfg6, idx):
        bias = ppo.bias_corrections(count0, idx.shape[0], dev)
        kout = pkk.sweep(pol, cfg6, *packed3, obs6, flt6, idx, bias)
        tout = pkk.sweep(twin, cfg6, *packed3, obs6, flt6, idx, bias)
        torch.cuda.synchronize()
        return kout, tout, bias

    step_cfg = dataclasses.replace(tcfg_ppo, n_epochs=1)
    idx1 = torch.randperm(mbs, generator=g6).to(dev, torch.int32)[None]  # one step, n = mb
    kout, tout, _ = k6_both(step_cfg, idx1)
    rel = rel_errs(kout, tout)
    if max(rel) > K6_STEP_REL:
        fail(f"K6 one grad step: relative errors (p, m, v, stats) {rel} > {K6_STEP_REL}")
    print(f"[K6 ppo] one grad step: relative errors p {rel[0]:.3g}, m {rel[1]:.3g}, "
          f"v {rel[2]:.3g}, stats {rel[3]:.3g}")
    idx = ppo.minibatch_indices(ppo.epoch_permutations(g6, n, tcfg_ppo.n_epochs), n, mbs)
    idx = idx.to(dev).contiguous()
    G = idx.shape[0]
    kout, tout, bias = k6_both(tcfg_ppo, idx)
    errs = [max_err(kv, tv) for kv, tv in zip(kout[:3], tout[:3])]
    errs.append(max_err(kout[3].mean(0), tout[3].mean(0)))
    rel = rel_errs(kout, tout)
    if max(rel) > K6_SWEEP_REL:
        fail(f"K6 {G}-step sweep: relative errors (p, m, v, mean stats) {rel} > {K6_SWEEP_REL}")
    if not torch.equal(pkk.sweep(pol, tcfg_ppo, *packed3, obs6, flt6, idx, bias)[0], kout[0]):
        fail("K6 is not bitwise repeatable")
    fast = pkk.make_kernel_fast_update_fn(model, tcfg_ppo, "pallas")
    fp, fopt, fstats = fast(params, ppo.AdamState(count0, mu, nu), batch, g6)
    if fopt.count != count0 + G or not all(bool(torch.isfinite(t).all()) for t in
                                           list(fp.values()) + list(fstats)):
        fail("the fast sweep entry gave a wrong count or non-finite output")
    k_ms = cuda_ms(lambda: pkk.sweep(pol, tcfg_ppo, *packed3, obs6, flt6, idx, bias), 3)
    k_dev = device_ms(lambda: pkk.sweep(pol, tcfg_ppo, *packed3, obs6, flt6, idx, bias),
                      KERNEL_NAMES["k6_ppo"], 3)
    p_ms = cuda_ms(lambda: pkk.sweep(twin, tcfg_ppo, *packed3, obs6, flt6, idx, bias), 1)
    L = d.n_layers
    fwd = 2 * (d.F * d.H + (L - 1) * d.H * d.H + d.H * A) + 2 * (d.F * d.H + (L - 1) * d.H * d.H + d.H)
    flops = G * mbs * (3 * fwd - 2 * 2 * d.F * d.H)  # backward ~2x forward, no input gradient
    S = packed3[0].numel()
    n_bytes = n * F + n * 16 + G * mbs * 4 + 6 * S * 4 + G * 2 * 4 + G * 8 * 4
    bnd, by = bound_ms(n_bytes, flops)
    kernels["k6_ppo"] = dict(ms=k_ms, device_ms=k_dev, plain_ms=p_ms, max_abs_err=max(errs),
                             bound_ms=bnd, bound_by=by)
    # the per-step cost against the grid: the same 80 steps on a prefix of each minibatch
    per_step = []
    for mb_s in (32, 512, mbs):
        cfg_s = dataclasses.replace(tcfg_ppo, minibatch_size=mb_s)
        idx_s = idx[:, :mb_s].contiguous()
        grid_s = cuda_lib.ppo_plan(d.F, d.H, d.A, d.n_layers, mb_s)[0]
        ms_s = cuda_ms(lambda: pkk.sweep(pol, cfg_s, *packed3, obs6, flt6, idx_s, bias), 3)
        per_step.append(f"{1000 * ms_s / G:.1f} us at mb {mb_s} ({grid_s} CTAs)")
    print(f"[K6 ppo] {G}-step sweep from count {count0}: abs errors p {errs[0]:.3g}, "
          f"m {errs[1]:.3g}, v {errs[2]:.3g}, mean stats {errs[3]:.3g}; relative errors "
          + ", ".join(f"{x:.3g}" for x in rel) + f"; bitwise repeatable; "
          f"fast entry count {fopt.count}; call {k_ms:.3f} ms, device {k_dev:.4f} ms, twin {p_ms:.3f} ms, "
          f"{flops / 1e9:.2f} GFLOP")
    print("[K6 ppo] per grad step: " + ", ".join(per_step))

    # ---- 5c. K6 on the other MLP towers of the preset grid (deeper, wider, ReLU) -------
    for fam in OTHER_MLPS:
        m_f = make_policy(fam, A, generator=g6)
        p_f = {k: v.detach().to(dev) for k, v in m_f.state_dict().items()}
        mu_f = {k: (torch.randn(v.shape, generator=g6) * 1e-3).to(dev) for k, v in p_f.items()}
        nu_f = {k: (torch.rand(v.shape, generator=g6) * 1e-5).to(dev) for k, v in p_f.items()}
        pol_f, twin_f = pk.PolicyOps(m_f, "pallas"), pk.PolicyOps(m_f, "lax")
        packed_f = (pol_f.pack_agent(p_f), pol_f.pack_agent(mu_f), pol_f.pack_agent(nu_f))
        idx_f = idx[:8].contiguous()
        bias_f = ppo.bias_corrections(count0, 8, dev)
        kout = pkk.sweep(pol_f, tcfg_ppo, *packed_f, obs6, flt6, idx_f, bias_f)
        tout = pkk.sweep(twin_f, tcfg_ppo, *packed_f, obs6, flt6, idx_f, bias_f)
        torch.cuda.synchronize()
        rel = rel_errs(kout, tout)
        if max(rel) > K6_SWEEP_REL:
            fail(f"K6 {fam} 8-step sweep: relative errors (p, m, v, mean stats) {rel} "
                 f"> {K6_SWEEP_REL}")
        d_f = pol_f.dims
        plan = cuda_lib.ppo_plan(d_f.F, d_f.H, d_f.A, d_f.n_layers, mbs)
        f_ms = cuda_ms(lambda: pkk.sweep(pol_f, tcfg_ppo, *packed_f, obs6, flt6, idx_f, bias_f), 3)
        print(f"[K6 ppo] {fam} (H {d_f.H}, {d_f.n_layers} layers, relu {d_f.relu}, plan {plan}): "
              f"8 steps at mb {mbs}, relative errors " + ", ".join(f"{x:.3g}" for x in rel)
              + f"; kernel {f_ms:.3f} ms")

    # ---- 5d. the phase clocks of K4 and K6 at the preset ------------------------------
    phase_splits("this tree")

    # ---- 6. main path, training: Trainer.fit of the preset -----------------------------
    per_iter = B * T
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    tcfg = get_config(PRESET, total_timesteps=3 * per_iter, checkpoint_every=2 * per_iter,
                      log_dir=os.path.join(work, "log"), model_dir=os.path.join(work, "models"))
    trainer = Trainer(tcfg, device=dev)
    algo = trainer.algo
    if (algo.runner.fused_pol is None or algo.evaluator.fused_pol is None
            or not algo.update_fn.__qualname__.startswith("make_kernel_update_fn")):
        fail("the preset's trainer does not resolve to the rollout and sweep kernels")
    stage_events = {"rollout": [], "gae": [], "sweep": [], "eval + pool update": []}

    def timed(stage, fn):
        def run(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            stage_events[stage].append((start, end))
            return out
        return run

    algo.runner.run = timed("rollout", algo.runner.run)
    algo.gae_fn = timed("gae", algo.gae_fn)
    algo.update_fn = timed("sweep", algo.update_fn)
    algo.evaluator.eval_and_update = timed("eval + pool update", algo.evaluator.eval_and_update)
    marks = []  # (host time, launch counts) at each iteration's start
    train_step = algo.train_step

    def marked_train_step(state):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), dict(cuda_lib.launches)))
        return train_step(state)

    algo.train_step = marked_train_step
    cuda_lib.reset_launches()
    state_a = trainer.fit()
    torch.cuda.synchronize()
    marks.append((time.perf_counter(), dict(cuda_lib.launches)))
    train_counts = dict(cuda_lib.launches)
    for i in range(3):
        got = {k: marks[i + 1][1][k] - marks[i][1][k] for k in cuda_lib.KERNELS}
        if (got["k4_rollout"], got["k5_gae"], got["k6_ppo"]) != (2, 1, 1) or got["k1_step"] < 1:
            fail(f"iteration {i + 1} launched {got}: expected K4 2, K5 1, K6 1, K1 >= 1")
    with open(os.path.join(tcfg.log_dir, tcfg.model_name, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    eval_steps = [r["step"] for r in recs if "eval/mean_reward" in r]
    if eval_steps != [per_iter, 2 * per_iter, 3 * per_iter]:
        fail(f"eval did not fire every iteration: {eval_steps}")
    if not all(np.isfinite(v) for r in recs for v in r.values()):
        fail("non-finite logged metrics")
    if not all(bool(torch.isfinite(v).all()) for v in state_a.params.values()):
        fail("non-finite parameters after training")
    iter_s = [marks[i + 1][0] - marks[i][0] for i in range(3)]
    stage_ms = {k: [round(s.elapsed_time(e), 3) for s, e in v] for k, v in stage_events.items()}
    print(f"[train] 3 iterations of {per_iter} transitions: launches {train_counts}; "
          f"eval at steps {eval_steps}")
    print(f"[train] s per iteration {[round(x, 4) for x in iter_s]}; "
          f"{per_iter / (sum(iter_s[1:]) / 2):.0f} transitions/s (iterations 2-3)")
    print("[train] stage ms of iterations 1-3 (CUDA events): "
          + "; ".join(f"{k} {v}" for k, v in stage_ms.items()))
    last = recs[-2]
    print("[train] iteration 3: " + ", ".join(
        f"{k} {last[k]:.4g}" for k in ("rollout/ep_rew_mean", "train/policy_loss",
                                        "train/value_loss", "train/entropy", "eval/score")))

    # resume from the checkpoint after iteration 2 and run iteration 3 again
    if trainer._ckpt_mgr().latest_step() != 2 * per_iter:
        fail("no checkpoint after iteration 2")
    trainer_r = Trainer(tcfg, logger=MetricsLogger(tcfg.log_dir, "resumed"), device=dev)
    state_r = trainer_r.resume()
    state_r = trainer_r.fit(state_r)
    if not all(torch.equal(state_r.params[k], state_a.params[k]) for k in state_a.params):
        fail("the resumed iteration 3 differs from the uninterrupted one")
    # fit_fused: three iterations per superstep, the same cadence and result
    tcfg_f = dataclasses.replace(tcfg, iters_per_dispatch=3, model_name="fused",
                                 checkpoint_every=10 * per_iter)
    trainer_f = Trainer(tcfg_f, device=dev)
    state_f = trainer_f.fit()
    with open(os.path.join(tcfg.log_dir, "fused", "metrics.jsonl")) as f:
        fused_steps = [json.loads(line)["step"] for line in f if "eval/mean_reward" in line]
    if fused_steps != eval_steps:
        fail(f"fit_fused evals at {fused_steps}, fit at {eval_steps}")
    if not all(torch.equal(state_f.params[k], state_a.params[k]) for k in state_a.params):
        fail("fit_fused ends on other parameters than fit")
    print("[train] resume from iteration 2 -> iteration 3 params bitwise equal; "
          "fit_fused: same eval cadence, bitwise equal params")

    # the bf16 bank on the training main path: the rollout and the eval take
    # K4's bf16-bank instance; the second iteration's time beside float32's
    tcfg_b = get_config(PRESET, rollout_bank_bf16=True, total_timesteps=2 * per_iter,
                        checkpoint_every=10 * per_iter, log_dir=os.path.join(work, "log"),
                        model_dir=os.path.join(work, "models"), model_name="bf16")
    trainer_b = Trainer(tcfg_b, device=dev)
    algo_b = trainer_b.algo
    if algo_b.runner.fused_pol is None or algo_b.evaluator.fused_pol is None:
        fail("rollout_bank_bf16 does not resolve to the whole-rollout kernel")
    marks_b = []
    train_step_b = algo_b.train_step

    def marked_train_step_b(state):
        torch.cuda.synchronize()
        marks_b.append((time.perf_counter(), dict(cuda_lib.launches)))
        return train_step_b(state)

    algo_b.train_step = marked_train_step_b
    cuda_lib.reset_launches()
    state_b = trainer_b.fit()
    torch.cuda.synchronize()
    marks_b.append((time.perf_counter(), dict(cuda_lib.launches)))
    for i in range(2):
        got = {k: marks_b[i + 1][1][k] - marks_b[i][1][k] for k in cuda_lib.KERNELS}
        if (got["k4_rollout_bf16"], got["k4_rollout"], got["k5_gae"], got["k6_ppo"]) != (2, 0, 1, 1):
            fail(f"bf16 iteration {i + 1} launched {got}: expected K4 (bf16 bank) 2, K5 1, K6 1")
    if not all(bool(torch.isfinite(v).all()) for v in state_b.params.values()):
        fail("non-finite parameters after the bf16-bank iterations")
    bf16_iter_launches = marks_b[2][1]["k4_rollout_bf16"] - marks_b[1][1]["k4_rollout_bf16"]
    iter_b = [marks_b[i + 1][0] - marks_b[i][0] for i in range(2)]
    print(f"[train bf16 bank] 2 iterations: s per iteration {[round(x, 4) for x in iter_b]} "
          f"(float32 bank: {[round(x, 4) for x in iter_s]}); K4 bf16 2, K5 1, K6 1 launches each")

    # ---- 7. learning on the card (tests/test_learning_curve.py's config) --------------
    lcfg = TrainConfig(ppo=PPOConfig(n_steps=32, minibatch_size=512, n_epochs=4),
                       selfplay=SelfplayConfig(board_size=4, n_envs=64, buffer_size=4))
    lalgo = SelfplayPPO(lcfg, device=dev)
    lstate = lalgo.init_state(0)
    cuda_lib.reset_launches()
    rews = []
    for _ in range(24):  # no eval: the pool stays all-zeros == random
        lstate, m = lalgo.train_step(lstate)
        rews.append(float(m.mean_episode_reward))
    lcounts = {k: cuda_lib.launches[k] for k in ("k4_rollout", "k5_gae", "k6_ppo")}
    early, late = float(np.mean(rews[:3])), float(np.mean(rews[-5:]))
    print(f"[learning] curve {[round(r, 3) for r in rews]}; early {early:.3f}, late {late:.3f}; "
          f"launches {lcounts}")
    if set(lcounts.values()) != {24}:
        fail(f"the learning run did not go through K4/K5/K6 every iteration: {lcounts}")
    if not (np.isfinite(rews).all() and abs(early) < 0.25 and late > 0.15 and late - early > 0.2):
        fail("no learning on the card")

    # ---- 8. where one preset iteration's time goes ---------------------------------------
    algo_f = trainer_f.algo

    def iterations(state, k):
        for _ in range(k):
            state, _ = algo_f.train_step(state)
            state, _ = algo_f.eval_step(state)
        return state

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iterations(state_f, 3)
    torch.cuda.synchronize()
    steady = (time.perf_counter() - t0) / 3
    print(f"[train] steady state, 3 more iterations of train_step + eval_step: {steady:.4f} s "
          f"per iteration, {per_iter / steady:.0f} transitions/s")
    wall_us, busy, top, top_host = device_profile(lambda: iterations(state_f, 1))
    print(f"[profile] one preset iteration (train + eval): wall {wall_us:.1f} us, device busy "
          f"{busy:.1f} us ({100 * busy / wall_us:.1f}%); top kernels (us): "
          + "; ".join(f"{k[:60]} {v:.1f}" for k, v in top))
    print("[profile] top host ops by self CPU time (us): "
          + "; ".join(f"{k[:40]} {v:.1f}" for k, v in top_host))
    shutil.rmtree(work, ignore_errors=True)

    # ---- 9. the env-throughput benchmark: K7, K1 per step, the plain step ----------------
    from hex_gym_env_tpu_torch import bench

    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    bench_rec = bench.main(repeats=3)  # prints its JSON record
    torch.cuda.synchronize()
    bench_counts = dict(cuda_lib.launches)
    for route in ("pallas", "api", "lax"):
        if not bench_rec[route]["median"] > 0:
            fail(f"the benchmark's {route} route reported no rate")
    if bench_counts["k7_random_rollout"] == 0 or bench_counts["k1_step"] == 0:
        fail(f"the benchmark did not run through K7 and K1: {bench_counts}")
    print(f"[bench] {time.perf_counter() - t0:.1f} s; launches {bench_counts}; env-steps/s "
          + ", ".join(f"{r} {bench_rec[r]['median']:.4g}" for r in ("pallas", "api", "lax")))

    # ---- 10. sample_board: one preset iteration from sampled boards (scan path) -----------
    sb_cfg = get_config(PRESET, sample_board=True)
    sb_algo = SelfplayPPO(sb_cfg, device=dev)
    if (sb_algo.runner.fused_pol is not None or sb_algo.runner.pol is None
            or sb_algo.evaluator.fused_pol is not None):
        fail("sample_board does not resolve to the scan path and the plain eval loop")
    sb_state = sb_algo.init_state(5)
    fresh_sb = sb_algo.runner.fresh_envs(torch.Generator().manual_seed(9))
    starts_sb = sb_algo.evaluator.start_states(sb_cfg.selfplay.eval_episodes,
                                               torch.Generator().manual_seed(9))
    if int(fresh_sb.stones.sum()) == 0 or int(starts_sb.stones.sum()) == 0:
        fail("sample_board: the fresh boards or the evaluator's start states hold no stone")
    sb_T = sb_cfg.ppo.n_steps
    sb_times, sb_counts = [], []
    for stage_fn in (sb_algo.train_step, sb_algo.eval_step):
        cuda_lib.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sb_state, sb_out = stage_fn(sb_state)
        torch.cuda.synchronize()
        sb_times.append(time.perf_counter() - t0)
        sb_counts.append(dict(cuda_lib.launches))
    want_train = dict.fromkeys(cuda_lib.KERNELS, 0)
    want_train.update(k1_step=3 * sb_T, k2_agent=sb_T, k2_agent_image=1, k3_bank=2 * sb_T,
                      k3_bank_image=1, k5_gae=1, k6_ppo=1)
    want_eval = dict.fromkeys(cuda_lib.KERNELS, 0)
    want_eval.update(k1_step=1 + 2 * (F // 2 + 2))
    if sb_counts != [want_train, want_eval]:
        fail(f"sample_board launched {sb_counts}, expected {[want_train, want_eval]}")
    if not all(bool(torch.isfinite(v).all()) for v in sb_state.params.values()):
        fail("sample_board: non-finite parameters")
    print(f"[sample_board] fresh boards hold {int(fresh_sb.stones.sum())} stones over {B} games, "
          f"eval starts {int(starts_sb.stones.sum())} over {sb_cfg.selfplay.eval_episodes}; "
          f"train_step {sb_times[0]:.3f} s, eval_step {sb_times[1]:.3f} s; launches train "
          f"{sb_counts[0]}, eval {sb_counts[1]}; eval mean reward {float(sb_out.mean_reward):.3f}")
    # the sampled boards of every rollout step's resets: how much of the step they take
    g9 = torch.Generator().manual_seed(9)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        sb_algo.runner.fresh_envs(g9)
    torch.cuda.synchronize()
    print(f"[sample_board] fresh_envs (sample_boards + state_from_boards, {B} games): "
          f"{(time.perf_counter() - t0) / 5 * 1e3:.2f} ms per call, once per rollout step")
    wall_us, busy, top, top_host = device_profile(lambda: sb_algo.runner.fresh_envs(g9))
    print(f"[profile] one sample_board fresh_envs: wall {wall_us:.1f} us, device busy {busy:.1f} us "
          f"({100 * busy / wall_us:.1f}%); top kernels (us): "
          + "; ".join(f"{k[:60]} {v:.1f}" for k, v in top))
    print("[profile] top host ops by self CPU time (us): "
          + "; ".join(f"{k[:40]} {v:.1f}" for k, v in top_host))

    # ---- 11. the CNN preset (the scan path through K1, K5; the model on cuDNN/cuBLAS) -----
    t0 = time.perf_counter()
    cnn_counts = cnn_phase(dev)
    print(f"[cnn] phase {time.perf_counter() - t0:.1f} s")

    # ---- 12. the match and tournament scripts, the Gym and native surfaces ---------------
    t0 = time.perf_counter()
    match_counts = match_phase(dev)
    compat_counts = compat_phase(dev)
    mlp_row = mlp_forward_phase(dev)
    print(f"[match + compat + mlp forward] phases {time.perf_counter() - t0:.1f} s")

    # ---- 13. the training entry points, data-parallel training, the scripts -------------
    t0 = time.perf_counter()
    train_cli_phase(dev)
    dist_counts = distributed_phase(dev)
    entry_counts = scripts_phase(dev)
    print(f"[train cli + distributed + scripts] phases {time.perf_counter() - t0:.1f} s")

    # ---- 14. the verify and measure tools --------------------------------------------------
    t0 = time.perf_counter()
    tools_counts = tools_phase(dev)
    print(f"[tools] phase {time.perf_counter() - t0:.1f} s")

    # ---- 15. report ----------------------------------------------------------------------
    rollout_src = "hex_gym_env_tpu_torch/csrc/hex_kernels.cu"
    learner_src = "hex_gym_env_tpu_torch/csrc/learner_kernels.cu"
    meta = {
        "k1_step": ("hex_gym_env_tpu/ops/pallas_step.py:38", scan_counts["k1_step"], rollout_src),
        "k2_agent": ("hex_gym_env_tpu/ops/pallas_policy.py:122", scan_counts["k2_agent"],
                     rollout_src),
        "k3_bank": ("hex_gym_env_tpu/ops/pallas_policy.py:268", scan_counts["k3_bank"],
                    rollout_src),
        "k4_rollout": ("hex_gym_env_tpu/ops/pallas_rollout.py:163", main_counts["k4_rollout"],
                       rollout_src),
        "k4_rollout_bf16": ("hex_gym_env_tpu/ops/pallas_rollout.py:163", bf16_iter_launches,
                            rollout_src),
        "k5_gae": ("hex_gym_env_tpu/ops/pallas_gae.py:32", train_counts["k5_gae"], learner_src),
        "k6_ppo": ("hex_gym_env_tpu/ops/pallas_ppo.py:119", train_counts["k6_ppo"], learner_src),
        "k7_random_rollout": ("hex_gym_env_tpu/ops/pallas_step.py:228",
                              bench_counts["k7_random_rollout"], rollout_src),
    }
    rows = []
    for name, (replaces, launches, source) in meta.items():
        k = kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "device_ms": k["device_ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "cnn_launches": cnn_counts[name],
            "match_launches": match_counts[name], "hexenv_launches": compat_counts[name],
            "dist_launches": dist_counts[name], "entry_launches": entry_counts[name],
            "tools_launches": tools_counts[name],
            **({"image_device_ms": k["image_device_ms"]} if "image_device_ms" in k else {}),
        })
    rows.append(mlp_row)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--split-only":
        sys.exit(split_only(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "--env-kernels":
        sys.exit(env_only(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 2 and sys.argv[1] == "--cnn-only":
        sys.exit(cnn_only())
    if len(sys.argv) == 2 and sys.argv[1] == "--train-only":
        sys.exit(train_only())
    if len(sys.argv) == 2 and sys.argv[1] == "--match-only":
        sys.exit(match_only())
    if len(sys.argv) == 2 and sys.argv[1] == "--tools-only":
        sys.exit(tools_only())
    if len(sys.argv) == 2 and sys.argv[1] == "--mlp-only":
        sys.exit(mlp_only())
    sys.exit(main())
