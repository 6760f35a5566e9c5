#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the CUDA kernels from ``hex_gym_env_tpu_torch/csrc`` (nvcc, sm_90a);
2. holds each kernel against its plain PyTorch twin at the main path's
   shapes (7x7, 256 games, H = 64, 31 bank members, 128 steps), fed the same
   random bits: env ints and actions exactly equal, floats within ``TOL``;
3. drives the main path: ``SelfplayRunner.run`` of the
   ``7x7_MLP-default_lr-0.0003`` preset three times through the
   whole-rollout kernel, replays the first rollout's record through the
   plain env ops, and prints transitions/s;
4. drives the scan path (env-step, agent and bank kernels) for 8 steps;
5. prints the card, a JSON line of per-kernel numbers, and the final line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX.  It exits non-zero, printing no result, when no
CUDA device is present or the port's sources are not beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 2e-5  # kernel vs twin: float32 sums in another order (FMA loops vs cuBLAS)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores

N, B, H, POOL, T = 7, 256, 64, 30, 128


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


def bound_ms(n_bytes: float, flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_actions(name, got, want, margins, tol=TOL):
    """Actions must be equal, except where the twin's two best scores lie
    within ``tol`` of each other (a float-order near tie).  Returns the
    number of such rows."""
    diff = (got != want).nonzero().flatten()
    if len(diff) and not bool((margins[diff] < tol).all()):
        fail(f"{name}: {len(diff)} actions differ, not all at near ties")
    return len(diff)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.exists(os.path.join(REPO, "hex_gym_env_tpu_torch", "csrc", "hex_kernels.cu")):
        print("chip_smoke: the port's sources are not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    from hex_gym_env_tpu_torch.core import env as hex_env
    from hex_gym_env_tpu_torch.core.topology import get_topology
    from hex_gym_env_tpu_torch.experiments import get_config
    from hex_gym_env_tpu_torch.models import make_policy
    from hex_gym_env_tpu_torch.ops import cuda_lib, masked
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
    obs = hex_env.observe(topo, state).reshape(B, F)
    legal = hex_env.legal_mask(topo, state)
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
    k_ms = cuda_ms(lambda: step_kernel.step_cuda(topo, state, actions, active), 200)
    p_ms = cuda_ms(lambda: hex_env.step(topo, state, actions, active), 50)
    n_bytes = B * (6 * L + 5 * 4 + 2) + B * (6 * L + 4 * 4 + 1 + 8)  # in + out
    bnd, by = bound_ms(n_bytes, 0)
    kernels["k1_step"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=0.0, bound_ms=bnd, bound_by=by)
    print(f"[K1 env step] exact; kernel {k_ms:.4f} ms, twin {p_ms:.4f} ms")

    # ---- 2b. K2 agent pass -----------------------------------------------------
    bits = masked.draw_bits(g, (B, A), dev)
    kr = pol.agent_act(packed, obs, legal, bits=bits)
    tr = twin.agent_act(packed, obs, legal, bits=bits)
    torch.cuda.synchronize()
    scores = tr.masked_logits + masked.gumbel(bits)
    top2 = torch.topk(scores, 2, dim=-1).values
    ties = check_actions("K2", kr.action, tr.action, top2[:, 0] - top2[:, 1])
    ok = kr.action == tr.action
    err = max(
        float((kr.masked_logits - tr.masked_logits).abs().max()),
        float((kr.value - tr.value).abs().max()),
        float((kr.log_prob - tr.log_prob)[ok].abs().max()),
    )
    if err > TOL:
        fail(f"K2 floats differ by {err}")
    gen_k = torch.Generator().manual_seed(1)
    k_ms = cuda_ms(lambda: pol.agent_act(packed, obs, legal, gen_k), 200)
    p_ms = cuda_ms(lambda: twin.agent_act(packed, obs, legal, bits=bits), 50)
    flops = 2 * B * (pk.tower_size(d, A) + pk.tower_size(d, 1) - (2 * d.H * d.n_layers + A + 1))
    n_bytes = 4 * packed.numel() + B * F + B * A + B * 12 + B * A * 4
    bnd, by = bound_ms(n_bytes, flops)
    kernels["k2_agent"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=err, bound_ms=bnd, bound_by=by)
    print(f"[K2 agent] max err {err:.3g}, near-tie rows {ties}; kernel {k_ms:.4f} ms, twin {p_ms:.4f} ms")

    # ---- 2c. K3 bank pass --------------------------------------------------------
    member = torch.randint(0, P1, (B,), generator=g).to(dev, torch.int32)
    use_best = member == P1 - 1
    ka, km = pol.bank_act(stacked, use_best, member, obs, legal, bits=bits)
    ta, tm = twin.bank_act(stacked, use_best, member, obs, legal, bits=bits)
    torch.cuda.synchronize()
    top2 = torch.topk(tm + masked.gumbel(bits), 2, dim=-1).values
    ties = check_actions("K3", ka, ta, top2[:, 0] - top2[:, 1])
    err = float((km - tm).abs().max())
    if err > TOL:
        fail(f"K3 logits differ by {err}")
    k_ms = cuda_ms(lambda: pol.bank_act(stacked, use_best, member, obs, legal, gen_k), 200)
    p_ms = cuda_ms(lambda: twin.bank_act(stacked, use_best, member, obs, legal, bits=bits), 50)
    used = int(member.unique().numel())
    flops = 2 * B * (pk.tower_size(d, A) - (d.H * d.n_layers + A))
    n_bytes = 4 * used * pk.tower_size(d, A) + B * F + B * A + B * 4 + B * 4 + B * A * 4
    bnd, by = bound_ms(n_bytes, flops)
    kernels["k3_bank"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=err, bound_ms=bnd, bound_by=by)
    print(f"[K3 bank] max err {err:.3g}, near-tie rows {ties}; kernel {k_ms:.4f} ms, twin {p_ms:.4f} ms")

    # ---- 2d. K4 whole rollout, training and eval mode ------------------------------
    setup = SelfplayRunner(topo, model, dataclasses.replace(
        cfg, rollout_impl="scan", policy_impl="lax", env_step_impl="lax"), device=dev)
    carry = setup.init_carry(bank, g)
    rbits = rk.draw_rollout_bits(g, T, B, A, dev)
    k4_err = 0.0
    for eval_mode in (False, True):
        args = (topo, pol, packed, stacked, table, carry.env, carry.agent_seat, carry.use_best,
                carry.opp_idx, T, cfg.best_prob, True)
        kout = rk.fused_rollout(*args, bits=rbits, eval_mode=eval_mode)
        tout, margins = rk.fused_rollout_twin(
            topo, d, packed, stacked, table, carry.env, carry.agent_seat, carry.use_best,
            carry.opp_idx, T, cfg.best_prob, True, rbits, eval_mode=eval_mode, with_margins=True)
        torch.cuda.synchronize()
        same = (kout.ints == tout.ints).all(-1) & (kout.obs == tout.obs).all(-1)  # (T, B)
        row_ok = same.all(0)
        for b in (~row_ok).nonzero().flatten().tolist():
            t = int((~same[:, b]).nonzero()[0])
            lanes = (kout.ints[t, b] != tout.ints[t, b]).nonzero().flatten().tolist()
            if not lanes or lanes[0] > 2 or float(margins[t, b, lanes[0]]) >= TOL:
                fail(f"K4 (eval={eval_mode}) row {b} diverges at step {t}, lanes {lanes}")
        for name in ("stones", "labels", "to_move", "done", "empty", "move_count"):
            k, tw = getattr(kout.state, name)[row_ok], getattr(tout.state, name)[row_ok]
            if not torch.equal(k, tw):
                fail(f"K4 (eval={eval_mode}) final {name} differs")
        for k, tw in ((kout.agent_seat, tout.agent_seat), (kout.use_best, tout.use_best),
                      (kout.opp_idx, tout.opp_idx)):
            if not torch.equal(k[row_ok], tw[row_ok]):
                fail(f"K4 (eval={eval_mode}) final seat/opponent differs")
        ferr = float((kout.flts - tout.flts)[:, row_ok].abs().max())
        if ferr > TOL:
            fail(f"K4 (eval={eval_mode}) floats differ by {ferr}")
        k4_err = max(k4_err, ferr)
        print(f"[K4 rollout eval={eval_mode}] {int(row_ok.sum())}/{B} rows identical, "
              f"{int((~row_ok).sum())} near-tie rows, max err {ferr:.3g}, "
              f"{int(kout.ints[..., rk.I_DONE].sum())} done flags")
    k_ms = cuda_ms(lambda: rk.fused_rollout(topo, pol, packed, stacked, table, carry.env,
                                            carry.agent_seat, carry.use_best, carry.opp_idx, T,
                                            cfg.best_prob, True, generator=gen_k), 10)
    p_ms = cuda_ms(lambda: rk.fused_rollout_twin(
        topo, d, packed, stacked, table, carry.env, carry.agent_seat, carry.use_best,
        carry.opp_idx, T, cfg.best_prob, True, rbits), 2)
    per_game_step = 2 * (pk.tower_size(d, A) + pk.tower_size(d, 1) - (2 * d.H * d.n_layers + A + 1)) \
        + 2 * (pk.tower_size(d, A) - (d.H * d.n_layers + A))
    flops = T * B * per_game_step
    n_bytes = (4 * (packed.numel() + stacked.numel() + table.numel())
               + 2 * B * (6 * L + 5 * 4 + 2)
               + T * B * F + 2 * T * B * 8 * 4)
    bnd, by = bound_ms(n_bytes, flops)
    kernels["k4_rollout"] = dict(ms=k_ms, plain_ms=p_ms, max_abs_err=k4_err, bound_ms=bnd,
                                 bound_by=by)
    print(f"[K4 rollout] kernel {k_ms:.3f} ms, twin {p_ms:.3f} ms for {T} steps x {B} games")

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
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(params, bank, c, gen, T)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_us = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            device_us[ev.key] = us
    busy = sum(device_us.values())
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
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
    picked = torch.take_along_dim(trs.legal, trs.action.long()[..., None], -1)
    if not bool(picked.all()) or not bool(torch.isfinite(lvs).all()):
        fail("the scan path produced illegal actions or non-finite values")
    print(f"[scan path] launches {scan_counts}")

    # ---- 5. report -----------------------------------------------------------------------
    meta = {
        "k1_step": ("hex_gym_env_tpu/ops/pallas_step.py:38", scan_counts["k1_step"]),
        "k2_agent": ("hex_gym_env_tpu/ops/pallas_policy.py:122", scan_counts["k2_agent"]),
        "k3_bank": ("hex_gym_env_tpu/ops/pallas_policy.py:268", scan_counts["k3_bank"]),
        "k4_rollout": ("hex_gym_env_tpu/ops/pallas_rollout.py:163", main_counts["k4_rollout"]),
    }
    rows = []
    for name, (replaces, launches) in meta.items():
        k = kernels[name]
        rows.append({
            "name": name, "route": "cuda", "source": "hex_gym_env_tpu_torch/csrc/hex_kernels.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
        })
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
    sys.exit(main())
