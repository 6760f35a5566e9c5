"""K4: the whole selfplay rollout as one CUDA kernel.

The counterpart of the JAX package's ``ops/pallas_rollout.py``.  One launch
runs all T transitions of a batch of games (``csrc/hex_kernels.cu``
``rollout_kernel``; its note gives the bound and the design).  Per step:

  1. mover-frame obs and legal mask, agent MLP forward, masked Gumbel-max
     sample (argmax in ``eval_mode``), log-prob, value;
  2. the agent's move (legal by construction, so no invalid-move branch);
  3. the opponent's reply where the game continues, from its bank member;
  4. training mode: auto-reset of finished games, seat redraw
     (``per_episode_seat``), best/pool redraw, and the opponent's opening
     move where it holds seat 0, sampled from the (P1, A) empty-board logits
     table.  ``eval_mode`` instead freezes finished games.

It records per step the agent's observation ``obs`` (T, B, F) int8, the
int lanes ``I_*`` (T, B, 8) and the float lanes ``F_*`` (T, B, 8), and
returns the final carry.  ``fused_rollout_twin`` is the plain PyTorch
version of the same function; ``verify_rollout_trajectory`` replays a
record through the plain env ops and the model.

With ``bank_bf16`` (``rollout_bank_bf16``) the opponent's towers run on a
bf16 bank as the JAX kernel's ``bank_bf16`` does (``pk.bank_logits_twin``);
the agent and the opening-move table stay float32.

Random draws follow the JAX kernel's map exactly (``ops/masked.py``): with
bits given (the JAX interpret-mode layout: agent, opponent and first-move
(T, B, A) and reset (T, B, 128), lanes 0-2 = seat, best, slot), the kernel
and the twin produce the same record.  Without bits the kernel draws from
Philox streams keyed by a seed from the generator, the game and the lane (a
warp holds one game), so a restored generator replays the draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hex_gym_env_tpu_torch.core import env as hex_env
from hex_gym_env_tpu_torch.core.state import HexState, Winner
from hex_gym_env_tpu_torch.core.topology import HexTopology
from hex_gym_env_tpu_torch.ops import cuda_lib
from hex_gym_env_tpu_torch.ops import labels as labels_ops
from hex_gym_env_tpu_torch.ops import masked as masked_ops
from hex_gym_env_tpu_torch.ops import policy_kernel as pk

# record int lanes (T, B, 8) int32
I_ACTION = 0
I_OPP_ACTION = 1
I_FIRST_ACTION = 2
I_DONE = 3
I_SEAT = 4
I_USE_BEST = 5
I_OPP_IDX = 6

# record float lanes (T, B, 8) float32
F_LOGP = 0
F_VALUE = 1
F_REWARD = 2

RESET_LANES = 128
# the kernel's phase clock: a start stamp and one stamp per phase of a step
ROLLOUT_PHASES = ("agent forward", "agent sample", "agent move", "opponent forward",
                  "opponent sample", "opponent move", "reset", "emit")
ROLLOUT_MARKS = len(ROLLOUT_PHASES) + 1


class FusedRolloutOut(NamedTuple):
    obs: torch.Tensor  # (T, B, F) int8 mover-frame boards the agent saw
    ints: torch.Tensor  # (T, B, 8) int32, I_* lanes
    flts: torch.Tensor  # (T, B, 8) float32, F_* lanes
    state: HexState  # final env state (winner is ONGOING everywhere)
    agent_seat: torch.Tensor  # (B,) int32
    use_best: torch.Tensor  # (B,) bool
    opp_idx: torch.Tensor  # (B,) int32


def first_move_table(stacked: torch.Tensor, d: pk.MlpDims) -> torch.Tensor:
    """Every member's action logits on the empty board, (P1, A): with empty
    resets, the opener's logits are a constant of the bank."""
    P1 = stacked.shape[0]
    zeros = torch.zeros((P1, d.F), dtype=torch.float32, device=stacked.device)
    idx = torch.arange(P1, device=stacked.device)
    return pk.bank_logits_twin(stacked, d, zeros, idx).contiguous()


def draw_rollout_bits(generator: torch.Generator, n_steps: int, batch: int, A: int, device):
    """The four bit planes of one rollout, drawn from ``generator``."""
    return tuple(
        masked_ops.draw_bits(generator, (n_steps, batch, w), device)
        for w in (A, A, A, RESET_LANES)
    )


# ---------------------------------------------------------------------------
# the plain PyTorch twin
# ---------------------------------------------------------------------------


def _to_world(a: torch.Tensor, tm: torch.Tensor, n: int) -> torch.Tensor:
    ym = torch.div(a, n, rounding_mode="floor")
    xm = a - ym * n
    return torch.where(tm == 0, ym * n + xm, xm * n + ym)


def _apply_move(topo, stones, labels, tm, c, act):
    """Place mover ``tm``'s stone at world cell ``c`` where ``act`` (the
    move is legal by construction); returns (stones, labels, win)."""
    onehot = torch.arange(topo.lanes, device=c.device)[None, :] == c[:, None]
    add = onehot & act[:, None]
    s0 = stones[:, 0] | (add & (tm == 0)[:, None])
    s1 = stones[:, 1] | (add & (tm == 1)[:, None])
    mover = torch.where((tm == 0)[:, None], s0, s1)
    labels, win = labels_ops.place_stone(topo, labels, mover, tm, c, act)
    return torch.stack([s0, s1], dim=1), labels, win


def _margin(scores: torch.Tensor) -> torch.Tensor:
    """Gap between each row's two best scores (how near the draw was to a tie)."""
    top = torch.topk(scores, 2, dim=-1).values
    return top[:, 0] - top[:, 1]


def fused_rollout_twin(
    topo: HexTopology,
    d: pk.MlpDims,
    packed_agent: torch.Tensor,
    stacked: torch.Tensor,
    first_table: torch.Tensor,
    state: HexState,
    agent_seat: torch.Tensor,
    use_best: torch.Tensor,
    opp_idx: torch.Tensor,
    n_steps: int,
    best_prob: float,
    per_episode_seat: bool,
    bits,
    eval_mode: bool = False,
    with_margins: bool = False,
    bank_bf16: bool = False,
    opp_logits: Optional[torch.Tensor] = None,
):
    """Plain PyTorch K4.  With ``with_margins`` it also returns the (T, B, 3)
    gaps between the two best scores of the agent, opponent and first-move
    draws.  ``bank_bf16`` runs the opponent's reply on the bf16 bank.
    ``opp_logits``, a float32 (T, B, A) buffer, receives the opponent's bank
    logits (before the legal mask) at each step."""
    n, F, L = topo.n, topo.num_cells, topo.lanes
    B = state.batch_size
    dev = state.device
    P1 = stacked.shape[0]
    pi = pk.tower_views(packed_agent[: pk.tower_size(d, d.A)], d, d.A)
    vf = pk.tower_views(packed_agent[pk.tower_size(d, d.A) :], d, 1)
    bp = torch.tensor(best_prob, dtype=torch.float32)
    lane = torch.arange(L, dtype=torch.int32, device=dev)
    zero = torch.zeros((B,), dtype=torch.int32, device=dev)

    stones, labels = state.stones, state.labels
    tm, done, empty, mc = state.to_move, state.done, state.empty, state.move_count
    seat = agent_seat.to(torch.int32)
    ub = use_best.to(torch.bool)
    oi = opp_idx.to(torch.int32)

    def obs_legal():
        st = HexState(stones, labels, tm, done, zero, empty, mc)
        return hex_env.observe(topo, st).reshape(B, F), hex_env.legal_mask(topo, st)

    def move(c, act):
        nonlocal stones, labels, tm, done, empty, mc
        stones, labels, win = _apply_move(topo, stones, labels, tm, c, act)
        empty = empty - act.to(torch.int32)
        done = done | win | (act & (empty <= 0))
        tm = torch.where(act, 1 - tm, tm)
        mc = mc + act.to(torch.int32)
        return win

    rec_obs, rec_ints, rec_flts, margins = [], [], [], []
    for t in range(n_steps):
        # 1. agent forward + sample
        obs, legal = obs_legal()
        x = obs.to(torch.float32)
        masked = masked_ops.mask_logits(pk.tower_apply(pi, x, d), legal)
        value = pk.tower_apply(vf, x, d)[:, 0]
        g_a = None if eval_mode else masked_ops.gumbel(bits[0][t])
        a, logp = pk.sample_and_logp(masked, None if eval_mode else bits[0][t])
        # 2. agent move
        win1 = move(_to_world(a, tm, n), ~done)
        # 3. opponent reply
        obs2, legal2 = obs_legal()
        idx = torch.where(ub, P1 - 1, oi)
        logits2 = pk.bank_logits_twin(stacked, d, obs2, idx, bf16=bank_bf16)
        if opp_logits is not None:
            opp_logits[t] = logits2
        masked2 = masked_ops.mask_logits(logits2, legal2)
        g_o = masked_ops.gumbel(bits[1][t])
        oa = masked_ops.argmax_first(masked2 + g_o)
        win2 = move(_to_world(oa, tm, n), ~done)
        reward = win1.to(torch.float32) - win2.to(torch.float32)
        done_out = done
        # 4. auto-reset + redraws + opening move
        if eval_mode:
            fa = zero
            gap_f = torch.zeros((B,), device=dev)
        else:
            r = bits[3][t]
            u_seat, u_best, u_idx = (masked_ops.unit_uniform(r[:, k]) for k in range(3))
            m = done
            stones = stones & ~m[:, None, None]
            labels = torch.where(m[:, None], lane[None, :], labels)
            empty = torch.where(m, F, empty)
            tm = torch.where(m, 0, tm)
            mc = torch.where(m, 0, mc)
            done = done & ~m
            if per_episode_seat:
                seat = torch.where(m, (u_seat < 0.5).to(torch.int32), seat)
            ub = torch.where(m, u_best < bp, ub)
            new_idx = torch.clamp((u_idx * (P1 - 1)).to(torch.int32), max=P1 - 2)
            oi = torch.where(m, new_idx, oi)
            first = first_table[torch.where(ub, P1 - 1, oi).long()]
            g_f = masked_ops.gumbel(bits[2][t])
            fa = masked_ops.argmax_first(first + g_f)
            move(fa, m & (seat == 1))  # seat 0 opens: world frame == mover frame
            gap_f = _margin(first + g_f)

        rec_obs.append(obs)
        rec_ints.append(
            torch.stack([a, oa, fa, done_out.to(torch.int32), seat, ub.to(torch.int32), oi, zero], 1)
        )
        zf = torch.zeros_like(logp)
        rec_flts.append(torch.stack([logp, value, reward, zf, zf, zf, zf, zf], 1))
        if with_margins:
            scores_a = masked if g_a is None else masked + g_a
            margins.append(torch.stack([_margin(scores_a), _margin(masked2 + g_o), gap_f], 1))

    out = FusedRolloutOut(
        obs=torch.stack(rec_obs),
        ints=torch.stack(rec_ints).to(torch.int32),
        flts=torch.stack(rec_flts),
        state=HexState(
            stones=stones,
            labels=labels,
            to_move=tm,
            done=done,
            winner=torch.full((B,), int(Winner.ONGOING), dtype=torch.int32, device=dev),
            empty=empty,
            move_count=mc,
        ),
        agent_seat=seat,
        use_best=ub,
        opp_idx=oi,
    )
    return (out, torch.stack(margins)) if with_margins else out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _rollout_cuda(
    topo, d, packed_agent, stacked, first_table, state, agent_seat, use_best, opp_idx,
    n_steps, best_prob, per_episode_seat, bits, generator, eval_mode, timers=None,
    bank_bf16=False, opp_logits=None,
) -> FusedRolloutOut:
    B, L, F, A = state.batch_size, topo.lanes, topo.num_cells, d.A
    P1 = stacked.shape[0]
    if L > 128:
        raise ValueError(f"the rollout kernel holds a game's lanes in one warp; {L} lanes is too many")
    chk = cuda_lib.check_cuda
    agent = chk("packed_agent", packed_agent, torch.float32,
                (pk.tower_size(d, A) + pk.tower_size(d, 1),))
    bank = chk("stacked", stacked, torch.float32, (P1, pk.tower_size(d, A)))
    first = chk("first_table", first_table, torch.float32, (P1, A))
    stones = chk("stones", state.stones, torch.bool, (B, 2, L))
    labels = chk("labels", state.labels, torch.int32, (B, L))
    to_move = chk("to_move", state.to_move, torch.int32, (B,))
    done = chk("done", state.done, torch.bool, (B,))
    empty = chk("empty", state.empty, torch.int32, (B,))
    moves = chk("move_count", state.move_count, torch.int32, (B,))
    seat = chk("agent_seat", agent_seat.to(torch.int32), torch.int32, (B,))
    ub = chk("use_best", use_best.to(torch.bool), torch.bool, (B,))
    oi = chk("opp_idx", opp_idx.to(torch.int32), torch.int32, (B,))
    seed = 0
    if bits is not None:
        widths = (A, A, A, RESET_LANES)
        bits = [chk(f"bits[{k}]", b, torch.int32, (n_steps, B, w))
                for k, (b, w) in enumerate(zip(bits, widths))]
    else:
        bits = [None] * 4
        seed = cuda_lib.philox_seed(generator)
    if timers is not None:
        timers = chk("timers", timers, torch.int64, (B, n_steps, ROLLOUT_MARKS))
    if opp_logits is not None:
        opp_logits = chk("opp_logits", opp_logits, torch.float32, (n_steps, B, A))

    dev = stones.device
    obs = torch.empty((n_steps, B, F), dtype=torch.int8, device=dev)
    ints = torch.empty((n_steps, B, 8), dtype=torch.int32, device=dev)
    flts = torch.empty((n_steps, B, 8), dtype=torch.float32, device=dev)
    o = HexState(
        stones=torch.empty_like(stones),
        labels=torch.empty_like(labels),
        to_move=torch.empty_like(to_move),
        done=torch.empty_like(done),
        winner=torch.full((B,), int(Winner.ONGOING), dtype=torch.int32, device=dev),
        empty=torch.empty_like(empty),
        move_count=torch.empty_like(moves),
    )
    o_seat, o_ub, o_oi = torch.empty_like(seat), torch.empty_like(ub), torch.empty_like(oi)
    # the launch's transposed, padded agent and bank (see the kernel's note)
    image = torch.empty((cuda_lib.rollout_image_floats(d.F, d.H, A, d.n_layers, P1),),
                        dtype=torch.float32, device=dev)
    p = cuda_lib.ptr
    cuda_lib.launch(
        "k4_rollout_bf16" if bank_bf16 else "k4_rollout", "hex_rollout",
        p(agent), p(bank), p(first), p(image), d.F, d.H, A, d.n_layers, int(d.relu), P1,
        p(stones), p(labels), p(to_move), p(done), p(empty), p(moves), p(seat), p(ub), p(oi),
        *[p(b) for b in bits], seed,
        p(obs), p(ints), p(flts),
        p(o.stones), p(o.labels), p(o.to_move), p(o.done), p(o.empty), p(o.move_count),
        p(o_seat), p(o_ub), p(o_oi),
        B, topo.n, L, n_steps, float(best_prob), int(per_episode_seat), int(eval_mode),
        int(bank_bf16),
        *cuda_lib.rollout_plan(d.F, d.H, A, d.n_layers, topo.n, L, B, bank_bf16)[:3], p(timers),
        p(opp_logits),
    )
    return FusedRolloutOut(obs, ints, flts, o, o_seat, o_ub, o_oi)


def fused_rollout(
    topo: HexTopology,
    pol: pk.PolicyOps,
    packed_agent: torch.Tensor,
    stacked: torch.Tensor,  # (P1, S) bank members, best last
    first_table: torch.Tensor,  # (P1, A) empty-board logits per member
    state: HexState,
    agent_seat: torch.Tensor,
    use_best: torch.Tensor,
    opp_idx: torch.Tensor,
    n_steps: int,
    best_prob: float,
    per_episode_seat: bool,
    bits=None,
    generator: Optional[torch.Generator] = None,
    eval_mode: bool = False,
    timers: Optional[torch.Tensor] = None,
    bank_bf16: bool = False,
    opp_logits: Optional[torch.Tensor] = None,
) -> FusedRolloutOut:
    """Run ``n_steps`` selfplay transitions in one pass; see the module
    docstring.  The kernel for a CUDA state under ``pol.impl`` "auto" or
    "pallas", the twin for a CPU state ("pallas" raises there).  ``timers``,
    for the kernel only, is an int64 (B, n_steps, ``ROLLOUT_MARKS``) buffer
    that receives its phase clock (``utils/profiling.phase_split``).
    ``bank_bf16`` takes the bf16-bank instance (``rollout_bank_bf16``).
    ``opp_logits``, a float32 (n_steps, B, A) buffer, receives the
    opponent's bank logits at each step (before the legal mask), from the
    kernel or the twin: what the check of the bf16 bank compares."""
    if pk.use_kernel(state.stones, pol.impl):
        return _rollout_cuda(
            topo, pol.dims, packed_agent, stacked, first_table, state, agent_seat,
            use_best, opp_idx, n_steps, best_prob, per_episode_seat, bits, generator,
            eval_mode, timers, bank_bf16, opp_logits,
        )
    if bits is None:
        if generator is None:
            raise ValueError("pass random bits or a torch.Generator")
        bits = draw_rollout_bits(generator, n_steps, state.batch_size, pol.dims.A, state.device)
    return fused_rollout_twin(
        topo, pol.dims, packed_agent, stacked, first_table, state, agent_seat, use_best,
        opp_idx, n_steps, best_prob, per_episode_seat, bits, eval_mode, bank_bf16=bank_bf16,
        opp_logits=opp_logits,
    )


# ---------------------------------------------------------------------------
# replay check
# ---------------------------------------------------------------------------


def verify_rollout_trajectory(
    topo: HexTopology,
    model,
    params,
    carry,
    out: FusedRolloutOut,
    n_steps: int,
    seat_mode: str,
    pool_size: int,
    atol: float = 1e-5,
) -> HexState:
    """Replay a rollout record through the plain env ops and assert exact
    trajectory equality.

    Works for any source of randomness, because the record holds every draw
    (actions, opponent replies, opening moves, reset seat/opponent draws):
    observations, legal masks, legality of every move, rewards, dones,
    reset bookkeeping, the value and log-prob (against ``model`` with
    ``params``) and the final carry down to the labels are re-derived and
    compared.  Returns the replayed final state; raises ``AssertionError``
    on a mismatch.
    """
    F, n = topo.num_cells, topo.n
    state = carry.env
    B = state.batch_size
    ar = np.arange(B)
    seat = carry.agent_seat.cpu().numpy()
    use_best = carry.use_best.cpu().numpy()
    opp_idx = carry.opp_idx.cpu().numpy()
    fresh = hex_env.initial_state(topo, B, state.device)
    ints = out.ints.cpu().numpy()
    flts = out.flts.cpu().numpy()
    obs_all = out.obs.cpu().numpy()

    def dev(x):
        return torch.as_tensor(x, device=state.device)

    for t in range(n_steps):
        obs_ref = hex_env.observe(topo, state)
        obs_np = obs_ref.cpu().numpy()
        np.testing.assert_array_equal(obs_all[t].reshape(B, n, n), obs_np, err_msg=f"obs @ {t}")
        legal_ref = hex_env.legal_mask(topo, state).cpu().numpy()
        np.testing.assert_array_equal(obs_all[t] == 0, legal_ref, err_msg=f"legal @ {t}")

        a = ints[t, :, I_ACTION]
        assert legal_ref[ar, a].all(), f"illegal agent action at step {t}"
        with torch.no_grad():
            logits, value = torch.func.functional_call(
                model, params, (obs_ref.to(torch.float32),)
            )
        logp = torch.log_softmax(
            torch.where(dev(legal_ref), logits, torch.full_like(logits, -np.inf)), dim=-1
        ).cpu().numpy()
        np.testing.assert_allclose(
            flts[t, :, F_VALUE], value.cpu().numpy(), atol=atol, err_msg=f"value @ {t}"
        )
        np.testing.assert_allclose(
            flts[t, :, F_LOGP], logp[ar, a], atol=atol, err_msg=f"log_prob @ {t}"
        )

        st1, rew1 = hex_env.step(topo, state, dev(a))
        r = rew1.cpu().numpy()[ar, seat]
        oa = ints[t, :, I_OPP_ACTION]
        active2 = ~st1.done.cpu().numpy()
        legal2 = hex_env.legal_mask(topo, st1).cpu().numpy()
        assert legal2[ar, oa][active2].all(), f"illegal opponent reply at {t}"
        st2, rew2 = hex_env.step(topo, st1, dev(oa), active=dev(active2))
        r = r + rew2.cpu().numpy()[ar, seat]
        np.testing.assert_allclose(flts[t, :, F_REWARD], r, err_msg=f"reward @ {t}")
        done = st2.done.cpu().numpy()
        np.testing.assert_array_equal(ints[t, :, I_DONE] != 0, done, err_msg=f"done @ {t}")

        st3 = hex_env.reset_where(topo, st2, dev(done), fresh)
        seat2 = ints[t, :, I_SEAT]
        use_best2 = ints[t, :, I_USE_BEST] != 0
        opp_idx2 = ints[t, :, I_OPP_IDX]
        np.testing.assert_array_equal(seat2[~done], seat[~done])
        np.testing.assert_array_equal(use_best2[~done], use_best[~done])
        np.testing.assert_array_equal(opp_idx2[~done], opp_idx[~done])
        if seat_mode == "fixed_random":
            np.testing.assert_array_equal(seat2, seat)
        assert ((opp_idx2 >= 0) & (opp_idx2 < pool_size)).all()

        fa = ints[t, :, I_FIRST_ACTION]
        st4, _ = hex_env.step(topo, st3, dev(fa), active=dev(done & (seat2 == 1)))
        state, seat, use_best, opp_idx = st4, seat2, use_best2, opp_idx2

    fin = out.state
    for name in ("stones", "labels", "to_move", "empty", "done"):
        np.testing.assert_array_equal(
            getattr(fin, name).cpu().numpy(), getattr(state, name).cpu().numpy(),
            err_msg=f"final {name}",
        )
    return state


# ---------------------------------------------------------------------------
# gate
# ---------------------------------------------------------------------------


def supported(model, cfg) -> bool:
    """The kernel takes plain equal-tower MLPs, empty-board resets (its
    opening-move table needs them) and boards up to 11x11 (cells + 4 edge
    virtuals in 128 lanes, four per thread of the game's warp), with a
    float32 or a bf16 bank (``rollout_bank_bf16``), as the JAX gate."""
    if cfg.board_size**2 + 4 > 128 or cfg.sample_board:
        return False
    return pk.supported(model)


def resolve(model, cfg) -> Optional[pk.PolicyOps]:
    """Gate for ``SelfplayConfig.rollout_impl``: the ``PolicyOps`` of the
    whole-rollout pass, or None for the per-step scan.

    "fused" takes the whole-rollout pass (raising where ``supported`` says
    no); "auto" takes it where supported unless ``policy_impl`` pins the
    plain "lax" path; "scan" never.  The pass runs the kernel on a CUDA
    state and the twin on a CPU state; ``policy_impl="pallas"`` pins the
    kernel."""
    impl = getattr(cfg, "rollout_impl", "auto")
    if impl not in ("auto", "scan", "fused"):
        raise ValueError(
            f"rollout_impl must be one of 'auto'/'scan'/'fused', got {impl!r}"
        )
    if impl == "scan":
        return None
    policy_impl = getattr(cfg, "policy_impl", "auto")
    if impl == "auto" and policy_impl == "lax":
        return None
    if supported(model, cfg):
        return pk.PolicyOps(model, "pallas" if policy_impl == "pallas" else "auto")
    if impl == "fused":
        raise ValueError(
            "rollout_impl='fused' requires a plain equal-tower MlpPolicy, "
            "sample_board=False and a board of at most 11x11"
        )
    return None
