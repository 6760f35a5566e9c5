"""K2 and K3: the agent pass and the opponent-bank pass as CUDA kernels.

Counterparts of the JAX package's ``ops/pallas_policy.py``:

- K2 ``agent_forward_sample`` (``_agent_kernel``): the agent's MLP forward,
  masked logits, Gumbel-max sample, log-prob of the sampled action, and the
  value, in one launch, on the agent operand built once per rollout
  (``PolicyOps.agent_operand``).
- K3 ``bank_forward_sample`` (``_bank_kernel``): for each row, the pi tower
  and action head of that row's opponent (a pool slot, or the best at index
  P), then the masked Gumbel-max sample, in one launch, on the bank
  operand built once per rollout (``PolicyOps.bank_operand``).

Weights travel as flat float32 runs, one per tower, with the kernels laid
out (in, out) (layout in ``csrc/hex_common.cuh``):

- agent: the pi tower with its action head, then the vf tower with its
  value head (``pack_agent``);
- bank: one row per member, best last, each a pi tower with its action head
  (``stack_bank``), (P1, S).  The TPU's window-masked stack is not needed.

The kernels read the towers as images (``tower_image_twin``; on the card
``tower_image_kernel``): each layer's weights transposed, one padded row
per output (the layout of ``csrc/hex_common.cuh`` ``team_mlp_towers``),
built once per rollout beside the packing: the agent's image
(``agent_image_cuda``) with the packed agent is an ``AgentOperand``, the
bank's (``bank_image_cuda``) with the stack a ``BankOperand``.  The twins
read the packing.

Each pass has a plain PyTorch twin here (``*_twin``) that computes the same
function from the same packed weights.  The wrappers take the kernel for a
CUDA tensor and the twin for a CPU tensor (``impl="auto"``); ``"pallas"``
pins the kernel (raises on a CPU tensor) and ``"lax"`` the twin.

Sampling is a function of uint32 bits (``ops/masked.py``).  With a bits
tensor given, the kernel and the twin draw the same action from it.
Without one, the twin draws bits from the generator and the kernel seeds
its own Philox streams from it (``ops/cuda_lib.philox_seed``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hex_gym_env_tpu_torch.models.mlp import MlpPolicy
from hex_gym_env_tpu_torch.ops import cuda_lib
from hex_gym_env_tpu_torch.ops import masked as masked_ops


class MlpDims(NamedTuple):
    F: int  # input features (N^2)
    H: int  # hidden width of every layer of both towers
    A: int  # actions (N^2)
    n_layers: int
    relu: bool  # else tanh


def mlp_dims(model: MlpPolicy) -> MlpDims:
    """The kernels' dims of an MLP with equal towers of one width
    (``supported``)."""
    return MlpDims(F=model.n_actions, H=model.pi_layers[0], A=model.n_actions,
                   n_layers=len(model.pi_layers), relu=model.activation == "relu")


def tower_size(d: MlpDims, out: int) -> int:
    """Floats in one packed tower with an ``out``-wide head."""
    return d.F * d.H + d.H + (d.n_layers - 1) * (d.H * d.H + d.H) + d.H * out + out


def _pack_tower(params, tower: str, head: str, n_layers: int) -> torch.Tensor:
    parts = []
    for i in range(n_layers):
        parts += [params[f"{tower}.{i}.weight"].transpose(-1, -2), params[f"{tower}.{i}.bias"]]
    parts += [params[f"{head}.weight"].transpose(-1, -2), params[f"{head}.bias"]]
    lead = parts[0].shape[:-2]
    return torch.cat([p.reshape(*lead, -1).to(torch.float32) for p in parts], dim=-1)


def _unpack_tower(flat: torch.Tensor, d: MlpDims, out: int, tower: str, head: str, sd: dict):
    views = tower_views(flat, d, out)
    names = [f"{tower}.{i}" for i in range(d.n_layers)] + [head]
    for name, (W, b) in zip(names, views):
        sd[f"{name}.weight"] = W.transpose(-1, -2).contiguous()
        sd[f"{name}.bias"] = b.contiguous()


def tower_views(flat: torch.Tensor, d: MlpDims, out: int):
    """[(W (..., in, out), b (..., out)), ...] views of packed towers."""
    lead = flat.shape[:-1]
    views, off, n_in = [], 0, d.F
    for width in [d.H] * d.n_layers + [out]:
        W = flat[..., off : off + n_in * width].reshape(*lead, n_in, width)
        off += n_in * width
        views.append((W, flat[..., off : off + width]))
        off += width
        n_in = width
    return views


# the transposed, padded layout of hex_common.cuh (round4, row_stride,
# tlayer_size, ttower_size): each layer is its n_out rows of n_in weights at
# row stride row_stride(n_in) (pads zero), then its n_out biases padded to
# round4(n_out); a tower is its layers in order, the head last


def round4(n: int) -> int:
    return (n + 3) & ~3


def row_stride(n: int) -> int:
    """n rounded up to 4 floats, with stride / 4 odd (distinct banks for the
    16-byte reads of neighbouring rows)."""
    s = round4(n)
    return s + 4 if (s >> 2) % 2 == 0 else s


def tlayer_size(n_in: int, n_out: int) -> int:
    return n_out * row_stride(n_in) + round4(n_out)


def ttower_size(d: MlpDims, out: int) -> int:
    """Floats in one transposed, padded tower with an ``out``-wide head."""
    return tlayer_size(d.F, d.H) + (d.n_layers - 1) * tlayer_size(d.H, d.H) + tlayer_size(d.H, out)


def tower_image_twin(towers: torch.Tensor, d: MlpDims, out: int) -> torch.Tensor:
    """Plain PyTorch of ``tower_image_kernel``: packed towers (P, ``tower_size(d,
    out)``) -> their images (P, ``ttower_size(d, out)``)."""
    P = towers.shape[0]
    parts = []
    for W, b in tower_views(towers, d, out):
        n_in, n_out = W.shape[-2:]
        rows = torch.zeros((P, n_out, row_stride(n_in)), dtype=torch.float32, device=towers.device)
        rows[:, :, :n_in] = W.transpose(1, 2)
        bias = torch.zeros((P, round4(n_out)), dtype=torch.float32, device=towers.device)
        bias[:, :n_out] = b
        parts += [rows.reshape(P, -1), bias]
    return torch.cat(parts, dim=1)


def bank_image_twin(stacked: torch.Tensor, d: MlpDims) -> torch.Tensor:
    """Plain PyTorch of K3's bank image: (P1, ``ttower_size(d, A)``)."""
    return tower_image_twin(stacked, d, d.A)


def agent_image_twin(packed: torch.Tensor, d: MlpDims) -> torch.Tensor:
    """Plain PyTorch of K2's agent image: the pi tower's image, then the vf
    tower's, (``ttower_size(d, A) + ttower_size(d, 1)``,)."""
    split = tower_size(d, d.A)
    return torch.cat([tower_image_twin(packed[None, :split], d, d.A)[0],
                      tower_image_twin(packed[None, split:], d, 1)[0]])


def _tower_image_cuda(kernel: str, agent, bank, d: MlpDims, first: int, count: int, floats: int):
    """``tower_image_kernel``'s instances ``first`` .. ``first + count - 1``
    (0 the agent's pi tower, 1 its vf tower, 2 + i bank member i) into one
    new buffer of ``floats``, counted as a launch of ``kernel``."""
    src = agent if agent is not None else bank
    image = torch.empty((floats,), dtype=torch.float32, device=src.device)
    p = cuda_lib.ptr
    cuda_lib.launch(kernel, "hex_tower_image",
                    p(agent), p(bank), d.F, d.H, d.A, d.n_layers, first, count, p(image))
    return image


def bank_image_cuda(stacked: torch.Tensor, d: MlpDims) -> torch.Tensor:
    """K3's bank image on the card, the twin's values exactly."""
    P1 = stacked.shape[0]
    stacked = cuda_lib.check_cuda("stacked", stacked, torch.float32, (P1, tower_size(d, d.A)))
    size = ttower_size(d, d.A)
    return _tower_image_cuda("k3_bank_image", None, stacked, d, 2, P1, P1 * size).view(P1, size)


def agent_image_cuda(packed: torch.Tensor, d: MlpDims) -> torch.Tensor:
    """K2's agent image on the card, the twin's values exactly."""
    packed = cuda_lib.check_cuda("packed", packed, torch.float32,
                                 (tower_size(d, d.A) + tower_size(d, 1),))
    return _tower_image_cuda("k2_agent_image", packed, None, d, 0, 2,
                             ttower_size(d, d.A) + ttower_size(d, 1))


class AgentOperand(NamedTuple):
    """The agent as the agent pass reads it, built once per rollout
    (``agent_operand``): ``packed`` (``pack_agent``), which the twin reads;
    and where the kernel runs, ``image``, its agent image
    (``agent_image_cuda``), which the kernel reads."""

    packed: torch.Tensor
    image: Optional[torch.Tensor] = None


def agent_operand(packed: torch.Tensor, d: MlpDims, impl: str = "auto") -> AgentOperand:
    """``packed`` with its agent image where ``impl`` takes the kernel
    (``use_kernel``), alone where it takes the twin."""
    return AgentOperand(packed, agent_image_cuda(packed, d) if use_kernel(packed, impl) else None)


class BankOperand(NamedTuple):
    """The bank as the bank pass reads it, built once per rollout
    (``bank_operand``): ``stacked`` (P1, S), the members then the best, which
    the twin reads; and where the kernel runs, ``image``, its bank image
    (``bank_image_cuda``), which the kernel reads."""

    stacked: torch.Tensor
    image: Optional[torch.Tensor] = None


def bank_operand(stacked: torch.Tensor, d: MlpDims, impl: str = "auto") -> BankOperand:
    """``stacked`` with its bank image where ``impl`` takes the kernel
    (``use_kernel``), alone where it takes the twin."""
    return BankOperand(stacked, bank_image_cuda(stacked, d) if use_kernel(stacked, impl) else None)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bfloat16 (ties to even), as float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _act(d: MlpDims):
    return torch.relu if d.relu else torch.tanh


def tower_apply(views, x: torch.Tensor, d: MlpDims) -> torch.Tensor:
    """One packed tower on a batch ``x`` (B, F), weights shared by the rows."""
    act = _act(d)
    h = x
    for W, b in views[:-1]:
        h = act(h @ W + b)
    W, b = views[-1]
    return h @ W + b


def tower_apply_rows(
    views, idx: torch.Tensor, x: torch.Tensor, d: MlpDims, bf16: bool = False
) -> torch.Tensor:
    """Stacked towers (leading member axis), row ``r`` through member
    ``idx[r]``.  ``bf16`` rounds each hidden activation to bf16 before the
    next dot (the bf16 bank; the weights are rounded by the caller)."""
    act = _act(d)
    h = x[:, None, :]
    idx = idx.long()
    for W, b in views[:-1]:
        h = act(torch.bmm(h, W[idx]) + b[idx][:, None, :])
        if bf16:
            h = bf16_round(h)
    W, b = views[-1]
    return (torch.bmm(h, W[idx]) + b[idx][:, None, :])[:, 0]


def sample_and_logp(masked: torch.Tensor, bits: Optional[torch.Tensor]):
    """Gumbel-max action (the argmax when ``bits`` is None) and its
    log-softmax, in the kernels' order: ``z = masked - max``,
    ``logp = z[a] - log(sum(exp(z)))``."""
    if bits is None:
        action = masked_ops.argmax_first(masked)
    else:
        action = masked_ops.sample_masked(masked, bits)
    z = masked - masked.max(dim=-1, keepdim=True).values
    lse = torch.log(torch.exp(z).sum(dim=-1))
    return action, z.gather(-1, action.long()[:, None])[:, 0] - lse


def use_kernel(t: torch.Tensor, impl: str) -> bool:
    """The one kernel-or-twin rule: "lax" twin; "auto" by device; "pallas"
    the kernel, raising on a CPU tensor."""
    if impl not in ("auto", "lax", "pallas"):
        raise ValueError(f"impl must be one of 'auto'/'lax'/'pallas', got {impl!r}")
    if impl == "lax":
        return False
    if t.is_cuda:
        return True
    if impl == "pallas":
        raise ValueError("impl='pallas' pins the CUDA kernel, but the tensor lies on the CPU")
    return False


def _bits_or_draw(bits, generator, shape, device):
    if bits is not None:
        return bits
    if generator is None:
        raise ValueError("pass random bits or a torch.Generator")
    return masked_ops.draw_bits(generator, shape, device)


# ---------------------------------------------------------------------------
# K2: agent pass
# ---------------------------------------------------------------------------


class AgentActResult(NamedTuple):
    action: torch.Tensor  # (B,) int32
    log_prob: torch.Tensor  # (B,) float32
    value: torch.Tensor  # (B,) float32
    masked_logits: torch.Tensor  # (B, A) float32


def agent_forward_sample_twin(packed, d: MlpDims, obs_flat, legal, bits) -> AgentActResult:
    """Plain PyTorch K2."""
    pi = tower_views(packed[: tower_size(d, d.A)], d, d.A)
    vf = tower_views(packed[tower_size(d, d.A) :], d, 1)
    x = obs_flat.to(torch.float32)
    masked = masked_ops.mask_logits(tower_apply(pi, x, d), legal.to(torch.bool))
    action, logp = sample_and_logp(masked, bits)
    return AgentActResult(action, logp, tower_apply(vf, x, d)[:, 0], masked)


def _agent_cuda(image, d: MlpDims, obs_flat, legal, bits, generator) -> AgentActResult:
    B = obs_flat.shape[0]
    chk = cuda_lib.check_cuda
    image = chk("image", image, torch.float32, (ttower_size(d, d.A) + ttower_size(d, 1),))
    obs = chk("obs", obs_flat, torch.int8, (B, d.F))
    legal = chk("legal", legal, torch.bool, (B, d.A))
    seed = 0
    if bits is not None:
        bits = chk("bits", bits, torch.int32, (B, d.A))
    else:
        seed = cuda_lib.philox_seed(generator)
    # one output buffer: the masked logits, the log-probs, the values, then
    # the actions' int32 words
    out = torch.empty((B * (d.A + 3),), dtype=torch.float32, device=obs.device)
    masked = out[: B * d.A].view(B, d.A)
    logp = out[B * d.A : B * (d.A + 1)]
    value = out[B * (d.A + 1) : B * (d.A + 2)]
    action = out[B * (d.A + 2) :].view(torch.int32)
    p = cuda_lib.ptr
    cuda_lib.launch(
        "k2_agent", "hex_agent",
        p(image), d.F, d.H, d.A, d.n_layers, int(d.relu), p(obs), p(legal), p(bits),
        seed, p(masked), p(logp), p(value), p(action), B,
    )
    return AgentActResult(action, logp, value, masked)


def agent_forward_sample(
    agent: AgentOperand,
    d: MlpDims,
    obs_flat: torch.Tensor,  # (B, F) integer boards (int8 for the kernel)
    legal: torch.Tensor,  # (B, A) bool
    bits: Optional[torch.Tensor] = None,  # (B, A) int32 bit patterns
    generator: Optional[torch.Generator] = None,
    impl: str = "auto",
) -> AgentActResult:
    """One pass: agent MLP forward, masked Gumbel sample, log-prob, value, on
    ``agent`` (``agent_operand``, built once per rollout: the kernel reads
    its image, the twin its packing)."""
    if use_kernel(obs_flat, impl):
        if agent.image is None:
            raise ValueError("the agent kernel reads the agent image: build the operand once per "
                             "rollout with agent_operand")
        return _agent_cuda(agent.image, d, obs_flat, legal, bits, generator)
    bits = _bits_or_draw(bits, generator, legal.shape, obs_flat.device)
    return agent_forward_sample_twin(agent.packed, d, obs_flat, legal, bits)


# ---------------------------------------------------------------------------
# K3: opponent-bank pass
# ---------------------------------------------------------------------------


def bank_logits_twin(stacked, d: MlpDims, obs_flat, member_idx, bf16: bool = False) -> torch.Tensor:
    """Each row's member's action logits, (B, A).

    ``bf16`` is the bf16 bank of the fused rollout (``rollout_bank_bf16``,
    JAX ``ops/pallas_rollout.py`` ``bank_bf16``): the members' weights and
    biases rounded to bf16, each dot's left-hand side rounded to bf16 (the
    observation is exact; each hidden activation is rounded), the sums and
    the bias additions in float32."""
    if bf16:
        stacked = bf16_round(stacked)
    views = tower_views(stacked, d, d.A)
    return tower_apply_rows(views, member_idx, obs_flat.to(torch.float32), d, bf16)


def bank_forward_sample_twin(stacked, d: MlpDims, obs_flat, legal, member_idx, bits):
    """Plain PyTorch K3: ``(action (B,) int32, masked_logits (B, A))``."""
    logits = bank_logits_twin(stacked, d, obs_flat, member_idx)
    masked = masked_ops.mask_logits(logits, legal.to(torch.bool))
    return masked_ops.sample_masked(masked, bits), masked


def _bank_cuda(image, P1: int, d: MlpDims, obs_flat, legal, member_idx, use_best, bits, generator):
    B = obs_flat.shape[0]
    chk = cuda_lib.check_cuda
    image = chk("image", image, torch.float32, (P1, ttower_size(d, d.A)))
    obs = chk("obs", obs_flat.to(torch.int8), torch.int8, (B, d.F))
    legal = chk("legal", legal.to(torch.bool), torch.bool, (B, d.A))
    member = chk("member_idx", member_idx.to(torch.int32), torch.int32, (B,))
    if use_best is not None:
        use_best = chk("use_best", use_best.to(torch.bool), torch.bool, (B,))
    seed = 0
    if bits is not None:
        bits = chk("bits", bits, torch.int32, (B, d.A))
    else:
        seed = cuda_lib.philox_seed(generator)
    # one output buffer: the masked logits, then the actions' int32 words
    out = torch.empty((B * (d.A + 1),), dtype=torch.float32, device=obs.device)
    masked = out[: B * d.A].view(B, d.A)
    action = out[B * d.A :].view(torch.int32)
    p = cuda_lib.ptr
    cuda_lib.launch(
        "k3_bank", "hex_bank",
        p(image), d.F, d.H, d.A, d.n_layers, int(d.relu), P1, p(obs), p(legal), p(member),
        p(use_best), p(bits), seed, p(action), p(masked), B,
    )
    return action, masked


def bank_forward_sample(
    bank: BankOperand,
    d: MlpDims,
    obs_flat: torch.Tensor,
    legal: torch.Tensor,
    member_idx: torch.Tensor,  # (B,) pool slot, or P1 - 1 for the best
    bits: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    impl: str = "auto",
    use_best: Optional[torch.Tensor] = None,
):
    """One pass: each row's member forward + masked sample, on ``bank``
    (``bank_operand``, built once per rollout: the kernel reads its image,
    the twin its stack).  Where ``use_best`` (B,) bool is set, the row's
    member is the best, P1 - 1.
    Returns ``(action (B,) int32, masked_logits (B, A) float32)``."""
    P1 = bank.stacked.shape[0]
    if use_kernel(obs_flat, impl):
        if bank.image is None:
            raise ValueError("the bank kernel reads the bank image: build the operand once per "
                             "rollout with bank_operand")
        return _bank_cuda(bank.image, P1, d, obs_flat, legal, member_idx, use_best, bits,
                          generator)
    if use_best is not None:
        member_idx = torch.where(use_best, P1 - 1, member_idx.to(torch.int32))
    bits = _bits_or_draw(bits, generator, legal.shape, obs_flat.device)
    return bank_forward_sample_twin(bank.stacked, d, obs_flat, legal, member_idx, bits)


# ---------------------------------------------------------------------------
# Runner-facing gate
# ---------------------------------------------------------------------------


class PolicyOps:
    """Shapes and packing for one MLP model, and the two passes bound to
    one ``impl``."""

    def __init__(self, model: MlpPolicy, impl: str = "auto"):
        self.dims = mlp_dims(model)
        self.impl = impl

    def pack_agent(self, params) -> torch.Tensor:
        """Agent state dict -> (S_pi + S_vf,) float32."""
        n = self.dims.n_layers
        return torch.cat(
            [_pack_tower(params, "pi", "action_head", n), _pack_tower(params, "vf", "value_head", n)]
        ).contiguous()

    def unpack_agent(self, packed: torch.Tensor) -> dict:
        """The inverse of ``pack_agent``: (S_pi + S_vf,) -> state dict."""
        d, sd = self.dims, {}
        split = tower_size(d, d.A)
        _unpack_tower(packed[:split], d, d.A, "pi", "action_head", sd)
        _unpack_tower(packed[split:], d, 1, "vf", "value_head", sd)
        return sd

    def stack_bank(self, bank) -> torch.Tensor:
        """Bank members + best (appended at index P) -> (P1, S) float32."""
        n = self.dims.n_layers
        members = _pack_tower(bank.params, "pi", "action_head", n)
        best = _pack_tower(bank.best_params, "pi", "action_head", n)
        return torch.cat([members, best[None]], dim=0).contiguous()

    def agent_operand(self, params) -> AgentOperand:
        """The agent pass's operand, built once per rollout: ``pack_agent``
        with, where the kernel runs, its agent image."""
        return agent_operand(self.pack_agent(params), self.dims, self.impl)

    def agent_act(self, agent: AgentOperand, obs, legal, generator=None, bits=None) -> AgentActResult:
        obs_flat = obs.reshape(obs.shape[0], -1)
        return agent_forward_sample(agent, self.dims, obs_flat, legal, bits, generator, self.impl)

    def bank_operand(self, bank) -> BankOperand:
        """The bank pass's operand, built once per rollout: ``stack_bank``
        with, where the kernel runs, its bank image."""
        return bank_operand(self.stack_bank(bank), self.dims, self.impl)

    def bank_act(self, bank: BankOperand, use_best, opp_idx, obs, legal, generator=None,
                 bits=None):
        obs_flat = obs.reshape(obs.shape[0], -1)
        return bank_forward_sample(
            bank, self.dims, obs_flat, legal, opp_idx, bits, generator, self.impl,
            use_best=use_best,
        )


def supported(model) -> bool:
    """True for a plain MLP with equal towers of one hidden width."""
    if not isinstance(model, MlpPolicy):
        return False
    return model.pi_layers == model.vf_layers and len(set(model.pi_layers)) == 1


def resolve_policy_ops(model, cfg) -> Optional[PolicyOps]:
    """Gate for ``SelfplayConfig.policy_impl``: None (the plain model path)
    for "lax" or a model the kernels cannot pack under "auto"; else the
    kernel passes ("auto": kernel on CUDA, twin on CPU; "pallas": kernel)."""
    impl = getattr(cfg, "policy_impl", "auto")
    if impl not in ("auto", "lax", "pallas"):
        raise ValueError(
            f"policy_impl must be one of 'auto'/'lax'/'pallas', got {impl!r}"
        )
    if impl == "lax":
        return None
    if not supported(model):
        if impl == "pallas":
            raise ValueError("policy_impl='pallas' requires a plain equal-tower MlpPolicy")
        return None
    return PolicyOps(model, impl)
