"""The port's opponent bank: the JAX package's semantics for the initial
random pool, the opponent draw and the replacement rule."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hex_gym_env_tpu.models import make_policy as jax_make_policy
from hex_gym_env_tpu.train.bank import init_bank as jax_init_bank

from hex_gym_env_tpu_torch.models import make_policy
from hex_gym_env_tpu_torch.models.convert import flax_state_dict
from hex_gym_env_tpu_torch.train.bank import init_bank, replace_member, sample_opponents


def _params(seed=0, n=9):
    model = make_policy("MLP-default", n, generator=torch.Generator().manual_seed(seed))
    return {k: v.detach() for k, v in model.state_dict().items()}


def test_init_bank_matches_jax_layout():
    n = 3
    jvars = jax_make_policy("MLP-default", n * n).init(jax.random.key(0), jnp.zeros((1, n, n)))
    jbank = jax_init_bank(jvars, 5)
    expected = flax_state_dict(jax.tree.map(np.asarray, jbank.params))
    bank = init_bank(_params(), 5)
    assert bank.size == 5
    for k, v in expected.items():
        assert tuple(bank.params[k].shape) == tuple(v.shape)
        assert torch.all(bank.params[k] == 0)
    assert all(torch.all(v == 0) for v in bank.best_params.values())
    assert float(bank.best_score) == 0.0 and torch.all(bank.scores == 0)


def test_sample_opponents_distribution():
    g = torch.Generator().manual_seed(0)
    use_best, idx = sample_opponents(g, 7, 20000, 0.8, "cpu")
    assert use_best.dtype == torch.bool and idx.dtype == torch.int32
    assert abs(float(use_best.float().mean()) - 0.8) < 0.02
    assert int(idx.min()) == 0 and int(idx.max()) == 6
    counts = torch.bincount(idx.long(), minlength=7).float() / 20000
    assert torch.all((counts - 1 / 7).abs() < 0.02)


def test_replace_member_picks_an_argmin_slot_and_promotes_strictly():
    g = torch.Generator().manual_seed(0)
    bank = init_bank(_params(), 4)
    scores = torch.tensor([0.5, 0.1, 0.1, 0.9])
    bank.scores = scores.clone()
    new = _params(seed=1)

    slots = set()
    for _ in range(40):
        b2 = replace_member(bank, g, new, torch.tensor(0.75), True)
        changed = [i for i in range(4) if float(b2.scores[i]) != float(bank.scores[i])]
        assert len(changed) == 1 and changed[0] in (1, 2)
        slots.add(changed[0])
        assert torch.equal(b2.params["pi.0.weight"][changed[0]], new["pi.0.weight"])
        assert float(b2.best_score) == 0.75  # 0.75 > 0: promoted
        assert torch.equal(b2.best_params["action_head.bias"], new["action_head.bias"])
    assert slots == {1, 2}  # uniform among the argmin slots

    bank.best_score = torch.tensor(0.75)
    b3 = replace_member(bank, g, new, torch.tensor(0.75), True)
    assert float(b3.best_score) == 0.75 and b3.best_params is bank.best_params  # not strict
    assert replace_member(bank, g, new, torch.tensor(2.0), False) is bank
    assert torch.equal(bank.scores, scores)  # the given bank is not modified
