"""The port's GAE against the JAX package.

The same numpy-made rewards, values, dones and last values go through the
JAX recurrence (the lax scan and the Pallas kernel in interpret mode) and
the port's ``train/gae.compute_gae`` and its K5 dispatch on the CPU (the
twin).  Tolerance: rtol 1e-6, atol 1e-6 (float32, the same operation order;
XLA may fuse the scan's multiply-adds).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hex_gym_env_tpu.ops import pallas_gae as jax_pallas_gae
from hex_gym_env_tpu.train import gae as jax_gae
from tests.test_train import reference_gae

from hex_gym_env_tpu_torch.ops import gae_kernel
from hex_gym_env_tpu_torch.train import gae

RTOL = ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in parallel worker processes, and
    small CPU ops gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(T, B, seed=0):
    rng = np.random.default_rng(seed)
    rewards = np.where(rng.random((T, B)) < 0.1, np.sign(rng.normal(size=(T, B))), 0.0)
    values = (rng.normal(size=(T, B)) * 0.5).astype(np.float32)
    dones = rng.random((T, B)) < 0.15
    last_values = (rng.normal(size=B) * 0.5).astype(np.float32)
    return rewards.astype(np.float32), values, dones, last_values


def _port(impl, rewards, values, dones, last_values):
    t = [torch.from_numpy(x) for x in (rewards, values, dones, last_values)]
    fn = gae_kernel.resolve(impl)
    adv, ret = fn(*t, 0.99, 0.95)
    return adv.numpy(), ret.numpy()


@functools.lru_cache(maxsize=None)
def _jax_outputs(T, B):
    """The JAX package's outputs, computed once per shape: the lax scan, and
    the Pallas kernel where T is within its unroll cap."""
    args = [jnp.asarray(x) for x in _inputs(T, B)]
    outs = [jax.jit(lambda *a: jax_gae.compute_gae(*a, 0.99, 0.95))(*args)]
    if T <= jax_pallas_gae.MAX_UNROLL_STEPS:
        outs.append(jax.jit(
            lambda *a: jax_pallas_gae.compute_gae(*a, 0.99, 0.95, interpret=True))(*args))
    return outs


@pytest.mark.parametrize("impl", ["lax", "auto"])
@pytest.mark.parametrize("T,B", [(16, 8), (128, 32), (128, 30), (2048, 8)])
def test_port_gae_matches_jax_scan_and_pallas(T, B, impl):
    """B = 30 leaves a warp of the kernel's columns partly empty; T = 2048 is
    the strict presets' rollout, past the Pallas kernel's unroll cap (the
    lax scan alone there)."""
    adv, ret = _port(impl, *_inputs(T, B))
    for want_adv, want_ret in _jax_outputs(T, B):
        np.testing.assert_allclose(adv, np.asarray(want_adv), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ret, np.asarray(want_ret), rtol=RTOL, atol=ATOL)


def test_port_gae_matches_literal_loop():
    rewards, values, dones, last_values = _inputs(12, 5, seed=3)
    want_adv, want_ret = reference_gae(
        rewards, values, dones.astype(np.float32), last_values, 0.99, 0.95)
    adv, ret = _port("auto", rewards, values, dones, last_values)
    np.testing.assert_allclose(adv, want_adv, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ret, want_ret, rtol=1e-5, atol=1e-6)


def test_gae_has_no_unroll_cap():
    """T = 300 is past the TPU kernel's VMEM unroll cap; the port runs it."""
    rewards, values, dones, last_values = _inputs(300, 4, seed=5)
    want_adv, want_ret = reference_gae(
        rewards, values, dones.astype(np.float32), last_values, 0.99, 0.95)
    adv, ret = _port("auto", rewards, values, dones, last_values)
    np.testing.assert_allclose(adv, want_adv, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ret, want_ret, rtol=1e-5, atol=1e-5)


def test_twin_is_the_plain_loop():
    rewards, values, dones, last_values = _inputs(20, 6, seed=7)
    t = [torch.from_numpy(x) for x in (rewards, values, dones, last_values)]
    a1, r1 = gae.compute_gae(*t, 0.99, 0.95)
    a2, r2 = gae_kernel.compute_gae(*t, 0.99, 0.95, impl="auto")
    assert torch.equal(a1, a2) and torch.equal(r1, r2)


def test_pinned_kernel_refuses_cpu_and_bad_impl():
    rewards, values, dones, last_values = (torch.from_numpy(x) for x in _inputs(4, 2))
    with pytest.raises(ValueError, match="pallas"):
        gae_kernel.resolve("pallas")(rewards, values, dones, last_values, 0.99, 0.95)
    with pytest.raises(ValueError, match="gae_impl"):
        gae_kernel.resolve("fast")
