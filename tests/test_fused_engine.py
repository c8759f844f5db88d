"""The fused chain engine's plumbing: per-block seeding, the chain-last
layout, the FES partner rotation and the recording output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ip_mcmc_tpu.ops import (
    fused_fes_chain,
    fused_pcn_chain,
    fused_pcn_chain_recorded,
    fused_rwm_chain,
)
from ip_mcmc_tpu.ops import fused_mcmc as fm

BLOCK_SEED_STRIDE = 7919


def _phi(x):
    y = jnp.array([1.0, -0.5, 0.3])
    return 0.5 * jnp.sum((y[:, None] - x) ** 2, axis=0)


_PRIOR = dict(prior_mean=np.zeros(3), prior_scale=np.ones(3))

_CALLS = {
    "rwm": lambda pos, seed, block: fused_rwm_chain(
        _phi, pos, step_size=0.6, seed=seed, n_steps=7, block_chains=block),
    "pcn": lambda pos, seed, block: fused_pcn_chain(
        _phi, pos, beta=0.4, seed=seed, n_steps=7, block_chains=block,
        **_PRIOR),
    "pcn_recorded": lambda pos, seed, block: fused_pcn_chain_recorded(
        _phi, pos, beta=0.4, seed=seed, n_steps=6, thin=2,
        block_chains=block, **_PRIOR),
    "fes": lambda pos, seed, block: fused_fes_chain(
        _phi, pos, n_low_modes=2, seed=seed, n_steps=5, block_chains=block,
        **_PRIOR),
}


@pytest.mark.parametrize("name", sorted(_CALLS))
def test_n_chain_call_equals_per_block_calls(name):
    """Block b of one n-chain call IS a one-block call on that block's
    chains with seed + b * 7919: the stream and ensemble partition, not the
    scheduling, is what ``block_chains`` fixes."""
    call = _CALLS[name]
    n, block, seed = 96, 32, 11
    pos = jax.random.normal(jax.random.key(0), (n, 3))
    whole = [np.asarray(o) for o in call(pos, seed, block)]
    for b in range(n // block):
        sl = slice(b * block, (b + 1) * block)
        part = call(pos[sl], seed + b * BLOCK_SEED_STRIDE, block)
        for w, p in zip(whole, part):
            # recorded samples carry the chain axis second
            w_b = w[:, sl] if w.ndim == 3 else w[sl]
            np.testing.assert_array_equal(w_b, np.asarray(p))


@pytest.mark.parametrize("block", [2, 8, 128])
@pytest.mark.parametrize("u", [0.0, 0.37, 0.999])
def test_fes_partner_rotation_has_opposite_parity(block, u):
    """The FES partner is ``jnp.roll`` of the chain axis by an odd shift,
    so every chain's partner sits at the other parity — fixed during the
    red-black sub-step that moves this chain."""
    shift = int(np.floor(u * (block // 2))) * 2 + 1
    lanes = jnp.arange(block)[None, :]
    partner = np.asarray(jnp.roll(lanes, shift, axis=1))[0]
    assert np.all(partner % 2 != np.arange(block) % 2)
    # direction: toward higher indices (chain i pairs with i - shift)
    np.testing.assert_array_equal(partner, (np.arange(block) - shift) % block)


def test_recorded_output_is_time_major_chain_second():
    n, block = 64, 32
    pos = jax.random.normal(jax.random.key(1), (n, 3))
    final, acc, samples = fused_pcn_chain_recorded(
        _phi, pos, beta=0.4, seed=3, n_steps=8, thin=4, block_chains=block,
        **_PRIOR)
    assert samples.shape == (2, n, 3) and final.shape == (n, 3)
    assert acc.shape == (n,)
    np.testing.assert_array_equal(np.asarray(samples[-1]), np.asarray(final))


def test_needs_grad_builder_gets_value_and_gradient():
    x = jnp.array([[1.0, 2.0], [0.5, -1.0]])  # (d, chains)
    phi, g = fm._with_grad(lambda u: 0.5 * jnp.sum(u * u, axis=0))(x)
    np.testing.assert_allclose(np.asarray(phi), [0.625, 2.5])
    np.testing.assert_allclose(np.asarray(g), np.asarray(x))


def test_engine_has_no_pallas_call():
    """The fused layer is plain XLA: nothing in the traced program is a
    Pallas kernel (which would run in the interpreter off its target)."""
    pos = jnp.zeros((32, 3))
    jaxpr = jax.make_jaxpr(
        lambda p: fused_pcn_chain(_phi, p, beta=0.4, seed=0, n_steps=2,
                                  block_chains=32, **_PRIOR))(pos)
    assert "pallas_call" not in str(jaxpr)
