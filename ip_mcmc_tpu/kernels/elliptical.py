"""Elliptical slice sampling (Murray, Adams & MacKay 2010).

Beyond-reference capability, natural for this framework's problem class:
targets exp(−Φ(u)) dμ₀ with Gaussian prior μ₀ — exactly pCN's setting — but
TUNING-FREE (no β) and rejection-free (every step moves).

Each transition draws an auxiliary prior point ν and slice-samples the
angle θ on the ellipse u' = (u−m)cosθ + ν sinθ + m, shrinking the bracket
until the point beats the log-likelihood threshold. Accelerator form: the
shrinkage loop is a ``lax.while_loop`` with a capped iteration count
(guaranteed-accept fallback at θ→0), static shapes, vmap-able over chains
(batch finishes when the slowest chain does — the usual trade).

Forward-model cost per step is variable (expected ~2-3 evaluations); the
cached Φ makes the common 1-evaluation exit cheap.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ip_mcmc_tpu.utils.struct import pytree_dataclass


@pytree_dataclass
class EllipticalState:
    position: jnp.ndarray
    potential: jnp.ndarray  # cached Φ(position)


@pytree_dataclass
class EllipticalInfo:
    n_evals: jnp.ndarray  # forward evaluations this step
    theta: jnp.ndarray  # final angle


def init(position, potential_fn):
    position = jnp.asarray(position)
    return EllipticalState(position=position, potential=potential_fn(position))


def build_kernel(potential_fn, prior, max_shrink=30):
    """One ESS transition targeting exp(−Φ) dμ₀ (μ₀ = ``prior``)."""

    def kernel(key, state):
        key_nu, key_u, key_theta = jax.random.split(key, 3)
        m = prior.mean
        nu = prior.sample_centered(key_nu)
        # slice level: log y = −Φ(u) + log U
        log_y = -state.potential + jnp.log(
            jax.random.uniform(key_u, (), dtype=state.potential.dtype)
        )
        theta0 = jax.random.uniform(
            key_theta, (), minval=0.0, maxval=2.0 * jnp.pi
        )
        lo0, hi0 = theta0 - 2.0 * jnp.pi, theta0

        def proposal(theta):
            return (
                (state.position - m) * jnp.cos(theta)
                + nu * jnp.sin(theta)
                + m
            )

        def cond(carry):
            _, _, _, _, phi, accepted, it = carry
            return (~accepted) & (it < max_shrink)

        def body(carry):
            key, theta, lo, hi, _, _, it = carry
            u = proposal(theta)
            phi = potential_fn(u)
            accepted = -phi > log_y
            # shrink bracket toward 0 on rejection
            lo = jnp.where(accepted | (theta >= 0.0), lo, theta)
            hi = jnp.where(accepted | (theta < 0.0), hi, theta)
            key, sub = jax.random.split(key)
            theta_new = jax.random.uniform(
                sub, (), minval=lo, maxval=hi, dtype=theta.dtype
            )
            theta = jnp.where(accepted, theta, theta_new)
            return key, theta, lo, hi, phi, accepted, it + 1

        key0 = jax.random.fold_in(key, 7)
        carry = (
            key0,
            theta0,
            lo0,
            hi0,
            jnp.zeros_like(state.potential),
            jnp.array(False),
            jnp.int32(0),
        )
        # evaluate first angle inside the loop (body runs ≥ once)
        key_f, theta_f, _, _, phi_f, accepted, n_it = jax.lax.while_loop(
            cond, body, carry
        )
        # fallback: if the bracket collapsed without acceptance (pathological
        # Φ), stay put — θ→0 reproduces the current point exactly
        new_position = jnp.where(
            accepted, proposal(theta_f), state.position
        )
        new_phi = jnp.where(accepted, phi_f, state.potential)
        new_state = EllipticalState(position=new_position, potential=new_phi)
        return new_state, EllipticalInfo(
            n_evals=n_it, theta=jnp.where(accepted, theta_f, 0.0)
        )

    return kernel
