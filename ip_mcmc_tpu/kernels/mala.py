"""Metropolis-adjusted Langevin algorithm (MALA).

Beyond-reference capability required by BASELINE.json config 3 (gradient-based
proposals on smooth forward models). The gradient comes from ``jax.value_and_
grad`` through the forward solve — AD through ``lax.scan`` time-steppers.

    v = u + (ε²/2) ∇log π(u) + ε ξ,  ξ ~ N(0, I)
    α = min(1, π(v) q(u|v) / (π(u) q(v|u)))
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ip_mcmc_tpu.kernels.base import MHInfo, mh_select
from ip_mcmc_tpu.precision import mm
from ip_mcmc_tpu.utils.struct import pytree_dataclass


@pytree_dataclass
class MALAState:
    position: jnp.ndarray
    log_density: jnp.ndarray
    grad: jnp.ndarray  # cached ∇log π(position)


def init(position, log_density_fn):
    position = jnp.asarray(position)
    ld, g = jax.value_and_grad(log_density_fn)(position)
    return MALAState(position=position, log_density=ld, grad=g)


def build_kernel(log_density_fn, step_size, precond=None):
    """``precond``: optional preconditioner Σ — (d,) variances (diagonal) or
    (d, d) lower-triangular Cholesky L with Σ = LLᵀ (dense, cross-chain
    adapted). Proposal: v = u + (ε²/2) Σ ∇log π(u) + ε Σ^{1/2} ξ."""
    value_and_grad = jax.value_and_grad(log_density_fn)
    eps = step_size
    dense = precond is not None and jnp.ndim(precond) == 2

    def apply_sigma(g):
        if precond is None:
            return g
        if dense:
            return mm(precond, mm(precond.T, g))
        return precond * g

    def sqrt_sigma_noise(xi):
        if precond is None:
            return xi
        if dense:
            return mm(precond, xi)
        return jnp.sqrt(precond) * xi

    def mahalanobis(d):
        """‖Σ^{-1/2} d‖² (the q-density exponent; normalizers cancel)."""
        if precond is None:
            return jnp.sum(jnp.square(d))
        if dense:
            w = jax.scipy.linalg.solve_triangular(precond, d, lower=True)
            return jnp.sum(jnp.square(w))
        return jnp.sum(jnp.square(d) / precond)

    def kernel(key, state):
        key_prop, key_acc = jax.random.split(key)
        xi = jax.random.normal(
            key_prop, state.position.shape, dtype=state.position.dtype
        )
        mean_fwd = state.position + 0.5 * eps * eps * apply_sigma(state.grad)
        proposal = mean_fwd + eps * sqrt_sigma_noise(xi)
        proposal_ld, proposal_grad = value_and_grad(proposal)
        mean_rev = proposal + 0.5 * eps * eps * apply_sigma(proposal_grad)
        log_q_rev = -0.5 * mahalanobis(state.position - mean_rev) / (eps * eps)
        log_q_fwd = -0.5 * mahalanobis(proposal - mean_fwd) / (eps * eps)
        log_ratio = proposal_ld - state.log_density + log_q_rev - log_q_fwd
        new_state, accepted, accept_prob = mh_select(
            key_acc,
            log_ratio,
            state,
            MALAState(
                position=proposal, log_density=proposal_ld, grad=proposal_grad
            ),
        )
        return new_state, MHInfo(
            accepted=accepted, accept_prob=accept_prob, proposal=proposal
        )

    return kernel
