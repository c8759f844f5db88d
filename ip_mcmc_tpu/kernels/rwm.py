"""Random-walk Metropolis kernel.

Reference parity: ``StandardRWProposer`` (v = u + δξ) + ``StandardRWAccepter``
/ ``AnalyticAccepter`` + the ``MCMCSampler`` step (SURVEY.md §2.1/§3.1 [H]),
fused into one jittable ``step(key, state) -> (state, info)``.

The proposal covariance is either isotropic (δ·ξ), diagonal, or a dense
Cholesky factor (δ·L·ξ — one triangular matmul, GEMM-friendly); the dense path
is what cross-chain covariance adaptation feeds (ip_mcmc_tpu.adapt).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ip_mcmc_tpu.kernels.base import MHInfo, mh_select
from ip_mcmc_tpu.utils.struct import pytree_dataclass


@pytree_dataclass
class RWMState:
    position: jnp.ndarray  # (d,)
    log_density: jnp.ndarray  # cached log π(position)


def init(position, log_density_fn):
    position = jnp.asarray(position)
    return RWMState(position=position, log_density=log_density_fn(position))


def build_kernel(log_density_fn, step_size, scale=None):
    """RWM step. ``scale``: None (isotropic), (d,) diag stddev, or (d, d)
    lower-triangular proposal Cholesky factor."""

    def kernel(key, state):
        key_prop, key_acc = jax.random.split(key)
        with jax.named_scope("rwm_propose"):
            xi = jax.random.normal(
                key_prop, state.position.shape, dtype=state.position.dtype
            )
            if scale is None:
                delta = step_size * xi
            elif jnp.ndim(scale) == 1:
                delta = step_size * scale * xi
            else:
                delta = step_size * (scale @ xi)
            proposal = state.position + delta
        with jax.named_scope("forward_potential"):
            proposal_ld = log_density_fn(proposal)
        new_state, accepted, accept_prob = mh_select(
            key_acc,
            proposal_ld - state.log_density,
            state,
            RWMState(position=proposal, log_density=proposal_ld),
        )
        return new_state, MHInfo(
            accepted=accepted, accept_prob=accept_prob, proposal=proposal
        )

    return kernel
