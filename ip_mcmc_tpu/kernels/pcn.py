"""Preconditioned Crank–Nicolson kernel (Cotter–Roberts–Stuart–White 2013).

Reference parity: ``pCNProposer`` + ``pCNAccepter`` (SURVEY.md §2.1 [H]):

    v = m + sqrt(1 − β²)(u − m) + β ξ,   ξ ~ N(0, C₀)
    accept with prob min(1, exp(Φ(u) − Φ(v)))

pCN is prior-reversible, so only the data-misfit potential Φ enters the
accept ratio — dimension-robust on function-space priors, and derivative-free
(the sampler of choice for the shock-forming Burgers forward model).

Accelerator design: the prior draw ξ is ``prior.sample_centered`` (elementwise op
for KL/diagonal priors, one triangular matmul for dense); Φ(u) is cached
in the state so each step costs exactly one forward-model evaluation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ip_mcmc_tpu.kernels.base import MHInfo, mh_select
from ip_mcmc_tpu.utils.struct import pytree_dataclass


@pytree_dataclass
class PCNState:
    position: jnp.ndarray  # (d,)
    potential: jnp.ndarray  # cached Φ(position)


def init(position, potential_fn):
    position = jnp.asarray(position)
    return PCNState(position=position, potential=potential_fn(position))


def build_kernel(potential_fn, prior, beta):
    """pCN step with contraction sqrt(1-β²) toward the prior mean."""
    if isinstance(beta, (int, float)) and not 0.0 < float(beta) <= 1.0:
        raise ValueError(
            f"pCN beta must be in (0, 1], got {beta}: sqrt(1-beta^2) would be NaN"
        )
    beta = jnp.asarray(beta)

    def kernel(key, state):
        key_prop, key_acc = jax.random.split(key)
        with jax.named_scope("pcn_propose"):
            contraction = jnp.sqrt(1.0 - beta * beta)
            xi = prior.sample_centered(key_prop)
            proposal = (
                prior.mean
                + contraction * (state.position - prior.mean)
                + beta * xi
            )
        with jax.named_scope("forward_potential"):
            proposal_phi = potential_fn(proposal)
        new_state, accepted, accept_prob = mh_select(
            key_acc,
            state.potential - proposal_phi,
            state,
            PCNState(position=proposal, potential=proposal_phi),
        )
        return new_state, MHInfo(
            accepted=accepted, accept_prob=accept_prob, proposal=proposal
        )

    return kernel
