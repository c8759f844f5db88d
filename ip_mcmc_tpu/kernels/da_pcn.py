"""Delayed-acceptance pCN (surrogate-transition / two-level MCMC).

Beyond-reference capability for expensive PDE forward models (ROADMAP P2):
run a SUBCHAIN of cheap pCN steps against a surrogate potential Φ* (coarse
grid, loose CG tolerance, reduced physics), then correct the endpoint with
ONE evaluation of the exact potential Φ. Christen–Fox (2005) delayed
acceptance in the k-step "surrogate transition" form (Liu 2001 §9.4.3):

    v  = endpoint of k pCN steps from u, invariant for  π*(du) ∝ e^{−Φ*} μ₀(du)
    α  = min(1, exp[(Φ(u) − Φ(v)) − (Φ*(u) − Φ*(v))])

Validity: the subchain kernel K* is reversible w.r.t. π*, so the proposal
q(u, dv) = K*ᵏ(u, dv) satisfies π*(du) q(u, dv) = π*(dv) q(v, du) and the
π*-ratio cancels out of the MH ratio for π ∝ e^{−Φ} μ₀, leaving exactly α.

Why this form on an accelerator: the classic two-stage DA gates the expensive solve
behind a data-dependent branch — useless under ``vmap`` where all chains run
in lock-step and ``where`` evaluates both sides. The k-step form has a STATIC
cost structure (k cheap solves + 1 expensive solve per outer step, for every
chain) and a real k× reduction in expensive evaluations per proposal —
exactly what vectorizes.

The state caches both Φ and Φ* at the current position, so each outer step
costs k surrogate solves + 1 exact solve, nothing recomputed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ip_mcmc_tpu.kernels.base import mh_select
from ip_mcmc_tpu.utils.struct import pytree_dataclass


@pytree_dataclass
class DAPCNState:
    position: jnp.ndarray  # (d,)
    potential: jnp.ndarray  # cached exact Φ(position)
    surrogate: jnp.ndarray  # cached surrogate Φ*(position)


@pytree_dataclass
class DAPCNInfo:
    accepted: jnp.ndarray  # outer (exact-correction) accept
    accept_prob: jnp.ndarray  # outer accept probability
    inner_accept_rate: jnp.ndarray  # mean surrogate-stage acceptance
    moved: jnp.ndarray  # subchain endpoint differs from start


def init(position, potential_fn, surrogate_fn):
    position = jnp.asarray(position)
    return DAPCNState(
        position=position,
        potential=potential_fn(position),
        surrogate=surrogate_fn(position),
    )


def build_kernel(potential_fn, surrogate_fn, prior, beta, subchain_len=4):
    """One DA-pCN transition: ``subchain_len`` surrogate pCN steps + one
    exact correction. ``surrogate_fn`` approximates ``potential_fn`` cheaply;
    any approximation is VALID (the correction is exact), only efficiency
    depends on its quality."""
    if isinstance(beta, (int, float)) and not 0.0 < float(beta) <= 1.0:
        raise ValueError(f"pCN beta must be in (0, 1], got {beta}")
    beta = jnp.asarray(beta)
    if subchain_len < 1:
        raise ValueError(f"subchain_len must be >= 1, got {subchain_len}")

    def kernel(key, state):
        key_sub, key_acc = jax.random.split(key)
        contraction = jnp.sqrt(1.0 - beta * beta)
        m = prior.mean

        def inner(carry, k):
            pos, phi_s, acc = carry
            k_prop, k_mh = jax.random.split(k)
            with jax.named_scope("da_surrogate_propose"):
                xi = prior.sample_centered(k_prop)
                prop = m + contraction * (pos - m) + beta * xi
                phi_prop = surrogate_fn(prop)
            log_ratio = phi_s - phi_prop
            log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
            log_u = jnp.log(jax.random.uniform(k_mh, (), dtype=log_ratio.dtype))
            take = log_u < log_ratio
            pos = jnp.where(take, prop, pos)
            phi_s = jnp.where(take, phi_prop, phi_s)
            return (pos, phi_s, acc + take.astype(jnp.float32)), None

        (endpoint, surr_end, n_acc), _ = jax.lax.scan(
            inner,
            (state.position, state.surrogate, jnp.zeros((), jnp.float32)),
            jax.random.split(key_sub, subchain_len),
        )

        with jax.named_scope("da_exact_correction"):
            phi_end = potential_fn(endpoint)
        # π*-to-π correction: (Φ(u) − Φ(v)) − (Φ*(u) − Φ*(v))
        log_ratio = (state.potential - phi_end) - (state.surrogate - surr_end)
        new_state, accepted, accept_prob = mh_select(
            key_acc,
            log_ratio,
            state,
            DAPCNState(position=endpoint, potential=phi_end, surrogate=surr_end),
        )
        moved = jnp.any(endpoint != state.position)
        return new_state, DAPCNInfo(
            accepted=accepted,
            accept_prob=accept_prob,
            inner_accept_rate=n_acc / subchain_len,
            moved=moved,
        )

    return kernel
