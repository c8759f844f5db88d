"""Potentials: data-misfit Φ(u) bridging samplers to forward models (layer L2).

Parity with the reference's ``AnalyticPotential`` / ``EvolutionPotential``
(SURVEY.md §2.1, expected ``ip_mcmc/potential.py`` [H names, M path]; mount
empty), redesigned for batched accelerator execution: a potential here is a *pure jittable function*
``u -> Φ(u)`` built by a factory, so it can be closed over by compiled
kernels, ``vmap``-ed over thousands of chains, and differentiated (for
MALA/HMC/NUTS) when the forward model is smooth.

Φ(u) = ½ ‖Γ^{-1/2} (y − O(G(u)))‖²  (Stuart 2010 least-squares potential),
with G the forward model, O the observation operator, Γ the noise covariance.
"""

from __future__ import annotations

import jax.numpy as jnp


def analytic_potential(log_density_fn):
    """Potential from a closed-form unnormalized log-density: Φ = -log π.

    Reference parity: ``AnalyticPotential`` wrapping an analytic density.
    """

    def phi(u):
        return -log_density_fn(u)

    return phi


def misfit_potential(forward_fn, data, noise, observation_fn=None):
    """Build Φ(u) = ½‖Γ^{-1/2}(y − O(G(u)))‖² as a pure function.

    Reference parity: ``EvolutionPotential`` (forward evolution operator +
    observation operator + noise-weighted misfit).

    Parameters
    ----------
    forward_fn : u -> prediction. The (batched-friendly) forward model G.
    data : observed data y, shape matching the observation output.
    noise : distribution with ``whiten`` (applies Γ^{-1/2} after centering)
        — typically ``DiagGaussian(0, noise_std)`` — or ``None`` for identity
        noise weighting.
    observation_fn : optional restriction O applied to the forward output
        (defaults to identity; forward models often fold O in themselves).
    """
    data = jnp.asarray(data)

    def phi(u):
        pred = forward_fn(u)
        if observation_fn is not None:
            pred = observation_fn(pred)
        if pred.shape != data.shape:
            raise ValueError(
                f"forward-model prediction shape {pred.shape} != data shape "
                f"{data.shape}; refusing to broadcast a misfit silently"
            )
        r = data - pred
        if noise is not None:
            r = noise.whiten(r + noise.mean)  # center w.r.t. noise mean (usually 0)
        return 0.5 * jnp.sum(jnp.square(r))

    return phi


def posterior_log_density(potential_fn, prior):
    """Unnormalized log posterior: log π(u) = −Φ(u) − Φ_prior(u).

    Used by the whole-space kernels (RWM/MALA/HMC/NUTS). pCN instead keeps
    Φ and the prior separate (the prior is handled exactly by the proposal).
    """

    def logpi(u):
        return -potential_fn(u) - prior.potential(u)

    return logpi


def tempered_potential(potential_fn, beta):
    """β·Φ — likelihood tempering for SMC ladders."""

    def phi(u):
        return beta * potential_fn(u)

    return phi
