"""Batched ODE forward models: fixed-step RK4 via ``lax.scan``.

Reference analog: the evolution operators consumed by ``EvolutionPotential``
(SURVEY.md §2.1/§3.4 — ODE/PDE time-stepping loops in Python/NumPy [M]).
Accelerator design: static step count, ``lax.scan`` over time, observation by
static index gather, fully differentiable (AD through the scan — this is the
gradient path for MALA/NUTS, BASELINE.json config 3), ``jax.checkpoint``
available for memory-bound adjoints, and the whole solve ``vmap``s over
chains.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def rk4_integrate(vector_field, y0, dt, n_steps, params=None, remat=False):
    """Integrate dy/dt = f(y, params) for ``n_steps`` of size ``dt``.

    Returns the full trajectory (n_steps+1, state_dim) including y0.
    """

    def step(y, _):
        k1 = vector_field(y, params)
        k2 = vector_field(y + 0.5 * dt * k1, params)
        k3 = vector_field(y + 0.5 * dt * k2, params)
        k4 = vector_field(y + dt * k3, params)
        y_new = y + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
        return y_new, y_new

    step_fn = jax.checkpoint(step) if remat else step
    _, traj = jax.lax.scan(step_fn, y0, None, length=n_steps)
    return jnp.concatenate([y0[None], traj], axis=0)


def lotka_volterra_field(y, theta):
    """Predator–prey: dx = αx − βxy, dy = δxy − γy; θ = log(α,β,γ,δ)."""
    alpha, beta, gamma, delta = jnp.exp(theta)
    x, z = y[0], y[1]
    return jnp.stack([alpha * x - beta * x * z, delta * x * z - gamma * z])


def lotka_volterra_log_field(z, theta):
    """LV in log-population coordinates z = log(x, y):
    dz₁ = α − β e^{z₂}, dz₂ = δ e^{z₁} − γ.

    Positivity is unconditional and orbits stay bounded, so the RK4 solve is
    stable for the whole prior range — without this, prior-typical rate
    draws blow up the linear-coordinate integration and freeze MALA/NUTS
    chains at non-finite potentials."""
    alpha, beta, gamma, delta = jnp.exp(theta)
    return jnp.stack([alpha - beta * jnp.exp(z[1]), delta * jnp.exp(z[0]) - gamma])


def make_lotka_volterra_forward(
    y0, dt, n_steps, obs_indices, obs_species=(0, 1), remat=False
):
    """Forward map θ (log-rates, 4) → observed trajectory values.

    ``obs_indices``: static time indices (into the n_steps+1 trajectory).
    Output: flattened (len(obs_indices) * len(obs_species),).
    """
    y0 = jnp.asarray(y0)
    obs_indices = jnp.asarray(obs_indices)
    species = jnp.asarray(obs_species)

    z0 = jnp.log(y0)

    def forward(theta):
        traj = rk4_integrate(
            lotka_volterra_log_field, z0, dt, n_steps, params=theta, remat=remat
        )
        return jnp.exp(traj[obs_indices][:, species]).reshape(-1)

    return forward


def logistic_field(y, theta):
    """Logistic growth dy = r y (1 − y/K); θ = log(r, K)."""
    r, K = jnp.exp(theta)
    return r * y * (1.0 - y / K)


def make_logistic_forward(y0, dt, n_steps, obs_indices, remat=False):
    y0 = jnp.asarray(y0)
    obs_indices = jnp.asarray(obs_indices)

    def forward(theta):
        traj = rk4_integrate(
            logistic_field, y0, dt, n_steps, params=theta, remat=remat
        )
        return traj[obs_indices].reshape(-1)

    return forward
