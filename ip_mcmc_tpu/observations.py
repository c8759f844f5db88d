"""Observation operators O: restrict forward-solve output to observed
points/times (reference layer, SURVEY.md §2.1 "Observation operator" —
point-observation class/callable passed into ``EvolutionPotential`` [M]).

Accelerator form: static index gathers (compile-time constants — no dynamic
shapes), composable with any forward model and usable batched under vmap.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ip_mcmc_tpu.precision import mm


def point_observation(indices):
    """O(x) = x[indices] — point evaluation at static locations."""
    indices = jnp.asarray(np.asarray(indices))

    def observe(x):
        return x[..., indices]

    return observe


def time_point_observation(time_indices, space_indices=None):
    """For trajectory-valued forward output (T, n): select times (and
    optionally locations), flattened."""
    time_indices = jnp.asarray(np.asarray(time_indices))
    space_indices = (
        None if space_indices is None else jnp.asarray(np.asarray(space_indices))
    )

    def observe(traj):
        out = traj[..., time_indices, :]
        if space_indices is not None:
            out = out[..., space_indices]
        return out.reshape(out.shape[:-2] + (-1,))

    return observe


def linear_observation(weights):
    """O(x) = W x — general bounded linear observation functional
    (e.g. local averages, sensors with footprints). One matmul."""
    weights = jnp.asarray(weights)

    def observe(x):
        return mm(x, weights.T)

    return observe


def subsample_grid_2d(n_grid, n_obs_per_dim):
    """Flattened indices of an evenly spaced interior grid of observation
    points on an n×n field (matches models.darcy.default_observation_indices)."""
    pos = np.linspace(0, n_grid - 1, n_obs_per_dim + 2)[1:-1].round().astype(int)
    ii, jj = np.meshgrid(pos, pos, indexing="ij")
    return (ii * n_grid + jj).ravel()
