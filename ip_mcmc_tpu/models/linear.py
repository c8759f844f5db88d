"""Linear forward model G(u) = A u (+ b): the sanity model for conjugate
linear-Gaussian inverse problems (BASELINE.json config 2).

With Gaussian prior N(m0, C0) and noise N(0, Γ), the posterior is Gaussian
with closed form — the strongest correctness oracle in the suite
(SURVEY.md §4.2 item 2)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ip_mcmc_tpu.precision import mm


def make_forward(A, b=None):
    A = jnp.asarray(A)
    b = None if b is None else jnp.asarray(b)

    def forward(u):
        out = mm(A, u)
        return out if b is None else out + b

    return forward


def conjugate_posterior(A, prior_mean, prior_cov, noise_cov, y):
    """Exact Gaussian posterior (mean, cov) for y = A u + η (NumPy, test use)."""
    A = np.asarray(A, dtype=float)
    prior_cov = np.asarray(prior_cov, dtype=float)
    if prior_cov.ndim == 1:
        prior_cov = np.diag(prior_cov)
    noise_cov = np.asarray(noise_cov, dtype=float)
    if noise_cov.ndim == 1:
        noise_cov = np.diag(noise_cov)
    prec = np.linalg.inv(prior_cov) + A.T @ np.linalg.solve(noise_cov, A)
    cov = np.linalg.inv(prec)
    mean = cov @ (
        np.linalg.solve(prior_cov, np.asarray(prior_mean, dtype=float))
        + A.T @ np.linalg.solve(noise_cov, np.asarray(y, dtype=float))
    )
    return mean, cov
