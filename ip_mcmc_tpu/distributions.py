"""Distributions: priors and noise models (reference layer L1).

Capability parity with the reference's distribution layer (SURVEY.md §2.1:
``GaussianDistribution``, ``LogNormalDistribution``, ``IndependentDistributions``
expected in ``ip_mcmc/distribution.py`` — mount empty, recalled [H]/[M]),
redesigned for batched accelerator execution:

- every distribution is a frozen pytree dataclass, so it can be closed over by
  ``jit``-ed kernels or carried through ``scan``/``vmap``;
- sampling uses counter-based ``jax.random`` keys (replayable, shardable);
- covariance structure is explicit (diagonal vs dense Cholesky) so the hot
  Gaussian-draw path is either a elementwise multiply or a single batched
  triangular matmul — never a generic ``multivariate_normal``.

The KL-truncated Gaussian-process prior of the inverse problems is a
``DiagGaussian`` over KL coefficients (the KL basis diagonalizes the prior
covariance); see ``ip_mcmc_tpu.models.kl``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ip_mcmc_tpu.precision import mm
from ip_mcmc_tpu.utils.struct import pytree_dataclass

_LOG_2PI = math.log(2.0 * math.pi)


@pytree_dataclass
class DiagGaussian:
    """N(mean, diag(scale**2)). The workhorse prior (KL coordinates)."""

    mean: jnp.ndarray  # (d,)
    scale: jnp.ndarray  # (d,) stddev

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    def sample(self, key, sample_shape=()):
        z = jax.random.normal(key, tuple(sample_shape) + self.mean.shape)
        return self.mean + self.scale * z

    def sample_centered(self, key, sample_shape=()):
        """Draw xi ~ N(0, C). The pCN proposal noise term."""
        z = jax.random.normal(key, tuple(sample_shape) + self.mean.shape)
        return self.scale * z

    def scale_apply(self, z):
        """C^{1/2} z — apply the covariance factor."""
        return self.scale * z

    def whiten(self, x):
        """C^{-1/2} (x - mean)."""
        return (x - self.mean) / self.scale

    def log_prob(self, x):
        z = (x - self.mean) / self.scale
        return -0.5 * jnp.sum(z * z, axis=-1) - jnp.sum(
            jnp.log(self.scale), axis=-1
        ) - 0.5 * self.dim * _LOG_2PI

    def potential(self, x):
        """Negative log-density up to a constant: ½‖C^{-1/2}(x-m)‖²."""
        z = (x - self.mean) / self.scale
        return 0.5 * jnp.sum(z * z, axis=-1)


@pytree_dataclass
class Gaussian:
    """N(mean, cov) with dense covariance, stored via its Cholesky factor.

    ``chol`` is lower-triangular with cov = chol @ chol.T. Sampling is one
    triangular matmul (GEMM-friendly, batches trivially under vmap).
    """

    mean: jnp.ndarray  # (d,)
    chol: jnp.ndarray  # (d, d) lower triangular

    @classmethod
    def from_covariance(cls, mean, cov):
        mean = jnp.asarray(mean, dtype=jnp.result_type(float))
        cov = jnp.asarray(cov, dtype=mean.dtype)
        return cls(mean=mean, chol=jnp.linalg.cholesky(cov))

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    @property
    def covariance(self):
        return self.chol @ self.chol.T

    def sample(self, key, sample_shape=()):
        return self.mean + self.sample_centered(key, sample_shape)

    def sample_centered(self, key, sample_shape=()):
        z = jax.random.normal(key, tuple(sample_shape) + self.mean.shape)
        return self.scale_apply(z)

    def scale_apply(self, z):
        # full precision: pCN's prior-reversibility needs the covariance
        # itself, not a TF32-rounded factor
        return mm(z, self.chol.T)

    def whiten(self, x):
        d = x - self.mean
        # Solve L w = d  (batched triangular solve; d may have leading dims)
        return jax.scipy.linalg.solve_triangular(
            self.chol, d[..., None], lower=True
        )[..., 0]

    def log_prob(self, x):
        w = self.whiten(x)
        logdet = jnp.sum(jnp.log(jnp.diagonal(self.chol)))
        return -0.5 * jnp.sum(w * w, axis=-1) - logdet - 0.5 * self.dim * _LOG_2PI

    def potential(self, x):
        w = self.whiten(x)
        return 0.5 * jnp.sum(w * w, axis=-1)


@pytree_dataclass
class LogNormal:
    """Componentwise log-normal: log(x) ~ N(mu, diag(sigma**2)).

    Parity with the reference's ``LogNormalDistribution`` [M] (positive
    parameters, e.g. diffusion coefficients).
    """

    mu: jnp.ndarray
    sigma: jnp.ndarray

    @property
    def dim(self) -> int:
        return self.mu.shape[-1]

    def sample(self, key, sample_shape=()):
        z = jax.random.normal(key, tuple(sample_shape) + self.mu.shape)
        return jnp.exp(self.mu + self.sigma * z)

    def log_prob(self, x):
        logx = jnp.log(x)
        z = (logx - self.mu) / self.sigma
        return jnp.sum(
            -0.5 * z * z - logx - jnp.log(self.sigma) - 0.5 * _LOG_2PI, axis=-1
        )

    def potential(self, x):
        return -self.log_prob(x)


@pytree_dataclass(meta_fields=("dims",))
class IndependentProduct:
    """Product of independent distribution blocks over disjoint coordinate
    slices — parity with the reference's ``IndependentDistributions`` [M].

    ``dists`` is a tuple of component distributions; ``dims`` the static tuple
    of their dimensions (concatenated coordinate layout).
    """

    dists: tuple
    dims: tuple

    @classmethod
    def of(cls, *dists):
        return cls(dists=tuple(dists), dims=tuple(int(d.dim) for d in dists))

    @property
    def dim(self) -> int:
        return sum(self.dims)

    def _split(self, x):
        out, off = [], 0
        for d in self.dims:
            out.append(x[..., off : off + d])
            off += d
        return out

    def sample(self, key, sample_shape=()):
        keys = jax.random.split(key, len(self.dists))
        parts = [d.sample(k, sample_shape) for d, k in zip(self.dists, keys)]
        return jnp.concatenate(parts, axis=-1)

    def log_prob(self, x):
        parts = self._split(x)
        return sum(d.log_prob(p) for d, p in zip(self.dists, parts))

    def potential(self, x):
        return -self.log_prob(x)


def gaussian_kl_prior(eigenvalues, mean=None):
    """KL-truncated GP prior in KL coordinates: N(mean, diag(eigenvalues)).

    The Karhunen–Loève basis diagonalizes the prior covariance, so the
    function-space Gaussian prior is exactly a ``DiagGaussian`` over the
    truncated coefficient vector (Stuart 2010 §2; reference uses the same
    representation for its random-field priors [M]).
    """
    eigenvalues = jnp.asarray(eigenvalues, dtype=jnp.result_type(float))
    if mean is None:
        mean = jnp.zeros_like(eigenvalues)
    return DiagGaussian(mean=mean, scale=jnp.sqrt(eigenvalues))
