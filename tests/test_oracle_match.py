"""Cross-validation: the engine vs the NumPy oracle (reference-equivalent
implementation). Seeds can't transfer across RNGs, so we match
*distributions* — posterior moments within Monte-Carlo error (SURVEY.md §4.2
item 3; BASELINE.json correctness gate)."""

import jax
import jax.numpy as jnp
import numpy as np

from ip_mcmc_tpu import driver
from ip_mcmc_tpu.distributions import DiagGaussian, Gaussian
from ip_mcmc_tpu.kernels import pcn, rwm
from tests.oracle import (
    AnalyticPotential,
    CountedAccepter,
    GaussianDistribution,
    MCMCSampler,
    StandardRWAccepter,
    StandardRWProposer,
    pCNAccepter,
    pCNProposer,
)

MEAN = np.array([1.0, -0.5])
COV = np.array([[2.0, 0.8], [0.8, 1.0]])


def test_rwm_matches_oracle_2d_gaussian():
    """BASELINE config 1: RWM on a 2D Gaussian posterior."""
    rng = np.random.default_rng(0)
    target = GaussianDistribution(MEAN, COV)
    prior = GaussianDistribution(np.zeros(2), 100.0 * np.eye(2))  # ~flat
    potential = AnalyticPotential(target.log_density)
    accepter = CountedAccepter(StandardRWAccepter(potential, prior))
    sampler = MCMCSampler(StandardRWProposer(0.8, 2), accepter, rng)
    oracle_samples = sampler.run(np.zeros(2), n_samples=8000, burn_in=500)

    def logpi(x):
        t = Gaussian.from_covariance(jnp.array(MEAN), jnp.array(COV))
        pr = DiagGaussian(mean=jnp.zeros(2), scale=10.0 * jnp.ones(2))
        return t.log_prob(x) + pr.log_prob(x)

    kernel = rwm.build_kernel(logpi, step_size=0.8)
    key_i, key_r = jax.random.split(jax.random.key(0))
    state = driver.init_chains(rwm.init, jnp.zeros((128, 2)), logpi)
    _, samples, _ = driver.sample_chains(
        kernel, state, key_r, n_samples=500, burn_in=300
    )
    dev_flat = np.asarray(samples).reshape(-1, 2)

    # exact product posterior: N(MEAN, COV) × N(0, 100 I)
    prec = np.linalg.inv(COV) + np.eye(2) / 100.0
    exact_cov = np.linalg.inv(prec)
    exact_mean = exact_cov @ np.linalg.solve(COV, MEAN)

    # each side within its own Monte-Carlo error of the true posterior
    np.testing.assert_allclose(dev_flat.mean(axis=0), exact_mean, atol=0.08)
    np.testing.assert_allclose(oracle_samples.mean(axis=0), exact_mean, atol=0.3)
    np.testing.assert_allclose(np.cov(dev_flat.T), exact_cov, atol=0.2)
    np.testing.assert_allclose(np.cov(oracle_samples.T), exact_cov, atol=0.5)
    # and against each other, at combined-MC-error tolerance
    np.testing.assert_allclose(
        dev_flat.mean(axis=0), oracle_samples.mean(axis=0), atol=0.4
    )
    assert 0.05 < accepter.acceptance_rate < 0.9


def test_pcn_matches_oracle_gaussian_ip():
    """pCN on a conjugate Gaussian inverse problem, both sides, vs each other
    AND vs the closed-form posterior N(y/2, I/2)."""
    y = np.array([1.0, 1.0])
    prior_np = GaussianDistribution(np.zeros(2), np.eye(2))
    phi_np = lambda u: 0.5 * float(np.sum((y - u) ** 2))
    rng = np.random.default_rng(1)
    sampler = MCMCSampler(
        pCNProposer(0.5, prior_np), pCNAccepter(phi_np), rng
    )
    oracle_samples = sampler.run(np.zeros(2), n_samples=6000, burn_in=500)

    prior = DiagGaussian(mean=jnp.zeros(2), scale=jnp.ones(2))
    phi = lambda u: 0.5 * jnp.sum((jnp.array(y) - u) ** 2)
    kernel = pcn.build_kernel(phi, prior, beta=0.5)
    key_i, key_r = jax.random.split(jax.random.key(1))
    state = driver.init_chains(pcn.init, prior.sample(key_i, (256,)), phi)
    _, samples, _ = driver.sample_chains(
        kernel, state, key_r, n_samples=800, burn_in=300
    )
    dev_flat = np.asarray(samples).reshape(-1, 2)

    exact_mean, exact_cov = y / 2, 0.5 * np.eye(2)
    np.testing.assert_allclose(dev_flat.mean(axis=0), exact_mean, atol=0.06)
    np.testing.assert_allclose(oracle_samples.mean(axis=0), exact_mean, atol=0.1)
    np.testing.assert_allclose(np.cov(dev_flat.T), exact_cov, atol=0.1)
    np.testing.assert_allclose(np.cov(oracle_samples.T), exact_cov, atol=0.15)
