"""ip_mcmc_tpu — many-chain MCMC inference engine for Bayesian inverse
problems, with the capabilities of the reference ``ochsnerd/ip_mcmc``
(pure-NumPy thesis library; see SURVEY.md) rebuilt on JAX/XLA.

Layers (mirroring the reference's layer map, SURVEY.md §1.2):
- distributions  : priors & noise models (L1)
- potentials     : data-misfit Φ(u) factories (L2)
- kernels        : RWM, pCN, MALA, HMC, NUTS — fused step functions (L3+L4)
- driver         : lax.scan chain driver, vmap over chains (L4)
- models         : batched forward models (ODE / Darcy / Burgers) (L5)
- parallel       : device mesh, shard_map, cross-host collectives
- smc / vi       : SMC and variational backends (beyond-reference)
- diagnostics    : on-device ESS / split-R̂
- adapt          : step-size & proposal-covariance adaptation
- api            : reference-compatible object layer (MCMCSampler, ...)
"""

from ip_mcmc_tpu import (
    adapt,
    api,
    configs,
    diagnostics,
    distributions,
    driver,
    kernels,
    models,
    observations,
    parallel,
    potentials,
    smc,
    vi,
)
from ip_mcmc_tpu.distributions import (
    DiagGaussian,
    Gaussian,
    IndependentProduct,
    LogNormal,
    gaussian_kl_prior,
)
from ip_mcmc_tpu.driver import init_chains, sample_chains
from ip_mcmc_tpu.potentials import (
    analytic_potential,
    misfit_potential,
    posterior_log_density,
    tempered_potential,
)

__version__ = "0.1.0"
