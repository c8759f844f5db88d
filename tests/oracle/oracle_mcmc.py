"""NumPy oracle: a reference-equivalent reimplementation of ip_mcmc.

The reference mount was empty (SURVEY.md §0), so this module re-derives the
reference's semantics from its documented design (SURVEY.md §§1–3): the
strategy-composition kernel — ``MCMCSampler`` driving pluggable Proposer /
Accepter / Potential / Distribution objects, pure NumPy, single process,
single chain, sequential steps.

It serves two purposes (SURVEY.md §7.2 step 1):
1. correctness oracle for the JAX engine (distributional agreement tests);
2. the "reference side" of every benchmark (ESS/sec of the NumPy loop is the
   baseline the JAX engine must beat ≥10×, per BASELINE.json).

Deliberately written in the reference's idiom: Python ``for`` loop over
steps, per-step object dispatch, dense NumPy linalg. Do not optimize.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------- layer L1
class GaussianDistribution:
    """N(mean, cov). Reference: ip_mcmc/distribution.py::GaussianDistribution
    (expected location; mount empty — SURVEY.md §2.1 [H])."""

    def __init__(self, mean, covariance):
        self.mean = np.asarray(mean, dtype=float)
        self.covariance = np.asarray(covariance, dtype=float)
        if self.covariance.ndim == 1:
            self.covariance = np.diag(self.covariance)
        self._chol = np.linalg.cholesky(self.covariance)
        sign, self._logdet = np.linalg.slogdet(self.covariance)
        assert sign > 0

    @property
    def dim(self):
        return self.mean.shape[0]

    def sample(self, rng):
        return self.mean + self._chol @ rng.standard_normal(self.dim)

    def sample_centered(self, rng):
        return self._chol @ rng.standard_normal(self.dim)

    def apply_covariance_sqrt(self, z):
        return self._chol @ z

    def log_density(self, x):
        d = x - self.mean
        w = np.linalg.solve(self._chol, d)
        return -0.5 * w @ w - 0.5 * self._logdet - 0.5 * self.dim * np.log(2 * np.pi)

    def density(self, x):
        return np.exp(self.log_density(x))

    def potential(self, x):
        d = x - self.mean
        w = np.linalg.solve(self._chol, d)
        return 0.5 * w @ w


class LogNormalDistribution:
    """Componentwise log-normal (SURVEY.md §2.1 [M])."""

    def __init__(self, mu, sigma):
        self.mu = np.asarray(mu, dtype=float)
        self.sigma = np.asarray(sigma, dtype=float)

    @property
    def dim(self):
        return self.mu.shape[0]

    def sample(self, rng):
        return np.exp(self.mu + self.sigma * rng.standard_normal(self.dim))

    def log_density(self, x):
        logx = np.log(x)
        z = (logx - self.mu) / self.sigma
        return float(
            np.sum(-0.5 * z * z - logx - np.log(self.sigma) - 0.5 * np.log(2 * np.pi))
        )

    def density(self, x):
        return np.exp(self.log_density(x))


class IndependentDistributions:
    """Product of independent marginals (SURVEY.md §2.1 [M])."""

    def __init__(self, distributions):
        self.distributions = list(distributions)

    @property
    def dim(self):
        return sum(d.dim for d in self.distributions)

    def _split(self, x):
        out, off = [], 0
        for d in self.distributions:
            out.append(x[off : off + d.dim])
            off += d.dim
        return out

    def sample(self, rng):
        return np.concatenate([d.sample(rng) for d in self.distributions])

    def log_density(self, x):
        return sum(
            d.log_density(p) for d, p in zip(self.distributions, self._split(x))
        )

    def density(self, x):
        return np.exp(self.log_density(x))


# ---------------------------------------------------------------- layer L2
class AnalyticPotential:
    """Φ = −log density for a closed-form target (SURVEY.md §2.1 [H])."""

    def __init__(self, log_density_fn):
        self._log_density_fn = log_density_fn

    def __call__(self, u):
        return -self._log_density_fn(u)


class EvolutionPotential:
    """Φ(u) = ½‖Γ^{-1/2}(y − O(G(u)))‖² (SURVEY.md §2.1/§3.4 [H]).

    ``evolution`` is the forward operator G, ``observation`` the restriction
    O (optional), ``noise`` a GaussianDistribution for Γ.
    """

    def __init__(self, evolution, data, noise, observation=None):
        self.evolution = evolution
        self.data = np.asarray(data, dtype=float)
        self.noise = noise
        self.observation = observation

    def __call__(self, u):
        pred = self.evolution(u)
        if self.observation is not None:
            pred = self.observation(pred)
        r = self.data - pred
        w = np.linalg.solve(self.noise._chol, r)
        return 0.5 * w @ w


# ---------------------------------------------------------------- layer L3
class StandardRWProposer:
    """v = u + δ ξ (SURVEY.md §2.1 [H])."""

    def __init__(self, delta, dim, covariance_sqrt=None):
        self.delta = delta
        self.dim = dim
        self.covariance_sqrt = covariance_sqrt

    def __call__(self, u, rng):
        xi = rng.standard_normal(self.dim)
        if self.covariance_sqrt is not None:
            xi = self.covariance_sqrt @ xi
        return u + self.delta * xi


class pCNProposer:
    """v = m + √(1−β²)(u − m) + β ξ, ξ ~ N(0, C₀) (SURVEY.md §1.1 [H])."""

    def __init__(self, beta, prior):
        assert 0.0 < beta <= 1.0
        self.beta = beta
        self.prior = prior

    def __call__(self, u, rng):
        xi = self.prior.sample_centered(rng)
        m = self.prior.mean
        return m + np.sqrt(1.0 - self.beta**2) * (u - m) + self.beta * xi


class AnalyticAccepter:
    """Accept with density ratio of a closed-form target (SURVEY.md §3.2)."""

    def __init__(self, density):
        self.density = density

    def __call__(self, u, v, rng):
        ratio = self.density(v) / max(self.density(u), 1e-300)
        return rng.uniform() < min(1.0, ratio)


class StandardRWAccepter:
    """MH accept for RWM on the posterior: potential + prior term."""

    def __init__(self, potential, prior):
        self.potential = potential
        self.prior = prior

    def __call__(self, u, v, rng):
        log_ratio = (
            self.potential(u)
            + self.prior.potential(u)
            - self.potential(v)
            - self.prior.potential(v)
        )
        return np.log(rng.uniform()) < min(0.0, log_ratio)


class pCNAccepter:
    """accept w.p. min(1, exp(Φ(u) − Φ(v))) (SURVEY.md §1.1 [H])."""

    def __init__(self, potential):
        self.potential = potential

    def __call__(self, u, v, rng):
        log_ratio = self.potential(u) - self.potential(v)
        return np.log(rng.uniform()) < min(0.0, log_ratio)


class CountedAccepter:
    """Decorator counting accept rate (SURVEY.md §2.1 [H])."""

    def __init__(self, accepter):
        self.accepter = accepter
        self.calls = 0
        self.accepts = 0

    def __call__(self, u, v, rng):
        self.calls += 1
        accepted = self.accepter(u, v, rng)
        if accepted:
            self.accepts += 1
        return accepted

    @property
    def acceptance_rate(self):
        return self.accepts / max(self.calls, 1)


# ---------------------------------------------------------------- layer L4
class MCMCSampler:
    """Sequential chain loop (SURVEY.md §3.1 [H behavior]).

    run(u0, n_samples, burn_in, sample_interval) -> (n_samples, dim)
    """

    def __init__(self, proposer, accepter, rng):
        self.proposer = proposer
        self.accepter = accepter
        self.rng = rng

    def run(self, u0, n_samples, burn_in=0, sample_interval=1):
        u = np.array(u0, dtype=float)
        samples = []
        total = burn_in + n_samples * sample_interval
        for step in range(total):
            v = self.proposer(u, self.rng)
            if self.accepter(u, v, self.rng):
                u = v
            if step >= burn_in and (step - burn_in) % sample_interval == sample_interval - 1:
                samples.append(u.copy())
        return np.stack(samples)


# ------------------------------------------------- ODE forward model (L5)
class LotkaVolterraForward:
    """NumPy mirror of ip_mcmc_tpu.models.ode.make_lotka_volterra_forward:
    RK4 on the log-population LV field, observed at fixed time indices.

    ``forward_with_grad`` propagates the EXACT sensitivity dz/dθ through the
    RK4 map (forward sensitivity equations — the reference-equivalent way a
    NumPy practitioner provides MALA/NUTS gradients without AD; finite
    differences would change the algorithm)."""

    def __init__(self, y0, dt, n_steps, obs_indices, obs_species=(0, 1)):
        self.z0 = np.log(np.asarray(y0, dtype=float))
        self.dt = float(dt)
        self.n_steps = int(n_steps)
        self.obs_indices = np.asarray(obs_indices)
        self.species = np.asarray(obs_species)

    @staticmethod
    def _field(z, rates):
        a, b, g, d = rates
        return np.array([a - b * np.exp(z[1]), d * np.exp(z[0]) - g])

    @staticmethod
    def _field_jac(z, rates, S):
        """df/dz @ S + df/dθ for θ = log-rates (chain rule absorbs e^θ)."""
        a, b, g, d = rates
        e0, e1 = np.exp(z[0]), np.exp(z[1])
        JS = np.empty_like(S)
        JS[0] = -b * e1 * S[1]
        JS[1] = d * e0 * S[0]
        F = np.array([[a, -b * e1, 0.0, 0.0], [0.0, 0.0, -g, d * e0]])
        return JS + F

    def forward(self, theta):
        rates = np.exp(np.asarray(theta, dtype=float))
        z = self.z0.copy()
        traj = np.empty((self.n_steps + 1, 2))
        traj[0] = z
        dt = self.dt
        for i in range(self.n_steps):
            k1 = self._field(z, rates)
            k2 = self._field(z + 0.5 * dt * k1, rates)
            k3 = self._field(z + 0.5 * dt * k2, rates)
            k4 = self._field(z + dt * k3, rates)
            z = z + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            traj[i + 1] = z
        return np.exp(traj[self.obs_indices][:, self.species]).reshape(-1)

    def forward_with_grad(self, theta):
        """Returns (observations, J) with J = d obs / d theta, (m, 4)."""
        rates = np.exp(np.asarray(theta, dtype=float))
        z = self.z0.copy()
        S = np.zeros((2, 4))
        traj = np.empty((self.n_steps + 1, 2))
        sens = np.empty((self.n_steps + 1, 2, 4))
        traj[0], sens[0] = z, S
        dt = self.dt
        for i in range(self.n_steps):
            k1 = self._field(z, rates)
            A1 = self._field_jac(z, rates, S)
            z2, S2 = z + 0.5 * dt * k1, S + 0.5 * dt * A1
            k2 = self._field(z2, rates)
            A2 = self._field_jac(z2, rates, S2)
            z3, S3 = z + 0.5 * dt * k2, S + 0.5 * dt * A2
            k3 = self._field(z3, rates)
            A3 = self._field_jac(z3, rates, S3)
            z4, S4 = z + dt * k3, S + dt * A3
            k4 = self._field(z4, rates)
            A4 = self._field_jac(z4, rates, S4)
            z = z + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            S = S + (dt / 6.0) * (A1 + 2 * A2 + 2 * A3 + A4)
            traj[i + 1], sens[i + 1] = z, S
        zo = traj[self.obs_indices][:, self.species]
        So = sens[self.obs_indices][:, self.species, :]
        obs = np.exp(zo).reshape(-1)
        J = (np.exp(zo)[..., None] * So).reshape(-1, 4)
        return obs, J


class GradientMisfit:
    """Φ(θ) = ½‖(y − G(θ))/σ‖² with ∇Φ = −Jᵀ((y − G)/σ²) for diagonal
    noise — the grad-capable EvolutionPotential used by the MALA/NUTS
    oracle drivers."""

    def __init__(self, forward_model, data, noise_std):
        self.fm = forward_model
        self.y = np.asarray(data, dtype=float)
        self.sigma = float(noise_std)

    def value(self, theta):
        r = (self.y - self.fm.forward(theta)) / self.sigma
        return 0.5 * r @ r

    def value_and_grad(self, theta):
        pred, J = self.fm.forward_with_grad(theta)
        r = self.y - pred
        phi = 0.5 * (r @ r) / self.sigma**2
        grad = -(J.T @ r) / self.sigma**2
        return phi, grad


class PosteriorLogDensityWithGrad:
    """log π(θ) = −Φ(θ) − ½‖(θ−m)/s‖² (diagonal Gaussian prior)."""

    def __init__(self, misfit, prior_mean, prior_scale):
        self.misfit = misfit
        self.m = np.asarray(prior_mean, dtype=float)
        self.s = np.asarray(prior_scale, dtype=float)

    def value_and_grad(self, theta):
        phi, g = self.misfit.value_and_grad(theta)
        z = (theta - self.m) / self.s
        return -phi - 0.5 * z @ z, -g - z / self.s


class MALASampler:
    """Reference-idiom MALA chain: per-step Python dispatch, one chain.
    Proposal v = u + ½ε²∇log π(u) + εξ with the exact MH correction —
    algorithmically identical to ip_mcmc_tpu.kernels.mala."""

    def __init__(self, log_density, step_size, rng):
        self.logpi = log_density
        self.eps = float(step_size)
        self.rng = rng

    def run(self, u0, n_steps):
        u = np.array(u0, dtype=float)
        lp, g = self.logpi.value_and_grad(u)
        eps = self.eps
        half = 0.5 * eps * eps
        samples = np.empty((n_steps, u.shape[0]))
        accepts = 0
        for i in range(n_steps):
            xi = self.rng.standard_normal(u.shape[0])
            mean_fwd = u + half * g
            v = mean_fwd + eps * xi
            lp_v, g_v = self.logpi.value_and_grad(v)
            mean_rev = v + half * g_v
            log_q_rev = -np.sum((u - mean_rev) ** 2) / (2 * eps * eps)
            log_q_fwd = -0.5 * xi @ xi
            log_ratio = (lp_v - lp) + log_q_rev - log_q_fwd
            if np.log(self.rng.uniform()) < min(0.0, log_ratio):
                u, lp, g = v, lp_v, g_v
                accepts += 1
            samples[i] = u
        return samples, accepts / n_steps


class NUTSSampler:
    """Recursive multinomial NUTS (Betancourt 2017), single NumPy chain —
    the reference-equivalent counterpart of ip_mcmc_tpu.kernels.nuts
    (same posterior, same multinomial proposal scheme, same generalized
    U-turn criterion on momentum sums)."""

    def __init__(self, log_density, step_size, rng, max_depth=8):
        self.logpi = log_density
        self.eps = float(step_size)
        self.rng = rng
        self.max_depth = int(max_depth)
        self.grad_evals = 0

    def _leapfrog(self, q, p, g):
        eps = self.eps
        p = p + 0.5 * eps * g
        q = q + eps * p
        lp, g = self.logpi.value_and_grad(q)
        self.grad_evals += 1
        p = p + 0.5 * eps * g
        return q, p, lp, g

    def _build(self, q, p, lp, g, depth, h0):
        if depth == 0:
            q, p, lp, g = self._leapfrog(q, p, g)
            h = -lp + 0.5 * p @ p
            lw = min(h0 - h, 0.0) if np.isfinite(h) else -np.inf
            div = (h - h0) > 1000.0 or not np.isfinite(h)
            return (q, p, lp, g), (q, p, lp, g), (q, lp, g), lw, p.copy(), div, False
        left, right, prop, lw, rho, div, turn = self._build(
            q, p, lp, g, depth - 1, h0
        )
        if div or turn:
            return left, right, prop, lw, rho, div, turn
        l2, r2, prop2, lw2, rho2, div2, turn2 = self._build(
            *right, depth - 1, h0
        )
        total = np.logaddexp(lw, lw2)
        if np.isfinite(total) and np.log(self.rng.uniform()) < lw2 - total:
            prop = prop2
        rho = rho + rho2
        turn = turn2 or (rho @ l2[1] < 0) or (rho @ r2[1] < 0)
        return left, r2, prop, total, rho, div or div2, turn

    def run(self, u0, n_steps):
        q = np.array(u0, dtype=float)
        lp, g = self.logpi.value_and_grad(q)
        samples = np.empty((n_steps, q.shape[0]))
        for i in range(n_steps):
            p = self.rng.standard_normal(q.shape[0])
            h0 = -lp + 0.5 * p @ p
            left = (q, p.copy(), lp, g)
            right = (q, p.copy(), lp, g)
            prop, lw, rho = (q, lp, g), 0.0, p.copy()
            for depth in range(self.max_depth):
                go_right = self.rng.uniform() < 0.5
                if go_right:
                    _, right, prop2, lw2, rho2, div, turn = self._build(
                        *right, depth, h0
                    )
                else:
                    qm, pm, lpm, gm = left
                    l2, _, prop2, lw2, rho2, div, turn = self._build(
                        qm, -pm, lpm, gm, depth, h0
                    )
                    left = (l2[0], -l2[1], l2[2], l2[3])
                if div or turn:
                    break
                total = np.logaddexp(lw, lw2)
                if np.log(self.rng.uniform()) < lw2 - total:
                    prop = prop2
                lw = total
                rho = rho + rho2
                if (rho @ left[1] < 0) or (rho @ right[1] < 0):
                    break
            q, lp, g = prop
            samples[i] = q
        return samples


# -------------------------------------------------------------- SMC driver
def smc_tempered(
    potential,
    prior_sample,
    n_particles,
    rng,
    *,
    ess_target=0.5,
    mutation_steps=5,
    pcn_step=0.3,
    max_stages=60,
):
    """Reference-idiom adaptive tempered SMC: NumPy mirror of
    ip_mcmc_tpu.smc.run (same δβ bisection, systematic resampling, pCN
    mutations, evidence telescoping) with per-particle Python loops.

    ``potential``: Φ(u) callable; ``prior_sample(rng) -> u`` draws one
    whitened-prior particle (pCN mutations assume N(0, I) prior).
    Returns (particles, log_z, n_stages, total_potential_evals)."""
    particles = np.stack([prior_sample(rng) for _ in range(n_particles)])
    pots = np.array([potential(u) for u in particles])
    n_evals = n_particles
    beta, log_z, stage = 0.0, 0.0, 0
    contraction = np.sqrt(1.0 - pcn_step**2)

    def ess_at(log_w):
        w = np.exp(log_w - log_w.max())
        return (w.sum()) ** 2 / (w @ w)

    while beta < 1.0 and stage < max_stages:
        lo, hi = 0.0, 1.0 - beta
        if ess_at(-hi * pots) >= ess_target * n_particles:
            delta = hi
        else:
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                if ess_at(-mid * pots) >= ess_target * n_particles:
                    lo = mid
                else:
                    hi = mid
            delta = max(lo, 1e-6 * (1.0 - beta))
        new_beta = min(beta + delta, 1.0)
        log_w = -delta * pots
        shift = log_w.max()
        log_z += shift + np.log(np.mean(np.exp(log_w - shift)))
        # systematic resampling
        w = np.exp(log_w - shift)
        w = w / w.sum()
        cum = np.cumsum(w)
        u0 = rng.uniform() / n_particles
        ancestors = np.searchsorted(cum, u0 + np.arange(n_particles) / n_particles)
        ancestors = np.clip(ancestors, 0, n_particles - 1)
        particles = particles[ancestors]
        pots = pots[ancestors]
        # pCN mutations targeting exp(−new_beta Φ) dμ0, per-particle loop
        for _ in range(mutation_steps):
            for i in range(n_particles):
                xi = rng.standard_normal(particles.shape[1])
                v = contraction * particles[i] + pcn_step * xi
                phi_v = potential(v)
                n_evals += 1
                if np.log(rng.uniform()) < new_beta * (pots[i] - phi_v):
                    particles[i] = v
                    pots[i] = phi_v
        beta = new_beta
        stage += 1
    return particles, log_z, stage, n_evals


# ------------------------------------------------------------- diagnostics
def ess_numpy(x):
    """Multi-chain ESS, numerically identical estimator to
    ip_mcmc_tpu.diagnostics.ess (same split/Geyer truncation), pure NumPy.

    x: (n_steps, n_chains) or (n_steps,).
    """
    x = np.asarray(x, dtype=float)
    if x.ndim == 1:
        x = x[:, None]
    n0 = x.shape[0] - (x.shape[0] % 2)
    half = n0 // 2
    x = np.concatenate([x[:half], x[half:n0]], axis=1)
    n, m = x.shape
    xc = x - x.mean(axis=0, keepdims=True)
    size = 1
    while size < 2 * n:
        size <<= 1
    f = np.fft.rfft(xc, n=size, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=size, axis=0)[:n].real / n
    chain_vars = acov[0] * n / (n - 1)
    mean_acov = acov.mean(axis=1)
    within = chain_vars.mean()
    between_over_n = np.var(x.mean(axis=0), ddof=1)
    var_plus = (n - 1) / n * within + between_over_n
    rho = 1.0 - (within - mean_acov) / var_plus
    n_pairs = n // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(axis=1)
    positive = pairs > 0
    positive[0] = True
    keep = np.cumprod(positive.astype(int)) > 0
    pairs_mono = np.minimum.accumulate(pairs)
    pairs_used = np.where(keep, np.minimum(pairs, pairs_mono), 0.0)
    pairs_used = np.maximum(pairs_used, 0.0)
    tau = -1.0 + 2.0 * pairs_used.sum()
    tau = max(tau, 1.0 / np.log10(n * m + 10.0))
    return n * m / tau
