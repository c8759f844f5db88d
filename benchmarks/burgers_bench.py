"""Burgers initial-data inversion benchmark: fused-engine pCN vs the
reference-equivalent NumPy oracle (the reference's headline problem class —
conservation-law inversion with a Godunov FV solver, SURVEY.md §3.4).

Same methodology as bench.py: identical algorithm (pCN, same β) and data on
both sides; ESS/step from a GPU-recorded series; ESS/sec = ESS/step ×
steps/sec each side.

Run on GPU: python -m benchmarks.burgers_bench
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class OracleBurgersPCN:
    """Reference-idiom NumPy loop: per-step Python dispatch, one chain."""

    def __init__(self, aux):
        self.basis = np.asarray(aux["scaled_basis"])
        self.mean = np.asarray(aux["mean"])
        self.obs = np.asarray(aux["obs_indices"])
        self.dt = float(aux["dt"])
        self.n_steps_fv = int(aux["n_steps"])
        self.n_cells = int(aux["n_cells"])
        self.K = self.basis.shape[0]

    def forward(self, u):
        state = self.mean + u @ self.basis
        dt_over_h = self.dt * self.n_cells
        for _ in range(self.n_steps_fv):
            u_r = np.roll(state, -1)
            fl = 0.5 * np.maximum(state, 0.0) ** 2
            fr = 0.5 * np.minimum(u_r, 0.0) ** 2
            flux_right = np.maximum(fl, fr)
            flux_left = np.roll(flux_right, 1)
            state = state - dt_over_h * (flux_right - flux_left)
        return state[self.obs]

    def potential(self, u, y, noise_std):
        r = (y - self.forward(u)) / noise_std
        return 0.5 * r @ r

    def run_pcn(self, y, noise_std, beta, n_steps, rng):
        u = rng.standard_normal(self.K)
        phi = self.potential(u, y, noise_std)
        c = np.sqrt(1.0 - beta**2)
        acc = 0
        for _ in range(n_steps):
            v = c * u + beta * rng.standard_normal(self.K)
            phi_v = self.potential(v, y, noise_std)
            if np.log(rng.uniform()) < phi - phi_v:
                u, phi = v, phi_v
                acc += 1
        return acc / n_steps


def main():
    import jax
    import jax.numpy as jnp

    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_s=1.0)

    from ip_mcmc_tpu import diagnostics, distributions
    from ip_mcmc_tpu.models import burgers
    from ip_mcmc_tpu.ops import fused_pcn_chain

    BETA = 0.15
    NOISE = 0.02
    N_CHAINS = 4096
    BLOCK = 512
    N_REC = 300
    N_TIME = 500

    n_cells = 128
    x = (np.arange(n_cells) + 0.5) / n_cells
    fwd, aux = burgers.make_burgers_forward(
        n_cells=n_cells, n_modes=16, t_final=0.2,
        mean_profile=np.sin(2 * np.pi * x),
    )
    K = 16
    prior = distributions.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = prior.sample(jax.random.key(10))
    m = len(aux["obs_indices"])
    y = np.asarray(fwd(u_true)) + NOISE * np.random.default_rng(11).standard_normal(m)

    phi_batch = burgers.make_batched_misfit(aux, jnp.asarray(y, jnp.float32), NOISE)
    pm, ps = np.zeros(K), np.ones(K)

    def fused(pos, seed, n_steps):
        return fused_pcn_chain(
            phi_batch, pos, prior_mean=pm, prior_scale=ps, beta=BETA,
            seed=seed, n_steps=n_steps, block_chains=BLOCK,
        )

    positions = prior.sample(jax.random.key(0), (N_CHAINS,))
    t0 = time.time()
    positions, _ = fused(positions, 1, 400)
    jax.block_until_ready(positions)
    log(f"compile+burn-in: {time.time()-t0:.1f}s")

    series = np.empty((N_REC, N_CHAINS, K), np.float32)
    pos = positions
    t0 = time.time()
    for i in range(N_REC):
        pos, _ = fused(pos, 1000 + i, 1)
        series[i] = np.asarray(pos)
    log(f"ESS series: {time.time()-t0:.1f}s")
    ess = np.asarray(diagnostics.ess_per_param(jnp.asarray(series)))
    min_ess = float(ess.min())
    ess_per_step_chain = min_ess / (N_CHAINS * N_REC)

    out, _ = fused(pos, 99, N_TIME)
    jax.block_until_ready(out)
    t0 = time.time()
    out, acc = fused(pos, 2, N_TIME)
    jax.block_until_ready(out)
    dev_s = time.time() - t0
    dev_rate = N_CHAINS * N_TIME / dev_s
    dev_ess = ess_per_step_chain * dev_rate
    log(
        f"GPU fused: {dev_rate:,.0f} steps/s ({dev_s:.3f}s), "
        f"accept={float(np.asarray(acc).mean()):.3f}, min ESS={min_ess:,.0f} "
        f"-> {dev_ess:,.1f} ESS/s"
    )

    oracle = OracleBurgersPCN(aux)
    rng = np.random.default_rng(1)
    n_o = 100
    t0 = time.time()
    o_acc = oracle.run_pcn(y, NOISE, BETA, n_o, rng)
    o_s = time.time() - t0
    o_rate = n_o / o_s
    o_ess = ess_per_step_chain * o_rate
    log(
        f"oracle: {o_rate:,.1f} steps/s (accept={o_acc:.2f}) -> {o_ess:.4f} ESS/s"
    )
    print(
        f"burgers_pcn: GPU {dev_ess:,.1f} ESS/s vs oracle {o_ess:.4f} ESS/s "
        f"= {dev_ess / o_ess:,.0f}x"
    )


if __name__ == "__main__":
    main()
