"""Darcy-flow log-permeability inversion (BASELINE config 4 as a narrative
experiment): 64-dim KL field, thousands of pCN chains, posterior field
reconstruction with uncertainty.

Run: python examples/darcy_inversion.py [--plot out.png] [--smc]
"""

import argparse

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import jax
import jax.numpy as jnp
import numpy as np

from ip_mcmc_tpu import diagnostics, distributions, driver, potentials, smc
from ip_mcmc_tpu.kernels import pcn
from ip_mcmc_tpu.models import darcy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--plot", default=None)
    ap.add_argument("--n-chains", type=int, default=1024)
    ap.add_argument("--n-samples", type=int, default=500)
    ap.add_argument("--smc", action="store_true", help="use adaptive SMC instead of pCN")
    ap.add_argument("--fused", action="store_true",
                    help="fused warm-DST engine")
    args = ap.parse_args()

    n_grid = 16
    fwd, aux = darcy.make_darcy_forward(n_grid=n_grid, n_modes_per_dim=8)
    K = 64
    prior = distributions.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = prior.sample(jax.random.key(30))
    m = len(aux["obs_indices"])
    noise = distributions.DiagGaussian(mean=jnp.zeros(m), scale=0.002 * jnp.ones(m))
    y = fwd(u_true) + noise.sample(jax.random.key(31))
    phi = potentials.misfit_potential(fwd, y, noise)

    if args.smc:
        state, info = smc.run(
            phi, prior, jax.random.key(0), n_particles=args.n_chains,
            mutation_steps=5, pcn_step=0.15,
        )
        coeffs = np.asarray(state.particles)
        print(f"SMC stages: {int(info.n_stages)}, log Z: {float(state.log_z):.2f}")
    elif args.fused:
        from ip_mcmc_tpu.ops import fused_pcn_chain_warm, fused_pcn_chain_warm_recorded

        phi_w, aux_dim = darcy.make_batched_misfit_warm(
            aux, y, 0.002, cg_iters=6, precond="dst"
        )
        pm, ps = np.zeros(K), np.ones(K)
        block = min(256, args.n_chains)
        pos = prior.sample(jax.random.key(0), (args.n_chains,))
        pos, _ = fused_pcn_chain_warm(
            phi_w, pos, prior_mean=pm, prior_scale=ps, beta=0.08, seed=1,
            n_steps=500, aux_dim=aux_dim, block_chains=block,
        )
        _, acc, samples = fused_pcn_chain_warm_recorded(
            phi_w, pos, prior_mean=pm, prior_scale=ps, beta=0.08, seed=2,
            n_steps=args.n_samples, thin=1, aux_dim=aux_dim, block_chains=block,
        )
        coeffs = np.asarray(samples).reshape(-1, K)
        print(f"accept rate: {np.asarray(acc).mean():.3f}")
        print(f"min ESS    : {float(diagnostics.ess_per_param(samples).min()):.0f}")
    else:
        kernel = pcn.build_kernel(phi, prior, beta=0.08)
        key_i, key_r = jax.random.split(jax.random.key(0))
        state = driver.init_chains(pcn.init, prior.sample(key_i, (args.n_chains,)), phi)
        _, samples, infos = driver.sample_chains(
            kernel, state, key_r, n_samples=args.n_samples, burn_in=500
        )
        coeffs = np.asarray(samples).reshape(-1, K)
        print(f"accept rate: {np.asarray(infos.accepted).mean():.3f}")
        print(f"min ESS    : {float(diagnostics.ess_per_param(samples).min()):.0f}")

    basis = np.asarray(aux["scaled_basis"])
    field_post = (coeffs.mean(axis=0) @ basis).reshape(n_grid, n_grid)
    field_true = (np.asarray(u_true) @ basis).reshape(n_grid, n_grid)
    field_std = (coeffs @ basis).std(axis=0).reshape(n_grid, n_grid)
    print(
        "log-permeability field: max|post-mean − truth| ="
        f" {np.abs(field_post - field_true).max():.3f},"
        f" mean posterior std = {field_std.mean():.3f}"
    )

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(13, 4))
        for ax, (f, title) in zip(
            axes,
            [
                (field_true, "true log a"),
                (field_post, "posterior mean"),
                (field_std, "posterior std"),
            ],
        ):
            im = ax.imshow(f, origin="lower", extent=[0, 1, 0, 1])
            ax.set_title(title)
            fig.colorbar(im, ax=ax, shrink=0.8)
        fig.savefig(args.plot, dpi=100, bbox_inches="tight")
        print(f"plot saved to {args.plot}")


if __name__ == "__main__":
    main()
