"""Multi-device scaling-efficiency harness (BASELINE target 2: ≥80%
samples/s efficiency 1 host → N hosts).

Runs the Darcy pCN workload with the chain axis sharded over 1, 2, ..., all
visible devices and reports steps/s + efficiency vs linear scaling. On a pod
slice, launch one process per host with ``jax.distributed.initialize`` (the
runner picks up all global devices automatically). On a single chip this
degenerates to the 1-device row; on the 8-way virtual CPU mesh it validates
the mechanism (not the absolute numbers).

Run: python benchmarks/scaling.py [chains_per_device] [n_steps]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys
import time

import jax
import jax.numpy as jnp

from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache(min_compile_time_s=1.0)

from ip_mcmc_tpu import distributions, driver, parallel, potentials
from ip_mcmc_tpu.kernels import pcn
from ip_mcmc_tpu.models import darcy


def build_problem():
    fwd, aux = darcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8)
    prior = distributions.DiagGaussian(mean=jnp.zeros(64), scale=jnp.ones(64))
    u_true = prior.sample(jax.random.key(1))
    m = len(aux["obs_indices"])
    noise = distributions.DiagGaussian(mean=jnp.zeros(m), scale=0.002 * jnp.ones(m))
    y = fwd(u_true) + noise.sample(jax.random.key(2))
    phi = potentials.misfit_potential(fwd, y, noise)
    return pcn.build_kernel(phi, prior, beta=0.08), prior, phi


def main():
    per_dev = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    kernel, prior, phi = build_problem()
    n_all = len(jax.devices())
    counts = sorted({1, 2, n_all} & set(range(1, n_all + 1)))
    base_rate = None
    for nd in counts:
        mesh = parallel.make_chain_mesh(n_devices=nd)
        n_chains = per_dev * nd
        positions = prior.sample(jax.random.key(3), (n_chains,))
        state = driver.init_chains(pcn.init, positions, phi)
        state = parallel.shard_chains(state, mesh)

        def run():
            st, s, _ = driver.sample_chains(
                kernel, state, jax.random.key(4), n_samples=1, burn_in=n_steps
            )
            return st.position

        out = run()
        jax.block_until_ready(out)
        t0 = time.time()
        out = run()
        jax.block_until_ready(out)
        dt = time.time() - t0
        rate = n_chains * n_steps / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        print(
            f"{nd:3d} devices: {n_chains:6d} chains, {rate:12,.0f} steps/s, "
            f"efficiency {eff:6.1%}"
        )


if __name__ == "__main__":
    main()
