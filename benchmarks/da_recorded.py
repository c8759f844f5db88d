"""Recorded-path ESS/s for the fused DA-pCN headline engine.

A user who keeps the samples pays for the recorded path; recording every
``thin`` steps is an output of the engine's step loop. At per-outer-step
ESS ~0.14, thin=2-8 loses little ESS per chain step while cutting the
recorded volume (and any device->host transfer) linearly.

This script measures, on the GPU, for thin in {1, 2, 4, 8}:
  - recorded-launch throughput (outer steps/s) vs the non-recorded kernel
  - ESS of the recorded series (multi-chain Geyer, on-device)
  - device-side recorded ESS/s  = ESS / launch_wall   (samples in device memory,
    diagnostics on device — what the CLI's ess_per_s reports)
  - host-side recorded ESS/s    = ESS / (launch + np.asarray transfer)
    (samples in host RAM), plus the implied transfer bandwidth so the
    transfer floor is explicit.

Writes benchmarks/da_recorded.json and prints one JSON line per row.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax

    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_s=1.0)

    import jax.numpy as jnp

    from ip_mcmc_tpu import diagnostics, distributions
    from ip_mcmc_tpu.configs import _darcy_coarse_surrogate
    from ip_mcmc_tpu.models import darcy
    from ip_mcmc_tpu.ops import fused_da_pcn_chain, fused_da_pcn_chain_recorded

    NOISE = 0.002
    N_CHAINS = 4096
    BLOCK = 512
    DA_K, DA_BETA = 48, 0.35
    N_REC = 200  # records per row (fixed; steps = N_REC * thin)

    log(f"device: {jax.devices()[0]}")

    # same problem construction as bench.py's DA section
    from benchmarks.oracle_darcy import OracleDarcyPCN

    oracle = OracleDarcyPCN()
    rng = np.random.default_rng(7)
    u_true = rng.standard_normal(oracle.K)
    y = oracle.forward(u_true) + NOISE * rng.standard_normal(len(oracle.obs))

    fwd, aux = darcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8)
    phi_exact_b = darcy.make_batched_misfit(aux, jnp.asarray(y, jnp.float32), NOISE)
    prior = distributions.DiagGaussian(mean=jnp.zeros(64), scale=jnp.ones(64))
    pm, ps = np.zeros(64), np.ones(64)
    surr8 = _darcy_coarse_surrogate(prior, jnp.asarray(y, jnp.float32))

    def da(pos, seed, n_steps):
        return fused_da_pcn_chain(
            phi_exact_b, surr8, pos, pm, ps, DA_BETA, seed,
            n_steps=n_steps, subchain_len=DA_K, block_chains=BLOCK)

    def da_rec(pos, seed, n_steps, thin):
        return fused_da_pcn_chain_recorded(
            phi_exact_b, surr8, pos, pm, ps, DA_BETA, seed,
            n_steps=n_steps, thin=thin, subchain_len=DA_K,
            block_chains=BLOCK)

    # burn-in + compile
    pos = prior.sample(jax.random.key(3), (N_CHAINS,))
    t0 = time.time()
    pos, *_ = da(pos, 11, 40)
    np.asarray(pos)
    log(f"compile+burn-in (40 outer steps): {time.time() - t0:.1f}s")

    # non-recorded reference throughput (min of 3 reps x 3 chained launches)
    reps = []
    for rep in range(4):
        t0 = time.time()
        p = pos
        for j in range(3):
            p, acc, _ = da(p, 30 + rep * 3 + j, 100)
        np.asarray(p)
        if rep:
            reps.append(time.time() - t0)
    base_s = min(reps) / 3
    base_rate = N_CHAINS * 100 / base_s
    log(f"non-recorded: {base_rate:,.0f} outer chain-steps/s "
        f"({base_s*1000:.0f} ms / 100 outer steps)")

    rows = []
    for thin in (1, 2, 4, 8):
        n_steps = N_REC * thin
        # compile + warm (result discarded)
        p, _, series = da_rec(pos, 500 + thin, n_steps, thin)
        np.asarray(p)
        t0 = time.time()
        p, acc, series = da_rec(pos, 600 + thin, n_steps, thin)
        np.asarray(acc)  # transfer barrier for the launch (acc is tiny)
        launch_s = time.time() - t0

        # on-device diagnostics (what the CLI does)
        t0 = time.time()
        ess = float(np.asarray(diagnostics.ess_per_param(series)).min())
        diag_s = time.time() - t0

        # host transfer of the full series
        t0 = time.time()
        series_h = np.asarray(series)
        xfer_s = time.time() - t0
        mb = series_h.nbytes / 1e6

        dev_ess_s = ess / launch_s
        host_ess_s = ess / (launch_s + xfer_s)
        row = {
            "thin": thin,
            "n_rec": N_REC,
            "outer_steps": n_steps,
            "launch_s": round(launch_s, 3),
            "recorded_outer_steps_per_s": round(N_CHAINS * n_steps / launch_s),
            "record_overhead_vs_unrecorded": round(
                launch_s / (n_steps / 100 * base_s), 3),
            "min_ess": round(ess, 1),
            "ess_per_outer_step_chain": round(ess / (N_CHAINS * n_steps), 5),
            "ess_per_record_chain": round(ess / (N_CHAINS * N_REC), 4),
            "device_recorded_ess_per_s": round(dev_ess_s, 1),
            "series_mb": round(mb, 1),
            "transfer_s": round(xfer_s, 2),
            "transfer_mb_per_s": round(mb / max(xfer_s, 1e-9), 1),
            "host_recorded_ess_per_s": round(host_ess_s, 1),
            "diag_s": round(diag_s, 2),
            "accept": round(float(np.asarray(acc).mean()), 4),
        }
        rows.append(row)
        log(json.dumps(row))

    out = {
        "non_recorded_outer_steps_per_s": round(base_rate),
        "n_chains": N_CHAINS,
        "k": DA_K,
        "beta": DA_BETA,
        "rows": rows,
    }
    with open("benchmarks/da_recorded.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
