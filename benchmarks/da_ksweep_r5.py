"""Round-5 (k, β) re-sweep of the DA optima under the NEW cost structure.

The round-4 sweeps fixed (k, β) under the Jacobi solver pair. The
spectrally preconditioned solvers changed the inner/outer cost ratio,
which shifts the optimal subchain length k upward: cheaper
inner steps mean the chain can afford more decorrelation per exact
correction before the outer-acceptance decay bites.

Usage:
  python -m benchmarks.da_ksweep_r5 darcy16 48,0.35 64,0.35 64,0.4 ...
  python -m benchmarks.da_ksweep_r5 darcy64 32,0.4 48,0.4 64,0.45 ...

Appends rows to benchmarks/da_ksweep_r5_<problem>.json (chunk-friendly:
each (k, thin) pair is its own program and compile).
"""

from __future__ import annotations

import json
import os
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

    from ip_mcmc_tpu import diagnostics
    from ip_mcmc_tpu.ops import fused_da_pcn_chain, fused_da_pcn_chain_recorded

    problem = sys.argv[1]
    combos = [
        (int(a.split(",")[0]), float(a.split(",")[1])) for a in sys.argv[2:]
    ]
    log(f"device: {jax.devices()[0]}  problem={problem}  combos={combos}")

    from ip_mcmc_tpu import configs

    if problem == "darcy16":
        p = configs.build("darcy_da_fused")
        N_CHAINS, BLOCK = 4096, 512
    elif problem == "darcy64":
        p = configs.build("darcy64_da_fused")
        N_CHAINS, BLOCK = 1024, 128
    else:
        raise SystemExit(f"unknown problem {problem}")
    phi_e, surr = p.batched_potential_fn, p.batched_surrogate_fn
    K = p.dim
    pm, ps = np.zeros(K), np.ones(K)

    pos0 = p.prior.sample(jax.random.key(3), (N_CHAINS,))
    out_path = f"benchmarks/da_ksweep_r5_{problem}.json"
    rows = []
    if os.path.exists(out_path):
        with open(out_path) as f:
            rows = json.load(f)

    for k, beta in combos:
        def da(pos, seed, n_steps):
            return fused_da_pcn_chain(
                phi_e, surr, pos, pm, ps, beta, seed,
                n_steps=n_steps, subchain_len=k, block_chains=BLOCK)

        t0 = time.time()
        pos, _, _ = da(pos0, 11, max(1200 // k, 20))  # ~equal burn work
        np.asarray(pos)
        compile_s = time.time() - t0

        n_time = max(2400 // k, 25)
        reps = []
        for rep in range(4):
            t0 = time.time()
            q = pos
            for j in range(3):
                q, acc, in_acc = da(q, 30 + rep * 3 + j, n_time)
            np.asarray(q)
            if rep:
                reps.append(time.time() - t0)
        outer_rate = N_CHAINS * n_time / (min(reps) / 3)

        q, _, series = fused_da_pcn_chain_recorded(
            phi_e, surr, pos, pm, ps, beta, 900, n_steps=200, thin=1,
            subchain_len=k, block_chains=BLOCK)
        ess = float(np.asarray(diagnostics.ess_per_param(series)).min())
        row = {
            "k": k,
            "beta": beta,
            "compile_s": round(compile_s, 1),
            "outer_steps_per_s": round(outer_rate),
            "inner_steps_per_s": round(outer_rate * k),
            "outer_accept": round(float(np.asarray(acc).mean()), 4),
            "inner_accept": round(float(np.asarray(in_acc).mean()), 4),
            "ess_per_outer_step_chain": round(ess / (N_CHAINS * 200), 5),
            "ess_per_s": round(ess / (N_CHAINS * 200) * outer_rate, 1),
        }
        rows = [r for r in rows if (r["k"], r["beta"]) != (k, beta)] + [row]
        log(json.dumps(row))
        with open(out_path, "w") as f:
            json.dump(rows, f, indent=1)

    log(f"written: {out_path} ({len(rows)} rows)")
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
