"""Fused Darcy beyond n = 16 (round-1 VERDICT item 6): truncated-DST
two-level preconditioning vs the former Jacobi-warm path.

Measures, on one chip:
- n = 32: warm Jacobi-32 (round-1 shipping config) vs warm dst_trunc-6
  (equal-or-better residual: 7e-5 vs ~3e-4) — chain-steps/s.
- n = 64: warm dst_trunc-8 — the first FUSED darcy64 number (round 1 had
  scan-path only).

Run on GPU:  python -m benchmarks.darcy_scale [--quick]
Writes benchmarks/darcy_scale.json; prints one JSON line per row.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def log(*a):
    print(*a, file=_sys.stderr, flush=True)


def _bench_warm(label, n_grid, n_modes, misfit_kw, beta, n_chains, block,
                n_steps, key_seed):
    import jax
    import jax.numpy as jnp

    from ip_mcmc_tpu.models import darcy
    from ip_mcmc_tpu.ops import fused_pcn_chain_warm

    K = n_modes * n_modes
    fwd, aux = darcy.make_darcy_forward(
        n_grid=n_grid, n_modes_per_dim=n_modes, alpha=2.0, field_scale=10.0
    )
    u_true = jax.random.normal(jax.random.key(310), (K,))
    y = fwd(u_true) + 0.002 * jax.random.normal(jax.random.key(311), (16,))
    warm, aux_dim = darcy.make_batched_misfit_warm(aux, y, 0.002, **misfit_kw)
    pos = jax.random.normal(jax.random.key(key_seed), (n_chains, K)) * 0.3

    def run(steps):
        return fused_pcn_chain_warm(
            warm, pos, prior_mean=np.zeros(K), prior_scale=np.ones(K),
            beta=beta, seed=7, n_steps=steps, aux_dim=aux_dim,
            block_chains=block,
        )

    # compile at the TIMED n_steps: the step count is a static constant of
    # the fused program, so warming at a different n_steps leaves the timed
    # call paying a full recompile that would swamp the rate
    f, a = run(n_steps)
    jax.block_until_ready(f)
    t0 = time.perf_counter()
    f, acc = run(n_steps)
    jax.block_until_ready(f)
    dt = time.perf_counter() - t0
    steps_per_s = n_chains * n_steps / dt

    # solution quality: residual of the carried warm solve vs a deep solve
    phi_ref, _ = darcy.make_batched_misfit_warm(aux, y, 0.002, cg_iters=200)
    Ub = jnp.asarray(np.asarray(f[:block]).T, jnp.float32)
    x0 = jnp.zeros((n_grid * n_grid, block), jnp.float32)
    p_w, _ = warm(Ub, x0)   # cold-started warm config (worst case)
    p_r, _ = phi_ref(Ub, x0)
    phi_err = float(jnp.max(jnp.abs(p_w - p_r) / (1.0 + jnp.abs(p_r))))

    row = {
        "kernel": label,
        "n_grid": n_grid,
        "dim": K,
        "n_chains": n_chains,
        "block_chains": block,
        "n_steps": n_steps,
        "accept": float(np.asarray(acc).mean()),
        "steps_per_s": steps_per_s,
        "wall_s": dt,
        "phi_rel_err_coldstart": phi_err,
    }
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)

    import jax

    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_s=1.0)

    steps32 = 500 if args.quick else 3000
    steps64 = 200 if args.quick else 1000
    rows = [
        _bench_warm("darcy32 warm jacobi-32 (round-1 shipping)",
                    32, 8, dict(cg_iters=32), 0.08, 4096, 128, steps32, 5),
        _bench_warm("darcy32 warm dst_trunc-6 x128 modes",
                    32, 8, dict(cg_iters=6, precond="dst_trunc",
                                precond_modes=128), 0.08, 4096, 128,
                    steps32, 5),
        _bench_warm("darcy64 warm dst_trunc-8 x256 modes (first fused 64)",
                    64, 12, dict(cg_iters=8, precond="dst_trunc",
                                 precond_modes=256), 0.06, 2048, 128,
                    steps64, 6),
        _bench_warm("darcy64 warm dst_trunc-4 x256 modes",
                    64, 12, dict(cg_iters=4, precond="dst_trunc",
                                 precond_modes=256), 0.06, 2048, 128,
                    steps64, 6),
    ]
    out = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                        "darcy_scale.json")
    with open(out, "w") as fp:
        json.dump(rows, fp, indent=1)
    log(f"wrote {out}")
    log(f"darcy32 speedup dst_trunc/jacobi: "
        f"{rows[1]['steps_per_s']/rows[0]['steps_per_s']:.2f}x")


if __name__ == "__main__":
    main()
