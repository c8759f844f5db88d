"""Gated preconditioner sweep for the darcy32/darcy64 shipping configs —
the round-3 darcy16 methodology (throughput + acceptance + warm-path phi
error + posterior-moment parity, all on the device) applied to the
larger grids.

Warm-path phi error from a converged start is exactly 0 for EVERY variant
(the converged solve is a fixed point regardless of iteration count).
Shipped: darcy32_pcn_warm -> dst_trunc-4 K=128; darcy64_pcn_warm ->
dst_trunc-4 K=256. Throughput on the GPU: not measured.

Run: ``python -m benchmarks.darcy3264_precond`` (~25 min: the n=64
programs have long compiles on first run).
"""

import argparse
import json
import time

import numpy as np


def sweep(n, nm, beta, block, cases, nch, nsteps=400):
    import jax
    import jax.numpy as jnp

    from ip_mcmc_tpu.models import darcy
    from ip_mcmc_tpu.ops import (fused_pcn_chain_warm,
                                 fused_pcn_chain_warm_recorded)

    K = nm * nm
    fwd, aux = darcy.make_darcy_forward(n_grid=n, n_modes_per_dim=nm,
                                        alpha=2.0, field_scale=10.0)
    u_true = jax.random.normal(jax.random.key(310), (K,))
    y = fwd(u_true) + 0.002 * jax.random.normal(jax.random.key(311), (16,))
    pm, ps = np.zeros(K), np.ones(K)
    ref, _ = darcy.make_batched_misfit_warm(aux, y, 0.002, cg_iters=200,
                                            precond="dst_trunc",
                                            precond_modes=256)
    pos0 = jax.random.normal(jax.random.key(5), (nch, K)) * 0.3
    base_m = base_s = None
    rows = []
    for label, kw in cases:
        warm, aux_dim = darcy.make_batched_misfit_warm(aux, y, 0.002, **kw)

        def run(pos, steps, seed):
            return fused_pcn_chain_warm(
                warm, pos, prior_mean=pm, prior_scale=ps, beta=beta,
                seed=seed, n_steps=steps, aux_dim=aux_dim,
                block_chains=block)

        pos, _ = run(pos0, 300, 1)
        np.asarray(pos[:1])
        times = []
        for rep in range(3):
            t0 = time.perf_counter()
            p = pos
            for j in range(3):  # chained launches amortize dispatch latency
                p, a = run(p, nsteps, 7 + 3 * rep + j)
            np.asarray(p[:1])
            times.append(time.perf_counter() - t0)
        rate = nch * nsteps * 3 / min(times)
        acc = float(np.asarray(a).mean())

        Ub = jnp.asarray(np.asarray(p[:block]).T, jnp.float32)
        x0 = jnp.zeros((n * n, block), jnp.float32)
        _, x_deep = ref(Ub, x0)
        p_w, _ = warm(Ub, x_deep)
        p_r, _ = ref(Ub, x_deep)
        err = float(jnp.max(jnp.abs(p_w - p_r) / (1.0 + jnp.abs(p_r))))

        _, _, series = fused_pcn_chain_warm_recorded(
            warm, pos, prior_mean=pm, prior_scale=ps, beta=beta, seed=99,
            n_steps=300, thin=1, aux_dim=aux_dim, block_chains=block)
        s = np.asarray(series).reshape(-1, K)
        m, sd = s.mean(0), s.std(0)
        if base_m is None:
            base_m, base_s = m, sd
            dm = dsd = 0.0
        else:
            dm = float(np.abs(m - base_m).max())
            dsd = float(np.abs(sd - base_s).max())
        rows.append({"n": n, "label": label, "steps_per_s": rate,
                     "accept": acc, "warm_phi_rel_err": err,
                     "dmean_max": dm, "dstd_max": dsd})
        print(f"n={n} {label:18s} {rate:12,.0f} steps/s  acc {acc:.4f}  "
              f"warm_err {err:.1e}  |dmean| {dm:.4f} |dstd| {dsd:.4f}",
              flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="benchmarks/darcy3264_precond.json")
    args = ap.parse_args()

    import jax

    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_s=1.0)

    rows = sweep(32, 8, 0.08, 128, [
        ("dst_trunc-6 K=128",
         dict(cg_iters=6, precond="dst_trunc", precond_modes=128)),
        ("dst_trunc-4 K=128",
         dict(cg_iters=4, precond="dst_trunc", precond_modes=128)),
        ("dst_trunc-4 K=64",
         dict(cg_iters=4, precond="dst_trunc", precond_modes=64)),
        ("dst_trunc-6 K=64",
         dict(cg_iters=6, precond="dst_trunc", precond_modes=64)),
    ], nch=4096)
    rows += sweep(64, 12, 0.06, 128, [
        ("dst_trunc-8 K=256",
         dict(cg_iters=8, precond="dst_trunc", precond_modes=256)),
        ("dst_trunc-4 K=256",
         dict(cg_iters=4, precond="dst_trunc", precond_modes=256)),
        ("dst_trunc-4 K=128",
         dict(cg_iters=4, precond="dst_trunc", precond_modes=128)),
        ("dst_trunc-6 K=128",
         dict(cg_iters=6, precond="dst_trunc", precond_modes=128)),
    ], nch=2048)
    with open(args.out, "w") as fh:
        json.dump({"rows": rows}, fh, indent=1)
    print("written:", args.out)


if __name__ == "__main__":
    main()
