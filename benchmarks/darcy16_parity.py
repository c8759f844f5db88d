"""Parity gates behind the round-3 darcy16 preconditioner swap
(dense Kronecker DST-6  →  truncated-DST, 4 warm iters, K=64 modes).

Two checks on the device:

1. **Warm-path phi error** — the operative bias entering the MH ratio
   during a warm run is the phi error when the solve starts from the
   carried (near-converged) state, NOT the cold from-zero error the
   throughput probe reports. Measured: exactly 0 for dense-6,
   dst_trunc-6 and dst_trunc-4 (a converged start is a fixed point of
   all three), with chain acceptance equal to 4 decimals.

2. **Posterior-moment parity** (the BASELINE correctness gate): same
   data and seeds, 4096 chains, 400 recorded post-burn-in steps;
   per-coordinate |Δmean| / |Δstd| of each candidate vs the shipping
   dense kernel, compared against the dense kernel's own seed-to-seed
   MC spread. On the GPU: not measured.

Run: ``python -m benchmarks.darcy16_parity``.
"""

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_s=1.0)

    from benchmarks.oracle_darcy import OracleDarcyPCN
    from ip_mcmc_tpu import distributions
    from ip_mcmc_tpu.models import darcy
    from ip_mcmc_tpu.ops import (fused_pcn_chain_warm,
                                 fused_pcn_chain_warm_recorded)

    NOISE, BETA, BLOCK, C = 0.002, 0.08, 512, 4096
    fwd, aux = darcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8)
    rng = np.random.default_rng(7)
    u_true = rng.standard_normal(64)
    oracle = OracleDarcyPCN()
    y = oracle.forward(u_true) + NOISE * rng.standard_normal(len(oracle.obs))
    yj = jnp.asarray(y, jnp.float32)
    prior = distributions.DiagGaussian(mean=jnp.zeros(64), scale=jnp.ones(64))
    pm, ps = np.zeros(64), np.ones(64)

    CANDS = [
        ("dst_trunc-6 K=64",
         dict(cg_iters=6, precond="dst_trunc", precond_modes=64)),
        ("dst_trunc-4 K=64",
         dict(cg_iters=4, precond="dst_trunc", precond_modes=64)),
    ]
    SHIP = ("dst-6", dict(cg_iters=6, precond="dst"))

    # ---- gate 1: warm-path phi error from a converged start -------------
    ref, _ = darcy.make_batched_misfit_warm(
        aux, yj, NOISE, cg_iters=200, precond="dst_trunc", precond_modes=128)
    for label, kw in [SHIP] + CANDS:
        warm, aux_dim = darcy.make_batched_misfit_warm(aux, yj, NOISE, **kw)
        pos0 = prior.sample(jax.random.key(0), (BLOCK,))
        pos, acc = fused_pcn_chain_warm(
            warm, pos0, prior_mean=pm, prior_scale=ps, beta=BETA, seed=3,
            n_steps=500, aux_dim=aux_dim, block_chains=BLOCK)
        Ub = jnp.asarray(np.asarray(pos).T, jnp.float32)
        x0 = jnp.zeros((256, BLOCK), jnp.float32)
        _, x_deep = ref(Ub, x0)
        p_w, _ = warm(Ub, x_deep)
        p_r, _ = ref(Ub, x_deep)
        err = float(jnp.max(jnp.abs(p_w - p_r) / (1.0 + jnp.abs(p_r))))
        print(f"{label:20s} acc {float(np.asarray(acc).mean()):.4f}  "
              f"warm_phi_rel_err {err:.2e}", flush=True)

    # ---- gate 2: posterior-moment parity vs dense, against MC error -----
    def moments(kw, seed):
        warm, aux_dim = darcy.make_batched_misfit_warm(aux, yj, NOISE, **kw)
        pos = prior.sample(jax.random.key(seed), (C,))
        pos, _ = fused_pcn_chain_warm(
            warm, pos, prior_mean=pm, prior_scale=ps, beta=BETA, seed=seed,
            n_steps=400, aux_dim=aux_dim, block_chains=BLOCK)
        pos, _, series = fused_pcn_chain_warm_recorded(
            warm, pos, prior_mean=pm, prior_scale=ps, beta=BETA,
            seed=seed + 1, n_steps=400, thin=1, aux_dim=aux_dim,
            block_chains=BLOCK)
        s = np.asarray(series).reshape(-1, 64)
        return s.mean(0), s.std(0)

    m_a, s_a = moments(SHIP[1], 11)
    m_b, _ = moments(SHIP[1], 21)
    mc = np.abs(m_a - m_b)
    print(f"shipping seed-to-seed |dmean|: max {mc.max():.4f} "
          f"median {np.median(mc):.4f}", flush=True)
    for label, kw in CANDS:
        m_c, s_c = moments(kw, 11)  # same seed: differences purely precond
        dm, dsd = np.abs(m_c - m_a), np.abs(s_c - s_a)
        print(f"{label:18s} |dmean| max {dm.max():.4f} median "
              f"{np.median(dm):.4f} | |dstd| max {dsd.max():.4f}  "
              f"(vs MC max {mc.max():.4f})", flush=True)


if __name__ == "__main__":
    main()
