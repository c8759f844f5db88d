"""Round-4 frontier probe: does the Burgers DA3 win transfer to the
HEADLINE Darcy problem?

The warm fused pCN kernel (dst_trunc-4) is fast, but its chain is weakly
non-Markov through
the carried CG solution, and its per-recorded-sample ESS is ~1e-3 (beta
0.08, heavily autocorrelated). The Burgers round-4 result says: a cheap
calibrated coarse-GRID surrogate subchain + exact correction can multiply
honest ESS/s several-fold by decorrelating recorded samples while keeping
the posterior EXACT (no warm-start caveat). This benchmark measures that
trade on Darcy:

  - warm dst_trunc-4 (shipping headline)  — the ESS/s bar to beat
  - cold fused pCN (exact 48-iter model)  — the exactness-matched baseline
  - fused 2-level DA: 8x8-grid calibrated surrogate (same KL coefficient
    space — sine_basis_2d at the same mode set — bias-corrected and
    noise-inflated by the fine-coarse discrepancy over prior draws, the
    burgers_da_pcn recipe) x (subchain k, beta) grid

All DA rows target the SAME exact posterior as the cold row (exact
correction against the 48-iter model). ESS protocol identical to
benchmarks/burgers_da.py (3-rep-median launches, transfer barriers,
concatenated recorded windows, multi-chain Geyer estimator).

Usage: python -m benchmarks.darcy_da_fused [--quick] [--out f]
"""

import argparse
import json
import sys

import numpy as np

from benchmarks.burgers_da import log, measure


def build_coarse_surrogate(aux16, prior, y, noise, n_coarse, cg_iters,
                           key=402):
    """Calibrated coarse-grid batched Darcy misfit (burgers_da_pcn recipe):
    same whitened KL coefficients (the sine mode set is grid-independent),
    field sampled on the n_coarse grid, observations at the nearest coarse
    cells, bias/spread-calibrated on prior draws. Returns (batched misfit,
    cost_ratio) with cost ~ cells * iters."""
    import jax
    import jax.numpy as jnp

    from ip_mcmc_tpu.models import darcy

    n_fine = int(aux16["n_grid"])
    obs_f = np.asarray(aux16["obs_indices"])
    i_f, j_f = obs_f // n_fine, obs_f % n_fine
    def to_coarse(i):
        return np.clip(
            np.round((i + 0.5) * n_coarse / n_fine - 0.5).astype(int),
            0, n_coarse - 1,
        )
    obs_c = to_coarse(i_f) * n_coarse + to_coarse(j_f)

    fwd_c, aux_c = darcy.make_darcy_forward(
        n_grid=n_coarse, n_modes_per_dim=8, alpha=2.0, field_scale=10.0,
        obs_indices=obs_c, cg_iters=60,
    )
    fwd_f, _ = darcy.make_darcy_forward(
        n_grid=n_fine, n_modes_per_dim=8, alpha=2.0, field_scale=10.0,
    )
    U_cal = prior.sample(jax.random.key(key), (64,))
    d = np.asarray(jax.vmap(fwd_f)(U_cal) - jax.vmap(fwd_c)(U_cal))
    y_surr = np.asarray(y) - d.mean(axis=0)
    scale = np.sqrt(noise**2 + d.std(axis=0) ** 2).astype(np.float32)
    phi_c = darcy.make_batched_misfit(aux_c, y_surr, scale,
                                      cg_iters=cg_iters)
    cost = (n_coarse * n_coarse * cg_iters) / (n_fine * n_fine * 48)
    return phi_c, cost


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--da3-only", action="store_true",
                    help="skip the 2-level grid (measure warm reference + "
                         "DA3 probes only; separate output file)")
    ap.add_argument("--out", default="benchmarks/darcy_da_fused.json")
    args = ap.parse_args()
    if args.da3_only and args.out == "benchmarks/darcy_da_fused.json":
        args.out = "benchmarks/darcy_da3_probe.json"

    import jax
    import jax.numpy as jnp

    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_s=0.5)

    from ip_mcmc_tpu import configs, ops
    from ip_mcmc_tpu.models import darcy

    NOISE = 0.002
    p = configs.build("darcy_pcn_4096")
    n_chains = 1024 if args.quick else 4096
    n_time = 200 if args.quick else 500
    n_rec = 200 if args.quick else 400
    block = 512
    pm, ps = np.asarray(p.prior.mean), np.asarray(p.prior.scale)
    phi_exact = p.batched_potential_fn  # 48-iter jacobi — the exact model
    _, aux16 = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    yj = jnp.asarray(p.data, jnp.float32)
    positions = p.init_positions(jax.random.key(0), n_chains)
    beta0 = 0.08

    rows = []

    # --- the bar: shipping warm dst_trunc-4 kernel ----------------------
    phi_warm, aux_dim = darcy.make_batched_misfit_warm(
        aux16, yj, NOISE, cg_iters=4, precond="dst_trunc", precond_modes=64)

    def warm_launch(pos, seed, n):
        return ops.fused_pcn_chain_warm(
            phi_warm, pos, prior_mean=pm, prior_scale=ps, beta=beta0,
            seed=seed, n_steps=n, aux_dim=aux_dim, block_chains=block)

    def warm_rec(pos, seed, n):
        return ops.fused_pcn_chain_warm_recorded(
            phi_warm, pos, prior_mean=pm, prior_scale=ps, beta=beta0,
            seed=seed, n_steps=n, thin=1, aux_dim=aux_dim,
            block_chains=block)

    rows.append(measure(warm_launch, warm_rec, positions, n_time, n_rec,
                        "warm dst_trunc-4 (headline)", n_launches=8))

    # --- exactness-matched cold baseline --------------------------------
    def cold_launch(pos, seed, n):
        return ops.fused_pcn_chain(
            phi_exact, pos, pm, ps, beta0, seed, n_steps=n,
            block_chains=block)

    def cold_rec(pos, seed, n):
        return ops.fused_pcn_chain_recorded(
            phi_exact, pos, pm, ps, beta0, seed, n_steps=n, thin=1,
            block_chains=block)

    if not args.da3_only:
        rows.append(measure(cold_launch, cold_rec, positions,
                            max(n_time // 4, 50), n_rec,
                            "cold exact-48 fused pCN", n_launches=8))

    # --- 2-level DA: 8x8 calibrated surrogate ---------------------------
    surr8, cost8 = build_coarse_surrogate(aux16, p.prior, p.data, NOISE,
                                          8, 8)
    # pass-2 frontier (first pass: monotone rising to (32, 0.25) = 6.85x
    # the warm headline at per-sample ESS 0.092 — both k and beta still
    # paying; outer acceptance 0.61, inner 0.37)
    grid = [(8, 0.08), (16, 0.08), (16, 0.15), (32, 0.15), (32, 0.25),
            (32, 0.35), (48, 0.25), (48, 0.35), (64, 0.3), (64, 0.4)]
    if args.quick:
        grid = [(8, 0.08)]
    if args.da3_only:
        grid = [(48, 0.35)]  # re-measure the 2-level optimum for the ratio
    for k, beta in grid:

        def da_launch(pos, seed, n, _k=k, _b=beta):
            return ops.fused_da_pcn_chain(
                phi_exact, surr8, pos, pm, ps, _b, seed, n_steps=n,
                subchain_len=_k, block_chains=block)

        def da_rec(pos, seed, n, _k=k, _b=beta):
            return ops.fused_da_pcn_chain_recorded(
                phi_exact, surr8, pos, pm, ps, _b, seed, n_steps=n,
                thin=1, subchain_len=_k, block_chains=block)

        row = measure(da_launch, da_rec, positions,
                      max(n_time // max(k // 2, 1), 40), n_rec,
                      f"DA k={k} b={beta} surr 8x8-cg8", n_launches=2)
        row["surrogate_cost_ratio"] = cost8
        row.update(subchain_len=k, beta=beta)
        rows.append(row)

    # --- 3-level probes: 8x8 inner -> middle -> exact -------------------
    # The 2-level plateau sits at outer accept 0.56 (not collapsed like
    # Burgers' 0.17), so the middle level has less to restore — probe
    # whether it still pays. Two middle designs:
    #   loose16: exact grid, 8 jacobi iters (~1/6 the exact cost) —
    #     measured NEGATIVE (outer accept collapses to 0.12-0.16: the
    #     middle stage selects endpoints where the truncated solve
    #     underestimates the misfit — adversarial for the fine
    #     correction);
    #   cal12: calibrated 12x12 GRID, 30 iters (cost ~0.35 of fine — the
    #     burgers-style discretization-converged middle the loose-solver
    #     result predicts should work).
    if not args.quick:
        from ip_mcmc_tpu.models import darcy as _darcy

        _, aux16b = _darcy.make_darcy_forward(
            n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
        )
        mid_loose = _darcy.make_batched_misfit(aux16b, yj, NOISE, cg_iters=8)
        mid_cal12, _cost12 = build_coarse_surrogate(
            aux16, p.prior, p.data, NOISE, 12, 30)
        da3_grid = [
            (16, 4, 0.35, mid_loose, "loose16"),
            (24, 4, 0.35, mid_loose, "loose16"),
            (16, 8, 0.35, mid_loose, "loose16"),
            (16, 4, 0.35, mid_cal12, "cal12"),
            (16, 8, 0.35, mid_cal12, "cal12"),
            (32, 4, 0.35, mid_cal12, "cal12"),
        ]
        if args.da3_only:  # loose16 already measured (negative)
            da3_grid = [r for r in da3_grid if r[4] == "cal12"]
        for k1, k2, beta, mid_b, mid_tag in da3_grid:

            def da3_launch(pos, seed, n, _k1=k1, _k2=k2, _b=beta, _m=mid_b):
                return ops.fused_da3_pcn_chain(
                    phi_exact, _m, surr8, pos, pm, ps, _b, seed,
                    n_steps=n, k_inner=_k1, k_mid=_k2, block_chains=block)

            def da3_rec(pos, seed, n, _k1=k1, _k2=k2, _b=beta, _m=mid_b):
                return ops.fused_da3_pcn_chain_recorded(
                    phi_exact, _m, surr8, pos, pm, ps, _b, seed,
                    n_steps=n, thin=1, k_inner=_k1, k_mid=_k2,
                    block_chains=block)

            row = measure(da3_launch, da3_rec, positions,
                          max(n_time // max(k1 * k2 // 4, 1), 40), n_rec,
                          f"DA3 k1={k1} k2={k2} b={beta} 8x8+{mid_tag}",
                          n_launches=2)
            row.update(k_inner=k1, k_mid=k2, beta=beta)
            rows.append(row)

    bar = rows[0]["ess_per_s"]
    for r in rows:
        r["ess_speedup_vs_warm_headline"] = r["ess_per_s"] / bar
    with open(args.out, "w") as fh:
        json.dump({"n_chains": n_chains, "rows": rows}, fh, indent=1)
    log("written:", args.out)
    best = max(rows[2:], key=lambda r: r["ess_per_s"]) if len(rows) > 2 else rows[-1]
    log(f"best DA: {best['label']} -> {best['ess_speedup_vs_warm_headline']:.2f}x "
        f"the warm headline's ESS/s")


if __name__ == "__main__":
    main()
