"""Burgers warm path: fused delayed-acceptance pCN vs fused plain pCN
(round-2 VERDICT missing #5 — give the reference's headline problem class
the warm-path treatment; target >=3x ESS/s over the cold fused kernel).

Surrogate design (measured over 256 prior draws, discrepancy vs the fine
128-cell / CFL~0.3 model; observation noise 0.02):

| surrogate      | cost ratio | raw disc. mean/max | note |
|----------------|-----------|--------------------|------|
| 32 cells @0.9  |  1/47     | 0.028 / 0.184      | shock points ruined |
| 64 cells @0.9  |  1/11.9   | 0.014 / 0.098      | shock resid 5x noise |
| 96 cells @0.9  |  1/5.3    | 0.007 / 0.044      | shock resid 2x noise |
| 128 cells @0.9 |  1/2.96   | 0.002 / 0.010      | BELOW noise everywhere |

The same-grid / larger-dt surrogate is the structural win: the shock
POSITION (what the tight-noise shock-adjacent observations measure) is a
grid-resolution property, so time-coarsening preserves it — and Godunov at
CFL 0.9 is LESS diffusive than at 0.3, hence the tiny discrepancy. The DA
ESS/s multiplier is bounded by k*alpha/(1 + k/r) -> r*alpha (r = cost
ratio, alpha = exact-correction acceptance), so the sweep covers the
(r, alpha) trade: 128@0.9 (alpha~1, r~3), 96@0.9 (r 5.3), 64@0.9 (r 12).

Both sides sample the IDENTICAL posterior (exact correction); both ESS
estimates use the same multi-chain Geyer estimator on a recorded series
from the same kernel that is timed.

Usage: python benchmarks/burgers_da.py [--quick] [--out f]
"""

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def measure(launch, launch_rec, positions, n_time, n_rec, label,
            n_launches=1):
    """(steps/s from a timed launch, ESS/step from a recorded one).

    Sync via a device->host transfer of the tiny acceptance row (8 KB): an
    unambiguous barrier whose cost is noise on the timed windows. Median
    of 3 reps, and an absurdity guard re-measures if a rep implies >1e9
    steps/s."""
    import jax

    from ip_mcmc_tpu import diagnostics

    n = positions.shape[0]
    out = launch(positions, 1, n_time)  # compile + burn
    pos = out[0]
    np.asarray(out[1])
    reps = []
    for rep in range(3):
        t0 = time.perf_counter()
        out = launch(pos, 100 + rep, n_time)
        np.asarray(out[1])  # transfer barrier
        dt = time.perf_counter() - t0
        if n * n_time / dt > 1e9:  # early-returning barrier; re-measure
            log(f"  [{label}] absurd rep discarded: {dt*1e3:.2f} ms")
            continue
        reps.append(dt)
    dt = float(np.median(reps))
    steps_per_s = n * n_time / dt

    # ESS series: CONCATENATE n_launches sequential recorded launches (the
    # recorded program is already compiled — no extra compile). A single
    # 400-sample window underestimates the autocorrelation time of the cold chain (tau ~ 160 steps), inflating
    # its ESS/s ~2-3x and biasing the comparison AGAINST the k-thinned DA
    # rows whose recorded samples each span k underlying steps.
    parts, pos_r = [], pos
    for j in range(n_launches):
        rec = launch_rec(pos_r, 200 + j, n_rec)
        pos_r = rec[0]
        parts.append(np.asarray(rec[-1]))
    series = np.concatenate(parts, axis=0)
    ess = float(np.asarray(diagnostics.ess_per_param(series)).min())
    ess_per_step_chain = ess / (n * len(series))
    ess_per_s = ess_per_step_chain * steps_per_s
    extra = {}
    if len(out) > 2:
        extra["inner_accept"] = float(np.asarray(out[2]).mean())
    row = {
        "label": label,
        "steps_per_s": steps_per_s,
        "accept": float(np.asarray(out[1]).mean()),
        "min_ess_series": ess,
        "ess_per_s": ess_per_s,
        **extra,
    }
    log(f"{label:30s} {steps_per_s:12,.0f} steps/s  accept "
        f"{row['accept']:.3f}  ESS/s {ess_per_s:10,.1f}"
        + (f"  inner {extra.get('inner_accept', float('nan')):.3f}"
           if extra else ""))
    return row


def build_surrogate(fwd_fine, aux_fine, prior, y, n_coarse, cfl_amax):
    """Coarse/fast-time batched surrogate misfit, two-level calibrated:
    bias-corrected by the mean fine-coarse discrepancy over prior draws and
    per-observation noise-inflated by its std (configs.burgers_da_pcn)."""
    import jax
    import jax.numpy as jnp

    from ip_mcmc_tpu.models import burgers

    n_fine = int(aux_fine["n_cells"])
    obs_fine = np.asarray(aux_fine["obs_indices"])
    obs_c = np.clip(
        np.round((obs_fine + 0.5) * n_coarse / n_fine - 0.5).astype(int),
        0, n_coarse - 1,
    )
    mean_c = np.sin(2 * np.pi * (np.arange(n_coarse) + 0.5) / n_coarse)
    fwd_c, aux_c = burgers.make_burgers_forward(
        n_cells=n_coarse, n_modes=16, alpha=1.5, field_scale=1.0,
        t_final=0.2, mean_profile=mean_c, obs_indices=obs_c,
        cfl_amax=cfl_amax,
    )
    U_cal = prior.sample(jax.random.key(402), (64,))
    d = np.asarray(jax.vmap(fwd_fine)(U_cal) - jax.vmap(fwd_c)(U_cal))
    y_surr = np.asarray(y) - d.mean(axis=0)
    scale = np.sqrt(0.02**2 + d.std(axis=0) ** 2).astype(np.float32)
    cost = (n_coarse * aux_c["n_steps"]) / (n_fine * aux_fine["n_steps"])
    return burgers.make_batched_misfit(aux_c, y_surr, scale), cost


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="benchmarks/burgers_da.json")
    args = ap.parse_args()

    import jax

    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_s=0.5)

    from ip_mcmc_tpu import configs, ops
    from ip_mcmc_tpu.models import burgers

    p = configs.build("burgers_pcn")  # the fine posterior all rows target
    # n_time stays modest; the 3-rep median + transfer barrier make the
    # short windows reliable
    n_chains = 512 if args.quick else 2048
    n_time = 200 if args.quick else 500
    n_rec = 200 if args.quick else 400
    block = 512
    pm, ps = np.asarray(p.prior.mean), np.asarray(p.prior.scale)
    phi = p.batched_potential_fn
    beta = p.kernel_params.get("beta", 0.15)

    n_fine = 128
    mean_fine = np.sin(2 * np.pi * (np.arange(n_fine) + 0.5) / n_fine)
    fwd_fine, aux_fine = burgers.make_burgers_forward(
        n_cells=n_fine, n_modes=16, alpha=1.5, field_scale=1.0,
        t_final=0.2, mean_profile=mean_fine,
    )
    positions = p.init_positions(jax.random.key(0), n_chains)

    rows = []

    def pcn_launch(pos, seed, n):
        return ops.fused_pcn_chain(
            phi, pos, pm, ps, beta, seed, n_steps=n, block_chains=block)

    def pcn_rec(pos, seed, n):
        return ops.fused_pcn_chain_recorded(
            phi, pos, pm, ps, beta, seed, n_steps=n, thin=1,
            block_chains=block)

    # 8 concatenated windows -> 3200-step span (~20 tau): honest tau for
    # the cold chain; DA rows span k*n_rec*n_launches underlying steps
    rows.append(measure(pcn_launch, pcn_rec, positions, n_time, n_rec,
                        "fused pCN (cold reference)", n_launches=8))

    # round-3 sweep history: {128,96}c x k<=24 measured 1.8-2.1x (honest
    # windows) — bounded by r*alpha with alpha flat in k once subchain
    # endpoints decorrelate; 64c@0.9 k=16 hit 2.69x with alpha=0.274 still
    # flat, so the frontier is large-k at cheap surrogates (asymptote
    # r*alpha ~ 3.2x at 64c). k capped at 48: the DA step builder unrolls
    # the subchain, so jaxpr size (and compile time) grows
    # linearly in k.
    grid = [(64, 0.9, 16), (64, 0.9, 24), (64, 0.9, 32), (64, 0.9, 48),
            (48, 0.9, 24), (48, 0.9, 32)]
    if args.quick:
        grid = [(128, 0.9, 8), (96, 0.9, 16)]
    for n_c, cfl, k in grid:
        # cfl_amax=1.0 -> effective CFL ~0.9 at the prior's |u| <= 1.8
        surr, cost = build_surrogate(fwd_fine, aux_fine, p.prior, p.data,
                                     n_c, 1.0)

        def da_launch(pos, seed, n, _k=k, _s=surr):
            return ops.fused_da_pcn_chain(
                phi, _s, pos, pm, ps, beta, seed, n_steps=n,
                subchain_len=_k, block_chains=block)

        def da_rec(pos, seed, n, _k=k, _s=surr):
            return ops.fused_da_pcn_chain_recorded(
                phi, _s, pos, pm, ps, beta, seed, n_steps=n, thin=1,
                subchain_len=_k, block_chains=block)

        row = measure(da_launch, da_rec, positions,
                      max(n_time // max(k // 4, 1), 50), n_rec,
                      f"DA k={k} surr {n_c}c@CFL0.9", n_launches=2)
        row["surrogate_cost_ratio"] = cost
        rows.append(row)

    # --- 3-level DA (round-3 P2): 64c@0.9 inner + 128c@0.9 middle --------
    # 2-level plateaus at ~2.3x because the fine-correction acceptance
    # decays with k (0.274 at k=16 -> 0.167 at k=48); the accurate middle
    # level (2-level outer acceptance 0.82) restores it while the cheap
    # inner level still does the mixing. Program size grows with k1*k2
    # (unrolled), so the grid stays small.
    surr64, cost64 = build_surrogate(fwd_fine, aux_fine, p.prior, p.data,
                                     64, 1.0)
    surr128, cost128 = build_surrogate(fwd_fine, aux_fine, p.prior, p.data,
                                       128, 1.0)
    da3_grid = [(8, 2), (4, 4), (8, 4)]
    if args.quick:
        da3_grid = [(4, 2)]
    for k1, k2 in da3_grid:

        def da3_launch(pos, seed, n, _k1=k1, _k2=k2):
            return ops.fused_da3_pcn_chain(
                phi, surr128, surr64, pos, pm, ps, beta, seed, n_steps=n,
                k_inner=_k1, k_mid=_k2, block_chains=block)

        def da3_rec(pos, seed, n, _k1=k1, _k2=k2):
            return ops.fused_da3_pcn_chain_recorded(
                phi, surr128, surr64, pos, pm, ps, beta, seed, n_steps=n,
                thin=1, k_inner=_k1, k_mid=_k2, block_chains=block)

        row = measure(da3_launch, da3_rec, positions,
                      max(n_time // max(k1 * k2 // 4, 1), 40), n_rec,
                      f"DA3 k1={k1} k2={k2} 64c+128c", n_launches=2)
        row["surrogate_cost_ratio"] = cost64
        row["mid_cost_ratio"] = cost128
        rows.append(row)

    base = rows[0]["ess_per_s"]
    for r in rows:
        r["ess_speedup_vs_cold"] = r["ess_per_s"] / base
    with open(args.out, "w") as fh:
        json.dump({"n_chains": n_chains, "rows": rows}, fh, indent=1)
    log("written:", args.out)
    best = max(rows[1:], key=lambda r: r["ess_per_s"])
    log(f"best DA: {best['label']} -> {best['ess_speedup_vs_cold']:.2f}x "
        f"cold ESS/s")


if __name__ == "__main__":
    main()
