"""Round-4 3-level DA sweep: middle-level placement and (k1, k2) frontier.

DA3 (k1=8, k2=4, 64c inner + 128c middle) was the best Burgers row on the
earlier hardware, with the trend still rising in k2 (ESS/s on the GPU: not
measured). The named lever is middle-level placement: the middle correction
costs mid_cost_ratio per outer-middle step, so a cheaper-but-still-accurate
96c middle (cost 1/5.3, discrepancy ~2x noise vs 128c's below-noise 1/2.96)
trades correction acceptance for throughput. This sweep covers:

  - middle at 96c vs 128c (64c inner held fixed - the measured 2-level
    optimum);
  - the (k1, k2) grid extended past (8,4) in the rising direction, capped
    by compile size (the step builder unrolls k1*k2 inner steps);
  - a beta variant at the incumbent optimum (acceptance/mixing trade).

Methodology identical to benchmarks/burgers_da.py (same measure():
3-rep-median timed launches with transfer barriers, concatenated recorded
windows for honest multi-chain Geyer ESS, identical posterior by exact
correction at every level).

Usage: python benchmarks/burgers_da3_sweep.py [--quick] [--out f]
"""

import argparse
import json
import os as _os
import sys

sys.path.insert(
    0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
)

import numpy as np

from benchmarks.burgers_da import build_surrogate, log, measure


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="benchmarks/burgers_da3_sweep.json")
    args = ap.parse_args()

    import jax

    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_s=0.5)

    from ip_mcmc_tpu import configs, ops
    from ip_mcmc_tpu.models import burgers

    p = configs.build("burgers_pcn")
    n_chains = 512 if args.quick else 2048
    n_time = 200 if args.quick else 500
    n_rec = 200 if args.quick else 400
    block = 512
    pm, ps = np.asarray(p.prior.mean), np.asarray(p.prior.scale)
    phi = p.batched_potential_fn
    beta0 = p.kernel_params.get("beta", 0.15)

    n_fine = 128
    mean_fine = np.sin(2 * np.pi * (np.arange(n_fine) + 0.5) / n_fine)
    fwd_fine, aux_fine = burgers.make_burgers_forward(
        n_cells=n_fine, n_modes=16, alpha=1.5, field_scale=1.0,
        t_final=0.2, mean_profile=mean_fine,
    )
    positions = p.init_positions(jax.random.key(0), n_chains)

    rows = []

    # cold fused pCN reference (same honest-window protocol as round 3)
    def pcn_launch(pos, seed, n):
        return ops.fused_pcn_chain(
            phi, pos, pm, ps, beta0, seed, n_steps=n, block_chains=block)

    def pcn_rec(pos, seed, n):
        return ops.fused_pcn_chain_recorded(
            phi, pos, pm, ps, beta0, seed, n_steps=n, thin=1,
            block_chains=block)

    rows.append(measure(pcn_launch, pcn_rec, positions, n_time, n_rec,
                        "fused pCN (cold reference)", n_launches=8))

    surr = {
        n_c: build_surrogate(fwd_fine, aux_fine, p.prior, p.data, n_c, 1.0)
        for n_c in (64, 96, 128)
    }

    # (inner_cells, mid_cells, k1, k2, beta). Incumbent first (re-measured
    # under THIS session's windows so speedups share one reference), then
    # the rising-k2 frontier at both middle placements, then the beta
    # variant. k1*k2 <= 64 caps the unrolled program size.
    grid = [
        (64, 128, 8, 4, beta0),   # round-3 optimum, re-measured
        (64, 128, 8, 6, beta0),
        (64, 128, 8, 8, beta0),
        (64, 128, 12, 4, beta0),
        (64, 96, 8, 4, beta0),
        (64, 96, 8, 6, beta0),
        (64, 96, 12, 4, beta0),
        (64, 128, 8, 4, 0.2),
        # round-2 of the sweep: first pass measured 128c-middle dominant
        # (96c's fine-correction acceptance collapses to ~0.33), k2 rising
        # through the old k1*k2<=64 cap at (8,8)=3.41x, and beta=0.2
        # worth +20% at (8,4) — so push the (k2, beta) frontier past the
        # cap (compile time tolerated: full first-pass grid compiled+ran
        # in 9 min) and probe the k1<->k2 balance at fixed k1*k2.
        (64, 128, 8, 8, 0.2),
        (64, 128, 8, 8, 0.25),
        (64, 128, 8, 12, 0.2),
        (64, 128, 4, 16, 0.2),
        (64, 128, 12, 8, 0.2),
        # round-3 of the sweep: (8,12)@b=0.2 hit 4.65x with per-recorded-
        # sample ESS still only 0.063 (ceiling 1.0) and outer acceptance
        # holding at 0.79 — k2 is nowhere near exhausted; probe deeper.
        (64, 128, 8, 16, 0.2),
        (64, 128, 8, 24, 0.2),
        (64, 128, 8, 16, 0.25),
        # round-4 of the sweep: (8,24)@0.2 = 6.16x, per-sample ESS 0.138
        # — the k2 frontier still pays (5.60 -> 6.16 for 16 -> 24) and
        # beta=0.25 nearly matches at lower k2 (6.00 at (8,16)); probe
        # the joint (k2, beta) corner before calling the plateau.
        (64, 128, 8, 24, 0.25),
        (64, 128, 8, 32, 0.2),
        (64, 128, 8, 32, 0.25),
    ]
    if args.quick:
        grid = [(64, 128, 4, 2, beta0), (64, 96, 4, 2, beta0)]

    for n_in, n_mid, k1, k2, beta in grid:
        s_in, cost_in = surr[n_in]
        s_mid, cost_mid = surr[n_mid]

        def da3_launch(pos, seed, n, _k1=k1, _k2=k2, _b=beta,
                       _si=s_in, _sm=s_mid):
            return ops.fused_da3_pcn_chain(
                phi, _sm, _si, pos, pm, ps, _b, seed, n_steps=n,
                k_inner=_k1, k_mid=_k2, block_chains=block)

        def da3_rec(pos, seed, n, _k1=k1, _k2=k2, _b=beta,
                    _si=s_in, _sm=s_mid):
            return ops.fused_da3_pcn_chain_recorded(
                phi, _sm, _si, pos, pm, ps, _b, seed, n_steps=n,
                thin=1, k_inner=_k1, k_mid=_k2, block_chains=block)

        label = f"DA3 k1={k1} k2={k2} {n_in}c+{n_mid}c b={beta}"
        row = measure(da3_launch, da3_rec, positions,
                      max(n_time // max(k1 * k2 // 4, 1), 40), n_rec,
                      label, n_launches=2)
        row["surrogate_cost_ratio"] = cost_in
        row["mid_cost_ratio"] = cost_mid
        row.update(k_inner=k1, k_mid=k2, inner_cells=n_in,
                   mid_cells=n_mid, beta=beta)
        rows.append(row)

    base = rows[0]["ess_per_s"]
    for r in rows:
        r["ess_speedup_vs_cold"] = r["ess_per_s"] / base
    with open(args.out, "w") as fh:
        json.dump({"n_chains": n_chains, "rows": rows}, fh, indent=1)
    log("written:", args.out)
    best = max(rows[1:], key=lambda r: r["ess_per_s"])
    log(f"best DA3: {best['label']} -> {best['ess_speedup_vs_cold']:.2f}x "
        f"cold ESS/s")


if __name__ == "__main__":
    main()
