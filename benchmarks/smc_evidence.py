"""SMC log-evidence with error bars (round-2 VERDICT missing #2 / weak #2).

Every previous log-Z comparison was single-seed; the earlier claims
("inside the resampling-noise error bar", "TI brackets it") were therefore
unbacked. This harness replicates each estimator K times over independent
seeds and reports mean ± std per cell:

- NumPy oracle (reference-equivalent ``tests/oracle/oracle_mcmc.smc_tempered``)
  at 256 particles (the oracle is ~200 evals/s — 4096 particles would take
  hours per seed; the GPU cells cover the width axis);
- GPU cold path (``smc.run``) at 256 and 4096 particles;
- GPU warm path (``smc.run_batched`` + warm-DST mutation) at 256 and 4096;
- thermodynamic-integration cross-estimate per GPU run (same samples,
  different estimator).

Verdicts printed: the cross-side gap at equal N in units of the combined
spread, and whether the TI estimate is statistically consistent (NOT
"bracketing" — TI from the same adaptive ladder is a one-sided-biased
estimator at finite stage count).

Environment pinning: BLAS threads forced to 1 BEFORE numpy import so the
oracle rows are reproducible across rounds (round-2 VERDICT weak #5: a
1.6× oracle swing made the headline trend unreadable).

Usage: python benchmarks/smc_evidence.py [--seeds 10] [--quick] [--out f]
"""

import os

for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
           "VECLIB_MAXIMUM_THREADS", "NUMEXPR_NUM_THREADS"):
    os.environ[_v] = "1"

import argparse
import json
import platform
import time

import numpy as np


def _stats(xs):
    xs = np.asarray(xs, np.float64)
    return {
        "values": [round(float(v), 4) for v in xs],
        "mean": float(xs.mean()),
        "std": float(xs.std(ddof=1)) if len(xs) > 1 else 0.0,
        "n": int(len(xs)),
    }


def run_cells(n_seeds, quick):
    import jax

    from benchmarks.oracle_darcy import OracleDarcyPCN
    from ip_mcmc_tpu import configs, smc
    from tests.oracle import oracle_mcmc as om

    problem_cold = configs.build("darcy_smc")
    problem_warm = configs.build("darcy_smc_warm")
    kp = dict(problem_cold.kernel_params)
    n_small = 128 if quick else 256
    n_large = 1024 if quick else 4096
    seeds = list(range(n_seeds))

    out = {"n_small": n_small, "n_large": n_large, "seeds": seeds}

    # --- oracle at n_small --------------------------------------------------
    oracle = OracleDarcyPCN()
    y = np.asarray(problem_cold.data)
    pot = lambda u: oracle.potential(u, y, 0.002)
    logzs, t0 = [], time.perf_counter()
    for s in seeds:
        rng = np.random.default_rng(1000 + s)
        _, lz, _, _ = om.smc_tempered(
            pot, lambda r: r.standard_normal(oracle.K), n_small, rng,
            ess_target=kp["ess_target"], mutation_steps=kp["mutation_steps"],
            pcn_step=kp["pcn_step"], max_stages=kp["max_stages"],
        )
        logzs.append(lz)
    out["oracle_small"] = _stats(logzs)
    out["oracle_small"]["wall_s"] = time.perf_counter() - t0

    # --- GPU cold (smc.run) at n_small and n_large --------------------------
    def dev_cold(n):
        lz, ti = [], []
        for s in seeds:
            state, info = smc.run(
                problem_cold.potential_fn, problem_cold.prior,
                jax.random.key(s), n_particles=n, **kp,
            )
            jax.block_until_ready(state.particles)
            lz.append(float(state.log_z))
            ti.append(smc.thermodynamic_log_z(info))
        return lz, ti

    for label, n in (("dev_cold_small", n_small), ("dev_cold_large", n_large)):
        lz, ti = dev_cold(n)
        out[label] = _stats(lz)
        out[label + "_ti"] = _stats(ti)

    # --- GPU warm (smc.run_batched) at n_small and n_large ------------------
    phi2, aux_dim = problem_warm.batched_warm_potential
    wkp = dict(problem_warm.kernel_params)
    wkp.pop("batched", None)
    wkp.pop("warm", None)

    def dev_warm(n):
        lz, ti = [], []
        for s in seeds:
            state, info = smc.run_batched(
                problem_warm.batched_potential_fn,
                np.asarray(problem_warm.prior.mean),
                np.asarray(problem_warm.prior.scale),
                jax.random.key(s), n_particles=n,
                warm_potential_fn=phi2, aux_dim=aux_dim, **wkp,
            )
            jax.block_until_ready(state.particles)
            lz.append(float(state.log_z))
            ti.append(smc.thermodynamic_log_z(info))
        return lz, ti

    for label, n in (("dev_warm_small", n_small), ("dev_warm_large", n_large)):
        lz, ti = dev_warm(n)
        out[label] = _stats(lz)
        out[label + "_ti"] = _stats(ti)

    # --- verdicts ------------------------------------------------------------
    def gap_sigma(a, b):
        """|mean gap| in units of the combined seed-to-seed spread."""
        sd = float(np.hypot(a["std"], b["std"]))
        return {
            "gap": abs(a["mean"] - b["mean"]),
            "combined_std": sd,
            "gap_in_sigma": abs(a["mean"] - b["mean"]) / sd if sd else None,
        }

    out["verdict_cold_vs_oracle_small"] = gap_sigma(
        out["dev_cold_small"], out["oracle_small"])
    out["verdict_warm_vs_oracle_small"] = gap_sigma(
        out["dev_warm_small"], out["oracle_small"])
    out["verdict_warm_vs_cold_large"] = gap_sigma(
        out["dev_warm_large"], out["dev_cold_large"])
    out["environment"] = {
        "blas_threads": 1,
        "python": platform.python_version(),
        "machine": platform.machine(),
        "jax_backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
    }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="benchmarks/smc_evidence.json")
    args = ap.parse_args()
    res = run_cells(args.seeds, args.quick)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    for k in ("oracle_small", "dev_cold_small", "dev_warm_small",
              "dev_cold_large", "dev_warm_large"):
        r = res[k]
        print(f"{k:18s} logZ = {r['mean']:8.3f} ± {r['std']:.3f}  (n={r['n']})")
    for k in ("verdict_cold_vs_oracle_small", "verdict_warm_vs_oracle_small",
              "verdict_warm_vs_cold_large"):
        v = res[k]
        print(f"{k}: gap {v['gap']:.3f} = {v['gap_in_sigma']:.2f}σ")
    print("written:", args.out)


if __name__ == "__main__":
    main()
