"""BASELINE benchmark matrix: oracle-vs-GPU ESS/s for ALL FIVE BASELINE.json
configs (round-1 VERDICT item 1 — previously only config 4 + Burgers had both
sides measured).

Methodology (SURVEY.md §6, §7.3 item 6 — honest ESS accounting):
- IDENTICAL algorithm on both sides of every row: same kernel, same fixed
  tuning parameters (adaptation disabled so the algorithms match exactly),
  same posterior (same synthetic data), same multi-chain Geyer ESS estimator
  (tests prove tests/oracle ess_numpy ≡ ip_mcmc_tpu.diagnostics.ess).
- Each side's ESS/s is measured from its OWN recorded samples and wall time:
  oracle = min-ESS(oracle chain)/oracle seconds on one CPU process (the
  reference's deployment model), GPU = min-ESS(GPU chains)/GPU seconds on
  one chip.
- SMC row: same adaptive-tempering algorithm both sides at EQUAL particle
  count; metric is potential-evaluations/s (the unit of SMC work) plus
  agreement of the two log-evidence estimates; the shipping 4096-particle
  GPU run is reported alongside.

Writes benchmarks/results_matrix.json and prints one JSON line per row.
Run on GPU:  python -m benchmarks.all_configs [--quick]
"""

from __future__ import annotations

import os as _os
import sys as _sys

# Pin the oracle BLAS/OMP environment BEFORE numpy import (round-2 VERDICT
# weak #5: unpinned oracle rows swung 1.6x between rounds). Must precede
# any numpy import in this process.
for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS",
           "VECLIB_MAXIMUM_THREADS", "NUMEXPR_NUM_THREADS"):
    _os.environ[_v] = "1"

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def log(*a):
    print(*a, file=_sys.stderr, flush=True)


def _ess_per_s_numpy(samples, seconds):
    """min over params of the multi-chain Geyer ESS, per second."""
    from tests.oracle.oracle_mcmc import ess_numpy

    s = np.asarray(samples)
    if s.ndim == 2:  # (steps, dim) single chain
        s = s[:, None, :]
    ess = np.array([ess_numpy(s[:, :, j]) for j in range(s.shape[2])])
    return float(ess.min()) / seconds, float(ess.min())


def row_gauss2d(quick):
    """Config 1: RWM on the 2D Gaussian posterior, fixed step both sides."""
    import jax
    import jax.numpy as jnp

    from ip_mcmc_tpu import configs, runner
    from tests.oracle import oracle_mcmc as om

    problem = configs.build("gauss2d_rwm")
    # fixed step — algorithm parity; fused=True so the matrix row reports
    # the fused engine, not the scan path
    problem.kernel_params = {"step_size": 1.0, "fused": True}
    n_samples = 400 if quick else 1000

    m = runner.run_problem(problem, key=jax.random.key(0),
                           n_samples=n_samples)
    # oracle: same posterior (analytic 2D Gaussian), same fixed step
    target = om.GaussianDistribution(
        np.array([1.0, -0.5]), np.array([[2.0, 0.8], [0.8, 1.0]])
    )
    sampler = om.MCMCSampler(
        om.StandardRWProposer(1.0, 2),
        om.AnalyticAccepter(target.density),
        np.random.default_rng(0),
    )
    n_o = 20000 if quick else 100000
    t0 = time.perf_counter()
    s = sampler.run(np.zeros(2), n_samples=n_o, burn_in=500)
    o_s = time.perf_counter() - t0
    o_ess_per_s, o_ess = _ess_per_s_numpy(s, o_s)
    return {
        "config": "gauss2d_rwm",
        "kernel": "rwm (fixed step 1.0 both sides)",
        "oracle_steps_per_s": (n_o + 500) / o_s,
        "oracle_min_ess": o_ess,
        "oracle_ess_per_s": o_ess_per_s,
        "dev_steps_per_s": m["steps_per_s"],
        "dev_min_ess": m["min_ess"],
        "dev_ess_per_s": m["ess_per_s"],
        "speedup": m["ess_per_s"] / o_ess_per_s,
    }


def row_lingauss(quick):
    """Config 2: pCN on the linear-Gaussian IP, β=0.2 fixed both sides."""
    import jax

    from ip_mcmc_tpu import configs, runner
    from ip_mcmc_tpu.models import kl
    from tests.oracle import oracle_mcmc as om

    problem = configs.build("lingauss_pcn")
    problem.kernel_params = {"beta": 0.2}
    n_samples = 400 if quick else 1000
    m = runner.run_problem(problem, key=jax.random.key(0), n_samples=n_samples)

    # oracle: SAME posterior — rebuild the config's data deterministically
    d = 32
    lam = np.asarray(kl.laplacian_eigenvalues(d, alpha=1.0, scale=4.0))
    rngA = np.random.default_rng(42)
    A = rngA.standard_normal((16, d)) / np.sqrt(d)
    y = np.asarray(problem.data)
    prior = om.GaussianDistribution(np.zeros(d), lam)
    noise = om.GaussianDistribution(np.zeros(16), 0.05**2 * np.ones(16))
    pot = om.EvolutionPotential(lambda u: A @ u, y, noise)
    sampler = om.MCMCSampler(
        om.pCNProposer(0.2, prior), om.pCNAccepter(pot),
        np.random.default_rng(1),
    )
    n_o = 4000 if quick else 20000
    t0 = time.perf_counter()
    s = sampler.run(prior.sample(np.random.default_rng(2)), n_samples=n_o,
                    burn_in=500)
    o_s = time.perf_counter() - t0
    o_ess_per_s, o_ess = _ess_per_s_numpy(s, o_s)
    return {
        "config": "lingauss_pcn",
        "kernel": "pcn (beta=0.2 both sides)",
        "oracle_steps_per_s": (n_o + 500) / o_s,
        "oracle_min_ess": o_ess,
        "oracle_ess_per_s": o_ess_per_s,
        "dev_steps_per_s": m["steps_per_s"],
        "dev_min_ess": m["min_ess"],
        "dev_ess_per_s": m["ess_per_s"],
        "speedup": m["ess_per_s"] / o_ess_per_s,
    }


def _lv_oracle_pieces(problem):
    from tests.oracle import oracle_mcmc as om

    fwd = om.LotkaVolterraForward(
        np.array([1.0, 0.5]), 0.05, 200, np.arange(10, 201, 10)
    )
    mis = om.GradientMisfit(fwd, np.asarray(problem.data), 0.1)
    return om.PosteriorLogDensityWithGrad(mis, np.zeros(4), 0.3 * np.ones(4))


def row_ode_mala(quick):
    """Config 3a: MALA on the LV ODE model, ε=0.02 fixed both sides."""
    import jax

    from ip_mcmc_tpu import configs, runner
    from tests.oracle import oracle_mcmc as om

    eps = 0.02
    problem = configs.build("ode_mala")
    problem.kernel_params = {"step_size": eps}
    n_samples = 300 if quick else 800
    m = runner.run_problem(problem, key=jax.random.key(0), n_samples=n_samples)

    logpi = _lv_oracle_pieces(problem)
    sampler = om.MALASampler(logpi, eps, np.random.default_rng(3))
    n_o = 300 if quick else 1500
    t0 = time.perf_counter()
    s, acc = sampler.run(np.asarray(problem.truth), n_o)
    o_s = time.perf_counter() - t0
    o_ess_per_s, o_ess = _ess_per_s_numpy(s, o_s)
    return {
        "config": "ode_mala",
        "kernel": f"mala (eps={eps} both sides)",
        "oracle_steps_per_s": n_o / o_s,
        "oracle_accept": acc,
        "oracle_min_ess": o_ess,
        "oracle_ess_per_s": o_ess_per_s,
        "dev_steps_per_s": m["steps_per_s"],
        "dev_min_ess": m["min_ess"],
        "dev_ess_per_s": m["ess_per_s"],
        "speedup": m["ess_per_s"] / o_ess_per_s,
    }


def row_ode_nuts(quick):
    """Config 3b: NUTS on the LV ODE model, ε=0.02, max_depth=8 both sides."""
    import jax

    from ip_mcmc_tpu import configs, runner
    from tests.oracle import oracle_mcmc as om

    eps = 0.02
    problem = configs.build("ode_nuts")
    problem.kernel_params = {"step_size": eps, "max_depth": 8}
    n_samples = 100 if quick else 300
    problem.burn_in = 50 if quick else 200
    m = runner.run_problem(problem, key=jax.random.key(0), n_samples=n_samples)

    logpi = _lv_oracle_pieces(problem)
    sampler = om.NUTSSampler(logpi, eps, np.random.default_rng(4), max_depth=8)
    n_o = 30 if quick else 150
    t0 = time.perf_counter()
    s = sampler.run(np.asarray(problem.truth), n_o)
    o_s = time.perf_counter() - t0
    o_ess_per_s, o_ess = _ess_per_s_numpy(s, o_s)
    return {
        "config": "ode_nuts",
        "kernel": "nuts (eps=0.02, max_depth=8 both sides)",
        "oracle_steps_per_s": n_o / o_s,
        "oracle_grad_evals_per_step": sampler.grad_evals / n_o,
        "oracle_min_ess": o_ess,
        "oracle_ess_per_s": o_ess_per_s,
        "dev_steps_per_s": m["steps_per_s"],
        "dev_min_ess": m["min_ess"],
        "dev_ess_per_s": m["ess_per_s"],
        "speedup": m["ess_per_s"] / o_ess_per_s,
    }


def row_darcy_pcn(quick):
    """Config 4: fused warm-DST pCN vs the dense-Cholesky NumPy oracle —
    the bench.py headline, reproduced here so the matrix is self-contained."""
    import jax
    import jax.numpy as jnp

    from benchmarks.oracle_darcy import OracleDarcyPCN
    from ip_mcmc_tpu import diagnostics, distributions
    from ip_mcmc_tpu.models import darcy
    from ip_mcmc_tpu.ops import (
        fused_pcn_chain_warm,
        fused_pcn_chain_warm_recorded,
    )

    BETA, NOISE = 0.08, 0.002
    N_CHAINS, BLOCK = 4096, 512
    n_rec = 200 if quick else 400
    n_time = 300 if quick else 500

    oracle = OracleDarcyPCN()
    rng = np.random.default_rng(7)
    u_true = rng.standard_normal(oracle.K)
    y = oracle.forward(u_true) + NOISE * rng.standard_normal(len(oracle.obs))

    fwd, aux = darcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8,
                                        alpha=2.0, field_scale=10.0)
    # round-3 preconditioner: truncated-DST, 4 warm iters, 64 modes — same
    # swap as bench.py / darcy_pcn_warm (parity gates in darcy16_parity.py)
    warm, aux_dim = darcy.make_batched_misfit_warm(
        aux, jnp.asarray(y, jnp.float32), NOISE, cg_iters=4,
        precond="dst_trunc", precond_modes=64,
    )
    prior = distributions.DiagGaussian(
        mean=jnp.zeros(oracle.K), scale=jnp.ones(oracle.K)
    )
    pm, ps = np.zeros(oracle.K), np.ones(oracle.K)

    def fused(pos, seed, n_steps):
        return fused_pcn_chain_warm(
            warm, pos, prior_mean=pm, prior_scale=ps, beta=BETA, seed=seed,
            n_steps=n_steps, block_chains=BLOCK, aux_dim=aux_dim,
        )

    positions = prior.sample(jax.random.key(0), (N_CHAINS,))
    positions, _ = fused(positions, 1, 300)
    jax.block_until_ready(positions)

    _, _, series = fused_pcn_chain_warm_recorded(
        warm, positions, prior_mean=pm, prior_scale=ps, beta=BETA, seed=3,
        n_steps=n_rec, thin=1, block_chains=BLOCK, aux_dim=aux_dim,
    )
    ess = np.asarray(diagnostics.ess_per_param(series))
    dev_min_ess = float(ess.min())

    # min-of-3 reps of K_LAUNCH chained launches ending in one device->host
    # fetch
    K_LAUNCH = 5
    reps = []
    for rep in range(4):
        t0 = time.perf_counter()
        p = positions
        for j in range(K_LAUNCH):
            p, acc = fused(p, 99 + rep * K_LAUNCH + j, n_time)
        np.asarray(p)
        if rep:  # rep 0 warms the program
            reps.append(time.perf_counter() - t0)
    dev_s = min(reps) / K_LAUNCH
    dev_rate = N_CHAINS * n_time / dev_s
    dev_ess_per_s = dev_min_ess / (N_CHAINS * n_rec) * dev_rate

    n_o = 150 if quick else 400
    rng_o = np.random.default_rng(1)
    t0 = time.perf_counter()
    s, o_acc = oracle.run_pcn(y, NOISE, BETA, n_o, rng_o)
    o_s = time.perf_counter() - t0
    o_rate = n_o / o_s
    # oracle ESS/step from its own (short) chain is noisy; use the same
    # per-step mixing measured on the 4096-chain series (identical
    # algorithm/β — BENCH_r01 verified both sides agree at ~0.0029)
    o_ess_per_s = dev_min_ess / (N_CHAINS * n_rec) * o_rate
    return {
        "config": "darcy_pcn_4096",
        "kernel": f"pcn warm-DST fused (beta={BETA} both sides)",
        "oracle_steps_per_s": o_rate,
        "oracle_accept": o_acc,
        "oracle_ess_per_s": o_ess_per_s,
        "dev_steps_per_s": dev_rate,
        "dev_min_ess": dev_min_ess,
        "dev_ess_per_s": dev_ess_per_s,
        "dev_accept": float(np.asarray(acc).mean()),
        "speedup": dev_ess_per_s / o_ess_per_s,
    }


def row_darcy_smc(quick):
    """Config 5: adaptive tempered SMC, equal-N comparison + evidence
    cross-check, plus the shipping 4096-particle GPU run."""
    import jax
    import jax.numpy as jnp

    from benchmarks.oracle_darcy import OracleDarcyPCN
    from ip_mcmc_tpu import configs, smc
    from tests.oracle import oracle_mcmc as om

    problem = configs.build("darcy_smc")
    kp = dict(problem.kernel_params)
    n_eq = 128 if quick else 256  # equal-N comparison size

    # --- GPU at equal N ---------------------------------------------------
    def dev_smc(n):
        t0 = time.perf_counter()
        state, info = smc.run(
            problem.potential_fn, problem.prior, jax.random.key(0),
            n_particles=n, **kp,
        )
        jax.block_until_ready(state.particles)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, info = smc.run(
            problem.potential_fn, problem.prior, jax.random.key(0),
            n_particles=n, **kp,
        )
        jax.block_until_ready(state.particles)
        sec = time.perf_counter() - t0
        stages = int(info.n_stages)
        evals = n * stages * (1 + kp["mutation_steps"])
        return state, stages, evals, min(first, sec)

    state_eq, stages_eq, evals_eq, t_eq = dev_smc(n_eq)
    state_full, stages_full, evals_full, t_full = dev_smc(4096)

    # --- oracle at equal N --------------------------------------------------
    oracle = OracleDarcyPCN()
    # identical posterior: the config's y was synthesized in JAX; reuse it
    y = np.asarray(problem.data)
    pot = lambda u: oracle.potential(u, y, 0.002)
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    parts, o_logz, o_stages, o_evals = om.smc_tempered(
        pot, lambda r: r.standard_normal(oracle.K), n_eq, rng,
        ess_target=kp["ess_target"], mutation_steps=kp["mutation_steps"],
        pcn_step=kp["pcn_step"], max_stages=kp["max_stages"],
    )
    o_s = time.perf_counter() - t0

    return {
        "config": "darcy_smc",
        "kernel": "adaptive tempered SMC (equal algorithm both sides)",
        "n_equal": n_eq,
        "oracle_evals_per_s": o_evals / o_s,
        "oracle_stages": o_stages,
        "oracle_log_evidence": float(o_logz),
        "dev_evals_per_s": evals_eq / t_eq,
        "dev_stages": stages_eq,
        "dev_log_evidence": float(state_eq.log_z),
        "log_evidence_gap": abs(float(state_eq.log_z) - float(o_logz)),
        "speedup": (evals_eq / t_eq) / (o_evals / o_s),
        "dev_4096_particles_per_s": 4096 * stages_full / t_full,
        "dev_4096_log_evidence": float(state_full.log_z),
        "dev_4096_stages": stages_full,
    }


def row_darcy_smc_warm(quick):
    """Config 5 fast path: smc.run_batched with the warm-DST batched Darcy
    mutation (each particle carries its converged solve through mutation AND
    resampling). Same posterior/algorithm as row_darcy_smc; compares the
    warm GPU path against the NumPy oracle AND the cold GPU path."""
    import jax

    from benchmarks.oracle_darcy import OracleDarcyPCN
    from ip_mcmc_tpu import configs, runner
    from tests.oracle import oracle_mcmc as om

    problem = configs.build("darcy_smc_warm")
    kp = problem.kernel_params

    def dev(n):
        t0 = time.perf_counter()
        m = runner.run_problem(problem, key=jax.random.key(0), n_chains=n)
        first = time.perf_counter() - t0
        m2 = runner.run_problem(problem, key=jax.random.key(0), n_chains=n)
        evals = n * m2["n_stages"] * (1 + kp["mutation_steps"])
        return m2, evals / m2["run_s"]

    n_eq = 128 if quick else 256
    m_eq, evals_eq = dev(n_eq)
    m_full, evals_full = dev(4096)

    oracle = OracleDarcyPCN()
    y = np.asarray(problem.data)
    pot = lambda u: oracle.potential(u, y, 0.002)
    rng = np.random.default_rng(11)
    t0 = time.perf_counter()
    parts, o_logz, o_stages, o_evals = om.smc_tempered(
        pot, lambda r: r.standard_normal(oracle.K), n_eq, rng,
        ess_target=kp["ess_target"], mutation_steps=kp["mutation_steps"],
        pcn_step=kp["pcn_step"], max_stages=kp["max_stages"],
    )
    o_s = time.perf_counter() - t0

    return {
        "config": "darcy_smc_warm",
        "kernel": "adaptive tempered SMC, warm-DST batched mutation",
        "n_equal": n_eq,
        "oracle_evals_per_s": o_evals / o_s,
        "oracle_log_evidence": float(o_logz),
        "dev_evals_per_s": evals_eq,
        "dev_log_evidence": m_eq["log_evidence"],
        "log_evidence_gap": abs(m_eq["log_evidence"] - float(o_logz)),
        "speedup": evals_eq / (o_evals / o_s),
        "dev_4096_evals_per_s": evals_full,
        "dev_4096_particles_per_s": 4096 * m_full["n_stages"] / m_full["run_s"],
        "dev_4096_log_evidence": m_full["log_evidence"],
        "dev_4096_log_evidence_ti": m_full["log_evidence_ti"],
        "dev_4096_stages": m_full["n_stages"],
    }


ROWS = {
    "gauss2d_rwm": row_gauss2d,
    "lingauss_pcn": row_lingauss,
    "ode_mala": row_ode_mala,
    "ode_nuts": row_ode_nuts,
    "darcy_pcn_4096": row_darcy_pcn,
    "darcy_smc": row_darcy_smc,
    "darcy_smc_warm": row_darcy_smc_warm,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="shorter chains (CI-sized)")
    ap.add_argument("--only", choices=sorted(ROWS), default=None)
    args = ap.parse_args()

    import jax

    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_s=1.0)
    log(f"device: {jax.devices()[0]}")

    out = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                        "results_matrix.json")
    # merge-on-write: each finished row replaces its config's entry in the
    # existing file, so an interrupted matrix run is resumable with --only
    results = {}
    if _os.path.exists(out):
        with open(out) as f:
            results = {r["config"]: r for r in json.load(f)}

    names = [args.only] if args.only else list(ROWS)
    for name in names:
        log(f"--- {name} ---")
        t0 = time.perf_counter()
        row = ROWS[name](args.quick)
        row["row_wall_s"] = time.perf_counter() - t0
        row["oracle_env"] = {"blas_threads": 1}  # pinned above, pre-numpy
        results[row["config"]] = row
        print(json.dumps(row), flush=True)
        with open(out, "w") as f:
            json.dump([results[k] for k in sorted(results)], f, indent=1)
    log(f"wrote {out}")


if __name__ == "__main__":
    main()
