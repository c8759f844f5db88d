"""Delayed-acceptance pCN: exactness of the two-level correction.

The surrogate may be ARBITRARILY wrong — the exact-potential correction must
still produce the right posterior (only efficiency degrades). That is the
defining property tested here, alongside degenerate-surrogate behavior and
the runner/config wiring.
"""

import jax
import jax.numpy as jnp
import numpy as np

from ip_mcmc_tpu import driver
from ip_mcmc_tpu.distributions import DiagGaussian
from ip_mcmc_tpu.kernels import da_pcn, pcn


def _run(kernel, init_fn, n_chains=128, n_samples=500, burn_in=300, key=7):
    key_init, key_run = jax.random.split(jax.random.key(key))
    prior = DiagGaussian(mean=jnp.zeros(2), scale=jnp.ones(2))
    positions = prior.sample(key_init, (n_chains,))
    state = jax.vmap(init_fn)(positions)
    return driver.sample_chains(
        kernel, state, key_run, n_samples=n_samples, burn_in=burn_in
    )


class TestDAPCN:
    # posterior for prior N(0, I), likelihood y = u + N(0, I), y = (1, 1):
    # N(y/2, I/2)
    y = jnp.array([1.0, 1.0])

    @staticmethod
    def phi(u):
        return 0.5 * jnp.sum((TestDAPCN.y - u) ** 2)

    def test_exact_posterior_with_biased_surrogate(self):
        """Surrogate with the WRONG data and wrong scale: posterior must
        still match the closed form (correction is exact)."""
        prior = DiagGaussian(mean=jnp.zeros(2), scale=jnp.ones(2))
        surrogate = lambda u: 0.35 * jnp.sum((u - 0.3) ** 2)  # wrong on purpose
        kernel = da_pcn.build_kernel(
            self.phi, surrogate, prior, beta=0.5, subchain_len=4
        )
        _, samples, infos = _run(
            kernel, lambda p: da_pcn.init(p, self.phi, surrogate)
        )
        flat = np.asarray(samples).reshape(-1, 2)
        np.testing.assert_allclose(flat.mean(axis=0), [0.5, 0.5], atol=0.06)
        np.testing.assert_allclose(np.cov(flat.T), 0.5 * np.eye(2), atol=0.12)
        acc = np.asarray(infos.accepted).mean()
        assert 0.05 < acc < 1.0

    def test_perfect_surrogate_always_accepts_correction(self):
        """Φ* = Φ ⇒ the outer correction ratio is exactly 1."""
        prior = DiagGaussian(mean=jnp.zeros(2), scale=jnp.ones(2))
        kernel = da_pcn.build_kernel(
            self.phi, self.phi, prior, beta=0.5, subchain_len=3
        )
        _, _, infos = _run(
            kernel,
            lambda p: da_pcn.init(p, self.phi, self.phi),
            n_samples=100,
            burn_in=20,
        )
        np.testing.assert_allclose(np.asarray(infos.accept_prob), 1.0, atol=1e-5)
        # inner stage behaves like plain pCN: strictly between 0 and 1
        inner = np.asarray(infos.inner_accept_rate).mean()
        assert 0.2 < inner < 0.98

    def test_matches_plain_pcn_distribution(self):
        """DA-pCN with a good surrogate and plain pCN sample the same
        posterior (moments agree within MC error)."""
        prior = DiagGaussian(mean=jnp.zeros(2), scale=jnp.ones(2))
        surrogate = lambda u: 0.5 * jnp.sum((self.y - u) ** 2) * 1.1
        da_kernel = da_pcn.build_kernel(
            self.phi, surrogate, prior, beta=0.5, subchain_len=4
        )
        _, s_da, _ = _run(da_kernel, lambda p: da_pcn.init(p, self.phi, surrogate))
        plain = pcn.build_kernel(self.phi, prior, beta=0.5)
        _, s_p, _ = _run(plain, lambda p: pcn.init(p, self.phi), key=11)
        m_da = np.asarray(s_da).reshape(-1, 2).mean(0)
        m_p = np.asarray(s_p).reshape(-1, 2).mean(0)
        np.testing.assert_allclose(m_da, m_p, atol=0.05)

    def test_validation(self):
        prior = DiagGaussian(mean=jnp.zeros(2), scale=jnp.ones(2))
        import pytest

        with pytest.raises(ValueError):
            da_pcn.build_kernel(self.phi, self.phi, prior, beta=1.5)
        with pytest.raises(ValueError):
            da_pcn.build_kernel(self.phi, self.phi, prior, beta=0.5, subchain_len=0)


class TestDarcyDAConfig:
    def test_runner_smoke(self):
        """darcy_da_pcn config runs end-to-end through the runner (tiny)."""
        from ip_mcmc_tpu import configs, runner

        p = configs.build("darcy_da_pcn")
        p.n_chains, p.n_samples, p.burn_in = 64, 20, 10
        metrics = runner.run_problem(p)
        assert metrics["kernel"] == "da_pcn"
        assert 0.0 <= metrics["accept_rate"] <= 1.0
        assert np.isfinite(metrics["min_ess"])

    def test_surrogate_cheaper_than_exact(self):
        """The loose-CG surrogate tracks the exact potential to a few
        percent on prior draws (sanity of the two-level setup)."""
        from ip_mcmc_tpu import configs

        p = configs.build("darcy_da_pcn")
        u = p.prior.sample(jax.random.key(5), (8,))
        exact = jax.vmap(p.potential_fn)(u)
        surr = jax.vmap(p.surrogate_potential_fn)(u)
        # same order of magnitude — correlated enough to be a useful filter
        ratio = np.asarray(surr) / np.asarray(exact)
        assert np.all(ratio > 0.2) and np.all(ratio < 5.0)


class TestPODSurrogate:
    def test_pod_tracks_exact_misfit(self):
        """Rank-20 POD surrogate correlates tightly with the full misfit on
        prior draws (offline basis spans the prior solution manifold)."""
        from ip_mcmc_tpu import configs

        p = configs.build("darcy_da_pod")
        u = p.prior.sample(jax.random.key(11), (16,))
        exact = np.asarray(jax.vmap(p.potential_fn)(u))
        surr = np.asarray(jax.vmap(p.surrogate_potential_fn)(u))
        # strong rank correlation + same scale
        corr = np.corrcoef(exact, surr)[0, 1]
        assert corr > 0.95, corr
        ratio = surr / exact
        assert np.all(ratio > 0.3) and np.all(ratio < 3.0), ratio

    def test_da_pod_runner_smoke(self):
        from ip_mcmc_tpu import configs, runner

        p = configs.build("darcy_da_pod")
        p.n_chains, p.n_samples, p.burn_in = 64, 20, 10
        m = runner.run_problem(p)
        assert m["kernel"] == "da_pcn"
        assert 0.0 < m["accept_rate"] <= 1.0

    def test_choose_pod_rank_energy_criterion(self):
        from ip_mcmc_tpu.models import darcy

        # squared energies 0.5, 0.25, ...: tail after r is 2^-r
        s = np.sqrt(0.5 ** np.arange(1, 21))
        assert darcy.choose_pod_rank(s, energy_tol=0.3) == 2
        assert darcy.choose_pod_rank(s, energy_tol=1e-3) == 10
        assert darcy.choose_pod_rank(s, energy_tol=1e-3, max_rank=4) == 4
        # min_rank floor engages when the criterion would pick rank 1
        assert darcy.choose_pod_rank(s, energy_tol=0.9) == 2
        import pytest
        with pytest.raises(ValueError):
            darcy.choose_pod_rank(np.array([]))

    def test_pod_auto_rank_and_greedy_enrichment(self):
        """rank="auto" sizes the basis from the snapshot spectrum, and
        weak-greedy rounds append full solves at the worst reduced-residual
        candidates (ROADMAP P2), without degrading surrogate quality."""
        from ip_mcmc_tpu import configs
        from ip_mcmc_tpu.models import darcy

        p = configs.build("darcy_da_pod")
        _, aux = darcy.make_darcy_forward(
            n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
        )
        y = p.data
        base, info0 = darcy.make_pod_surrogate(
            aux, y, 0.002, jax.random.key(5), n_snapshots=32, rank="auto",
            energy_tol=1e-8, return_info=True,
        )
        assert 2 <= info0["rank"] <= 32
        assert info0["n_snapshots"] == 32
        enr, info1 = darcy.make_pod_surrogate(
            aux, y, 0.002, jax.random.key(5), n_snapshots=32, rank="auto",
            energy_tol=1e-8, greedy_rounds=2, n_candidates=64,
            greedy_batch=8, return_info=True,
        )
        assert info1["n_snapshots"] == 32 + 16
        assert len(info1["residual_history"]) == 2
        # enrichment tightens (or at least does not inflate) the indicator
        # across rounds (fresh candidate sets each round → generous margin)
        assert (info1["residual_history"][-1]["mean"]
                <= info1["residual_history"][0]["mean"] * 1.5)
        # quality on fresh validation draws: enriched surrogate tracks the
        # full misfit at least as well as the base one (generous margin for
        # MC noise)
        u = p.prior.sample(jax.random.key(123), (24,))
        exact = np.asarray(jax.vmap(p.potential_fn)(u))
        e_base = np.abs(np.asarray(jax.vmap(base)(u)) - exact).mean()
        e_enr = np.abs(np.asarray(jax.vmap(enr)(u)) - exact).mean()
        assert e_enr <= e_base * 1.2, (e_base, e_enr)


class TestPODOnlineEnrichment:
    """Round-4 (VERDICT item 6): error-indicator-driven ONLINE enrichment
    during DA sampling — runner._pod_enrich_burnin +
    darcy.make_pod_surrogate_online."""

    def test_online_enrichment_reduces_indicator(self):
        """enrich() at chain positions appends snapshots and the residual
        indicator over those positions decreases — the basis absorbs the
        posterior-typical states it was asked about."""
        from ip_mcmc_tpu import configs
        from ip_mcmc_tpu.models import darcy

        p = configs.build("darcy_da_pod")  # reuse the data/problem
        _, aux = darcy.make_darcy_forward(
            n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
        )
        phi_r, enrich = darcy.make_pod_surrogate_online(
            aux, p.data, 0.002, jax.random.key(3), n_snapshots=12,
            rank="auto", enrich_batch=8,
        )
        pos = np.asarray(p.prior.sample(jax.random.key(9), (32,)))
        phi_r2, s1 = enrich(pos)
        _, s2 = enrich(pos)  # same positions: indicator must drop hard
        assert s2["n_snapshots"] == s1["n_snapshots"] + 8
        assert s2["indicator_max"] < s1["indicator_max"]
        assert s2["indicator_mean"] < s1["indicator_mean"]

    def test_pod_enrich_rejects_fused(self):
        """pod_enrich with fused=True would silently skip enrichment (the
        fused branch consumes batched_surrogate_fn) — must fail loudly
        (ADVICE round 4, medium)."""
        import pytest

        from ip_mcmc_tpu import configs, runner

        p = configs.build("darcy_da_pod_online")
        p.n_chains, p.n_samples, p.burn_in = 32, 4, 20
        p.kernel_params = {**p.kernel_params, "fused": True}
        with pytest.raises(ValueError, match="pod_enrich"):
            runner.run_problem(p)

    def test_pod_enrich_does_not_mutate_caller_problem(self):
        """A second run_problem() on the same Problem instance must start
        from the configured burn-in/surrogate, not the already-enriched
        state (ADVICE round 4: _pod_enrich_burnin used to mutate the
        shared instance)."""
        from ip_mcmc_tpu import configs, runner

        p = configs.build("darcy_da_pod_online")
        p.n_chains, p.n_samples, p.burn_in = 48, 8, 24
        p.kernel_params = {
            **p.kernel_params,
            "pod_enrich": {"epochs": 2, "segment_steps": 8},
        }
        surr0 = p.surrogate_potential_fn
        init0 = p.init_positions_fn
        m1 = runner.run_problem(p)
        assert p.burn_in == 24  # unchanged on the caller's instance
        assert p.surrogate_potential_fn is surr0
        assert p.init_positions_fn is init0
        m2 = runner.run_problem(p)  # re-run enriches from scratch again
        assert m2["pod_enrich_epochs"] == m1["pod_enrich_epochs"] == 2

    def test_online_config_runner_end_to_end(self):
        """darcy_da_pod_online through the runner (tiny sizes): enrichment
        history lands in metrics with a decreasing indicator, the
        surrogate is frozen before recording (structural: recorded phase
        runs the standard one-dispatch DA kernel), and the posterior is
        sane."""
        from ip_mcmc_tpu import configs, runner

        p = configs.build("darcy_da_pod_online")
        p.n_chains, p.n_samples, p.burn_in = 64, 20, 30
        p.kernel_params = {
            **p.kernel_params,
            "pod_enrich": {"epochs": 2, "segment_steps": 10},
        }
        m = runner.run_problem(p)
        assert m["kernel"] == "da_pcn"
        assert m["pod_enrich_epochs"] == 2
        assert len(m["pod_enrich_indicator_mean"]) == 2
        # enrichment reduces the surrogate error indicator on-line
        assert (m["pod_enrich_indicator_mean"][-1]
                < m["pod_enrich_indicator_mean"][0])
        # exactness machinery intact: recorded chain ran with some burn-in
        # left (30 - 2*10 = 10) and produced finite diagnostics
        assert 0.0 < m["accept_rate"] <= 1.0
        assert np.isfinite(m["min_ess"])


class TestDarcyDAFused:
    def test_darcy_da_fused_config_runs(self):
        """Round-4 headline config (fused DA, 8x8 calibrated surrogate)
        through the runner at smoke sizes (subchain shortened: the fused
        engine unrolls it, and the CPU pays per op)."""
        from ip_mcmc_tpu import configs, runner

        p = configs.build("darcy_da_fused")
        p.n_chains, p.n_samples, p.burn_in = 64, 10, 4
        p.kernel_params = {**p.kernel_params, "subchain_len": 6,
                           "block_chains": 64}
        m = runner.run_problem(p)
        assert m["kernel"] == "da_pcn(fused)"
        assert 0.0 < m["accept_rate"] <= 1.0
        assert np.isfinite(m["min_ess"])

    def test_calibrated_coarse_surrogate_tracks_exact(self):
        """The calibrated 8x8 surrogate rank-correlates with the exact
        misfit on prior draws (the property that makes the subchain a
        useful filter; exactness never depends on it)."""
        from ip_mcmc_tpu import configs

        p = configs.build("darcy_da_fused")
        u = p.prior.sample(jax.random.key(5), (16,))
        exact = np.asarray(jax.vmap(p.potential_fn)(u))
        Ub = jnp.asarray(np.asarray(u).T)
        surr = np.asarray(p.batched_surrogate_fn(Ub))
        corr = np.corrcoef(exact, surr)[0, 1]
        assert corr > 0.9, corr

    def test_darcy64_da_fused_config_runs(self):
        """Large-grid round-4 DA config through the runner at smoke sizes
        (short subchain + small block for the CPU)."""
        from ip_mcmc_tpu import configs, runner

        p = configs.build("darcy64_da_fused")
        p.n_chains, p.n_samples, p.burn_in = 32, 6, 3
        p.kernel_params = {**p.kernel_params, "subchain_len": 4,
                           "block_chains": 32}
        m = runner.run_problem(p)
        assert m["kernel"] == "da_pcn(fused)"
        assert 0.0 < m["accept_rate"] <= 1.0
        assert np.isfinite(m["min_ess"])
