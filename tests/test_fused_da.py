"""Fused delayed-acceptance pCN kernel (ops.fused_da_pcn_chain):
correctness of the two-potential fused path (round-2 VERDICT missing #5).

The DA correction makes ANY surrogate exact in distribution — the tests
verify that invariance (biased surrogate, same posterior), the perfect-
surrogate limit (corrections always accepted), equivalence with plain
fused pCN, and the burgers_da_pcn config end-to-end (posterior parity with
burgers_pcn, whose posterior is identical by construction)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ip_mcmc_tpu.ops import (
    fused_da_pcn_chain,
    fused_da_pcn_chain_recorded,
    fused_pcn_chain_recorded,
)

D = 4
PREC = jnp.linspace(0.5, 2.0, D)  # posterior precision = 1 + PREC
PM, PS = np.zeros(D), np.ones(D)


def phi_exact(U):  # (d, block) -> (block,)
    return 0.5 * jnp.sum(PREC[:, None] * U * U, axis=0)


def _post_var():
    return 1.0 / (1.0 + np.asarray(PREC))


def _run_recorded(surrogate, subchain_len, n=512, n_steps=400, seed=3):
    pos = jax.random.normal(jax.random.key(0), (n, D))
    _, acc, samples = fused_da_pcn_chain_recorded(
        phi_exact, surrogate, pos, PM, PS, 0.3, seed,
        n_steps=n_steps, thin=1, subchain_len=subchain_len,
        block_chains=256,
    )
    return np.asarray(samples)[n_steps // 4:], acc


def test_exact_posterior_with_biased_surrogate():
    """A deliberately WRONG surrogate (shifted + rescaled potential) must
    still produce the exact posterior — only efficiency may suffer."""

    def surr(U):
        return 0.8 * phi_exact(U + 0.3) + 1.7

    s, _ = _run_recorded(surr, subchain_len=4)
    flat = s.reshape(-1, D)
    np.testing.assert_allclose(flat.mean(axis=0), np.zeros(D), atol=0.06)
    np.testing.assert_allclose(flat.var(axis=0), _post_var(), rtol=0.12)


def test_perfect_surrogate_always_accepts_correction():
    """Surrogate == exact: the correction ratio is identically 1."""
    pos = jax.random.normal(jax.random.key(1), (256, D))
    _, acc, inner = fused_da_pcn_chain(
        phi_exact, phi_exact, pos, PM, PS, 0.3, 5,
        n_steps=100, subchain_len=3, block_chains=256,
    )
    np.testing.assert_allclose(np.asarray(acc), 1.0, atol=1e-6)
    assert 0.3 < float(np.asarray(inner).mean()) < 1.0


def test_matches_plain_fused_pcn_distribution():
    """DA with a near-exact surrogate samples the same posterior as the
    plain fused pCN kernel (different streams; moments must agree)."""

    def surr(U):
        return phi_exact(U) * 1.02

    s_da, _ = _run_recorded(surr, subchain_len=4)
    pos = jax.random.normal(jax.random.key(0), (512, D))
    _, _, s_pcn = fused_pcn_chain_recorded(
        phi_exact, pos, PM, PS, 0.3, 11, n_steps=1200, thin=1,
        block_chains=256,
    )
    a = s_da.reshape(-1, D)
    b = np.asarray(s_pcn)[300:].reshape(-1, D)
    np.testing.assert_allclose(a.mean(axis=0), b.mean(axis=0), atol=0.06)
    np.testing.assert_allclose(a.var(axis=0), b.var(axis=0), rtol=0.12)


def test_inner_rate_reported_and_recorded_consistent():
    """The recorded variant's endpoint equals a fresh unrecorded run with
    the same seed (same stream), and inner acceptance lands in (0, 1)."""
    pos = jax.random.normal(jax.random.key(2), (256, D))

    def surr(U):
        return phi_exact(U) + 0.1

    f1, a1, inner = fused_da_pcn_chain(
        phi_exact, surr, pos, PM, PS, 0.3, 9, n_steps=60,
        subchain_len=4, block_chains=256,
    )
    f2, a2, _ = fused_da_pcn_chain_recorded(
        phi_exact, surr, pos, PM, PS, 0.3, 9, n_steps=60, thin=1,
        subchain_len=4, block_chains=256,
    )
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    assert 0.0 < float(np.asarray(inner).mean()) < 1.0


@pytest.mark.slow
def test_burgers_da_config_posterior_parity():
    """burgers_da_pcn and burgers_pcn target the IDENTICAL posterior (same
    data, same fine model; the coarse surrogate is corrected exactly) —
    their posterior moments must agree within MC error."""
    from ip_mcmc_tpu import configs, runner

    da = configs.build("burgers_da_pcn")
    ref = configs.build("burgers_pcn")
    np.testing.assert_array_equal(da.data, ref.data)
    m_da = runner.run_problem(da, key=jax.random.key(0), n_chains=256,
                              n_samples=150)
    m_ref = runner.run_problem(ref, key=jax.random.key(1), n_chains=256,
                               n_samples=300)
    mu_da = np.asarray(m_da["posterior_mean"])
    mu_ref = np.asarray(m_ref["posterior_mean"])
    # leading KL modes are data-informed; compare there, loose MC tolerance
    np.testing.assert_allclose(mu_da[:6], mu_ref[:6], atol=0.15)
    assert m_da["accept_rate"] > 0.15  # calibrated surrogate: corrections pass
    assert 0.1 < m_da["inner_accept_rate"] < 0.9


class TestDA3:
    """Three-level fused delayed acceptance (ops.fused_da3_pcn_chain)."""

    def test_perfect_levels_always_accept(self):
        """All three potentials equal: both correction ratios are
        identically 1 — fine AND middle acceptance are exactly 1."""
        from ip_mcmc_tpu.ops import fused_da3_pcn_chain

        pos = jax.random.normal(jax.random.key(1), (256, D))
        _, acc, mid = fused_da3_pcn_chain(
            phi_exact, phi_exact, phi_exact, pos, PM, PS, 0.3, 5,
            n_steps=30, k_inner=4, k_mid=3, block_chains=256)
        np.testing.assert_array_equal(np.asarray(acc), 1.0)
        np.testing.assert_array_equal(np.asarray(mid), 1.0)

    def test_exact_posterior_with_biased_levels(self):
        """Deliberately wrong coarse AND middle levels must still yield
        the exact posterior (both corrections are exact MH ratios)."""
        from ip_mcmc_tpu.ops import fused_da3_pcn_chain_recorded

        def surr_c(U):  # badly biased coarse level
            return 0.8 * phi_exact(U + 0.3) + 1.7

        def surr_m(U):  # mildly biased middle level
            return 1.05 * phi_exact(U + 0.05) - 0.4

        pos = jax.random.normal(jax.random.key(0), (512, D))
        n_steps = 400
        _, acc, samples = fused_da3_pcn_chain_recorded(
            phi_exact, surr_m, surr_c, pos, PM, PS, 0.3, 3,
            n_steps=n_steps, thin=1, k_inner=4, k_mid=2, block_chains=256)
        flat = np.asarray(samples)[n_steps // 4:].reshape(-1, D)
        np.testing.assert_allclose(flat.mean(axis=0), np.zeros(D), atol=0.06)
        np.testing.assert_allclose(flat.var(axis=0), _post_var(), rtol=0.12)

    def test_middle_level_restores_fine_acceptance(self):
        """The 3-level design claim, on the analytic target: with a biased
        coarse level, inserting an ACCURATE middle level raises the fine
        correction acceptance above the 2-level kernel's at the same total
        subchain length."""
        from ip_mcmc_tpu.ops import fused_da3_pcn_chain, fused_da_pcn_chain

        def surr_c(U):
            return 0.8 * phi_exact(U + 0.3) + 1.7

        def surr_m(U):  # accurate middle (small perturbation)
            return phi_exact(U) + 0.01 * jnp.sum(U, axis=0)

        pos = jax.random.normal(jax.random.key(2), (512, D))
        _, acc2, _ = fused_da_pcn_chain(
            phi_exact, surr_c, pos, PM, PS, 0.3, 7,
            n_steps=60, subchain_len=8, block_chains=256)
        _, acc3, mid3 = fused_da3_pcn_chain(
            phi_exact, surr_m, surr_c, pos, PM, PS, 0.3, 7,
            n_steps=60, k_inner=4, k_mid=2, block_chains=256)
        assert float(np.asarray(acc3).mean()) > float(np.asarray(acc2).mean())
        assert float(np.asarray(acc3).mean()) > 0.9  # accurate middle
        assert 0.0 < float(np.asarray(mid3).mean()) < 1.0

    def test_recorded_matches_plain_endpoint(self):
        from ip_mcmc_tpu.ops import (fused_da3_pcn_chain,
                                     fused_da3_pcn_chain_recorded)

        def surr_c(U):
            return 0.9 * phi_exact(U) + 0.2

        def surr_m(U):
            return phi_exact(U) - 0.1

        pos = jax.random.normal(jax.random.key(3), (256, D))
        f1, a1, mid = fused_da3_pcn_chain(
            phi_exact, surr_m, surr_c, pos, PM, PS, 0.3, 9,
            n_steps=40, k_inner=3, k_mid=2, block_chains=256)
        f2, a2, _ = fused_da3_pcn_chain_recorded(
            phi_exact, surr_m, surr_c, pos, PM, PS, 0.3, 9,
            n_steps=40, thin=1, k_inner=3, k_mid=2, block_chains=256)
        np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
        np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
