"""Fused chain engine: distributional equivalence with the scan path
(streams differ; posteriors must match). Plain XLA on every backend."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ip_mcmc_tpu.ops import fused_pcn_chain, fused_rwm_chain


def gaussian_potential(x):
    # N(mean, diag(var)) potential, features-first batch: (d, block) -> (block,)
    mean = jnp.array([1.0, -0.5])
    var = jnp.array([2.0, 0.5])
    return 0.5 * jnp.sum((x - mean[:, None]) ** 2 / var[:, None], axis=0)


def test_fused_rwm_targets_gaussian():
    n, d = 512, 2
    pos = jnp.zeros((n, d), jnp.float32)
    # burn-in then sample: run twice, second call continues from output
    pos, _ = fused_rwm_chain(
        gaussian_potential, pos, step_size=0.9, seed=0, n_steps=500,
        block_chains=128,
    )
    pos, acc = fused_rwm_chain(
        gaussian_potential, pos, step_size=0.9, seed=1, n_steps=500,
        block_chains=128,
    )
    p = np.asarray(pos)
    np.testing.assert_allclose(p.mean(axis=0), [1.0, -0.5], atol=0.2)
    np.testing.assert_allclose(p.var(axis=0), [2.0, 0.5], rtol=0.35)
    assert 0.05 < float(np.asarray(acc).mean()) < 0.9


def test_fused_rwm_chains_differ_across_blocks():
    """Each grid block must get its own PRNG stream."""
    n, d = 256, 2
    pos = jnp.zeros((n, d), jnp.float32)
    pos, _ = fused_rwm_chain(
        gaussian_potential, pos, step_size=0.5, seed=7, n_steps=50,
        block_chains=128,
    )
    p = np.asarray(pos)
    assert not np.allclose(p[:128], p[128:])


def test_fused_pcn_conjugate_posterior():
    """pCN fused kernel on the conjugate Gaussian IP: posterior N(y/2, I/2)."""
    n, d = 1024, 2
    y = jnp.array([1.0, 1.0])

    def phi(x):
        return 0.5 * jnp.sum((y[:, None] - x) ** 2, axis=0)

    pos = jnp.zeros((n, d), jnp.float32)
    pos, _ = fused_pcn_chain(
        phi, pos, prior_mean=np.zeros(2), prior_scale=np.ones(2),
        beta=0.5, seed=0, n_steps=800, block_chains=256,
    )
    pos, acc = fused_pcn_chain(
        phi, pos, prior_mean=np.zeros(2), prior_scale=np.ones(2),
        beta=0.5, seed=1, n_steps=800, block_chains=256,
    )
    p = np.asarray(pos)
    np.testing.assert_allclose(p.mean(axis=0), [0.5, 0.5], atol=0.08)
    np.testing.assert_allclose(p.var(axis=0), [0.5, 0.5], rtol=0.25)
    assert float(np.asarray(acc).mean()) > 0.2


def test_fused_pcn_with_burgers_forward():
    """The full FV Burgers time loop inside the fused kernel: matches the
    scan+vmap path's posterior on the same inverse problem."""
    import jax.numpy as jnp

    from ip_mcmc_tpu import distributions, driver, potentials
    from ip_mcmc_tpu.kernels import pcn
    from ip_mcmc_tpu.models import burgers

    fwd, aux = burgers.make_burgers_forward(n_cells=64, n_modes=8, t_final=0.1)
    K = 8
    prior = distributions.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = prior.sample(jax.random.key(0))
    m = len(aux["obs_indices"])
    y = fwd(u_true)  # noiseless for determinism
    noise_scale = 0.05

    # scan+vmap reference
    noise = distributions.DiagGaussian(
        mean=jnp.zeros(m), scale=noise_scale * jnp.ones(m)
    )
    phi_single = potentials.misfit_potential(fwd, y, noise)
    kernel = pcn.build_kernel(phi_single, prior, beta=0.3)
    key_i, key_r = jax.random.split(jax.random.key(1))
    state = driver.init_chains(pcn.init, prior.sample(key_i, (128,)), phi_single)
    _, samples, _ = driver.sample_chains(
        kernel, state, key_r, n_samples=300, burn_in=300
    )
    ref_mean = np.asarray(samples).reshape(-1, K).mean(axis=0)

    # fused chain engine
    phi_batch = burgers.make_batched_misfit(aux, y, noise_scale)
    pos = prior.sample(jax.random.key(2), (128,))
    pos, _ = fused_pcn_chain(
        phi_batch, pos, prior_mean=np.zeros(K), prior_scale=np.ones(K),
        beta=0.3, seed=0, n_steps=300, block_chains=64,
    )
    pos, acc = fused_pcn_chain(
        phi_batch, pos, prior_mean=np.zeros(K), prior_scale=np.ones(K),
        beta=0.3, seed=1, n_steps=300, block_chains=64,
    )
    fused_mean = np.asarray(pos).mean(axis=0)
    assert float(np.asarray(acc).mean()) > 0.05
    np.testing.assert_allclose(fused_mean, ref_mean, atol=0.35)


def test_fused_pcn_with_darcy_forward():
    """The full Jacobi-PCG Darcy solve inside the fused kernel: matches the
    scan+vmap path's posterior on the same inverse problem."""
    from ip_mcmc_tpu import distributions, driver, potentials
    from ip_mcmc_tpu.kernels import pcn
    from ip_mcmc_tpu.models import darcy

    fwd, aux = darcy.make_darcy_forward(n_grid=8, n_modes_per_dim=4)
    K = 16
    prior = distributions.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = prior.sample(jax.random.key(0))
    m = len(aux["obs_indices"])
    y = fwd(u_true)
    noise_scale = 0.01

    noise = distributions.DiagGaussian(
        mean=jnp.zeros(m), scale=noise_scale * jnp.ones(m)
    )
    phi_single = potentials.misfit_potential(fwd, y, noise)
    kernel = pcn.build_kernel(phi_single, prior, beta=0.2)
    key_i, key_r = jax.random.split(jax.random.key(1))
    state = driver.init_chains(pcn.init, prior.sample(key_i, (64,)), phi_single)
    _, samples, _ = driver.sample_chains(
        kernel, state, key_r, n_samples=300, burn_in=300
    )
    ref_mean = np.asarray(samples).reshape(-1, K).mean(axis=0)

    phi_batch = darcy.make_batched_misfit(aux, y, noise_scale)
    pos = prior.sample(jax.random.key(2), (64,))
    pos, _ = fused_pcn_chain(
        phi_batch, pos, prior_mean=np.zeros(K), prior_scale=np.ones(K),
        beta=0.2, seed=0, n_steps=300, block_chains=32,
    )
    pos, acc = fused_pcn_chain(
        phi_batch, pos, prior_mean=np.zeros(K), prior_scale=np.ones(K),
        beta=0.2, seed=1, n_steps=300, block_chains=32,
    )
    fused_mean = np.asarray(pos).mean(axis=0)
    assert float(np.asarray(acc).mean()) > 0.05
    np.testing.assert_allclose(fused_mean, ref_mean, atol=0.4)


def test_recorded_chain_matches_unrecorded_and_distribution():
    """Recording: last record == final positions; recorded trajectory has
    the right posterior."""
    from ip_mcmc_tpu.ops import fused_pcn_chain_recorded

    n, d = 512, 2
    y = jnp.array([1.0, 1.0])

    def phi(x):
        return 0.5 * jnp.sum((y[:, None] - x) ** 2, axis=0)

    pos0 = jnp.zeros((n, d), jnp.float32)
    final, acc, samples = fused_pcn_chain_recorded(
        phi, pos0, prior_mean=np.zeros(d), prior_scale=np.ones(d),
        beta=0.5, seed=3, n_steps=600, thin=2, block_chains=128,
    )
    assert samples.shape == (300, n, d)
    np.testing.assert_array_equal(np.asarray(samples[-1]), np.asarray(final))
    flat = np.asarray(samples[100:]).reshape(-1, d)  # post-burn-in records
    np.testing.assert_allclose(flat.mean(axis=0), [0.5, 0.5], atol=0.06)
    np.testing.assert_allclose(flat.var(axis=0), [0.5, 0.5], rtol=0.2)
    assert float(np.asarray(acc).mean()) > 0.2


def test_recorded_equals_unrecorded_bitwise():
    """Recording is PASSIVE: the recorded program's chain is bitwise the
    unrecorded program's chain at the same seed (the RNG stream is a pure
    function of (seed, step, tag); recording must never perturb the state
    it snapshots)."""
    from ip_mcmc_tpu.ops import fused_pcn_chain, fused_pcn_chain_recorded

    n, d = 256, 2
    y = jnp.array([1.0, -0.5])

    def phi(x):
        return 0.5 * jnp.sum((y[:, None] - x) ** 2, axis=0)

    pos0 = jnp.zeros((n, d), jnp.float32)
    kw = dict(prior_mean=np.zeros(d), prior_scale=np.ones(d), beta=0.4,
              seed=9, n_steps=30, block_chains=128)
    final_u, acc_u = fused_pcn_chain(phi, pos0, **kw)
    final_r, acc_r, _ = fused_pcn_chain_recorded(phi, pos0, thin=3, **kw)
    np.testing.assert_array_equal(np.asarray(final_u), np.asarray(final_r))
    np.testing.assert_array_equal(np.asarray(acc_u), np.asarray(acc_r))


def test_recorded_thin_validation():
    from ip_mcmc_tpu.ops import fused_pcn_chain_recorded

    with pytest.raises(ValueError):
        fused_pcn_chain_recorded(
            gaussian_potential, jnp.zeros((128, 2)), np.zeros(2), np.ones(2),
            0.5, 0, n_steps=10, thin=3, block_chains=128,
        )


def test_block_mismatch_raises():
    with pytest.raises(ValueError):
        fused_rwm_chain(
            gaussian_potential, jnp.zeros((100, 2)), 0.5, 0, n_steps=10,
            block_chains=64,
        )


def test_fused_mala_targets_gaussian():
    """Fused MALA (jax.vjp gradients) samples the right target."""
    from ip_mcmc_tpu.ops import fused_mala_chain

    n, d = 512, 2
    pos = jnp.zeros((n, d), jnp.float32)
    pos, _ = fused_mala_chain(
        gaussian_potential, pos, step_size=0.7, seed=0, n_steps=500,
        block_chains=128,
    )
    pos, acc = fused_mala_chain(
        gaussian_potential, pos, step_size=0.7, seed=1, n_steps=500,
        block_chains=128,
    )
    p = np.asarray(pos)
    np.testing.assert_allclose(p.mean(axis=0), [1.0, -0.5], atol=0.2)
    np.testing.assert_allclose(p.var(axis=0), [2.0, 0.5], rtol=0.35)
    assert 0.3 < float(np.asarray(acc).mean()) < 1.0


def test_fused_mala_linear_misfit_conjugate():
    """MALA through a linear forward misfit: gradient = matmul transpose;
    the matmul path of the vjp. Conjugate posterior as oracle."""
    from ip_mcmc_tpu.ops import fused_mala_chain

    d, m, n = 4, 3, 512
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.standard_normal((m, d)) / np.sqrt(d), jnp.float32)
    y = jnp.asarray(rng.standard_normal(m), jnp.float32)
    sigma = 0.5

    def phi(x):  # (d, block) -> (block,): misfit + PRIOR (MALA needs full −logπ)
        r = (y[:, None] - A @ x) / sigma
        return 0.5 * jnp.sum(r * r, axis=0) + 0.5 * jnp.sum(x * x, axis=0)

    H = np.linalg.inv(np.eye(d) + np.asarray(A).T @ np.asarray(A) / sigma**2)
    mu = H @ np.asarray(A).T @ np.asarray(y) / sigma**2

    pos = jnp.zeros((n, d), jnp.float32)
    pos, _ = fused_mala_chain(phi, pos, step_size=0.5, seed=3, n_steps=800,
                              block_chains=128)
    pos, acc = fused_mala_chain(phi, pos, step_size=0.5, seed=4, n_steps=800,
                                block_chains=128)
    p = np.asarray(pos)
    np.testing.assert_allclose(p.mean(axis=0), mu, atol=0.12)
    np.testing.assert_allclose(np.cov(p.T), H, atol=0.15)
    assert float(np.asarray(acc).mean()) > 0.3


def test_fused_mala_recorded_matches_endpoint():
    """Recorded MALA: last recorded step == endpoint of the same launch."""
    from ip_mcmc_tpu.ops import fused_mala_chain_recorded

    n, d = 256, 2
    pos = jnp.zeros((n, d), jnp.float32)
    final, acc, samples = fused_mala_chain_recorded(
        gaussian_potential, pos, step_size=0.7, seed=5, n_steps=40, thin=4,
        block_chains=128,
    )
    assert samples.shape == (10, n, d)
    np.testing.assert_allclose(np.asarray(samples[-1]), np.asarray(final))


def test_fused_rwm_recorded_matches_endpoint():
    from ip_mcmc_tpu.ops import fused_rwm_chain_recorded

    n, d = 256, 2
    pos = jnp.zeros((n, d), jnp.float32)
    final, acc, samples = fused_rwm_chain_recorded(
        gaussian_potential, pos, step_size=0.9, seed=6, n_steps=30, thin=3,
        block_chains=128,
    )
    assert samples.shape == (10, n, d)
    np.testing.assert_allclose(np.asarray(samples[-1]), np.asarray(final))


def test_fused_mala_darcy_adjoint_smoke():
    """Gradient-based MCMC on Darcy entirely inside the fused kernel: the
    vjp runs the adjoint CG solve (custom_vjp)."""
    from ip_mcmc_tpu import distributions as dist
    from ip_mcmc_tpu.models import darcy
    from ip_mcmc_tpu.ops import fused_mala_chain

    fwd, aux = darcy.make_darcy_forward(n_grid=8, n_modes_per_dim=4,
                                        alpha=2.0, field_scale=10.0)
    K, m = 16, 16
    noise = dist.DiagGaussian(mean=jnp.zeros(m), scale=0.002 * jnp.ones(m))
    u_true = jax.random.normal(jax.random.key(300), (K,))
    y = fwd(u_true) + noise.sample(jax.random.key(301))
    phi_data = darcy.make_batched_misfit(aux, y, 0.002, cg_iters=24,
                                         differentiable=True)
    phi = lambda U: phi_data(U) + 0.5 * jnp.sum(U * U, axis=0)
    pos = jax.random.normal(jax.random.key(1), (64, K)) * 0.1
    pos2, acc = fused_mala_chain(phi, pos, step_size=0.02, seed=3, n_steps=5,
                                 block_chains=64)
    assert np.isfinite(np.asarray(pos2)).all()
    assert not np.allclose(np.asarray(pos2), np.asarray(pos))
    assert 0.0 < float(np.asarray(acc).mean()) <= 1.0


class TestWarmStartPCN:
    """Warm-started fused pCN: carried CG solution (ROADMAP P1)."""

    def _darcy(self, warm_iters=12):
        from ip_mcmc_tpu import distributions as dist
        from ip_mcmc_tpu.models import darcy

        fwd, aux = darcy.make_darcy_forward(n_grid=8, n_modes_per_dim=4,
                                            alpha=2.0, field_scale=10.0)
        K = 16
        noise = dist.DiagGaussian(mean=jnp.zeros(16), scale=0.002 * jnp.ones(16))
        u_true = jax.random.normal(jax.random.key(300), (K,))
        y = fwd(u_true) + noise.sample(jax.random.key(301))
        cold = darcy.make_batched_misfit(aux, y, 0.002, cg_iters=40)
        warm, aux_dim = darcy.make_batched_misfit_warm(aux, y, 0.002,
                                                       cg_iters=warm_iters)
        return cold, warm, aux_dim, K

    def test_warm_matches_cold_acceptance(self):
        """Same seed ⇒ same random streams; the warm kernel's acceptance
        rate must match the cold one (solver error ≪ noise)."""
        from ip_mcmc_tpu.ops import fused_pcn_chain, fused_pcn_chain_warm

        cold, warm, aux_dim, K = self._darcy()
        pos = jax.random.normal(jax.random.key(1), (64, K)) * 0.3
        _, acc_c = fused_pcn_chain(cold, pos, prior_mean=np.zeros(K),
                                   prior_scale=np.ones(K), beta=0.1, seed=5,
                                   n_steps=30, block_chains=64)
        _, acc_w = fused_pcn_chain_warm(warm, pos, prior_mean=np.zeros(K),
                                        prior_scale=np.ones(K), beta=0.1,
                                        seed=5, n_steps=30, aux_dim=aux_dim,
                                        block_chains=64)
        np.testing.assert_allclose(
            float(np.asarray(acc_c).mean()), float(np.asarray(acc_w).mean()),
            atol=0.05,
        )

    def test_warm_recorded_matches_endpoint(self):
        from ip_mcmc_tpu.ops import fused_pcn_chain_warm_recorded

        _, warm, aux_dim, K = self._darcy()
        pos = jax.random.normal(jax.random.key(2), (64, K)) * 0.3
        final, acc, s = fused_pcn_chain_warm_recorded(
            warm, pos, prior_mean=np.zeros(K), prior_scale=np.ones(K),
            beta=0.1, seed=6, n_steps=12, thin=3, aux_dim=aux_dim,
            block_chains=64,
        )
        assert s.shape == (4, 64, K)
        np.testing.assert_allclose(np.asarray(s[-1]), np.asarray(final))

    def test_aux_dim_required(self):
        from ip_mcmc_tpu.ops import fused_pcn_chain_warm

        _, warm, _, K = self._darcy()
        pos = jnp.zeros((64, K), jnp.float32)
        with pytest.raises(ValueError):
            fused_pcn_chain_warm(warm, pos, prior_mean=np.zeros(K),
                                 prior_scale=np.ones(K), beta=0.1, seed=0,
                                 n_steps=2, block_chains=64)

    def test_runner_warm_config(self):
        from ip_mcmc_tpu import configs, runner

        p = configs.build("darcy_pcn_warm")
        p.n_chains, p.n_samples, p.burn_in = 128, 20, 10
        p.kernel_params["block_chains"] = 128
        m = runner.run_problem(p)
        assert m["kernel"] == "pcn(fused)"
        assert 0.0 < m["accept_rate"] < 1.0


class TestFusedESS:
    """Fused elliptical slice sampling (masked fixed-budget shrink)."""

    def test_conjugate_posterior(self):
        from ip_mcmc_tpu.ops import fused_ess_chain

        y = jnp.array([1.0, 1.0])
        phi = lambda x: 0.5 * jnp.sum((y[:, None] - x) ** 2, axis=0)
        pos = jnp.zeros((1024, 2), jnp.float32)
        for seed in (0, 1):
            pos, acc = fused_ess_chain(
                phi, pos, prior_mean=np.zeros(2), prior_scale=np.ones(2),
                seed=seed, n_steps=300, block_chains=128,
            )
        p = np.asarray(pos)
        np.testing.assert_allclose(p.mean(axis=0), [0.5, 0.5], atol=0.07)
        np.testing.assert_allclose(p.var(axis=0), [0.5, 0.5], atol=0.12)
        assert float(np.asarray(acc).mean()) > 0.95  # shrink budget suffices

    def test_recorded_matches_endpoint(self):
        from ip_mcmc_tpu.ops import fused_ess_chain_recorded

        phi = gaussian_potential
        pos = jnp.zeros((256, 2), jnp.float32)
        f, acc, s = fused_ess_chain_recorded(
            phi, pos, prior_mean=np.zeros(2), prior_scale=3.0 * np.ones(2),
            seed=5, n_steps=20, thin=4, block_chains=128,
        )
        assert s.shape == (5, 256, 2)
        np.testing.assert_allclose(np.asarray(s[-1]), np.asarray(f))

    def test_darcy_misfit_smoke(self):
        """Tuning-free sampling of the Darcy posterior in the fused kernel
        (8 CG-solve evals per step, masked)."""
        from ip_mcmc_tpu import distributions as dist
        from ip_mcmc_tpu.models import darcy
        from ip_mcmc_tpu.ops import fused_ess_chain

        fwd, aux = darcy.make_darcy_forward(n_grid=8, n_modes_per_dim=4,
                                            alpha=2.0, field_scale=10.0)
        K = 16
        noise = dist.DiagGaussian(mean=jnp.zeros(16), scale=0.01 * jnp.ones(16))
        u_true = jax.random.normal(jax.random.key(300), (K,))
        y = fwd(u_true) + noise.sample(jax.random.key(301))
        phi = darcy.make_batched_misfit(aux, y, 0.01, cg_iters=24)
        pos = jax.random.normal(jax.random.key(1), (64, K)) * 0.3
        pos2, acc = fused_ess_chain(
            phi, pos, prior_mean=np.zeros(K), prior_scale=np.ones(K),
            seed=3, n_steps=10, max_shrink=6, block_chains=64,
        )
        assert np.isfinite(np.asarray(pos2)).all()
        assert not np.allclose(np.asarray(pos2), np.asarray(pos))


def test_warm_dst_matches_jacobi_acceptance():
    """DST-preconditioned warm CG (bf16 Kronecker factors): same
    acceptance as the Jacobi warm path on identical streams — the
    preconditioner changes the solver path, not the solution."""
    from ip_mcmc_tpu import distributions as dist
    from ip_mcmc_tpu.models import darcy
    from ip_mcmc_tpu.ops import fused_pcn_chain_warm

    fwd, aux = darcy.make_darcy_forward(n_grid=8, n_modes_per_dim=4,
                                        alpha=2.0, field_scale=10.0)
    K = 16
    noise = dist.DiagGaussian(mean=jnp.zeros(16), scale=0.002 * jnp.ones(16))
    u_true = jax.random.normal(jax.random.key(300), (K,))
    y = fwd(u_true) + noise.sample(jax.random.key(301))
    pj, adj = darcy.make_batched_misfit_warm(aux, y, 0.002, cg_iters=12)
    pd, add = darcy.make_batched_misfit_warm(aux, y, 0.002, cg_iters=4,
                                             precond="dst")
    pos = jax.random.normal(jax.random.key(1), (64, K)) * 0.3
    kw = dict(prior_mean=np.zeros(K), prior_scale=np.ones(K), beta=0.1,
              seed=5, n_steps=30, block_chains=64)
    _, aj = fused_pcn_chain_warm(pj, pos, aux_dim=adj, **kw)
    _, ad = fused_pcn_chain_warm(pd, pos, aux_dim=add, **kw)
    np.testing.assert_allclose(float(np.asarray(aj).mean()),
                               float(np.asarray(ad).mean()), atol=0.05)
    with pytest.raises(ValueError):
        darcy.make_batched_misfit_warm(aux, y, 0.002, precond="amg")


def test_truncated_dst_equals_dense_at_full_rank():
    """At K = n² with a zero Jacobi term, the truncated two-level
    preconditioner IS the dense Kronecker fast-Poisson apply (f32)."""
    from ip_mcmc_tpu.models import darcy

    n = 16
    rng = np.random.default_rng(0)
    a = jnp.asarray(np.exp(0.4 * rng.standard_normal((n * n, 8))), jnp.float32)
    r = jnp.asarray(rng.standard_normal((n * n, 8)), jnp.float32)
    dense = darcy._flat_dst_preconditioner(n, a, precond_dtype=jnp.float32)(r)
    trunc = darcy._flat_truncated_dst_preconditioner(
        n, a, 0.0, n * n, precond_dtype=jnp.float32
    )(r)
    np.testing.assert_allclose(np.asarray(trunc), np.asarray(dense),
                               rtol=1e-4, atol=1e-6)


def test_truncated_dst_beats_jacobi_convergence():
    """n = 32 (past the dense factors' reach): trunc-128 PCG at 8 iterations
    beats 48 Jacobi iterations by orders of magnitude in residual — the
    measurement behind switching darcy32_pcn_warm off Jacobi."""
    from ip_mcmc_tpu.models import darcy

    n = 32
    rng = np.random.default_rng(1)
    fwd, aux = darcy.make_darcy_forward(n_grid=n, n_modes_per_dim=8,
                                        alpha=2.0, field_scale=10.0)
    basis_t = jnp.asarray(np.asarray(aux["scaled_basis"]).T)
    U = jnp.asarray(rng.standard_normal((64, 4)), jnp.float32)
    a = jnp.exp(basis_t @ U)
    masks = darcy._flat_masks(n)
    t_h, t_v = darcy._flat_transmissibilities(a, n, masks)
    b = jnp.ones((n * n, 4), jnp.float32)
    inv_diag = 1.0 / darcy._operator_diagonal_flat(a, n, masks, t_h, t_v)

    def resid(x):
        r = b - darcy._apply_operator_flat(a, x, n, masks, t_h, t_v)
        return float(jnp.max(jnp.linalg.norm(r, axis=0)
                             / jnp.linalg.norm(b, axis=0)))

    xj = darcy._cg_flat(a, b, n, masks, t_h, t_v, inv_diag, 48)
    inv_m = darcy._flat_truncated_dst_preconditioner(n, a, inv_diag, 128)
    xt = darcy._cg_flat(a, b, n, masks, t_h, t_v, None, 8, inv_m=inv_m)
    assert resid(xt) < 1e-3
    assert resid(xt) < 0.5 * resid(xj)


def test_warm_dst_trunc_matches_jacobi_acceptance():
    """Truncated-DST warm CG at n = 32 through the FUSED kernel: same
    acceptance as a deep Jacobi warm path on identical streams (the
    preconditioner changes the solver path, not the solution)."""
    from ip_mcmc_tpu import distributions as dist
    from ip_mcmc_tpu.models import darcy
    from ip_mcmc_tpu.ops import fused_pcn_chain_warm

    fwd, aux = darcy.make_darcy_forward(n_grid=32, n_modes_per_dim=8,
                                        alpha=2.0, field_scale=10.0)
    K = 64
    noise = dist.DiagGaussian(mean=jnp.zeros(16), scale=0.002 * jnp.ones(16))
    u_true = jax.random.normal(jax.random.key(310), (K,))
    y = fwd(u_true) + noise.sample(jax.random.key(311))
    pj, adj = darcy.make_batched_misfit_warm(aux, y, 0.002, cg_iters=48)
    pt, adt = darcy.make_batched_misfit_warm(aux, y, 0.002, cg_iters=6,
                                             precond="dst_trunc",
                                             precond_modes=128)
    pos = jax.random.normal(jax.random.key(1), (32, K)) * 0.3
    kw = dict(prior_mean=np.zeros(K), prior_scale=np.ones(K), beta=0.08,
              seed=5, n_steps=25, block_chains=32)
    _, aj = fused_pcn_chain_warm(pj, pos, aux_dim=adj, **kw)
    _, at = fused_pcn_chain_warm(pt, pos, aux_dim=adt, **kw)
    np.testing.assert_allclose(float(np.asarray(aj).mean()),
                               float(np.asarray(at).mean()), atol=0.06)


def test_fused_pcn_dense_prior_invariance_and_posterior():
    """Dense-prior fused pCN: with Φ ≡ 0 the chain leaves the CORRELATED
    prior invariant (cross-covariance reproduced); with a misfit it matches
    the conjugate posterior."""
    from ip_mcmc_tpu.ops import fused_pcn_chain_dense, fused_pcn_chain_dense_recorded

    C = np.array([[2.0, 0.8], [0.8, 1.0]], np.float32)
    L = np.linalg.cholesky(C)
    mean = np.array([1.0, -0.5], np.float32)
    zero_phi = lambda x: jnp.zeros((x.shape[1],), jnp.float32)

    pos = jnp.zeros((1024, 2), jnp.float32) + jnp.asarray(mean)
    pos, acc = fused_pcn_chain_dense(zero_phi, pos, prior_mean=mean,
                                     prior_chol=L, beta=0.7, seed=0,
                                     n_steps=400, block_chains=128)
    p = np.asarray(pos)
    assert float(np.asarray(acc).mean()) > 0.999  # Φ≡0: always accept
    np.testing.assert_allclose(p.mean(axis=0), mean, atol=0.15)
    np.testing.assert_allclose(np.cov(p.T), C, atol=0.3)

    # conjugate: prior N(mean, C), y = u + N(0, I) noise
    y = jnp.array([0.0, 0.0])
    phi = lambda x: 0.5 * jnp.sum((y[:, None] - x) ** 2, axis=0)
    H = np.linalg.inv(np.linalg.inv(C) + np.eye(2))
    mu = H @ (np.linalg.inv(C) @ mean)
    final, acc, s = fused_pcn_chain_dense_recorded(
        phi, pos, prior_mean=mean, prior_chol=L, beta=0.5, seed=1,
        n_steps=600, thin=1, block_chains=128)
    flat = np.asarray(s[200:]).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), mu, atol=0.1)
    np.testing.assert_allclose(np.cov(flat.T), H, atol=0.2)
    np.testing.assert_allclose(np.asarray(s[-1]), np.asarray(final))


class TestFusedFES:
    """Fused functional ensemble sampler (dynamic odd-roll partners)."""

    def _target(self):
        C = np.array([[1.0, 0.9], [0.9, 1.0]], np.float32)
        P = jnp.asarray(np.linalg.inv(C))
        mu = jnp.array([0.7, -0.3])

        def phi(x):  # posterior N(mu, C) under prior N(0, 9I)
            d = x - mu[:, None]
            return (0.5 * jnp.sum(d * (P @ d), axis=0)
                    - 0.5 * jnp.sum(x * x, axis=0) / 9.0)

        return phi, np.asarray(mu), C

    def test_correlated_posterior_no_tuning(self):
        """Affine invariance: the correlated posterior is matched with NO
        covariance adaptation, including the 0.9 cross-correlation."""
        from ip_mcmc_tpu.ops import fused_fes_chain

        phi, mu, C = self._target()
        pos = jax.random.normal(jax.random.key(0), (512, 2)) * 3.0
        kw = dict(prior_mean=np.zeros(2), prior_scale=3.0 * np.ones(2),
                  n_low_modes=2, block_chains=128)
        for seed in (1, 2):
            pos, acc, stretch_acc = fused_fes_chain(
                phi, pos, seed=seed, n_steps=600, **kw
            )
        p = np.asarray(pos)
        np.testing.assert_allclose(p.mean(axis=0), mu, atol=0.08)
        np.testing.assert_allclose(np.cov(p.T), C, atol=0.15)
        # stretch-move acceptance channel (extra_out): a real rate in (0, 1)
        sa = np.asarray(stretch_acc)
        assert sa.shape == (512,)
        assert 0.05 < sa.mean() < 0.95, sa.mean()

    def test_odd_block_rejected(self):
        from ip_mcmc_tpu.ops import fused_fes_chain

        phi, *_ = self._target()
        pos = jnp.zeros((254, 2), jnp.float32)
        with pytest.raises(ValueError, match="even"):
            fused_fes_chain(
                phi, pos, prior_mean=np.zeros(2),
                prior_scale=3.0 * np.ones(2), n_low_modes=2, seed=1,
                n_steps=2, block_chains=127,
            )

    def test_recorded_matches_endpoint(self):
        from ip_mcmc_tpu.ops import fused_fes_chain_recorded

        phi, *_ = self._target()
        pos = jnp.zeros((256, 2), jnp.float32)
        f, acc, s = fused_fes_chain_recorded(
            phi, pos, prior_mean=np.zeros(2), prior_scale=3.0 * np.ones(2),
            n_low_modes=2, seed=5, n_steps=12, thin=3, block_chains=128)
        assert s.shape == (4, 256, 2)
        np.testing.assert_allclose(np.asarray(s[-1]), np.asarray(f))


def test_warm_dst_posterior_matches_scan_path():
    """END-TO-END exactness: posterior moments from the warm-DST fused
    kernel match the scan+vmap pCN path (exact solver) on the same Darcy
    posterior within MC error — the solver approximation does not bias the
    posterior."""
    from ip_mcmc_tpu import distributions as dist, driver, potentials
    from ip_mcmc_tpu.kernels import pcn as pcn_kernel
    from ip_mcmc_tpu.models import darcy
    from ip_mcmc_tpu.ops import fused_pcn_chain_warm, fused_pcn_chain_warm_recorded

    fwd, aux = darcy.make_darcy_forward(n_grid=8, n_modes_per_dim=4,
                                        alpha=2.0, field_scale=10.0)
    K = 16
    noise = dist.DiagGaussian(mean=jnp.zeros(16), scale=0.01 * jnp.ones(16))
    prior = dist.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = jax.random.normal(jax.random.key(300), (K,))
    y = fwd(u_true) + noise.sample(jax.random.key(301))

    # scan path (exact custom_linear_solve CG)
    phi = potentials.misfit_potential(fwd, y, noise)
    kern = pcn_kernel.build_kernel(phi, prior, beta=0.12)
    state = driver.init_chains(pcn_kernel.init,
                               prior.sample(jax.random.key(1), (128,)), phi)
    _, s_scan, _ = driver.sample_chains(kern, state, jax.random.key(2),
                                        n_samples=600, burn_in=200)
    m_scan = np.asarray(s_scan).reshape(-1, K).mean(0)

    # fused warm-DST path
    warm, ad = darcy.make_batched_misfit_warm(aux, y, 0.01, cg_iters=4,
                                              precond="dst")
    pos = prior.sample(jax.random.key(3), (128,))
    pos, _ = fused_pcn_chain_warm(warm, pos, prior_mean=np.zeros(K),
                                  prior_scale=np.ones(K), beta=0.12, seed=4,
                                  n_steps=200, aux_dim=ad, block_chains=128)
    _, _, s_f = fused_pcn_chain_warm_recorded(
        warm, pos, prior_mean=np.zeros(K), prior_scale=np.ones(K), beta=0.12,
        seed=5, n_steps=600, thin=1, aux_dim=ad, block_chains=128)
    m_fused = np.asarray(s_f).reshape(-1, K).mean(0)

    # two INDEPENDENT 128-chain runs: se per coordinate ~0.04-0.05 after
    # autocorrelation; 0.18 ≈ 3σ on the difference
    np.testing.assert_allclose(m_fused, m_scan, atol=0.18)


class TestFusedMalaWarm:
    def _setup(self):
        from ip_mcmc_tpu import distributions as dist
        from ip_mcmc_tpu.models import darcy

        fwd, aux = darcy.make_darcy_forward(n_grid=8, n_modes_per_dim=4,
                                            alpha=2.0, field_scale=10.0)
        noise = dist.DiagGaussian(mean=jnp.zeros(16), scale=0.01 * jnp.ones(16))
        u_true = jax.random.normal(jax.random.key(300), (16,))
        y = fwd(u_true) + noise.sample(jax.random.key(301))
        return aux, y

    def test_explicit_adjoint_matches_custom_vjp(self):
        """The hand-written value-and-grad (carried-aux form) reproduces the
        custom_vjp adjoint bit-for-bit at converged iteration counts."""
        from ip_mcmc_tpu.models import darcy

        aux, y = self._setup()
        pag, ad = darcy.make_batched_misfit_mala_warm(aux, y, 0.01,
                                                      cg_iters=60,
                                                      precond="jacobi")
        phi_ad = darcy.make_batched_misfit(aux, y, 0.01, cg_iters=60,
                                           differentiable=True)
        U = jax.random.normal(jax.random.key(7), (16, 4)) * 0.4
        phi1, g1, aux_out = pag(U, jnp.zeros((ad, 4), jnp.float32))
        np.testing.assert_allclose(np.asarray(phi1), np.asarray(phi_ad(U)),
                                   rtol=1e-5)
        g2 = jax.grad(lambda u: jnp.sum(phi_ad(u)))(U)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                                   rtol=1e-4, atol=1e-5)
        assert aux_out.shape == (ad, 4)

    def test_warm_matches_cold_mala_acceptance(self):
        from ip_mcmc_tpu.models import darcy
        from ip_mcmc_tpu.ops import fused_mala_chain, fused_mala_chain_warm

        aux, y = self._setup()
        K = 16
        phi_d = darcy.make_batched_misfit(aux, y, 0.01, cg_iters=40,
                                          differentiable=True)
        phi_post = lambda U: phi_d(U) + 0.5 * jnp.sum(U * U, axis=0)
        pag, ad = darcy.make_batched_misfit_mala_warm(aux, y, 0.01,
                                                      cg_iters=4,
                                                      precond="dst")
        pos = jax.random.normal(jax.random.key(1), (64, K)) * 0.2
        _, ac = fused_mala_chain(phi_post, pos, step_size=0.05, seed=5,
                                 n_steps=30, block_chains=64)
        _, aw = fused_mala_chain_warm(pag, pos, prior_mean=np.zeros(K),
                                      prior_scale=np.ones(K), step_size=0.05,
                                      seed=5, n_steps=30, aux_dim=ad,
                                      block_chains=64)
        np.testing.assert_allclose(float(np.asarray(ac).mean()),
                                   float(np.asarray(aw).mean()), atol=0.06)

    def test_recorded_matches_endpoint(self):
        from ip_mcmc_tpu.models import darcy
        from ip_mcmc_tpu.ops import fused_mala_chain_warm_recorded

        aux, y = self._setup()
        K = 16
        pag, ad = darcy.make_batched_misfit_mala_warm(aux, y, 0.01,
                                                      cg_iters=4,
                                                      precond="dst")
        pos = jax.random.normal(jax.random.key(2), (64, K)) * 0.2
        f, a, s = fused_mala_chain_warm_recorded(
            pag, pos, prior_mean=np.zeros(K), prior_scale=np.ones(K),
            step_size=0.05, seed=6, n_steps=12, thin=3, aux_dim=ad,
            block_chains=64)
        assert s.shape == (4, 64, K)
        np.testing.assert_allclose(np.asarray(s[-1]), np.asarray(f))


class TestFusedBetaAdaptation:
    def test_adapts_down_to_target_on_sharp_likelihood(self):
        """Fused Robbins–Monro β adaptation: frozen β reproduces the
        target acceptance on a sharp 16-dim posterior."""
        from ip_mcmc_tpu.ops import fused_pcn_chain, fused_pcn_chain_adapt

        d = 16
        y = jnp.linspace(-0.5, 0.5, d)
        phi = lambda x: 0.5 * jnp.sum((y[:, None] - x) ** 2, axis=0) / 0.01
        pos = jnp.broadcast_to(y[None, :], (512, d)).astype(jnp.float32)
        pos2, acc, beta = fused_pcn_chain_adapt(
            phi, pos, prior_mean=np.zeros(d), prior_scale=np.ones(d),
            beta0=0.5, seed=0, n_steps=800, target_accept=0.3,
            block_chains=128)
        b = float(np.asarray(beta).mean())
        assert 0.005 < b < 0.3  # adapted well below the 0.5 init
        _, acc3 = fused_pcn_chain(
            phi, pos2, prior_mean=np.zeros(d), prior_scale=np.ones(d),
            beta=b, seed=1, n_steps=400, block_chains=128)
        assert 0.2 < float(np.asarray(acc3).mean()) < 0.42

    def test_caps_at_one_on_easy_target(self):
        """Easy target where even β≈1 over-accepts: β must peg at the
        ceiling, not blow past 1 (which would NaN the contraction)."""
        from ip_mcmc_tpu.ops import fused_pcn_chain_adapt

        y = jnp.array([1.0, 1.0])
        phi = lambda x: 0.5 * jnp.sum((y[:, None] - x) ** 2, axis=0)
        pos = jnp.zeros((256, 2), jnp.float32)
        _, _, beta = fused_pcn_chain_adapt(
            phi, pos, prior_mean=np.zeros(2), prior_scale=np.ones(2),
            beta0=0.05, seed=0, n_steps=400, target_accept=0.3,
            block_chains=128)
        b = np.asarray(beta)
        assert np.all(b <= 0.999 + 1e-6) and np.all(np.isfinite(b))
        assert b.mean() > 0.9  # pushed up hard against the ceiling
