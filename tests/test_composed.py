"""Composed ('chains', 'model') mesh (round-1 VERDICT item 9): chain-parallel
pCN where EACH chain's Darcy forward solve is row-sharded over 'model'.

Two anchors:
- mesh-shape invariance: (8,1), (4,2), (2,4), (1,8) all produce the same
  chains (keys depend only on (step, global chain id); solver converged to
  float noise so psum reduction order cannot flip accept decisions),
- equality with the 1-device product path: a plain vmap-over-chains loop
  built on ``models.darcy.solve_cg`` with the identical key derivation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ip_mcmc_tpu.models import darcy
from ip_mcmc_tpu.parallel import composed

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

N_GRID, N_CHAINS, N_SAMPLES, BURN, BETA, NOISE, CG = 16, 16, 40, 20, 0.3, 0.05, 150


def _setup():
    fwd, aux = darcy.make_darcy_forward(
        n_grid=N_GRID, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    u_true = jax.random.normal(jax.random.key(300), (64,))
    y = fwd(u_true) + NOISE * jax.random.normal(
        jax.random.key(301), (len(aux["obs_indices"]),)
    )
    u0 = jax.random.normal(jax.random.key(5), (N_CHAINS, 64))
    return aux, y, u0


def _run(mesh_shape):
    aux, y, u0 = _setup()
    mesh = composed.make_composed_mesh(*mesh_shape)
    samples, acc = composed.sample_composed_pcn(
        aux, y, NOISE, beta=BETA, mesh=mesh, u0=u0,
        base_key=jax.random.key(9), n_samples=N_SAMPLES, burn_in=BURN,
        cg_iters=CG,
    )
    return np.asarray(samples), float(acc)


def test_mesh_shape_invariance():
    ref_samples, ref_acc = _run((8, 1))
    for shape in [(4, 2), (2, 4), (1, 8)]:
        s, a = _run(shape)
        np.testing.assert_allclose(s, ref_samples, rtol=0, atol=1e-5,
                                   err_msg=f"mesh {shape}")
        assert a == pytest.approx(ref_acc, abs=1e-6)


def test_matches_single_device_product_path():
    """The composed program on a (2, 4) mesh equals a plain single-device
    vmap-over-chains pCN loop built on models.darcy.solve_cg (the product's
    'cg' forward path) with the identical key derivation."""
    aux, y, u0 = _setup()
    basis3 = jnp.asarray(aux["scaled_basis"], jnp.float32).reshape(
        64, N_GRID, N_GRID
    )
    f = jnp.asarray(aux["source"], jnp.float32)
    obs_idx = np.asarray(aux["obs_indices"])

    def misfit(ub):  # (c, K) -> (c,)
        log_a = jnp.einsum("ck,krn->crn", ub, basis3)
        a = jnp.exp(log_a)
        sol = jax.vmap(
            lambda a2: darcy.solve_cg(a2, f, N_GRID, n_iters=CG,
                                      precond="jacobi")
        )(a)
        pred = sol[:, obs_idx]
        r = (y[None, :] - pred) / NOISE
        return 0.5 * jnp.sum(r * r, axis=1)

    base_key = jax.random.key(9)

    @jax.jit
    def run_reference(u0):
        gidx = jnp.arange(N_CHAINS)

        def step(carry, t):
            u, phi = carry
            keys = jax.vmap(
                lambda g: jax.random.fold_in(jax.random.fold_in(base_key, t), g)
            )(gidx)
            xi = jax.vmap(
                lambda k: jax.random.normal(jax.random.fold_in(k, 0), (64,))
            )(keys)
            log_u = jnp.log(
                jax.vmap(
                    lambda k: jax.random.uniform(jax.random.fold_in(k, 1))
                )(keys)
            )
            v = jnp.sqrt(1.0 - BETA**2) * u + BETA * xi
            phi_v = misfit(v)
            acc = log_u < (phi - phi_v)
            u = jnp.where(acc[:, None], v, u)
            phi = jnp.where(acc, phi_v, phi)
            return (u, phi), (u, acc)

        _, (us, accs) = jax.lax.scan(
            step, (u0, misfit(u0)), jnp.arange(BURN + N_SAMPLES)
        )
        return us[BURN:], jnp.mean(accs.astype(jnp.float32))

    ref_samples, ref_acc = run_reference(u0)
    s, a = _run((2, 4))
    # both solvers are Jacobi-PCG run to convergence (residual at float
    # noise after 150 iters on a 16x16 grid); agreement is limited only by
    # f32 reduction order, far inside the accept-decision margin
    np.testing.assert_allclose(s, np.asarray(ref_samples), rtol=0, atol=1e-4)
    assert a == pytest.approx(float(ref_acc), abs=1e-6)
    # the chains actually move (acceptance is high — the 0.05-noise
    # posterior is broad — so check motion directly)
    assert a > 0.05
    assert np.std(s[-1] - s[0]) > 1e-3


@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 4)])
def test_composed_config_misfit_matches_single_device(mesh_shape):
    """At the darcy_composed_* configs' σ = 0.002, the composed misfit
    equals the single-device batched misfit of darcy_da_fused on the same
    data to 1e-4 relative (chip_smoke's bound on the card)."""
    from ip_mcmc_tpu import configs

    kp = configs.build("darcy_composed_pcn").kernel_params
    single = configs.build("darcy_da_fused")
    u = jax.random.normal(jax.random.key(11), (64, 64))
    phi_c, _ = composed.composed_misfit_and_grad(
        kp["aux"], single.data, kp["noise_scale"],
        composed.make_composed_mesh(*mesh_shape), u, cg_iters=kp["cg_iters"])
    phi_1 = single.batched_potential_fn(u.T)
    np.testing.assert_allclose(np.asarray(phi_c), np.asarray(phi_1),
                               rtol=1e-4)


def _plain_misfit(aux, y, noise):
    """Single-device reference misfit built on the dense-graph solve path."""
    n = int(aux["n_grid"])
    basis = jnp.asarray(aux["scaled_basis"])
    f = jnp.asarray(aux["source"]).reshape(-1)
    obs = jnp.asarray(np.asarray(aux["obs_indices"]))

    def phi(u):
        a = jnp.exp(u @ basis).reshape(n, n)
        sol = darcy.solve_cg(a, f, n, n_iters=CG, precond="jacobi")
        r = (jnp.asarray(y) - sol[obs]) / NOISE
        return 0.5 * jnp.sum(r * r)

    return phi


class TestComposedMala:
    def test_distributed_adjoint_gradient_matches_ad(self):
        """The composed-mesh value-and-grad (distributed forward + adjoint
        solves + face-derivative assembly) matches jax.value_and_grad of the
        plain single-device misfit (implicit AD through custom_linear_solve)."""
        aux, y, u0 = _setup()
        u = u0[:8]
        mesh = composed.make_composed_mesh(2, 4)
        phi_c, g_c = composed.composed_misfit_and_grad(
            aux, y, NOISE, mesh, u, cg_iters=CG
        )
        phi_ref, g_ref = jax.vmap(
            jax.value_and_grad(_plain_misfit(aux, y, NOISE))
        )(u)
        np.testing.assert_allclose(
            np.asarray(phi_c), np.asarray(phi_ref), rtol=2e-4
        )
        np.testing.assert_allclose(
            np.asarray(g_c), np.asarray(g_ref), rtol=2e-3, atol=2e-3
        )

    def test_mala_mesh_shape_invariance(self):
        aux, y, u0 = _setup()

        def run(shape):
            mesh = composed.make_composed_mesh(*shape)
            s, a = composed.sample_composed_mala(
                aux, y, NOISE, step_size=0.05, mesh=mesh, u0=u0,
                base_key=jax.random.key(9), n_samples=10, burn_in=5,
                cg_iters=CG,
            )
            return np.asarray(s), float(a)

        ref_s, ref_a = run((8, 1))
        assert 0.05 < ref_a <= 1.0, ref_a
        for shape in [(2, 4), (1, 8)]:
            s, a = run(shape)
            np.testing.assert_allclose(s, ref_s, rtol=0, atol=2e-4,
                                       err_msg=f"mesh {shape}")
            assert a == pytest.approx(ref_a, abs=1e-6)


class TestComposedElliptical:
    def test_matches_single_device_and_mesh_invariance(self):
        """Composed elliptical slice sampling equals an independent plain
        vmap-over-chains reimplementation (same fixed-shrink schedule, same
        key derivation, built on models.darcy.solve_cg), and is mesh-shape
        invariant. Algorithmic correctness of the ESS transition itself is
        covered by tests/test_elliptical.py's distributional suite."""
        aux, y, u0 = _setup()
        max_shrink = 12
        n_samp, burn = 12, 6
        basis3 = jnp.asarray(aux["scaled_basis"], jnp.float32).reshape(
            64, N_GRID, N_GRID
        )
        f = jnp.asarray(aux["source"], jnp.float32)
        obs_idx = np.asarray(aux["obs_indices"])
        base_key = jax.random.key(9)

        def misfit(ub):  # (c, K) -> (c,)
            a = jnp.exp(jnp.einsum("ck,krn->crn", ub, basis3))
            sol = jax.vmap(
                lambda a2: darcy.solve_cg(a2, f, N_GRID, n_iters=CG,
                                          precond="jacobi")
            )(a)
            r = (y[None, :] - sol[:, obs_idx]) / NOISE
            return 0.5 * jnp.sum(r * r, axis=1)

        @jax.jit
        def run_reference(u0):
            gidx = jnp.arange(N_CHAINS)
            two_pi = jnp.float32(2.0 * np.pi)

            def step(carry, t):
                u, phi = carry
                keys = jax.vmap(
                    lambda g: jax.random.fold_in(
                        jax.random.fold_in(base_key, t), g)
                )(gidx)
                nu = jax.vmap(
                    lambda k: jax.random.normal(jax.random.fold_in(k, 0),
                                                (64,))
                )(keys)
                log_w = jnp.log(jax.vmap(
                    lambda k: jax.random.uniform(jax.random.fold_in(k, 1))
                )(keys))
                theta0 = jax.vmap(
                    lambda k: jax.random.uniform(
                        jax.random.fold_in(k, 2), minval=0.0, maxval=two_pi)
                )(keys)
                log_y = -phi + log_w

                def shrink(i, st):
                    u_new, phi_new, theta, lo, hi, done = st
                    v = (u * jnp.cos(theta)[:, None]
                         + nu * jnp.sin(theta)[:, None])
                    phi_v = misfit(v)
                    acc = (-phi_v > log_y) & ~done
                    u_new = jnp.where(acc[:, None], v, u_new)
                    phi_new = jnp.where(acc, phi_v, phi_new)
                    done = done | acc
                    lo = jnp.where(done | (theta >= 0.0), lo, theta)
                    hi = jnp.where(done | (theta < 0.0), hi, theta)
                    us01 = jax.vmap(
                        lambda k: jax.random.uniform(
                            jax.random.fold_in(k, 3 + i))
                    )(keys)
                    theta = jnp.where(done, theta, lo + us01 * (hi - lo))
                    return u_new, phi_new, theta, lo, hi, done

                done0 = jnp.zeros((N_CHAINS,), bool)
                u_new, phi_new, *_ = jax.lax.fori_loop(
                    0, max_shrink, shrink,
                    (u, phi, theta0, theta0 - two_pi, theta0, done0))
                return (u_new, phi_new), u_new

            _, us = jax.lax.scan(step, (u0, misfit(u0)),
                                 jnp.arange(burn + n_samp))
            return us[burn:]

        ref = np.asarray(run_reference(u0))

        def run(shape):
            mesh = composed.make_composed_mesh(*shape)
            s, ev = composed.sample_composed_elliptical(
                aux, y, NOISE, mesh=mesh, u0=u0, base_key=base_key,
                n_samples=n_samp, burn_in=burn, cg_iters=CG,
                max_shrink=max_shrink,
            )
            return np.asarray(s), float(ev)

        s81, ev = run((8, 1))
        np.testing.assert_allclose(s81, ref, rtol=0, atol=1e-4)
        # ESS is rejection-free: chains must move, and the expected
        # evaluation count per step sits in the documented ~1-4 band
        assert np.std(s81[-1] - s81[0]) > 1e-3
        assert 1.0 <= ev <= float(max_shrink)
        s24, ev24 = run((2, 4))
        np.testing.assert_allclose(s24, s81, rtol=0, atol=1e-4)
        assert ev24 == pytest.approx(ev, abs=1e-5)
