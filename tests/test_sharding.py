"""Multi-device tests on the 8-way virtual CPU mesh (SURVEY.md §4.2 item 4):
sharded run ≡ single-device run bit-for-bit, collectives vs serial oracle.
Determinism across mesh shapes doubles as the 'race detector' (§5.2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from ip_mcmc_tpu import driver, parallel
from ip_mcmc_tpu.distributions import DiagGaussian
from ip_mcmc_tpu.kernels import pcn, rwm

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def logdensity(x):
    return -0.5 * jnp.sum(x * x)


def _setup(n_chains=64, dim=4):
    kernel = rwm.build_kernel(logdensity, step_size=0.7)
    positions = jax.random.normal(jax.random.key(0), (n_chains, dim))
    state = driver.init_chains(rwm.init, positions, logdensity)
    return kernel, state


def test_mesh_construction():
    mesh = parallel.make_chain_mesh()
    assert mesh.axis_names == (parallel.CHAIN_AXIS,)
    assert mesh.devices.size == 8


def test_sharded_state_placement():
    mesh = parallel.make_chain_mesh()
    _, state = _setup(n_chains=64)
    sharded = parallel.shard_chains(state, mesh)
    shard_shapes = [
        s.data.shape for s in sharded.position.addressable_shards
    ]
    assert all(sh == (8, 4) for sh in shard_shapes)  # 64 chains / 8 devices


def test_sharded_equals_single_device_bitwise():
    """Same base key ⇒ identical samples regardless of device placement."""
    kernel, state = _setup(n_chains=64)
    mesh = parallel.make_chain_mesh()
    _, s_single, _ = driver.sample_chains(
        kernel, state, jax.random.key(5), n_samples=20, burn_in=10
    )
    _, s_sharded, _ = parallel.sample_chains_sharded(
        kernel, state, jax.random.key(5), mesh, n_samples=20, burn_in=10
    )
    np.testing.assert_array_equal(np.asarray(s_single), np.asarray(s_sharded))


def test_mesh_shape_invariance():
    """2-device vs 8-device mesh produce identical results (determinism as
    collective-misuse detector)."""
    kernel, state = _setup(n_chains=32)
    mesh8 = parallel.make_chain_mesh()
    mesh2 = parallel.make_chain_mesh(n_devices=2)
    _, s8, _ = parallel.sample_chains_sharded(
        kernel, state, jax.random.key(3), mesh8, n_samples=15, burn_in=5
    )
    _, s2, _ = parallel.sample_chains_sharded(
        kernel, state, jax.random.key(3), mesh2, n_samples=15, burn_in=5
    )
    np.testing.assert_array_equal(np.asarray(s8), np.asarray(s2))


def test_cross_chain_reduction_matches_serial():
    """Pooled moments over a sharded chain axis == NumPy oracle."""
    mesh = parallel.make_chain_mesh()
    x = jax.random.normal(jax.random.key(1), (64, 4))
    xs = jax.device_put(x, parallel.chain_sharding(mesh))

    @jax.jit
    def pooled(a):
        mean = jnp.mean(a, axis=0)
        cov = (a - mean).T @ (a - mean) / (a.shape[0] - 1)
        return mean, cov

    mean, cov = pooled(xs)
    np.testing.assert_allclose(np.asarray(mean), np.asarray(x).mean(0), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(cov), np.cov(np.asarray(x).T), atol=1e-5
    )


def test_shard_map_psum_acceptance_stats():
    """Explicit shard_map path: per-device acceptance counts pooled with psum
    equal the global mean (the CountedAccepter collective)."""
    mesh = parallel.make_chain_mesh()
    accepted = (jax.random.uniform(jax.random.key(2), (64,)) < 0.3).astype(
        jnp.float32
    )
    accepted_sharded = jax.device_put(accepted, parallel.chain_sharding(mesh))

    def rate(a):
        local_sum = jnp.sum(a)
        total = jax.lax.psum(local_sum, parallel.CHAIN_AXIS)
        n = jax.lax.psum(jnp.float32(a.shape[0]), parallel.CHAIN_AXIS)
        return (total / n)[None]

    f = jax.shard_map(
        rate, mesh=mesh, in_specs=P(parallel.CHAIN_AXIS), out_specs=P(parallel.CHAIN_AXIS)
    )
    out = np.asarray(f(accepted_sharded))
    np.testing.assert_allclose(out, np.asarray(accepted).mean(), atol=1e-6)


def test_pcn_sharded_posterior():
    """End-to-end sharded pCN on the conjugate Gaussian IP."""
    mesh = parallel.make_chain_mesh()
    prior = DiagGaussian(mean=jnp.zeros(2), scale=jnp.ones(2))
    y = jnp.array([1.0, 1.0])
    phi = lambda u: 0.5 * jnp.sum((y - u) ** 2)
    kernel = pcn.build_kernel(phi, prior, beta=0.4)
    key_i, key_r = jax.random.split(jax.random.key(7))
    state = driver.init_chains(pcn.init, prior.sample(key_i, (256,)), phi)
    _, samples, _ = parallel.sample_chains_sharded(
        kernel, state, key_r, mesh, n_samples=600, burn_in=300
    )
    flat = np.asarray(samples).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), [0.5, 0.5], atol=0.06)
    np.testing.assert_allclose(np.cov(flat.T), 0.5 * np.eye(2), atol=0.1)


class TestShardedFusedChains:
    """shard_map over the fused chain engine (parallel.fused_shard)."""

    def _phi(self):
        y = jnp.array([1.0, 1.0])
        return lambda x: 0.5 * jnp.sum((y[:, None] - x) ** 2, axis=0)

    def test_matches_serial_oracle_per_device(self):
        """Each device's shard is BITWISE a standalone single-device run
        with that device's decorrelated seed."""
        from ip_mcmc_tpu.ops import fused_pcn_chain
        from ip_mcmc_tpu.parallel.fused_shard import SEED_STRIDE

        phi = self._phi()
        mesh = parallel.make_chain_mesh()
        n, d = 1024, 2
        pos = jax.random.normal(jax.random.key(0), (n, d))
        kw = dict(prior_mean=np.zeros(d), prior_scale=np.ones(d), beta=0.5,
                  n_steps=50, block_chains=128)
        final, acc = parallel.sharded_fused_chain(
            fused_pcn_chain, mesh, phi, pos, seed=7, **kw)
        per = n // mesh.devices.size
        for didx in (0, mesh.devices.size - 1):
            f2, _ = fused_pcn_chain(
                phi, pos[didx * per:(didx + 1) * per],
                seed=7 + didx * SEED_STRIDE, **kw)
            np.testing.assert_array_equal(
                np.asarray(final[didx * per:(didx + 1) * per]), np.asarray(f2))

    def test_recorded_variant_shards_sample_axis(self):
        from ip_mcmc_tpu.ops import fused_pcn_chain_recorded

        phi = self._phi()
        mesh = parallel.make_chain_mesh()
        n, d = 1024, 2
        pos = jnp.zeros((n, d), jnp.float32)
        final, acc, samples = parallel.sharded_fused_chain(
            fused_pcn_chain_recorded, mesh, phi, pos, seed=3,
            prior_mean=np.zeros(d), prior_scale=np.ones(d), beta=0.5,
            n_steps=20, thin=4, block_chains=128,
        )
        assert samples.shape == (5, n, d)
        np.testing.assert_allclose(np.asarray(samples[-1]), np.asarray(final))

    def test_validation(self):
        from ip_mcmc_tpu.ops import fused_pcn_chain

        phi = self._phi()
        mesh = parallel.make_chain_mesh()
        with pytest.raises(ValueError):
            parallel.sharded_fused_chain(
                fused_pcn_chain, mesh, phi, jnp.zeros((1000, 2)), seed=0,
                prior_mean=np.zeros(2), prior_scale=np.ones(2), beta=0.5)

    def test_warm_variant_with_carried_aux_shards(self):
        """The warm kernel's carried CG solution stays device-local under
        shard_map (aux never crosses the mesh)."""
        from ip_mcmc_tpu import distributions as dist
        from ip_mcmc_tpu.models import darcy
        from ip_mcmc_tpu.ops import fused_pcn_chain_warm

        fwd, aux = darcy.make_darcy_forward(n_grid=8, n_modes_per_dim=4,
                                            alpha=2.0, field_scale=10.0)
        K = 16
        noise = dist.DiagGaussian(mean=jnp.zeros(16), scale=0.01 * jnp.ones(16))
        u_true = jax.random.normal(jax.random.key(300), (K,))
        y = fwd(u_true) + noise.sample(jax.random.key(301))
        warm, aux_dim = darcy.make_batched_misfit_warm(aux, y, 0.01, cg_iters=8)
        mesh = parallel.make_chain_mesh()
        n = 8 * mesh.devices.size
        pos = jax.random.normal(jax.random.key(1), (n, K)) * 0.3
        final, acc = parallel.sharded_fused_chain(
            fused_pcn_chain_warm, mesh, warm, pos, seed=3,
            prior_mean=np.zeros(K), prior_scale=np.ones(K), beta=0.1,
            n_steps=5, aux_dim=aux_dim, block_chains=8,
        )
        assert final.shape == pos.shape
        assert np.isfinite(np.asarray(final)).all()


class TestComposedFused:
    """Fused per-device launches under the ('chains','model') composed mesh
    (parallel.sharded_fused_chain_composed): the 2-D mesh acts as a flat
    chain pool when each chain's solve fits one device."""

    def _phi(self):
        y = jnp.array([1.0, 1.0])
        return lambda x: 0.5 * jnp.sum((y[:, None] - x) ** 2, axis=0)

    def test_matches_standalone_per_device(self):
        """Device (i, j)'s shard is BITWISE a standalone run with the
        flattened-index seed."""
        from ip_mcmc_tpu.ops import fused_pcn_chain
        from ip_mcmc_tpu.parallel.composed import make_composed_mesh
        from ip_mcmc_tpu.parallel.fused_shard import SEED_STRIDE

        phi = self._phi()
        mesh = make_composed_mesh(4, 2)
        n, d = 512, 2
        pos = jax.random.normal(jax.random.key(0), (n, d))
        kw = dict(prior_mean=np.zeros(d), prior_scale=np.ones(d), beta=0.5,
                  n_steps=40, block_chains=64)
        final, acc = parallel.sharded_fused_chain_composed(
            fused_pcn_chain, mesh, phi, pos, seed=7, **kw)
        per = n // 8
        for flat in (0, 3, 7):
            f2, _ = fused_pcn_chain(
                phi, pos[flat * per:(flat + 1) * per],
                seed=7 + flat * SEED_STRIDE, **kw)
            np.testing.assert_array_equal(
                np.asarray(final[flat * per:(flat + 1) * per]),
                np.asarray(f2))

    def test_matches_flat_chain_mesh(self):
        """Full-width result on the (4,2) composed mesh == the 1-D 8-device
        chain mesh (same flattened seed policy -> bitwise identical)."""
        from ip_mcmc_tpu.ops import fused_pcn_chain

        phi = self._phi()
        from ip_mcmc_tpu.parallel.composed import make_composed_mesh

        pos = jax.random.normal(jax.random.key(2), (512, 2))
        kw = dict(prior_mean=np.zeros(2), prior_scale=np.ones(2), beta=0.5,
                  n_steps=30, block_chains=64, seed=11)
        f_2d, _ = parallel.sharded_fused_chain_composed(
            fused_pcn_chain, make_composed_mesh(4, 2), phi, pos, **kw)
        f_1d, _ = parallel.sharded_fused_chain(
            fused_pcn_chain, parallel.make_chain_mesh(), phi, pos, **kw)
        np.testing.assert_array_equal(np.asarray(f_2d), np.asarray(f_1d))

    def test_recorded_variant(self):
        from ip_mcmc_tpu.ops import fused_pcn_chain_recorded
        from ip_mcmc_tpu.parallel.composed import make_composed_mesh

        phi = self._phi()
        pos = jax.random.normal(jax.random.key(3), (512, 2))
        final, acc, samples = parallel.sharded_fused_chain_composed(
            fused_pcn_chain_recorded, make_composed_mesh(2, 4), phi, pos,
            seed=5, prior_mean=np.zeros(2), prior_scale=np.ones(2),
            beta=0.5, n_steps=20, thin=2, block_chains=64)
        assert samples.shape == (10, 512, 2)
        assert np.isfinite(np.asarray(samples)).all()


class TestShardedFusedDA:
    """The round-4 headline kernel (fused delayed-acceptance pCN) under
    chain sharding: each device's shard is bitwise a standalone run with
    its decorrelated seed — the same serial-oracle guarantee the plain
    fused kernels carry."""

    def test_da_matches_serial_oracle_per_device(self):
        from ip_mcmc_tpu.ops import fused_da_pcn_chain
        from ip_mcmc_tpu.parallel.fused_shard import SEED_STRIDE

        y = jnp.array([1.0, -0.5])
        phi = lambda x: 0.5 * jnp.sum((y[:, None] - x) ** 2, axis=0)
        surr = lambda x: 0.55 * jnp.sum((y[:, None] - x) ** 2, axis=0)
        mesh = parallel.make_chain_mesh()
        n, d = 512, 2
        pos = jax.random.normal(jax.random.key(0), (n, d))
        kw = dict(prior_mean=np.zeros(d), prior_scale=np.ones(d), beta=0.4,
                  n_steps=12, subchain_len=4, block_chains=64)

        def da_fn(p, positions, **kwargs):
            return fused_da_pcn_chain(p, surr, positions, **kwargs)

        final, acc, inner = parallel.sharded_fused_chain(
            da_fn, mesh, phi, pos, seed=7, **kw)
        per = n // mesh.devices.size
        for didx in (0, mesh.devices.size - 1):
            f2, a2, i2 = da_fn(
                phi, pos[didx * per:(didx + 1) * per],
                seed=7 + didx * SEED_STRIDE, **kw)
            np.testing.assert_array_equal(
                np.asarray(final[didx * per:(didx + 1) * per]),
                np.asarray(f2))
