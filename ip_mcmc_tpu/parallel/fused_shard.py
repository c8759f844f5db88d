"""Multi-device fused chains: shard_map the fused chain engine over the
'chains' mesh axis.

The fused entry points (ops.fused_mcmc) are per-device programs — all of a
device's chain blocks advanced in lockstep. This wrapper row-shards the
(n_chains, d) state over the chain mesh and runs the SAME fused program on
every device's shard inside one ``shard_map``-ed XLA program: zero
cross-device communication during sampling (chains are independent), so
scaling is embarrassingly parallel; per-device PRNG streams are decorrelated
by folding ``axis_index`` into the seed. On four cards of one host the mesh
is a flat chain pool: every card reaches every other over NVLink at the
same rate, so the mesh follows the algorithm, not the wiring.

Serial-oracle equivalence (device d's shard ≡ a single-device run of that
shard with seed + d·SEED_STRIDE) is tested in tests/test_sharding.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ip_mcmc_tpu.parallel.mesh import CHAIN_AXIS

SEED_STRIDE = 1_000_003  # decorrelates per-device counter-hash streams


def sharded_fused_chain(fused_fn, mesh, potential_fn, positions, *, seed,
                        **kwargs):
    """Run ``fused_fn`` (an ops.fused_* entry point) on a chain-sharded
    position array. ``kwargs`` pass through (step_size/beta/priors/...).

    Returns outputs with the chain axis sharded over the mesh: the same
    (final_positions, accept_rate[, samples]) tuple the fused kernel
    returns, with samples' chain axis sharded too.
    """
    n = positions.shape[0]
    n_dev = mesh.devices.size
    if n % n_dev:
        raise ValueError(f"n_chains {n} must divide over {n_dev} devices")
    block = kwargs.get("block_chains", 256)
    if (n // n_dev) % block:
        raise ValueError(
            f"per-device chains {n // n_dev} must be a multiple of "
            f"block_chains {block}"
        )

    def local(pos_local):
        dev_seed = seed + jax.lax.axis_index(CHAIN_AXIS) * SEED_STRIDE
        out = fused_fn(potential_fn, pos_local, seed=dev_seed, **kwargs)
        return tuple(out)

    probe = jax.eval_shape(
        lambda p: fused_fn(potential_fn, p, seed=jnp.int32(0), **kwargs),
        jax.ShapeDtypeStruct((n // n_dev,) + positions.shape[1:], positions.dtype),
    )
    # chain axis position: samples are (n_rec, chains, d); others lead with chains
    out_specs = tuple(
        P(None, CHAIN_AXIS) if o.ndim == 3 else P(CHAIN_AXIS) for o in probe
    )
    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(CHAIN_AXIS),), out_specs=out_specs,
        check_vma=False,
    )(positions)


def sharded_fused_chain_composed(fused_fn, mesh, potential_fn, positions,
                                 *, seed, **kwargs):
    """Fused per-device runs under a composed ``('chains','model')`` mesh
    (ROADMAP P2): when each chain's solve fits one device, the 2-D mesh is
    a flat chain pool — the chain axis shards over BOTH mesh axes and every
    device runs the same fused program on its shard.

    Why: a long-lived service holds ONE mesh. Large grid-sharded solves
    (parallel.composed) need the 'model' axis; small/fused configs would
    otherwise idle ``n_model - 1`` of every ``n_model`` devices. This entry
    point runs them at full width on the SAME mesh object, no re-meshing.

    Seed policy mirrors :func:`sharded_fused_chain` with the flattened
    device index ``chains_idx * n_model + model_idx``, so device (i, j)'s
    shard is bitwise a standalone single-device run with seed
    ``seed + (i*n_model + j) * SEED_STRIDE`` (tested in
    tests/test_sharding.py).
    """
    from ip_mcmc_tpu.parallel.mesh import MODEL_AXIS

    n = positions.shape[0]
    n_dev = mesh.devices.size
    n_model = mesh.shape[MODEL_AXIS]
    if n % n_dev:
        raise ValueError(f"n_chains {n} must divide over {n_dev} devices")
    block = kwargs.get("block_chains", 256)
    if (n // n_dev) % block:
        raise ValueError(
            f"per-device chains {n // n_dev} must be a multiple of "
            f"block_chains {block}"
        )

    def local(pos_local):
        flat = (jax.lax.axis_index(CHAIN_AXIS) * n_model
                + jax.lax.axis_index(MODEL_AXIS))
        out = fused_fn(potential_fn, pos_local, seed=seed + flat * SEED_STRIDE,
                       **kwargs)
        return tuple(out)

    probe = jax.eval_shape(
        lambda p: fused_fn(potential_fn, p, seed=jnp.int32(0), **kwargs),
        jax.ShapeDtypeStruct((n // n_dev,) + positions.shape[1:],
                             positions.dtype),
    )
    both = (CHAIN_AXIS, MODEL_AXIS)
    out_specs = tuple(
        P(None, both) if o.ndim == 3 else P(both) for o in probe
    )
    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(both),), out_specs=out_specs,
        check_vma=False,
    )(positions)
