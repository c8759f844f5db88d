"""Device mesh & sharding policy — the distributed backend (SURVEY.md §2.4).

The reference is single-process/single-chain; the rebuild's parallelism axis
is CHAINS (data parallel ≡ chain/particle parallel, SURVEY.md §2.3): chain
state pytrees carry a leading ``(n_chains, ...)`` axis, sharded over the
1-D device mesh ``('chains',)``. The four cards of one host are joined all
to all by NVLink, so no device order is closer than another and the mesh
follows the algorithm alone. A second ``'model'`` axis is for sharded-grid
forward solves (SURVEY.md §5.7; ``parallel.composed``).

Transport is XLA collectives, which XLA hands to NCCL on GPUs; this
module's job is only mesh construction + sharding annotation. Computation
stays in the global view: ``driver.sample_chains`` jitted with sharded
inputs lets XLA partition the vmapped kernel across devices (zero
collectives in the hot loop — chains are independent); cross-chain
reductions (adaptation, diagnostics, SMC) are plain jnp reductions that XLA
lowers to psum/all-gather over the mesh.

Multi-host bootstrap: ``distributed_init`` wraps ``jax.distributed
.initialize`` (one process per host).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAIN_AXIS = "chains"
MODEL_AXIS = "model"  # reserved extension axis (SURVEY.md §5.7)


def distributed_init(coordinator_address=None, num_processes=None, process_id=None):
    """Multi-host bootstrap (no-op if already initialized)."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_chain_mesh(n_devices=None, devices=None):
    """1-D mesh over the chain axis. Defaults to all visible devices.

    Built as a plain ``Mesh`` (Auto axis types): the samplers rely on XLA's
    global-view partitioning of the vmapped kernel, not explicit sharding
    propagation — ``jax.make_mesh`` in jax>=0.9 would default the axis to
    Explicit and change jnp-reduction semantics under the mesh context."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (CHAIN_AXIS,))


def chain_sharding(mesh, batched=True):
    """NamedSharding putting the leading (chain) axis across the mesh."""
    return NamedSharding(mesh, P(CHAIN_AXIS) if batched else P())


def shard_chains(pytree, mesh):
    """Place a chain-batched pytree with its leading axis sharded.

    Works in BOTH runtime shapes:
    - single process: plain ``device_put`` with the chain NamedSharding;
    - multi-process (``jax.distributed``): every process holds the full
      (replicated, deterministically-initialized) value; each contributes
      its contiguous chain slice via ``make_array_from_process_local_data``
      (process order == ``jax.devices()`` order == mesh order, so slices
      line up — the layout the multiprocess product tests verify bitwise).
    """
    if jax.process_count() == 1:
        sharding = chain_sharding(mesh)
        return jax.tree_util.tree_map(
            lambda x: jax.device_put(x, sharding), pytree
        )
    n_proc, pid = jax.process_count(), jax.process_index()

    def to_global(x):
        x = np.asarray(x)
        n = x.shape[0]
        if n % n_proc:
            raise ValueError(
                f"chain axis {n} must be divisible by process count {n_proc}"
            )
        per = n // n_proc
        spec = P(CHAIN_AXIS, *([None] * (x.ndim - 1)))
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), x[pid * per : (pid + 1) * per]
        )

    return jax.tree_util.tree_map(to_global, pytree)


def replicate(pytree, mesh):
    sharding = chain_sharding(mesh, batched=False)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), pytree
    )


def sample_chains_sharded(kernel, state, base_key, mesh, **kwargs):
    """``driver.sample_chains`` with the chain axis sharded over ``mesh``.

    The chain state is placed with a ``('chains',)`` sharding; XLA then
    partitions the whole scan body (the vmapped kernel) across devices.
    Samples come back sharded as (n_samples, chains@mesh, dim). Bitwise
    identical to the single-device run for the same base key: per-chain
    threefry streams don't depend on device placement (tested in
    tests/test_sharding.py — the "race detector" of SURVEY.md §5.2).
    """
    from ip_mcmc_tpu import driver

    state = shard_chains(state, mesh)
    return driver.sample_chains(kernel, state, base_key, **kwargs)
