"""Chain driver: the reference's ``MCMCSampler.run`` loop (SURVEY.md §3.1),
re-architected as one compiled XLA program.

Reference semantics (layer L4, ``ip_mcmc/sampler.py`` [H behavior]):
``run(u0, n_samples, burn_in, sample_interval)`` → propose / accept-reject /
record with burn-in and thinning, returning ``(n_samples, dim)``.

Accelerator design:
- the per-step Python loop becomes ``lax.scan`` (steps are compiled, not
  interpreted);
- thinning is a scan-of-scans — inner ``scan`` of ``thin`` steps, outer scan
  emits one retained sample, so memory is flat in total chain length;
- chains are a ``vmap`` axis ((n_chains, dim) state), which the mesh layer
  (ip_mcmc_tpu.parallel) shards across devices;
- RNG is counter-based: step keys are ``fold_in(base_key, step)`` then split
  per chain — replayable for checkpoint/resume, identical on any mesh shape;
- info/metrics are reduced on-device (mean over chains per retained sample),
  the ``CountedAccepter`` equivalent.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def chain_keys(base_key, step, n_chains):
    """Per-(step, chain) keys, deterministic in (base_key, step, chain)."""
    return jax.random.split(jax.random.fold_in(base_key, step), n_chains)


def _batched_step(kernel, base_key, n_chains):
    def step(state, step_idx):
        keys = chain_keys(base_key, step_idx, n_chains)
        return jax.vmap(kernel)(keys, state)

    return step


@partial(
    jax.jit,
    static_argnames=(
        "kernel", "n_samples", "burn_in", "thin", "n_chains", "record_fn",
        "accum_field",
    ),
)
def sample_chains(
    kernel,
    state,
    base_key,
    *,
    n_samples,
    burn_in=0,
    thin=1,
    n_chains=None,
    record_fn=None,
    accum_field=None,
):
    """Run vmapped chains; return (final_state, samples, info_means).

    Parameters
    ----------
    kernel : single-chain ``step(key, state) -> (state, info)``.
    state : chain-batched state pytree, leading axis ``n_chains``.
    base_key : scalar PRNG key.
    n_samples : retained samples per chain (after burn-in, every ``thin``).
    record_fn : state -> recorded pytree (default: ``state.position``).
    accum_field : optional info-field name (e.g. ``"accepted"``) to sum
        EXACTLY over every step of every chain — burn-in included — on
        device (int32; exact below 2³¹ events). When set, the return is a
        4-tuple ``(state, samples, info_means, total)``. This is the exact
        ``CountedAccepter`` counter (round-2 VERDICT weak #3: the retained-
        step extrapolation was biased during non-stationary burn-in).

    Returns samples with shape ``(n_samples, n_chains, ...)`` and a pytree of
    per-retained-step chain-mean info (acceptance statistics etc.).
    """
    if n_chains is None:
        n_chains = jax.tree_util.tree_leaves(state)[0].shape[0]
    if record_fn is None:
        record_fn = lambda s: s.position
    step = _batched_step(kernel, base_key, n_chains)

    def _count(info):
        if accum_field is None:
            return jnp.int32(0)
        return jnp.sum(getattr(info, accum_field).astype(jnp.int32))

    def burn_body(carry, step_idx):
        state, acc = carry
        state, info = step(state, step_idx)
        return (state, acc + _count(info)), None

    (state, acc), _ = jax.lax.scan(
        burn_body, (state, jnp.int32(0)), jnp.arange(burn_in), length=burn_in
    )

    def inner(carry, step_idx):
        state, acc = carry
        state, info = step(state, step_idx)
        return (state, acc + _count(info)), info

    def outer(carry, sample_idx):
        steps = burn_in + sample_idx * thin + jnp.arange(thin)
        carry, infos = jax.lax.scan(inner, carry, steps)
        # keep only the last step's info, mean-reduced over chains on-device
        info_mean = jax.tree_util.tree_map(
            lambda x: jnp.mean(x[-1].astype(jnp.float32), axis=0), infos
        )
        return carry, (record_fn(carry[0]), info_mean)

    (state, acc), (samples, info_means) = jax.lax.scan(
        outer, (state, acc), jnp.arange(n_samples)
    )
    if accum_field is not None:
        return state, samples, info_means, acc
    return state, samples, info_means


def init_chains(init_fn, positions, *args):
    """vmap a kernel's ``init`` over a (n_chains, dim) position batch."""
    return jax.vmap(lambda p: init_fn(p, *args))(positions)
