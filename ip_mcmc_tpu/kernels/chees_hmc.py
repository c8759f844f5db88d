"""ChEES-HMC: cross-chain ensemble adaptation of the HMC trajectory length
(Hoffman, Radul & Sountsov, AISTATS 2021).

Beyond-reference capability (ROADMAP P2): the ensemble alternative to NUTS.
NUTS's per-chain recursive tree building vmaps badly — every chain pays the
max tree depth (see kernels/nuts.py). ChEES instead adapts ONE shared
trajectory length τ by maximizing the Change in the Estimator of the
Expected Square criterion,

    ChEES = ¼ E[(‖x' − E x'‖² − ‖x − E x‖²)²],

whose gradient w.r.t. τ has the per-chain Monte-Carlo estimator

    ĝ = mean_c[ α_c · (‖x'_c − x̄'‖² − ‖x_c − x̄‖²) · (x'_c − x̄') · v'_c ] · u
        / mean_c[α_c]

(α = accept prob, v' = final velocity, u = the trajectory jitter) — an
expectation over the CHAIN axis, i.e. exactly what thousands of vmapped
chains give for free, one psum/pmean per step when sharded.

Accelerator design: the kernel is BATCH-LEVEL — it updates the whole
(n_chains, d) block at once. Trajectory jitter u is shared across chains
(one Halton draw per iteration), so the leapfrog count is a single traced
scalar and the integration is one ``lax.fori_loop`` over whole-batch
leapfrog steps — no per-chain dynamic control flow, no masked tree building,
dense-matmul gradient batches. Step size ε adapts by dual averaging on the
pooled acceptance; τ by Adam on the ChEES gradient; both frozen after
warmup (detailed balance).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ip_mcmc_tpu.adapt import dual_averaging as da
from ip_mcmc_tpu.utils.struct import pytree_dataclass


@pytree_dataclass
class CheesState:
    """Batch state: leading axis is the chain axis."""

    positions: jnp.ndarray  # (n, d)
    log_densities: jnp.ndarray  # (n,)
    grads: jnp.ndarray  # (n, d)


@pytree_dataclass
class CheesInfo:
    accept_prob: jnp.ndarray  # (n,)
    accepted: jnp.ndarray  # (n,) bool
    final_velocity: jnp.ndarray  # (n, d) — feeds the ChEES gradient
    proposal: jnp.ndarray  # (n, d)


def init(positions, log_density_fn):
    ld, g = jax.vmap(jax.value_and_grad(log_density_fn))(positions)
    return CheesState(positions=positions, log_densities=ld, grads=g)


def halton(i, base=2):
    """Radical-inverse (van der Corput) sequence in base 2 for the shared
    trajectory jitter — low-discrepancy, deterministic, trace-friendly."""
    i = jnp.asarray(i, jnp.uint32) + 1

    def body(k, carry):
        acc, denom, n = carry
        acc = acc + (n % 2).astype(jnp.float32) * denom
        return acc, denom * 0.5, n // 2

    acc, _, _ = jax.lax.fori_loop(
        0, 32, body, (jnp.float32(0.0), jnp.float32(0.5), i)
    )
    return acc


def batch_step(log_density_fn, state, key, step_size, trajectory_length,
               jitter_u, inv_mass=None):
    """One jittered-HMC transition of the WHOLE chain batch.

    Integrates ⌈(u·τ)/ε⌉ leapfrog steps (a single traced scalar — shared
    across chains) and Metropolis-corrects per chain. Returns
    (CheesState, CheesInfo).
    """
    n, d = state.positions.shape
    vg = jax.vmap(jax.value_and_grad(log_density_fn))
    key_mom, key_acc = jax.random.split(key)
    if inv_mass is None:
        inv_mass = jnp.ones((d,), state.positions.dtype)
    sqrt_mass = 1.0 / jnp.sqrt(inv_mass)

    traj = jitter_u * trajectory_length
    n_leap = jnp.maximum(jnp.ceil(traj / step_size).astype(jnp.int32), 1)
    # integrate EXACTLY time τ·u with n_leap equal steps of size ≤ ε: the
    # dynamics is then continuous in τ (no step-count quantization), which
    # is what makes the ChEES gradient meaningful
    eps = traj / n_leap.astype(traj.dtype)

    p0 = sqrt_mass[None, :] * jax.random.normal(
        key_mom, (n, d), state.positions.dtype
    )

    def leapfrog(_, carry):
        x, p, g = carry
        p_half = p + 0.5 * eps * g  # g = ∇log π
        x_new = x + eps * inv_mass[None, :] * p_half
        _, g_new = vg(x_new)
        p_new = p_half + 0.5 * eps * g_new
        return x_new, p_new, g_new

    x1, p1, g1 = jax.lax.fori_loop(
        0, n_leap, leapfrog, (state.positions, p0, state.grads)
    )
    ld1, g1 = vg(x1)

    kin0 = 0.5 * jnp.sum(inv_mass[None, :] * p0 * p0, axis=1)
    kin1 = 0.5 * jnp.sum(inv_mass[None, :] * p1 * p1, axis=1)
    log_ratio = (ld1 - kin1) - (state.log_densities - kin0)
    log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
    accept_prob = jnp.exp(jnp.minimum(log_ratio, 0.0))
    log_u = jnp.log(jax.random.uniform(key_acc, (n,), state.positions.dtype))
    accepted = log_u < log_ratio

    sel = accepted[:, None]
    new_state = CheesState(
        positions=jnp.where(sel, x1, state.positions),
        log_densities=jnp.where(accepted, ld1, state.log_densities),
        grads=jnp.where(sel, g1, state.grads),
    )
    info = CheesInfo(
        accept_prob=accept_prob,
        accepted=accepted,
        final_velocity=inv_mass[None, :] * p1,
        proposal=x1,
    )
    return new_state, info


def chees_gradient(state, info, jitter_u):
    """Monte-Carlo ∂ChEES/∂τ over the chain axis (pmean-compatible).

    ``state`` must be the PRE-step state: the Hoffman–Radul–Sountsov
    estimator contrasts the proposal x' against the positions x the
    trajectory STARTED from. Feeding the post-update state (where accepted
    chains already hold x') partially cancels the ‖x−x̄‖² term against
    ‖x'−x̄'‖² and weakens the gradient (advisor round-1 finding).

    Diverged trajectories (NaN/inf proposals — rejected by the MH test with
    probability 1) are masked out of the estimator: their accept_prob is 0
    but 0·NaN would still be NaN, and one bad chain would poison x̄'."""
    x, xp, v = state.positions, info.proposal, info.final_velocity
    ok = jnp.all(jnp.isfinite(xp) & jnp.isfinite(v), axis=1)
    xp = jnp.where(ok[:, None], xp, x)
    v = jnp.where(ok[:, None], v, 0.0)
    w = jnp.where(ok, info.accept_prob, 0.0)
    xbar = jnp.mean(x, axis=0)
    xpbar = jnp.mean(xp, axis=0)
    dsq = jnp.sum((xp - xpbar) ** 2, axis=1) - jnp.sum((x - xbar) ** 2, axis=1)
    proj = jnp.sum((xp - xpbar) * v, axis=1)
    num = jnp.mean(w * dsq * proj) * jitter_u
    return num / jnp.maximum(jnp.mean(w), 1e-6)


@pytree_dataclass
class AdamState:
    log_value: jnp.ndarray
    m: jnp.ndarray
    v: jnp.ndarray
    t: jnp.ndarray


def adam_init(value):
    z = jnp.zeros((), jnp.float32)
    return AdamState(log_value=jnp.log(jnp.float32(value)), m=z, v=z, t=z)


def adam_ascend(s, grad, lr=0.025, b1=0.9, b2=0.999, eps=1e-8):
    t = s.t + 1.0
    m = b1 * s.m + (1.0 - b1) * grad
    v = b2 * s.v + (1.0 - b2) * grad * grad
    mhat = m / (1.0 - b1**t)
    vhat = v / (1.0 - b2**t)
    return AdamState(
        log_value=s.log_value + lr * mhat / (jnp.sqrt(vhat) + eps),
        m=m, v=v, t=t,
    )


@partial(
    jax.jit,
    static_argnames=("log_density_fn", "num_steps", "adapt_mass"),
)
def warmup_chees(
    log_density_fn,
    positions,
    base_key,
    num_steps=400,
    initial_step_size=0.1,
    initial_trajectory=1.0,
    target_accept=0.651,
    adapt_mass=True,
):
    """Joint warmup: ε by dual averaging on pooled acceptance, τ by Adam on
    the ChEES gradient, diagonal mass from cross-chain variances. Returns
    (state, step_size, trajectory_length, inv_mass) — all frozen."""
    state = init(positions, log_density_fn)
    n, d = positions.shape

    def body(carry, step_idx):
        st, das, adam, inv_mass = carry
        u = halton(step_idx)
        key = jax.random.fold_in(base_key, step_idx)
        tau = jnp.exp(adam.log_value)
        # ε is capped at τ: beyond it the (≥1-step) dynamics no longer
        # depends on ε and dual averaging would run away on easy targets
        pre = st  # ChEES gradient contrasts proposals vs PRE-step positions
        st, info = batch_step(
            log_density_fn, st, key,
            step_size=jnp.minimum(da.current(das), tau),
            trajectory_length=tau,
            jitter_u=u, inv_mass=inv_mass,
        )
        das = da.update(das, jnp.mean(info.accept_prob), target=target_accept)
        adam = adam_ascend(adam, chees_gradient(pre, info, u))
        if adapt_mass:
            inv_mass = jnp.var(st.positions, axis=0) + 1e-6
        return (st, das, adam, inv_mass), jnp.mean(info.accept_prob)

    carry0 = (
        state,
        da.init(initial_step_size),
        adam_init(initial_trajectory),
        jnp.ones((d,), positions.dtype),
    )
    (state, das, adam, inv_mass), _ = jax.lax.scan(
        body, carry0, jnp.arange(num_steps)
    )
    tau = jnp.exp(adam.log_value)
    return state, jnp.minimum(da.final(das), tau), tau, inv_mass


@partial(
    jax.jit,
    static_argnames=("log_density_fn", "n_samples", "burn_in", "thin"),
)
def sample_chees(
    log_density_fn,
    state,
    base_key,
    step_size,
    trajectory_length,
    inv_mass=None,
    *,
    n_samples,
    burn_in=0,
    thin=1,
):
    """Sampling phase with frozen (ε, τ): jittered-HMC scan at batch level.
    Returns (state, samples (n_samples, n, d), info_means) — the driver
    contract of ``driver.sample_chains`` for batch-level kernels."""
    def one(st, step_idx):
        u = halton(step_idx)
        key = jax.random.fold_in(base_key, step_idx)
        return batch_step(
            log_density_fn, st, key, step_size=step_size,
            trajectory_length=trajectory_length, jitter_u=u,
            inv_mass=inv_mass,
        )

    def burn_body(st, i):
        st, _ = one(st, i)
        return st, None

    state, _ = jax.lax.scan(burn_body, state, jnp.arange(burn_in))

    def outer(st, sample_idx):
        def inner(st, i):
            return one(st, i)

        steps = burn_in + sample_idx * thin + jnp.arange(thin)
        st, infos = jax.lax.scan(inner, st, steps)
        info_mean = jax.tree_util.tree_map(
            lambda x: jnp.mean(x[-1].astype(jnp.float32), axis=0), infos
        )
        return st, (st.positions, info_mean)

    state, (samples, info_means) = jax.lax.scan(
        outer, state, jnp.arange(n_samples)
    )
    return state, samples, info_means
