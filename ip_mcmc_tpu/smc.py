"""Adaptive tempered-likelihood Sequential Monte Carlo.

BASELINE.json config 5: "adaptive SMC with tempered likelihood on the PDE
inverse problem, particles sharded across hosts with collective resampling".
Beyond-reference capability (the reference has no SMC).

Algorithm (Del Moral–Doucet–Jasra adaptive tempering):
- particles x_i ~ prior, inverse temperature β: 0 → 1;
- each stage choose δβ by BISECTION so the incremental ESS hits
  ``ess_target · N`` (`lax.while_loop`, on-device, data-dependent but
  static-shaped);
- reweight with −δβ·Φ, SYSTEMATIC resampling by global ancestor indices,
  then ``mutation_steps`` pCN moves targeting exp(−β Φ) dμ₀;
- evidence log Z = Σ_stages log mean_i w_i exp(−δβ Φ_i) accumulated
  on-device (testable against the closed-form linear-Gaussian evidence).

Distribution: everything is global-view jnp over the (sharded) particle
axis — the weight reductions lower to psum, the ancestor gather to an
all-gather/collective-permute over ICI/DCN (SURVEY.md §2.4). Bitwise
mesh-shape invariance is tested in tests/test_smc.py.

The whole sampler is ONE ``lax.while_loop`` program: stage count is
data-dependent (capped at ``max_stages``) without leaving the device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ip_mcmc_tpu.driver import chain_keys
from ip_mcmc_tpu.kernels import pcn
from ip_mcmc_tpu.utils.struct import pytree_dataclass


@pytree_dataclass
class SMCState:
    particles: jnp.ndarray  # (n, d)
    potentials: jnp.ndarray  # (n,) untempered Φ(x_i), cached
    beta: jnp.ndarray  # current inverse temperature
    log_z: jnp.ndarray  # accumulated log evidence
    stage: jnp.ndarray  # stage counter


@pytree_dataclass
class SMCInfo:
    betas: jnp.ndarray  # (max_stages,) β ladder (nan-padded)
    ess: jnp.ndarray  # (max_stages,) post-reweight ESS
    accept_rates: jnp.ndarray  # (max_stages,) mutation acceptance
    n_stages: jnp.ndarray
    mutation_counts: jnp.ndarray  # (max_stages,) mutation steps per stage
    mean_potentials: jnp.ndarray  # (max_stages,) E_β[Φ] after each stage
    prior_mean_potential: jnp.ndarray  # E_{β=0}[Φ] (the TI integrand at 0)


def effective_sample_size(log_weights):
    """ESS = (Σw)²/Σw² computed stably in log space."""
    lse1 = jax.scipy.special.logsumexp(log_weights)
    lse2 = jax.scipy.special.logsumexp(2.0 * log_weights)
    return jnp.exp(2.0 * lse1 - lse2)


def find_next_beta(beta, potentials, ess_target_frac, n_bisect=40):
    """Largest δβ ∈ (0, 1−β] with ESS(−δβ·Φ) ≥ target·N, by bisection."""
    n = potentials.shape[0]
    target = ess_target_frac * n

    def ess_at(delta):
        return effective_sample_size(-delta * potentials)

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

    hi0 = 1.0 - beta
    # if even the full remaining step keeps ESS above target, just take it
    full_ok = ess_at(hi0) >= target
    lo, hi = jax.lax.fori_loop(
        0, n_bisect, body, (jnp.zeros_like(beta), hi0)
    )
    delta = jnp.where(full_ok, hi0, lo)
    # never stall: enforce a tiny floor so β always advances
    return jnp.maximum(delta, 1e-6 * (1.0 - beta) + 1e-12)


def systematic_resample(key, log_weights, n_out=None):
    """Systematic resampling: ``n_out`` global ancestor indices from one
    uniform (default n_out = n).

    Deterministic given (key, weights) — the distributed-friendly scheme
    (SURVEY.md §7.3 item 1): the weight vector is all-gathered by XLA under
    sharding, ancestors are identical on every device, and the particle
    gather lowers to a collective.
    """
    n = log_weights.shape[0]
    n_out = n if n_out is None else n_out
    w = jax.nn.softmax(log_weights)
    cum = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), minval=0.0, maxval=1.0 / n_out)
    positions = u0 + jnp.arange(n_out, dtype=w.dtype) / n_out
    ancestors = jnp.searchsorted(cum, positions)
    return jnp.clip(ancestors, 0, n - 1)


@partial(
    jax.jit,
    static_argnames=(
        "potential_fn",
        "n_particles",
        "mutation_steps",
        "max_stages",
        "waste_free",
    ),
)
def run(
    potential_fn,
    prior,
    key,
    n_particles=1024,
    *,
    ess_target=0.5,
    mutation_steps=5,
    pcn_step=0.3,
    max_stages=50,
    waste_free=False,
    esjd_target=None,
):
    """Run adaptive tempered SMC. Returns (SMCState, SMCInfo).

    ``potential_fn``: untempered data misfit Φ(u) (single particle).
    ``prior``: distribution with sample/sample_centered/mean (pCN-compatible).

    ``waste_free=True`` (Dau–Chopin 2022): resample only M = N/(k+1)
    ancestors (k = mutation_steps) and keep ALL k+1 states of each mutation
    chain as the next N-particle cloud — every forward-model evaluation
    becomes a particle instead of only the chain endpoints. Same collective
    structure (the resample just emits fewer ancestors); requires
    n_particles % (mutation_steps + 1) == 0.

    ``esjd_target``: if set, ADAPTIVE mutation counts — each stage runs pCN
    moves until the pooled cumulative expected squared jump distance
    Σ_steps mean_i[α_i·‖v_i − x_i‖²] reaches the target (early stages with
    high acceptance stop sooner; hard stages near β = 1 run longer), capped
    at ``mutation_steps`` (data-dependent ``lax.while_loop``, on-device).
    Incompatible with ``waste_free`` (the chain length must be static to
    unroll the cloud).
    """
    if waste_free and n_particles % (mutation_steps + 1):
        raise ValueError(
            f"waste-free SMC needs n_particles ({n_particles}) divisible by "
            f"mutation_steps+1 ({mutation_steps + 1})"
        )
    if waste_free and esjd_target is not None:
        raise ValueError("esjd_target (adaptive counts) is incompatible with waste_free")
    key_init, key_loop = jax.random.split(key)
    particles = prior.sample(key_init, (n_particles,))
    potentials = jax.vmap(potential_fn)(particles)
    state = SMCState(
        particles=particles,
        potentials=potentials,
        beta=jnp.zeros((), potentials.dtype),
        log_z=jnp.zeros((), potentials.dtype),
        stage=jnp.zeros((), jnp.int32),
    )
    nan = jnp.full((max_stages,), jnp.nan, dtype=potentials.dtype)
    info = SMCInfo(
        betas=nan, ess=nan, accept_rates=nan,
        n_stages=jnp.zeros((), jnp.int32), mutation_counts=nan,
        mean_potentials=nan,
        prior_mean_potential=jnp.mean(potentials),
    )

    def cond(carry):
        state, _ = carry
        return (state.beta < 1.0) & (state.stage < max_stages)

    def body(carry):
        state, info = carry
        key_stage = jax.random.fold_in(key_loop, state.stage)
        key_res, key_mut = jax.random.split(key_stage)

        delta = find_next_beta(state.beta, state.potentials, ess_target)
        new_beta = jnp.minimum(state.beta + delta, 1.0)
        log_w = -delta * state.potentials  # incremental weights (uniform prior weights)
        # evidence increment: log mean exp(log_w)
        log_z = state.log_z + jax.scipy.special.logsumexp(log_w) - jnp.log(
            jnp.asarray(n_particles, log_w.dtype)
        )
        ess_val = effective_sample_size(log_w)

        # mutation: pCN targeting exp(-new_beta Φ) dμ0
        tempered = lambda u: new_beta * potential_fn(u)
        kernel = pcn.build_kernel(tempered, prior, beta=pcn_step)
        n_mut = n_particles // (mutation_steps + 1) if waste_free else n_particles

        ancestors = systematic_resample(key_res, log_w, n_out=n_mut)
        particles0 = state.particles[ancestors]
        potentials0 = state.potentials[ancestors]
        mut_state = pcn.PCNState(
            position=particles0, potential=new_beta * potentials0
        )

        zero = jnp.zeros((), potentials0.dtype)
        if esjd_target is None:
            def mut_body(carry, step_idx):
                ms, _ = carry
                keys = chain_keys(key_mut, step_idx, n_mut)
                ms, minfo = jax.vmap(kernel)(keys, ms)
                out = (ms.position, ms.potential) if waste_free else None
                return (ms, jnp.mean(minfo.accept_prob)), out

            (mut_state, acc_rate), recorded = jax.lax.scan(
                mut_body,
                (mut_state, zero),
                jnp.arange(mutation_steps),
            )
            n_mut_steps = jnp.int32(mutation_steps)
        else:
            def mut_cond(carry):
                _, _, esjd, i = carry
                return (esjd < esjd_target) & (i < mutation_steps)

            def mut_body(carry):
                ms, _, esjd, i = carry
                prev = ms.position
                keys = chain_keys(key_mut, i, n_mut)
                ms, minfo = jax.vmap(kernel)(keys, ms)
                jump = jnp.mean(
                    minfo.accept_prob
                    * jnp.sum(jnp.square(minfo.proposal - prev), axis=-1)
                )
                return ms, jnp.mean(minfo.accept_prob), esjd + jump, i + 1

            mut_state, acc_rate, _, n_mut_steps = jax.lax.while_loop(
                mut_cond, mut_body, (mut_state, zero, zero, jnp.int32(0))
            )
            recorded = None
        if waste_free:
            # the next cloud = every state of every mutation chain (starts
            # included): (k+1, M, d) -> (N, d)
            pos_seq, pot_seq = recorded
            particles = jnp.concatenate(
                [particles0[None], pos_seq], axis=0
            ).reshape(n_particles, -1)
            potentials = jnp.concatenate(
                [(new_beta * potentials0)[None], pot_seq], axis=0
            ).reshape(n_particles) / jnp.maximum(new_beta, 1e-12)
        else:
            particles = mut_state.position
            potentials = mut_state.potential / jnp.maximum(new_beta, 1e-12)

        info = SMCInfo(
            betas=info.betas.at[state.stage].set(new_beta),
            ess=info.ess.at[state.stage].set(ess_val),
            accept_rates=info.accept_rates.at[state.stage].set(acc_rate),
            n_stages=info.n_stages + 1,
            mutation_counts=info.mutation_counts.at[state.stage].set(
                n_mut_steps.astype(info.mutation_counts.dtype)
            ),
            mean_potentials=info.mean_potentials.at[state.stage].set(
                jnp.mean(potentials)
            ),
            prior_mean_potential=info.prior_mean_potential,
        )
        state = SMCState(
            particles=particles,
            potentials=potentials,
            beta=new_beta,
            log_z=log_z,
            stage=state.stage + 1,
        )
        return state, info

    state, info = jax.lax.while_loop(cond, body, (state, info))
    return state, info


@pytree_dataclass
class SMCBatchedState:
    particles: jnp.ndarray  # (d, n) CHAIN-LAST (the batched-misfit layout)
    potentials: jnp.ndarray  # (n,) untempered Φ, cached
    warm_aux: jnp.ndarray  # (aux_dim, n) carried warm-solve state
    beta: jnp.ndarray
    log_z: jnp.ndarray
    stage: jnp.ndarray


@partial(
    jax.jit,
    static_argnames=(
        "batched_potential_fn",
        "warm_potential_fn",
        "aux_dim",
        "n_particles",
        "mutation_steps",
        "max_stages",
        "init_sweeps",
    ),
)
def run_batched(
    batched_potential_fn,
    prior_mean,
    prior_scale,
    key,
    n_particles=4096,
    *,
    warm_potential_fn=None,
    aux_dim=1,
    ess_target=0.5,
    mutation_steps=5,
    pcn_step=0.3,
    max_stages=50,
    init_sweeps=8,
):
    """Adaptive tempered SMC on a BATCHED potential (VERDICT round-1 item 4:
    config-5 mutation previously ran the cold per-particle scan-path misfit
    with 48-iteration CG; this path runs the same warm/DST batched machinery
    that makes config 4 fast).

    ``batched_potential_fn``: Φ over a chain-last batch, (d, n) -> (n,)
    (e.g. ``darcy.make_batched_misfit``) — one XLA program evaluates ALL
    particles' PDE solves as batched matmul/stencil ops on the device.

    ``warm_potential_fn``: optional ``phi2(U, X0) -> (phi, X)`` (e.g.
    ``darcy.make_batched_misfit_warm``): each particle CARRIES its converged
    solve (``warm_aux``); mutation proposals warm-start from it (local moves
    → ~6 DST iterations instead of 48 cold), resampling gathers it with the
    ancestor (a copied particle inherits its ancestor's converged solution —
    exact, no re-solve). ``init_sweeps`` repeated applications converge the
    very first solve from a zero start.

    Prior: diagonal Gaussian (mean, scale) — the whitened-KL convention of
    every fused config. Algorithm, β-bisection, evidence telescoping and
    systematic resampling are IDENTICAL to ``run`` (tests assert equal
    log-evidence on the linear-Gaussian closed form).
    """
    pm = jnp.asarray(prior_mean, jnp.float32).reshape(-1, 1)  # (d, 1)
    ps = jnp.asarray(prior_scale, jnp.float32).reshape(-1, 1)
    d = pm.shape[0]
    contraction = jnp.sqrt(1.0 - pcn_step * pcn_step)

    if warm_potential_fn is not None:
        evaluate = warm_potential_fn
    else:
        aux_dim = 1

        def evaluate(U, X0):
            return batched_potential_fn(U), X0

    key_init, key_loop = jax.random.split(key)
    particles = pm + ps * jax.random.normal(
        key_init, (d, n_particles), jnp.float32
    )
    warm_aux = jnp.zeros((aux_dim, n_particles), jnp.float32)
    # converge the initial solves: repeated warm applications from zero
    # (k sweeps of m iterations ≈ one k·m-iteration cold solve)
    sweeps = init_sweeps if warm_potential_fn is not None else 1
    for _ in range(sweeps):
        potentials, warm_aux = evaluate(particles, warm_aux)

    state = SMCBatchedState(
        particles=particles,
        potentials=potentials,
        warm_aux=warm_aux,
        beta=jnp.zeros((), potentials.dtype),
        log_z=jnp.zeros((), potentials.dtype),
        stage=jnp.zeros((), jnp.int32),
    )
    nan = jnp.full((max_stages,), jnp.nan, dtype=potentials.dtype)
    info = SMCInfo(
        betas=nan, ess=nan, accept_rates=nan,
        n_stages=jnp.zeros((), jnp.int32), mutation_counts=nan,
        mean_potentials=nan,
        prior_mean_potential=jnp.mean(potentials),
    )

    def cond(carry):
        state, _ = carry
        return (state.beta < 1.0) & (state.stage < max_stages)

    def body(carry):
        state, info = carry
        key_stage = jax.random.fold_in(key_loop, state.stage)
        key_res, key_mut = jax.random.split(key_stage)

        delta = find_next_beta(state.beta, state.potentials, ess_target)
        new_beta = jnp.minimum(state.beta + delta, 1.0)
        log_w = -delta * state.potentials
        log_z = state.log_z + jax.scipy.special.logsumexp(log_w) - jnp.log(
            jnp.asarray(n_particles, log_w.dtype)
        )
        ess_val = effective_sample_size(log_w)

        ancestors = systematic_resample(key_res, log_w)
        U = state.particles[:, ancestors]
        phi = state.potentials[ancestors]
        X = state.warm_aux[:, ancestors]

        def mut_body(carry, step_idx):
            U, phi, X, _ = carry
            k = jax.random.fold_in(key_mut, step_idx)
            k_prop, k_acc = jax.random.split(k)
            xi = jax.random.normal(k_prop, U.shape, U.dtype)
            V = pm + contraction * (U - pm) + pcn_step * (ps * xi)
            phi_v, X_v = evaluate(V, X)  # warm-start from current solution
            log_ratio = new_beta * (phi - phi_v)
            log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
            log_u = jnp.log(
                jax.random.uniform(k_acc, phi.shape, dtype=phi.dtype)
            )
            acc = log_u < log_ratio
            U = jnp.where(acc[None, :], V, U)
            phi = jnp.where(acc, phi_v, phi)
            X = jnp.where(acc[None, :], X_v, X)
            return (U, phi, X, jnp.mean(acc.astype(phi.dtype))), None

        (U, phi, X, acc_rate), _ = jax.lax.scan(
            mut_body,
            (U, phi, X, jnp.zeros((), phi.dtype)),
            jnp.arange(mutation_steps),
        )

        info = SMCInfo(
            betas=info.betas.at[state.stage].set(new_beta),
            ess=info.ess.at[state.stage].set(ess_val),
            accept_rates=info.accept_rates.at[state.stage].set(acc_rate),
            n_stages=info.n_stages + 1,
            mutation_counts=info.mutation_counts.at[state.stage].set(
                jnp.asarray(mutation_steps, info.mutation_counts.dtype)
            ),
            mean_potentials=info.mean_potentials.at[state.stage].set(
                jnp.mean(phi)
            ),
            prior_mean_potential=info.prior_mean_potential,
        )
        state = SMCBatchedState(
            particles=U,
            potentials=phi,
            warm_aux=X,
            beta=new_beta,
            log_z=log_z,
            stage=state.stage + 1,
        )
        return state, info

    state, info = jax.lax.while_loop(cond, body, (state, info))
    return state, info


def thermodynamic_log_z(info):
    """Independent evidence estimate from the SAME run: thermodynamic
    integration (path sampling) log Z = −∫₀¹ E_β[Φ] dβ, trapezoid over the
    adaptive β ladder using the per-stage particle means of Φ (plus the
    β = 0 prior mean recorded at init). Shares samples but NOT the
    estimator with ``state.log_z`` (importance-weight telescoping), so
    agreement between the two anchors the evidence (ROADMAP P2). Host-side
    post-hoc diagnostic.
    """
    import numpy as np

    n = int(info.n_stages)
    betas = np.concatenate([[0.0], np.asarray(info.betas)[:n]])
    pots = np.concatenate(
        [[float(info.prior_mean_potential)], np.asarray(info.mean_potentials)[:n]]
    )
    return float(-np.trapezoid(pots, betas))
