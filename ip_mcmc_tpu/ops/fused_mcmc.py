"""Fused MCMC chains: every entry point runs ``n_steps`` of one sampler for
all chains inside a single XLA program (SURVEY.md §2.2's "inner loop"
obligation), with a counter-hash RNG (~8 integer ops per draw) in place of
threefry key splitting.

LAYOUT IS CHAIN-LAST: state is (d, chains), so every elementwise op of
the step runs along the long chain axis. Consequently ``potential_fn``
here takes a FEATURES-FIRST batch: (d, block) -> (block,). Public arrays
stay (n_chains, d); the driver transposes once per call.

Chains are grouped in blocks of ``block_chains``. A block is the unit of
the RNG stream (seed + block * 7919) and the walker ensemble of the
ensemble sampler; blocks are vmapped, so the block size changes which
random numbers a chain sees, not how the work is scheduled.

Distributional equivalence with the scan+vmap path is tested in
tests/test_pallas_ops.py; the PRNG streams differ by construction.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ip_mcmc_tpu.precision import mm

_TWO_PI = 2.0 * math.pi


def _hash_bits(key, shape):
    """Counter-based random uint32s: murmur3/splitmix finalizer over the
    element index, mixed with ``key``."""
    n = int(np.prod(shape))
    idx = jax.lax.broadcasted_iota(jnp.uint32, (1, n), 1).reshape(shape)
    x = idx * jnp.uint32(0x9E3779B9) + key
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _mix_key(seed, step, tag):
    """(seed, step, tag) → stream key, NONLINEAR sponge.

    The round-1 mixer was linear in its inputs before the final shuffle
    (k = seed·A + step·B + tag·C mod 2³²), so any (Δseed, Δstep) on the
    lattice {Δseed·A + Δstep·B ≡ 0} aliased EXACTLY: the shortest vector
    (Δseed=92, Δstep=56540) made two launches with seeds 92 apart replay
    the identical normal stream 56k steps apart (found by the lattice
    audit in tests/test_kernel_rng.py, which guards this function).
    Interleaving a murmur3-style finalizer between absorbing the
    (seed, tag) pair and the step counter destroys the linear structure —
    aliasing would now require inverting the avalanche."""
    k = seed.astype(jnp.uint32) ^ (jnp.uint32(tag) * jnp.uint32(0x27D4EB2F))
    k = k * jnp.uint32(0x85EBCA6B)
    k = k ^ (k >> 13)
    k = k * jnp.uint32(0x165667B1)
    k = k ^ (k >> 16)
    k = k + step.astype(jnp.uint32) * jnp.uint32(0x9E3779B9)
    k = k ^ (k >> 13)
    k = k * jnp.uint32(0xC2B2AE35)
    k = k ^ (k >> 16)
    return k


def _uniform01(key, shape):
    """U(0,1), 24-bit mantissa (never exactly 0). The 24-bit value goes
    through int32 (exact, and the stream every test pins)."""
    bits = _hash_bits(key, shape)
    return (bits >> 8).astype(jnp.int32).astype(jnp.float32) * (
        1.0 / (1 << 24)
    ) + (0.5 / (1 << 24))


def _normal(key1, key2, shape):
    """(d, block) standard normals; uses BOTH Box–Muller outputs (cos and
    sin halves) so transcendental count is halved."""
    d, b = shape
    half = (d + 1) // 2
    u1 = _uniform01(key1, (half, b))
    u2 = _uniform01(key2, (half, b))
    r = jnp.sqrt(-2.0 * jnp.log(u1))
    theta = _TWO_PI * u2
    z = jnp.concatenate([r * jnp.cos(theta), r * jnp.sin(theta)], axis=0)
    return z[:d]


def _with_grad(potential_fn):
    """Value-and-gradient of a batched potential via ``jax.vjp`` (the
    potential sums over chains, so a ones cotangent gives per-chain
    gradients)."""

    def pot_and_grad(x):
        phi, vjp = jax.vjp(potential_fn, x)
        (g,) = vjp(jnp.ones_like(phi))
        return phi, g

    return pot_and_grad


def _run_chains(step_builder, potential_fn, positions, params, seed, n_steps,
                block_chains, thin=None):
    """Shared driver for every fused entry point.

    ``step_builder(pot, *params) -> (init, step)`` with ``init(pos_t) ->
    carry`` (carry[0] is the (d, block) position by convention) and
    ``step(carry, rand_n, rand_u) -> (carry, accepted)`` — the generalized
    carry lets kernels cache extra state (MALA's gradient, the warm-started
    CG solution). ``potential_fn`` is one features-first potential or a
    tuple of them (delayed acceptance); a builder flagged ``needs_grad``
    receives value-and-gradient instead.

    The (n, d) chains are split into ``n_blocks`` blocks of
    ``block_chains``, laid out chain-last as (n_blocks, d, block). Each
    block draws from its own counter-hash stream (``seed + block * 7919``)
    and is one walker ensemble for the ensemble samplers; blocks are
    vmapped, so one XLA program advances every chain in lockstep.

    ``thin=None`` returns (final (n, d), accept_rate (n,)[, extra (n,)]),
    with ``extra`` the builder's ``extra_out`` channel. With ``thin`` set,
    the position is recorded every ``thin`` steps and the result is
    (final, accept_rate, samples (n_steps // thin, n, d)).
    """
    positions = jnp.asarray(positions, jnp.float32)
    n, d = positions.shape
    if n % block_chains:
        raise ValueError(
            f"n_chains {n} must be a multiple of block_chains {block_chains}"
        )
    if thin is not None and n_steps % thin:
        raise ValueError(f"n_steps {n_steps} must be a multiple of thin {thin}")
    if getattr(step_builder, "needs_grad", False):
        potential_fn = _with_grad(potential_fn)
    step_init, step = step_builder(
        potential_fn, *[jnp.asarray(p, jnp.float32) for p in params]
    )
    extra_out = getattr(step_builder, "extra_out", None)
    n_blocks = n // block_chains
    block_seeds = (
        jnp.asarray(seed, jnp.int32)
        + jnp.arange(n_blocks, dtype=jnp.int32) * 7919
    ).astype(jnp.uint32)
    blocks = positions.reshape(n_blocks, block_chains, d).transpose(0, 2, 1)

    def run_block(block_seed, pos0):
        def body(i, state):
            carry, acc = state
            rand_u = lambda shape, tag: _uniform01(
                _mix_key(block_seed, i, tag), shape
            )
            rand_n = lambda shape, tag: _normal(
                _mix_key(block_seed, i, tag),
                _mix_key(block_seed, i, tag + 1),
                shape,
            )
            carry, accepted = step(carry, rand_n, rand_u)
            return carry, acc + accepted.astype(jnp.float32)

        state = (step_init(pos0), jnp.zeros((1, block_chains), jnp.float32))
        if thin is None:
            carry, acc = jax.lax.fori_loop(0, n_steps, body, state)
            extra = None if extra_out is None else extra_out(carry)
            return carry[0], acc / n_steps, extra

        def record(state, r):
            state = jax.lax.fori_loop(
                0, thin, lambda j, s: body(r * thin + j, s), state
            )
            return state, state[0][0]

        (carry, acc), samples = jax.lax.scan(
            record, state, jnp.arange(n_steps // thin, dtype=jnp.int32)
        )
        return carry[0], acc / n_steps, samples

    final, acc, third = jax.vmap(run_block)(block_seeds, blocks)
    final = final.transpose(0, 2, 1).reshape(n, d)
    acc = acc.reshape(n)
    if thin is not None:
        # (n_blocks, n_rec, d, block) -> (n_rec, n, d)
        samples = third.transpose(1, 0, 3, 2).reshape(-1, n, d)
        return final, acc, samples
    if third is None:
        return final, acc
    return final, acc, third.reshape(n)


def _rwm_step_builder(pot, step_size):
    def init(pos):
        return (pos, pot(pos))

    def step(carry, rand_n, rand_u):
        pos, phi = carry
        xi = rand_n(pos.shape, 0)
        prop = pos + step_size * xi
        phi_prop = pot(prop)
        log_u = jnp.log(rand_u((1, pos.shape[1]), 2))[0]
        accept = log_u < (phi - phi_prop)
        return (
            jnp.where(accept[None, :], prop, pos),
            jnp.where(accept, phi_prop, phi),
        ), accept[None, :]

    return init, step


def _pcn_step_builder(pot, beta, mean, scale):
    contraction = jnp.sqrt(1.0 - beta * beta)

    def init(pos):
        return (pos, pot(pos))

    def step(carry, rand_n, rand_u):
        pos, phi = carry
        m = mean[:, None]
        xi = scale[:, None] * rand_n(pos.shape, 0)
        prop = m + contraction * (pos - m) + beta * xi
        phi_prop = pot(prop)
        log_u = jnp.log(rand_u((1, pos.shape[1]), 2))[0]
        accept = log_u < (phi - phi_prop)
        return (
            jnp.where(accept[None, :], prop, pos),
            jnp.where(accept, phi_prop, phi),
        ), accept[None, :]

    return init, step


def _make_da_pcn_step_builder(subchain_len):
    """Fused delayed-acceptance pCN (the kernels/da_pcn.py algorithm on the
    fused path): ``subchain_len`` pCN steps against the SURROGATE potential
    Φ* (e.g. a coarse-grid FV solve, ~16x cheaper), then ONE exact-potential
    correction — Christen–Fox (2005) surrogate-transition form. The cost
    structure is STATIC (k cheap + 1 expensive eval per outer step for every
    chain), which is exactly what vectorizes across chains; the inner loop is
    a compile-time unroll (k is small and static). ``pot`` is the
    (exact, surrogate) pair; the carry caches Φ AND Φ* at the current state
    so nothing is recomputed. extra_out reports the inner (surrogate-stage)
    acceptance rate — the knob β is tuned against it, while the main accept
    channel reports the exact-correction rate (a surrogate-quality meter:
    ≈1 means the coarse model ranks proposals like the fine one)."""
    k = int(subchain_len)

    def builder(pots, beta, mean, scale):
        pot_exact, pot_surr = pots
        contraction = jnp.sqrt(1.0 - beta * beta)

        def init(pos):
            block = pos.shape[1]
            return (
                pos,
                pot_exact(pos),
                pot_surr(pos),
                jnp.zeros((1, block), jnp.float32),  # inner-accept sum
                jnp.float32(0.0),  # outer-step count (normalizes extra_out)
            )

        def step(carry, rand_n, rand_u):
            pos0, phi0, surr0, in_acc, cnt = carry
            m = mean[:, None]
            s = scale[:, None]
            pos, surr = pos0, surr0
            for j in range(k):  # static unroll; 4 rand tags per inner step
                xi = s * rand_n(pos.shape, 4 * j)
                prop = m + contraction * (pos - m) + beta * xi
                surr_prop = pot_surr(prop)
                log_u = jnp.log(rand_u((1, pos.shape[1]), 4 * j + 2))[0]
                take = log_u < (surr - surr_prop)  # NaN ratio -> False
                in_acc = in_acc + take[None, :].astype(jnp.float32)
                pos = jnp.where(take[None, :], prop, pos)
                surr = jnp.where(take, surr_prop, surr)
            phi_end = pot_exact(pos)
            # π*-to-π correction: (Φ(u) − Φ(v)) − (Φ*(u) − Φ*(v))
            log_ratio = (phi0 - phi_end) - (surr0 - surr)
            log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
            log_u = jnp.log(rand_u((1, pos.shape[1]), 4 * k + 2))[0]
            accept = log_u < log_ratio
            acc2 = accept[None, :]
            return (
                jnp.where(acc2, pos, pos0),
                jnp.where(accept, phi_end, phi0),
                jnp.where(accept, surr, surr0),
                in_acc,
                cnt + 1.0,
            ), acc2

        return init, step

    builder.extra_out = lambda carry: carry[3] / jnp.maximum(
        carry[4] * k, 1.0
    )
    return builder


def _make_da3_pcn_step_builder(k_inner, k_mid):
    """Fused THREE-level delayed-acceptance pCN (round-3 ROADMAP P2).

    Motivation, measured (benchmarks/burgers_da.py): 2-level DA plateaus at
    ~2.3x honest ESS because pushing the subchain length k decays the
    exact-correction acceptance (0.274 at k=16 -> 0.167 at k=48 on the
    64-cell Burgers surrogate) — the endpoint drifts into surrogate-error
    territory faster than the per-step cost falls. A MIDDLE level with
    discrepancy below the observation noise (e.g. 128-cell @CFL0.9, whose
    2-level outer acceptance measured 0.82) restores the top-level
    acceptance while the cheap inner level still does the mixing.

    Structure per outer step (Christen–Fox composition — each level's DA
    chain is exactly invariant for its level's posterior, so the level
    above may use its endpoint as a proposal with the between-level ratio):

        for j2 < k_mid:                       # DA chain targeting π_mid
            k_inner pCN steps against Φ_coarse
            accept vs  (Φm(u)−Φm(v)) − (Φc(u)−Φc(v))
        one fine correction vs (Φf(u)−Φf(v)) − (Φm(u)−Φm(v))

    ``pots`` = (Φ_fine, Φ_mid, Φ_coarse), all (d, block) -> (block,).
    Main accept channel = fine-correction rate; ``extra_out`` = middle-
    correction rate (the inner rate equals the plain 2-level kernel's at
    the same β — it is the same π_coarse chain — so it is not re-reported).
    """
    k1, k2 = int(k_inner), int(k_mid)

    def builder(pots, beta, mean, scale):
        pot_fine, pot_mid, pot_coarse = pots
        contraction = jnp.sqrt(1.0 - beta * beta)

        def init(pos):
            block = pos.shape[1]
            return (
                pos,
                pot_fine(pos),
                pot_mid(pos),
                pot_coarse(pos),
                jnp.zeros((1, block), jnp.float32),  # mid-accept sum
                jnp.float32(0.0),  # outer-step count
            )

        def step(carry, rand_n, rand_u):
            pos0, phi0, mid0, surr0, mid_acc, cnt = carry
            m = mean[:, None]
            s = scale[:, None]
            pos, mid, surr = pos0, mid0, surr0
            for j2 in range(k2):  # middle-level DA steps (static unroll)
                p1, s1 = pos, surr
                for j1 in range(k1):  # inner pCN on the coarse level
                    t = 4 * (j2 * k1 + j1)
                    xi = s * rand_n(p1.shape, t)
                    prop = m + contraction * (p1 - m) + beta * xi
                    sp = pot_coarse(prop)
                    log_u = jnp.log(rand_u((1, p1.shape[1]), t + 2))[0]
                    take = log_u < (s1 - sp)  # NaN ratio -> False
                    p1 = jnp.where(take[None, :], prop, p1)
                    s1 = jnp.where(take, sp, s1)
                mid_end = pot_mid(p1)
                # π_coarse -> π_mid correction
                lr = (mid - mid_end) - (surr - s1)
                lr = jnp.where(jnp.isnan(lr), -jnp.inf, lr)
                t_mid = 4 * k1 * k2 + 4 * j2 + 2
                log_u = jnp.log(rand_u((1, p1.shape[1]), t_mid))[0]
                take_m = log_u < lr
                mid_acc = mid_acc + take_m[None, :].astype(jnp.float32)
                pos = jnp.where(take_m[None, :], p1, pos)
                mid = jnp.where(take_m, mid_end, mid)
                surr = jnp.where(take_m, s1, surr)
            phi_end = pot_fine(pos)
            # π_mid -> π_fine correction
            log_ratio = (phi0 - phi_end) - (mid0 - mid)
            log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
            t_out = 4 * k1 * k2 + 4 * k2 + 2
            log_u = jnp.log(rand_u((1, pos.shape[1]), t_out))[0]
            accept = log_u < log_ratio
            acc2 = accept[None, :]
            return (
                jnp.where(acc2, pos, pos0),
                jnp.where(accept, phi_end, phi0),
                jnp.where(accept, mid, mid0),
                jnp.where(accept, surr, surr0),
                mid_acc,
                cnt + 1.0,
            ), acc2

        return init, step

    builder.extra_out = lambda carry: carry[4] / jnp.maximum(
        carry[5] * k2, 1.0
    )
    return builder


def _make_pcn_warm_step_builder(aux_dim):
    """pCN whose potential carries an aux block (the warm-started CG
    solution): ``pot(U, x0) -> (phi, x)``. The aux follows the accept/reject
    select, so proposal solves always start from the CURRENT state's
    converged solution."""

    def builder(pot, beta, mean, scale):
        contraction = jnp.sqrt(1.0 - beta * beta)

        def init(pos):
            x0 = jnp.zeros((aux_dim, pos.shape[1]), pos.dtype)
            phi0, x0 = pot(pos, x0)
            return (pos, phi0, x0)

        def step(carry, rand_n, rand_u):
            pos, phi, x = carry
            m = mean[:, None]
            xi = scale[:, None] * rand_n(pos.shape, 0)
            prop = m + contraction * (pos - m) + beta * xi
            phi_prop, x_prop = pot(prop, x)
            log_u = jnp.log(rand_u((1, pos.shape[1]), 2))[0]
            accept = log_u < (phi - phi_prop)
            acc2 = accept[None, :]
            return (
                jnp.where(acc2, prop, pos),
                jnp.where(accept, phi_prop, phi),
                jnp.where(acc2, x_prop, x),
            ), acc2

        return init, step

    return builder


def _make_pcn_adapt_step_builder(target_accept, gain):
    """pCN with fused β adaptation: Robbins–Monro on the block-pooled
    acceptance probability (the cross-chain adaptation signal, pooled over
    the block's chains — the fused analog of ``adapt.warmup_pcn``). log-β rides
    the carry as a (1, block) row (broadcast value); γ_i = gain/(1+i)^0.6
    via a step counter also carried. Burn-in only — freeze the returned β
    for sampling (detailed balance)."""

    def builder(pot, beta0, mean, scale):
        def init(pos):
            block = pos.shape[1]
            return (
                pos,
                pot(pos),
                jnp.full((1, block), jnp.log(beta0), jnp.float32),
                jnp.zeros((1, block), jnp.float32),  # step counter
            )

        def step(carry, rand_n, rand_u):
            pos, phi, log_beta, i = carry
            beta = jnp.exp(log_beta[0, 0])
            contraction = jnp.sqrt(1.0 - beta * beta)
            m = mean[:, None]
            xi = scale[:, None] * rand_n(pos.shape, 0)
            prop = m + contraction * (pos - m) + beta * xi
            phi_prop = pot(prop)
            log_ratio = jnp.minimum(phi - phi_prop, 0.0)
            accept_prob = jnp.exp(log_ratio)
            log_u = jnp.log(rand_u((1, pos.shape[1]), 2))[0]
            accept = log_u < log_ratio
            # Robbins–Monro on pooled acceptance; clamp β ∈ (1e-4, 1).
            # (1+i)^0.6 via exp/log
            gamma = gain * jnp.exp(-0.6 * jnp.log(1.0 + i[0, 0]))
            pooled = jnp.mean(accept_prob)
            log_beta = jnp.clip(
                log_beta + gamma * (pooled - target_accept),
                jnp.log(1e-4), jnp.log(0.999),
            )
            return (
                jnp.where(accept[None, :], prop, pos),
                jnp.where(accept, phi_prop, phi),
                log_beta,
                i + 1.0,
            ), accept[None, :]

        return init, step

    builder.extra_out = lambda carry: jnp.exp(carry[2])  # adapted β per lane
    return builder


def _make_fes_step_builder(n_low_modes, stretch_a):
    """Fused functional ensemble sampler (see kernels/ensemble.py for the
    algorithm): each BLOCK of chains is one walker ensemble. Red-black
    sub-steps alternate over chain-index parity; the affine partner is
    selected by a DYNAMIC ODD rotation of the block's chain axis
    (``jnp.roll``, toward higher indices; an odd shift guarantees the partner
    has the opposite parity, i.e. is FIXED during the sub-step). Affine stretch on
    the first ``n_low_modes`` whitened rows, pCN on the complement:
    3 potential evaluations per step."""
    M = n_low_modes
    a = stretch_a

    def builder(pot, pcn_beta, mean, scale):
        contraction = jnp.sqrt(1.0 - pcn_beta * pcn_beta)

        def init(pos):
            block = pos.shape[1]
            return (
                pos,
                pot(pos),
                jnp.zeros((1, block), jnp.float32),  # stretch-accept sum
                jnp.float32(0.0),  # step count (normalizes extra_out)
            )

        def step(carry, rand_n, rand_u):
            pos, phi, st_acc, cnt = carry
            d, block = pos.shape
            m = mean[:, None]
            s = scale[:, None]
            low = (
                jax.lax.broadcasted_iota(jnp.int32, (d, 1), 0) < M
            ).astype(pos.dtype)
            lane = jax.lax.broadcasted_iota(jnp.int32, (1, block), 1)[0]
            w = (pos - m) / s

            for sub, tag0 in ((0, 32), (1, 40)):
                u_s = rand_u((1, 1), tag0)[0, 0]
                shift = (
                    jnp.floor(u_s * (block // 2)).astype(jnp.int32) * 2 + 1
                )
                partner = jnp.roll(w, shift, axis=1)
                uz = rand_u((1, block), tag0 + 2)[0]
                z = jnp.square((a - 1.0) * uz + 1.0) / a  # g(z) ∝ 1/√z
                w_prop = jnp.where(
                    low > 0, partner + z[None, :] * (w - partner), w
                )
                phi_p = pot(m + s * w_prop)
                d_prior = 0.5 * jnp.sum(
                    low * (jnp.square(w_prop) - jnp.square(w)), axis=0
                )
                log_ratio = (M - 1) * jnp.log(z) - (phi_p - phi) - d_prior
                log_ratio = jnp.where(
                    jnp.isnan(log_ratio), -jnp.inf, log_ratio
                )
                log_u = jnp.log(rand_u((1, block), tag0 + 4)[0])
                acc = (lane % 2 == sub) & (log_u < log_ratio)
                # each lane is attempted in exactly ONE of the two subs, so
                # summing over subs gives the per-step stretch accept bit
                st_acc = st_acc + acc[None, :].astype(jnp.float32)
                w = jnp.where(acc[None, :], w_prop, w)
                phi = jnp.where(acc, phi_p, phi)

            # pCN on the complement rows (prior-reversible: only Φ enters)
            xi = rand_n((d, block), 48)
            w_prop = jnp.where(
                low > 0, w, contraction * w + pcn_beta * xi
            )
            phi_p = pot(m + s * w_prop)
            log_u = jnp.log(rand_u((1, block), 52)[0])
            acc = log_u < (phi - phi_p)
            w = jnp.where(acc[None, :], w_prop, w)
            phi = jnp.where(acc, phi_p, phi)
            return (m + s * w, phi, st_acc, cnt + 1.0), acc[None, :]

        return init, step

    # stretch-move acceptance per lane (the quantity stretch_a is tuned
    # with — the main acc channel reports only the pCN complement move)
    builder.extra_out = lambda carry: carry[2] / jnp.maximum(carry[3], 1.0)
    return builder


def _pcn_dense_step_builder(pot, beta, mean, chol):
    """pCN with a DENSE Gaussian prior N(mean, L Lᵀ): the proposal noise is
    ξ = L z — one (d, d)·(d, block) matmul per step (the fused analog of
    ``distributions.Gaussian.sample_centered``)."""
    contraction = jnp.sqrt(1.0 - beta * beta)

    def init(pos):
        return (pos, pot(pos))

    def step(carry, rand_n, rand_u):
        pos, phi = carry
        m = mean[:, None]
        # full precision: a TF32 product would perturb the prior
        # covariance the proposal must preserve
        xi = mm(chol, rand_n(pos.shape, 0),
                preferred_element_type=jnp.float32)
        prop = m + contraction * (pos - m) + beta * xi
        phi_prop = pot(prop)
        log_u = jnp.log(rand_u((1, pos.shape[1]), 2))[0]
        accept = log_u < (phi - phi_prop)
        return (
            jnp.where(accept[None, :], prop, pos),
            jnp.where(accept, phi_prop, phi),
        ), accept[None, :]

    return init, step


def _make_ess_step_builder(max_shrink):
    """Elliptical slice sampling, fused form: the bracket-shrink loop is a
    FIXED-budget loop with per-chain done masks (all chains pay
    ``max_shrink`` batched potential evals; expected acceptance is within
    2-3, so 6-8 is a safe budget). Chains whose bracket hasn't accepted by
    the budget stay put — the θ→0 limit, which is always in the slice, so
    validity is unaffected. Tuning-free and rejection-free like the scan
    path (kernels/elliptical.py)."""

    def builder(pot, mean, scale):
        two_pi = jnp.float32(_TWO_PI)

        def init(pos):
            return (pos, pot(pos))

        def step(carry, rand_n, rand_u):
            pos, phi = carry
            block = pos.shape[1]
            m = mean[:, None]
            nu = scale[:, None] * rand_n(pos.shape, 0)
            log_y = -phi + jnp.log(rand_u((1, block), 2))[0]
            theta = two_pi * rand_u((1, block), 4)[0]
            lo, hi = theta - two_pi, theta
            done = jnp.zeros((block,), jnp.bool_)
            centered = pos - m

            # UNROLLED shrink loop (trace-time Python): max_shrink is small,
            # and unrolling keeps the potential's own CG loop from nesting
            # inside a second loop.
            new_pos, new_phi = pos, phi
            for k in range(max_shrink):
                prop = centered * jnp.cos(theta)[None, :] + nu * jnp.sin(
                    theta
                )[None, :] + m
                phi_p = pot(prop)
                ok = (-phi_p > log_y) & (~done)
                new_pos = jnp.where(ok[None, :], prop, new_pos)
                new_phi = jnp.where(ok, phi_p, new_phi)
                done = done | ok
                # shrink the bracket toward 0 where still searching
                lo = jnp.where(done | (theta >= 0.0), lo, theta)
                hi = jnp.where(done | (theta < 0.0), hi, theta)
                u = rand_u((1, block), 16 + k)[0]
                theta = jnp.where(done, theta, lo + (hi - lo) * u)
            return (new_pos, new_phi), done[None, :]

        return init, step

    return builder


def _make_mala_warm_step_builder(aux_dim):
    """MALA whose potential is an EXPLICIT value-and-grad with a carried
    solver aux (``pag(U, aux) -> (phi_misfit, grad_misfit, aux_out)`` — the
    Darcy warm forward+adjoint pair). The whitened prior is folded in here
    (misfit potentials carry no prior), so the target is the full posterior.
    ``pm``/``ps`` are the whitened prior's mean and scale."""

    def builder(pag, step_size, pm, ps):
        eps = step_size

        def full(pos, aux):
            phi_m, g_m, aux_out = pag(pos, aux)
            z = (pos - pm[:, None]) / ps[:, None]
            phi = phi_m + 0.5 * jnp.sum(z * z, axis=0)
            g = g_m + z / ps[:, None]
            return phi, g, aux_out

        def init(pos):
            aux0 = jnp.zeros((aux_dim, pos.shape[1]), pos.dtype)
            phi, g, aux0 = full(pos, aux0)
            return (pos, phi, g, aux0)

        def step(carry, rand_n, rand_u):
            pos, phi, g, aux = carry
            xi = rand_n(pos.shape, 0)
            half_eps2 = 0.5 * eps * eps
            mean_fwd = pos - half_eps2 * g
            prop = mean_fwd + eps * xi
            phi_p, g_p, aux_p = full(prop, aux)
            mean_rev = prop - half_eps2 * g_p
            inv2e2 = 1.0 / (2.0 * eps * eps)
            d_rev = pos - mean_rev
            log_q_rev = -jnp.sum(d_rev * d_rev, axis=0) * inv2e2
            log_q_fwd = -jnp.sum(xi * xi, axis=0) * 0.5
            log_ratio = (phi - phi_p) + log_q_rev - log_q_fwd
            log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
            log_u = jnp.log(rand_u((1, pos.shape[1]), 2))[0]
            accept = log_u < log_ratio
            acc2 = accept[None, :]
            return (
                jnp.where(acc2, prop, pos),
                jnp.where(accept, phi_p, phi),
                jnp.where(acc2, g_p, g),
                jnp.where(acc2, aux_p, aux),
            ), acc2

        return init, step

    return builder


def _mala_step_builder(pot_and_grad, step_size):
    """MALA on exp(−Φ): the driver wraps the batched potential in
    value-and-grad (``needs_grad`` flag → ``_with_grad``), so ``pot_and_
    grad(x) -> (Φ, ∇Φ)``. Reverse-differentiable potentials only — analytic, linear
    misfits, or adjoint-equipped PDE misfits (``darcy.make_batched_misfit(
    differentiable=True)``); not the plain fori_loop CG/FV misfits."""
    eps = step_size

    def init(pos):
        phi, g = pot_and_grad(pos)
        return (pos, phi, g)

    def step(carry, rand_n, rand_u):
        pos, phi, g = carry
        xi = rand_n(pos.shape, 0)
        half_eps2 = 0.5 * eps * eps
        mean_fwd = pos - half_eps2 * g  # ∇log π = −∇Φ
        prop = mean_fwd + eps * xi
        phi_prop, g_prop = pot_and_grad(prop)
        mean_rev = prop - half_eps2 * g_prop
        inv2e2 = 1.0 / (2.0 * eps * eps)
        d_rev = pos - mean_rev
        log_q_rev = -jnp.sum(d_rev * d_rev, axis=0) * inv2e2
        log_q_fwd = -jnp.sum(xi * xi, axis=0) * 0.5  # ‖prop−mean_fwd‖²=ε²‖ξ‖²
        log_ratio = (phi - phi_prop) + log_q_rev - log_q_fwd
        log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
        log_u = jnp.log(rand_u((1, pos.shape[1]), 2))[0]
        accept = log_u < log_ratio
        acc2 = accept[None, :]
        return (
            jnp.where(acc2, prop, pos),
            jnp.where(accept, phi_prop, phi),
            jnp.where(acc2, g_prop, g),
        ), acc2

    return init, step


_mala_step_builder.needs_grad = True


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_steps", "target_accept", "gain",
                     "block_chains"),
)
def fused_pcn_chain_adapt(
    potential_fn,
    positions,
    prior_mean,
    prior_scale,
    beta0,
    seed,
    n_steps=300,
    target_accept=0.3,
    gain=0.5,
    block_chains=256,
):
    """Burn-in pCN with fused β adaptation (Robbins–Monro on the
    block-pooled acceptance probability — the fused analog of
    ``adapt.warmup_pcn``). Returns (positions, accept_rate, beta) with
    ``beta`` per chain (constant within each block); freeze e.g.
    ``float(beta.mean())`` for the sampling launch."""
    return _run_chains(
        _make_pcn_adapt_step_builder(target_accept, gain),
        potential_fn,
        positions,
        [
            jnp.float32(beta0),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_steps", "aux_dim", "block_chains"),
)
def fused_mala_chain_warm(
    potential_fn,
    positions,
    prior_mean,
    prior_scale,
    step_size,
    seed,
    n_steps=100,
    aux_dim=None,
    block_chains=256,
):
    """Warm-started fused MALA: ``potential_fn(U, aux) -> (phi_misfit,
    grad_misfit, aux)`` carries the forward AND adjoint solver solutions
    (``darcy.make_batched_misfit_mala_warm``) — both CG loops warm-start
    from the current state's solves. The whitened prior (prior_mean/scale)
    is folded into the target internally. Returns
    (final_positions, acceptance_rate_per_chain)."""
    if aux_dim is None:
        raise ValueError("fused_mala_chain_warm requires aux_dim")
    return _run_chains(
        _make_mala_warm_step_builder(aux_dim),
        potential_fn,
        positions,
        [
            jnp.float32(step_size),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_steps", "thin", "aux_dim",
                     "block_chains"),
)
def fused_mala_chain_warm_recorded(
    potential_fn,
    positions,
    prior_mean,
    prior_scale,
    step_size,
    seed,
    n_steps=100,
    thin=1,
    aux_dim=None,
    block_chains=256,
):
    """Warm-started fused MALA with trajectory recording."""
    if aux_dim is None:
        raise ValueError("fused_mala_chain_warm_recorded requires aux_dim")
    return _run_chains(
        _make_mala_warm_step_builder(aux_dim),
        potential_fn,
        positions,
        [
            jnp.float32(step_size),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
        thin=thin,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_low_modes", "n_steps", "stretch_a",
                     "block_chains"),
)
def fused_fes_chain(
    potential_fn,
    positions,
    prior_mean,
    prior_scale,
    n_low_modes,
    seed,
    pcn_beta=0.2,
    stretch_a=2.0,
    n_steps=100,
    block_chains=256,
):
    """Fused functional ensemble sampler: affine-invariant stretch moves on
    the first ``n_low_modes`` whitened coordinates (partner = dynamic odd
    rotation within the block-ensemble) + pCN complement. Each block of
    ``block_chains`` chains is one interacting walker
    ensemble. Returns (final_positions, pCN-move acceptance per chain,
    stretch-move acceptance per chain)."""
    if block_chains % 2:
        raise ValueError(
            f"block_chains {block_chains} must be even: the red-black scheme "
            "relies on an odd roll landing on the opposite parity"
        )
    return _run_chains(
        _make_fes_step_builder(n_low_modes, stretch_a),
        potential_fn,
        positions,
        [
            jnp.float32(pcn_beta),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_low_modes", "n_steps", "thin",
                     "stretch_a", "block_chains"),
)
def fused_fes_chain_recorded(
    potential_fn,
    positions,
    prior_mean,
    prior_scale,
    n_low_modes,
    seed,
    pcn_beta=0.2,
    stretch_a=2.0,
    n_steps=100,
    thin=1,
    block_chains=256,
):
    """Fused FES with trajectory recording."""
    if block_chains % 2:
        raise ValueError(
            f"block_chains {block_chains} must be even: the red-black scheme "
            "relies on an odd roll landing on the opposite parity"
        )
    return _run_chains(
        _make_fes_step_builder(n_low_modes, stretch_a),
        potential_fn,
        positions,
        [
            jnp.float32(pcn_beta),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
        thin=thin,
    )


@functools.partial(
    jax.jit, static_argnames=("potential_fn", "n_steps", "block_chains")
)
def fused_pcn_chain_dense(
    potential_fn,
    positions,
    prior_mean,
    prior_chol,
    beta,
    seed,
    n_steps=100,
    block_chains=256,
):
    """pCN with a DENSE (correlated) Gaussian prior, fused:
    ``prior_chol`` is the lower Cholesky factor of the prior covariance.
    Returns (final_positions, acceptance_rate_per_chain)."""
    return _run_chains(
        _pcn_dense_step_builder,
        potential_fn,
        positions,
        [
            jnp.float32(beta),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_chol, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_steps", "thin", "block_chains"),
)
def fused_pcn_chain_dense_recorded(
    potential_fn,
    positions,
    prior_mean,
    prior_chol,
    beta,
    seed,
    n_steps=100,
    thin=1,
    block_chains=256,
):
    """Dense-prior pCN with trajectory recording."""
    return _run_chains(
        _pcn_dense_step_builder,
        potential_fn,
        positions,
        [
            jnp.float32(beta),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_chol, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
        thin=thin,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_steps", "max_shrink", "block_chains"),
)
def fused_ess_chain(
    potential_fn,
    positions,
    prior_mean,
    prior_scale,
    seed,
    n_steps=100,
    max_shrink=8,
    block_chains=256,
):
    """``n_steps`` of elliptical slice sampling on exp(−Φ)dμ₀ (diagonal
    Gaussian prior), fused — tuning-free (no β/ε to adapt). Each
    step costs ``max_shrink`` batched potential evaluations (masked shrink
    loop). Returns (final_positions, within-budget-acceptance per chain)."""
    return _run_chains(
        _make_ess_step_builder(max_shrink),
        potential_fn,
        positions,
        [
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_steps", "thin", "max_shrink", "block_chains"),
)
def fused_ess_chain_recorded(
    potential_fn,
    positions,
    prior_mean,
    prior_scale,
    seed,
    n_steps=100,
    thin=1,
    max_shrink=8,
    block_chains=256,
):
    """Elliptical slice sampling with trajectory recording."""
    return _run_chains(
        _make_ess_step_builder(max_shrink),
        potential_fn,
        positions,
        [
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
        thin=thin,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_steps", "aux_dim", "block_chains"),
)
def fused_pcn_chain_warm(
    potential_fn,
    positions,
    prior_mean,
    prior_scale,
    beta,
    seed,
    n_steps=100,
    aux_dim=None,
    block_chains=256,
):
    """Warm-started fused pCN: ``potential_fn(U, x0) -> (phi, x)`` carries a
    per-chain (aux_dim, block) solver state (e.g. the Darcy CG solution from
    ``darcy.make_batched_misfit_warm``), so each proposal's solve starts from
    the current state's converged solution — ~2-3× fewer CG iterations at
    equal residual. Returns (final_positions, acceptance_rate_per_chain)."""
    if aux_dim is None:
        raise ValueError("fused_pcn_chain_warm requires aux_dim (solver rows)")
    return _run_chains(
        _make_pcn_warm_step_builder(aux_dim),
        potential_fn,
        positions,
        [
            jnp.float32(beta),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_steps", "thin", "aux_dim", "block_chains"),
)
def fused_pcn_chain_warm_recorded(
    potential_fn,
    positions,
    prior_mean,
    prior_scale,
    beta,
    seed,
    n_steps=100,
    thin=1,
    aux_dim=None,
    block_chains=256,
):
    """Warm-started fused pCN with trajectory recording."""
    if aux_dim is None:
        raise ValueError("fused_pcn_chain_warm_recorded requires aux_dim")
    return _run_chains(
        _make_pcn_warm_step_builder(aux_dim),
        potential_fn,
        positions,
        [
            jnp.float32(beta),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
        thin=thin,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_steps", "thin", "block_chains"),
)
def fused_pcn_chain_recorded(
    potential_fn,
    positions,
    prior_mean,
    prior_scale,
    beta,
    seed,
    n_steps=100,
    thin=1,
    block_chains=256,
):
    """pCN with trajectory recording: one launch returns
    (final_positions, accept_rate, samples (n_steps//thin, n, d))."""
    return _run_chains(
        _pcn_step_builder,
        potential_fn,
        positions,
        [
            jnp.float32(beta),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
        thin=thin,
    )


@functools.partial(
    jax.jit, static_argnames=("potential_fn", "n_steps", "block_chains")
)
def fused_rwm_chain(
    potential_fn, positions, step_size, seed, n_steps=100, block_chains=256
):
    """``n_steps`` of random-walk Metropolis on exp(−potential), fused.
    ``potential_fn``: FEATURES-FIRST batch (d, block) -> (block,).
    Returns (final_positions (n, d), acceptance_rate_per_chain (n,))."""
    return _run_chains(
        _rwm_step_builder,
        potential_fn,
        positions,
        [jnp.float32(step_size)],
        seed,
        n_steps,
        block_chains,
    )


@functools.partial(
    jax.jit, static_argnames=("potential_fn", "n_steps", "block_chains")
)
def fused_mala_chain(
    potential_fn, positions, step_size, seed, n_steps=100, block_chains=256
):
    """``n_steps`` of MALA on exp(−potential), fused, with gradients from
    ``jax.vjp`` of the batched potential.
    ``potential_fn`` must be reverse-differentiable: analytic / linear-misfit
    targets (not the fori_loop CG/FV misfits). Returns
    (final_positions (n, d), acceptance_rate_per_chain (n,))."""
    return _run_chains(
        _mala_step_builder,
        potential_fn,
        positions,
        [jnp.float32(step_size)],
        seed,
        n_steps,
        block_chains,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_steps", "thin", "block_chains"),
)
def fused_mala_chain_recorded(
    potential_fn, positions, step_size, seed, n_steps=100, thin=1, block_chains=256
):
    """MALA with trajectory recording: one launch returns
    (final_positions, accept_rate, samples (n_steps//thin, n, d))."""
    return _run_chains(
        _mala_step_builder,
        potential_fn,
        positions,
        [jnp.float32(step_size)],
        seed,
        n_steps,
        block_chains,
        thin=thin,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "n_steps", "thin", "block_chains"),
)
def fused_rwm_chain_recorded(
    potential_fn, positions, step_size, seed, n_steps=100, thin=1, block_chains=256
):
    """RWM with trajectory recording (see fused_pcn_chain_recorded)."""
    return _run_chains(
        _rwm_step_builder,
        potential_fn,
        positions,
        [jnp.float32(step_size)],
        seed,
        n_steps,
        block_chains,
        thin=thin,
    )


@functools.partial(
    jax.jit, static_argnames=("potential_fn", "n_steps", "block_chains")
)
def fused_pcn_chain(
    potential_fn,
    positions,
    prior_mean,
    prior_scale,
    beta,
    seed,
    n_steps=100,
    block_chains=256,
):
    """``n_steps`` of pCN with a diagonal (KL-coordinate) Gaussian prior,
    fused. ``potential_fn``: (d, block) -> (block,).
    Returns (final_positions, acceptance_rate_per_chain)."""
    return _run_chains(
        _pcn_step_builder,
        potential_fn,
        positions,
        [
            jnp.float32(beta),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "surrogate_fn", "n_steps",
                     "subchain_len", "block_chains"),
)
def fused_da_pcn_chain(
    potential_fn,
    surrogate_fn,
    positions,
    prior_mean,
    prior_scale,
    beta,
    seed,
    n_steps=100,
    subchain_len=4,
    block_chains=256,
):
    """Delayed-acceptance pCN, fully fused: each outer step runs
    ``subchain_len`` pCN steps against the cheap ``surrogate_fn`` (e.g. a
    coarse-grid FV misfit), then one ``potential_fn``
    (exact) correction. Both potentials: (d, block) -> (block,).
    Returns (final_positions, exact_accept_rate, inner_accept_rate) —
    the exact rate measures surrogate quality (≈1 is ideal), the inner
    rate is what β tunes."""
    return _run_chains(
        _make_da_pcn_step_builder(subchain_len),
        (potential_fn, surrogate_fn),
        positions,
        [
            jnp.float32(beta),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "mid_fn", "surrogate_fn", "n_steps",
                     "k_inner", "k_mid", "block_chains"),
)
def fused_da3_pcn_chain(
    potential_fn,
    mid_fn,
    surrogate_fn,
    positions,
    prior_mean,
    prior_scale,
    beta,
    seed,
    n_steps=100,
    k_inner=8,
    k_mid=4,
    block_chains=256,
):
    """THREE-level delayed-acceptance pCN, fully fused: per outer step,
    ``k_mid`` middle-level DA steps (each = ``k_inner`` pCN steps against
    ``surrogate_fn`` + one ``mid_fn`` correction), then one ``potential_fn``
    (exact) correction. All three potentials: (d, block) -> (block,).
    Returns (final_positions, fine_accept_rate, mid_accept_rate). See
    ``_make_da3_pcn_step_builder`` for the measured rationale."""
    return _run_chains(
        _make_da3_pcn_step_builder(k_inner, k_mid),
        (potential_fn, mid_fn, surrogate_fn),
        positions,
        [
            jnp.float32(beta),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "mid_fn", "surrogate_fn", "n_steps",
                     "thin", "k_inner", "k_mid", "block_chains"),
)
def fused_da3_pcn_chain_recorded(
    potential_fn,
    mid_fn,
    surrogate_fn,
    positions,
    prior_mean,
    prior_scale,
    beta,
    seed,
    n_steps=100,
    thin=1,
    k_inner=8,
    k_mid=4,
    block_chains=256,
):
    """3-level DA pCN with trajectory recording; each recorded
    step is one OUTER step (= k_inner*k_mid surrogate proposals + k_mid
    middle + 1 fine correction)."""
    return _run_chains(
        _make_da3_pcn_step_builder(k_inner, k_mid),
        (potential_fn, mid_fn, surrogate_fn),
        positions,
        [
            jnp.float32(beta),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
        thin=thin,
    )


@functools.partial(
    jax.jit,
    static_argnames=("potential_fn", "surrogate_fn", "n_steps", "thin",
                     "subchain_len", "block_chains"),
)
def fused_da_pcn_chain_recorded(
    potential_fn,
    surrogate_fn,
    positions,
    prior_mean,
    prior_scale,
    beta,
    seed,
    n_steps=100,
    thin=1,
    subchain_len=4,
    block_chains=256,
):
    """Delayed-acceptance pCN with trajectory recording: one
    launch returns (final_positions, exact_accept_rate,
    samples (n_steps//thin, n, d)). Each recorded step is one OUTER DA
    step (= subchain_len surrogate proposals + 1 exact correction)."""
    return _run_chains(
        _make_da_pcn_step_builder(subchain_len),
        (potential_fn, surrogate_fn),
        positions,
        [
            jnp.float32(beta),
            jnp.asarray(prior_mean, jnp.float32),
            jnp.asarray(prior_scale, jnp.float32),
        ],
        seed,
        n_steps,
        block_chains,
        thin=thin,
    )
