"""No-U-Turn Sampler — iterative, fixed-budget, vmap-able formulation.

Beyond-reference capability (BASELINE.json config 3: "MALA / NUTS on an ODE
forward model"). Recursion does not vmap, so this is the iterative multinomial
NUTS (Betancourt 2017 conceptual form; iterative sub-tree U-turn bookkeeping
after Phan & Pradhan's checkpointing scheme):

- outer ``lax.while_loop`` over tree doublings (≤ ``max_depth``),
- inner ``lax.while_loop`` over the 2^depth leapfrog steps of the new
  sub-tree, with progressive multinomial sampling of the proposal,
- sub-tree U-turn checks at every power-of-two-aligned span via a
  checkpoint stack of size ``max_depth`` indexed by the popcount of the
  span-start leaf index (all simultaneously open spans have distinct
  popcounts, and the spans completing at leaf ``i`` occupy the contiguous
  slot range ``[popcount(i) - trailing_ones(i), popcount(i) - 1]``),
- generalized U-turn criterion on momentum sums: a span [a, b] turns iff
  ρ·(M⁻¹ p_a) < 0 or ρ·(M⁻¹ p_b) < 0 with ρ = Σ_{j∈[a,b]} p_j.

Everything is static-shaped; under ``vmap`` the while loops run until all
chains finish (masked wasted work only), which is the standard lockstep trade.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ip_mcmc_tpu.utils.struct import pytree_dataclass

_MAX_DELTA_ENERGY = 1000.0


@pytree_dataclass
class NUTSState:
    position: jnp.ndarray
    log_density: jnp.ndarray
    grad: jnp.ndarray


@pytree_dataclass
class NUTSInfo:
    accept_prob: jnp.ndarray  # mean leaf accept prob (dual-averaging statistic)
    num_steps: jnp.ndarray  # leapfrog steps taken this transition
    depth: jnp.ndarray  # tree depth reached
    divergent: jnp.ndarray  # bool
    turning: jnp.ndarray  # bool


def init(position, log_density_fn):
    position = jnp.asarray(position)
    ld, g = jax.value_and_grad(log_density_fn)(position)
    return NUTSState(position=position, log_density=ld, grad=g)


def _popcount(x):
    # int32 popcount via SWAR (no jnp.bitwise_count dependency).
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101) >> 24


def _trailing_ones(x):
    # number of trailing 1-bits = trailing zeros of x+1
    y = (x + 1) & ~x  # isolates lowest 0-bit as a power of two
    return _popcount(y - 1)


def build_kernel(
    log_density_fn, step_size, max_depth=10, inv_mass=None, divergence_threshold=_MAX_DELTA_ENERGY
):
    value_and_grad = jax.value_and_grad(log_density_fn)

    def kernel(key, state):
        dtype = state.position.dtype
        dim = state.position.shape
        im = jnp.ones_like(state.position) if inv_mass is None else inv_mass

        key_mom, key_tree = jax.random.split(key)
        z = jax.random.normal(key_mom, dim, dtype=dtype)
        p0 = z / jnp.sqrt(im)

        def energy(ld, p):
            return -ld + 0.5 * jnp.sum(im * p * p)

        h0 = energy(state.log_density, p0)

        def leapfrog_one(q, p, _ld, g, direction):
            eps = direction * step_size
            p_half = p + 0.5 * eps * g
            q_new = q + eps * im * p_half
            ld_new, g_new = value_and_grad(q_new)
            p_new = p_half + 0.5 * eps * g_new
            return q_new, p_new, ld_new, g_new

        # Tree edge/proposal state: (q, p, ld, grad) tuples.
        z0 = (state.position, p0, state.log_density, state.grad)

        def is_turning(r_sum, p_left, p_right):
            return jnp.logical_or(
                jnp.sum(r_sum * (im * p_left)) < 0.0,
                jnp.sum(r_sum * (im * p_right)) < 0.0,
            )

        def build_subtree(key, z_edge, depth, direction):
            """Integrate 2^depth steps from z_edge in `direction`.

            Returns (z_new_edge, z_first, subtree proposal, log_sum_weight,
            r_sum, turning, divergent, sum_accept_prob, n_leaves_done).
            """
            n_steps = jnp.int32(1) << depth
            ckpt_p = jnp.zeros((max_depth + 1,) + dim, dtype)
            ckpt_rsum = jnp.zeros((max_depth + 1,) + dim, dtype)

            def cond(carry):
                i = carry[0]
                turning, divergent = carry[8], carry[9]
                return (i < n_steps) & ~turning & ~divergent

            def body(carry):
                (
                    i,
                    key,
                    z_cur,
                    z_first,
                    z_prop,
                    log_w_sum,
                    r_cum,
                    ckpts,
                    turning,
                    divergent,
                    sum_ap,
                ) = carry
                key, key_sel = jax.random.split(key)
                q, p, ld, g = leapfrog_one(*z_cur, direction)
                z_new = (q, p, ld, g)
                h = energy(ld, p)
                delta_h = h - h0
                # NaN energy (overflowed leapfrog) counts as a divergence
                delta_h = jnp.where(jnp.isnan(delta_h), jnp.inf, delta_h)
                log_w = -delta_h
                divergent_new = delta_h > divergence_threshold
                # dual-averaging statistic: min(1, exp(-Δh)) per leaf
                sum_ap = sum_ap + jnp.exp(jnp.minimum(-delta_h, 0.0))
                # progressive multinomial sampling within the subtree
                log_w_sum_new = jnp.logaddexp(log_w_sum, log_w)
                take = jnp.log(
                    jax.random.uniform(key_sel, (), dtype=dtype)
                ) < (log_w - log_w_sum_new)
                z_prop = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(take, a, b), z_new, z_prop
                )
                z_first = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(i == 0, a, b), z_new, z_first
                )
                r_cum_new = r_cum + p
                ckpt_p_a, ckpt_rsum_a = ckpts
                # checkpoint at even leaves, slot = popcount(i)
                slot = _popcount(i)
                is_even = (i & 1) == 0
                ckpt_p_a = jnp.where(
                    is_even,
                    ckpt_p_a.at[slot].set(p),
                    ckpt_p_a,
                )
                ckpt_rsum_a = jnp.where(
                    is_even,
                    ckpt_rsum_a.at[slot].set(r_cum),  # cumulative sum BEFORE leaf i
                    ckpt_rsum_a,
                )
                # spans completing at leaf i occupy slots [pc-K, pc-1]
                K = _trailing_ones(i)
                pc = slot
                slot_ids = jnp.arange(max_depth + 1, dtype=jnp.int32)
                active = (slot_ids >= pc - K) & (slot_ids <= pc - 1)
                span_r = r_cum_new[None, :] - ckpt_rsum_a  # (slots, dim)
                t_left = jnp.sum(span_r * (im * ckpt_p_a), axis=-1) < 0.0
                t_right = jnp.sum(span_r * (im * p)[None, :], axis=-1) < 0.0
                turning_new = jnp.any(active & (t_left | t_right))
                return (
                    i + 1,
                    key,
                    z_new,
                    z_first,
                    z_prop,
                    log_w_sum_new,
                    r_cum_new,
                    (ckpt_p_a, ckpt_rsum_a),
                    turning | turning_new,
                    divergent | divergent_new,
                    sum_ap,
                )

            init_carry = (
                jnp.int32(0),
                key,
                z_edge,
                z_edge,
                z_edge,
                jnp.array(-jnp.inf, dtype),
                jnp.zeros(dim, dtype),
                (ckpt_p, ckpt_rsum),
                jnp.array(False),
                jnp.array(False),
                jnp.array(0.0, dtype),
            )
            (
                i,
                _,
                z_end,
                z_first,
                z_prop,
                log_w_sum,
                r_cum,
                _,
                turning,
                divergent,
                sum_ap,
            ) = jax.lax.while_loop(cond, body, init_carry)
            return z_end, z_first, z_prop, log_w_sum, r_cum, turning, divergent, sum_ap, i

        def outer_cond(carry):
            depth, _, _, _, _, _, _, _, terminated, _, _ = carry
            return (depth < max_depth) & ~terminated

        def outer_body(carry):
            (
                depth,
                key,
                z_left,
                z_right,
                z_prop,
                log_w_tree,
                r_sum,
                n_steps_total,
                _terminated,
                divergent,
                stats,
            ) = carry
            key, key_dir, key_sub, key_merge = jax.random.split(key, 4)
            go_right = jax.random.bernoulli(key_dir)
            direction = jnp.where(go_right, 1.0, -1.0).astype(dtype)
            z_edge = jax.tree_util.tree_map(
                lambda a, b: jnp.where(go_right, a, b), z_right, z_left
            )
            (
                z_end,
                _z_first,
                z_prop_sub,
                log_w_sub,
                r_sum_sub,
                turning_sub,
                divergent_sub,
                sum_ap,
                leaves_done,
            ) = build_subtree(key_sub, z_edge, depth, direction)

            # update the moved edge
            z_left = jax.tree_util.tree_map(
                lambda e, old: jnp.where(go_right, old, e), z_end, z_left
            )
            z_right = jax.tree_util.tree_map(
                lambda e, old: jnp.where(go_right, e, old), z_end, z_right
            )

            subtree_ok = ~turning_sub & ~divergent_sub
            # biased progressive merge: take subtree proposal w.p. min(1, W_sub/W_tree)
            take = jnp.log(
                jax.random.uniform(key_merge, (), dtype=dtype)
            ) < (log_w_sub - log_w_tree)
            take = take & subtree_ok
            z_prop = jax.tree_util.tree_map(
                lambda a, b: jnp.where(take, a, b), z_prop_sub, z_prop
            )
            log_w_tree = jnp.where(
                subtree_ok, jnp.logaddexp(log_w_tree, log_w_sub), log_w_tree
            )
            r_sum = r_sum + r_sum_sub
            p_left, p_right = z_left[1], z_right[1]
            turning_tree = is_turning(r_sum, p_left, p_right)
            terminated = turning_sub | divergent_sub | turning_tree
            sum_ap_tot, n_leaves_tot = stats
            return (
                depth + 1,
                key,
                z_left,
                z_right,
                z_prop,
                log_w_tree,
                r_sum,
                n_steps_total + leaves_done,
                terminated,
                divergent | divergent_sub,
                (sum_ap_tot + sum_ap, n_leaves_tot + leaves_done),
            )

        init_carry = (
            jnp.int32(0),
            key_tree,
            z0,
            z0,
            z0,
            jnp.array(0.0, dtype),  # log weight of the initial state
            p0,
            jnp.int32(0),
            jnp.array(False),
            jnp.array(False),
            (jnp.array(0.0, dtype), jnp.int32(0)),
        )
        (
            depth,
            _,
            _,
            _,
            z_prop,
            _,
            _,
            n_steps_total,
            terminated,
            divergent,
            (sum_ap, n_leaves),
        ) = jax.lax.while_loop(outer_cond, outer_body, init_carry)

        q, _p, ld, g = z_prop
        new_state = NUTSState(position=q, log_density=ld, grad=g)
        accept_prob = jnp.where(
            n_leaves > 0, sum_ap / jnp.maximum(n_leaves, 1), jnp.array(0.0, dtype)
        )
        info = NUTSInfo(
            accept_prob=accept_prob,
            num_steps=n_steps_total,
            depth=depth,
            divergent=divergent,
            turning=terminated & ~divergent,
        )
        return new_state, info

    return kernel
