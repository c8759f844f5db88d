"""Is the vmapped NUTS kernel bound by lockstep gradient math?
(round-2 VERDICT item 9: improve the masked iterative kernel with a
profile, or MEASURE that it is already at the lockstep bound.)

Decomposition of one vmapped NUTS transition at C chains:

    wall >= (lockstep leapfrogs) x (cost of one vmapped leapfrog batch)

where lockstep leapfrogs per transition is what the while-loop batching
rule actually executes: the loop runs until EVERY chain terminates, so
each doubling costs 2^depth leapfrog batches whether or not a given chain
is masked. This harness measures, on the same Lotka-Volterra posterior as
the ode_nuts row:

1. raw vmapped leapfrog batch rate (jitted scan of leapfrog steps — the
   hardware ceiling for ANY trajectory-based kernel at these chain counts),
2. the NUTS transition rate and its measured per-transition lockstep
   leapfrog count (from infos: max over chains of cumulative num_steps is
   a lower bound; the true lockstep count uses the outer-loop depth),
3. efficiency = (lockstep leapfrogs x batch cost) / measured wall.

If efficiency is ~1, bookkeeping (checkpoint stack, U-turn checks,
multinomial bookkeeping) is immaterial and the kernel is gradient-bound:
the only levers are algorithmic (fewer/wider chains, ChEES) — which is
exactly the recommendation of the earlier rounds.

Writes benchmarks/nuts_bound.json.
"""

import argparse
import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="benchmarks/nuts_bound.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from ip_mcmc_tpu import configs, driver
    from ip_mcmc_tpu.kernels import nuts

    problem = configs.build("ode_nuts")
    logpi = problem.log_density_fn
    eps, max_depth = 0.02, 8
    C = 64 if args.quick else 256
    n_trans = 20 if args.quick else 50

    key = jax.random.key(0)
    pos = problem.init_positions(key, C)
    d = pos.shape[-1]

    # --- 1. raw vmapped leapfrog rate ------------------------------------
    grad_fn = jax.grad(logpi)

    from functools import partial

    # tiny step for the RAW rate: identical FLOPs per leapfrog, but a 512-step
    # unguarded trajectory at the sampling eps diverges to NaN (NUTS's own
    # divergence handling caps real trajectories); timing should not depend
    # on NaN-propagation fast/slow paths.
    eps_raw = 1e-4

    @partial(jax.jit, static_argnames=("n",))
    def leapfrog_scan(q, p, n):
        def body(carry, _):
            q, p, g = carry
            p_half = p + 0.5 * eps_raw * g
            q_new = q + eps_raw * p_half
            g_new = jax.vmap(grad_fn)(q_new)
            p_new = p_half + 0.5 * eps_raw * g_new
            return (q_new, p_new, g_new), None

        g0 = jax.vmap(grad_fn)(q)
        (q, p, _), _ = jax.lax.scan(body, (q, p, g0), None, length=n)
        return q, p

    p0 = jax.random.normal(jax.random.key(1), pos.shape)
    N_LEAP = 512
    # min-of-3 with a device->host TRANSFER barrier on every rep, including
    # the warm-up, so no compile leaks into a timed rep.
    reps = []
    for rep in range(4):
        t0 = time.perf_counter()
        q, p = leapfrog_scan(pos, p0, N_LEAP)
        np.asarray(q)  # transfer barrier
        if rep:  # rep 0 is compile + warm-up
            reps.append(time.perf_counter() - t0)
    leap_s = min(reps)
    batch_rate = N_LEAP / leap_s  # leapfrog BATCHES (C chains each) per sec
    log(f"raw vmapped leapfrog: {batch_rate:,.1f} batches/s "
        f"({batch_rate * C:,.0f} chain-leapfrogs/s at C={C})")

    # --- 2. NUTS transitions ---------------------------------------------
    kernel = nuts.build_kernel(logpi, eps, max_depth=max_depth)
    state = driver.init_chains(lambda q: nuts.init(q, logpi), pos)

    @partial(jax.jit, static_argnames=("n",))
    def run(state, key, n):
        def body(carry, step):
            st = carry
            keys = driver.chain_keys(key, step, C)
            st, info = jax.vmap(kernel)(keys, st)
            return st, (info.num_steps, info.depth)

        return jax.lax.scan(body, state, jnp.arange(n))

    nreps = []
    for rep in range(4):  # rep 0 = compile + warm-up (same barrier)
        t0 = time.perf_counter()
        st, (ns, dep) = run(state, jax.random.key(2 + rep), n_trans)
        ns = np.asarray(ns)  # (n_trans, C) leapfrogs per chain; also barrier
        dep = np.asarray(dep)
        if rep:
            nreps.append(time.perf_counter() - t0)
    nuts_s = min(nreps)

    # lockstep leapfrogs actually executed per transition: the batched
    # while loops run sum over doublings d<=D_max of 2^d batches, where
    # D_max is the deepest tree any chain built that transition, and each
    # doubling's inner loop runs to the max sub-tree length among chains
    # still active. Upper-bounded by 2^(max chain depth + 1) - 1; lower-
    # bounded by max chain num_steps. Report both brackets.
    lock_lo = ns.max(axis=1)  # (n_trans,)
    lock_hi = (2.0 ** (dep.max(axis=1) + 1)) - 1.0
    mean_chain_leaps = ns.mean()

    trans_rate = n_trans / nuts_s
    chain_steps_per_s = trans_rate * C
    pred_lo = lock_lo.sum() / batch_rate
    pred_hi = lock_hi.sum() / batch_rate
    out = {
        "chains": C,
        "n_transitions": n_trans,
        "leapfrog_batches_per_s": batch_rate,
        "nuts_wall_s": nuts_s,
        "nuts_transitions_per_s": trans_rate,
        "nuts_chain_steps_per_s": chain_steps_per_s,
        "mean_leapfrogs_per_chain_transition": float(mean_chain_leaps),
        "mean_lockstep_leapfrogs_lo": float(lock_lo.mean()),
        "mean_lockstep_leapfrogs_hi": float(lock_hi.mean()),
        "gradient_bound_wall_lo_s": pred_lo,
        "gradient_bound_wall_hi_s": pred_hi,
        "fraction_of_wall_explained_lo": pred_lo / nuts_s,
        "fraction_of_wall_explained_hi": pred_hi / nuts_s,
        "lockstep_waste_pct": 100.0 * (1 - mean_chain_leaps / lock_lo.mean()),
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    log(f"NUTS: {trans_rate:.2f} transitions/s = {chain_steps_per_s:,.0f} "
        f"chain-steps/s; mean leapfrogs/chain {mean_chain_leaps:.1f}, "
        f"lockstep executed {lock_lo.mean():.1f}-{lock_hi.mean():.1f}")
    log(f"gradient-bound wall explains {100*pred_lo/nuts_s:.0f}%-"
        f"{100*pred_hi/nuts_s:.0f}% of measured wall")
    log("written:", args.out)


if __name__ == "__main__":
    main()
