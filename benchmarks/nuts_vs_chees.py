"""NUTS vs ChEES-HMC: ESS per gradient evaluation on the ODE suite.

Round-1 VERDICT item 8: the package documents NUTS as fixed-budget with
masked wasted work (kernels/nuts.py:18-21) and recommends ChEES-HMC as the
gradient-based default — this harness produces the measurement backing that
claim.

Methodology (honest gradient accounting, SURVEY.md §7.3 item 6 analog):
- Same Lotka-Volterra posterior for both (configs._lv_problem is
  deterministic in its data seed), same MAP localization, each kernel's OWN
  warmup (dual-averaging ε + diagonal mass for NUTS; ε + ChEES-Adam τ +
  diagonal mass for ChEES) — adapting each sampler the way its authors
  intend, then a frozen 1000-step sampling phase.
- Gradient evals counted exactly, per chain per transition:
  * NUTS: ``info.num_steps`` — one ``value_and_grad`` per leapfrog leaf
    (the carried state gradient is reused; tree building does no other
    gradient work).
  * ChEES: ``n_leap(step) + 1`` — n_leap = ceil(u·τ/ε) leapfrogs (exactly
    replayable from the Halton sequence) plus the one extra
    ``value_and_grad(x1)`` in batch_step.
- Two efficiency views:
  * ESS / 1k gradient evals (algorithmic work — chain-count fair), and
  * ESS / s on the device (what a user experiences; for NUTS this includes
    the vmap lockstep penalty: every chain in the batch waits for the
    slowest tree of the step, measured here as ``lockstep_waste``).

Run on GPU:  python -m benchmarks.nuts_vs_chees [--quick]
Writes benchmarks/nuts_vs_chees.json and prints one JSON line per sampler.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import math
import time

import numpy as np


def log(*a):
    print(*a, file=_sys.stderr, flush=True)


def run_nuts(logpi, positions, n_samples, max_depth=8):
    import jax
    import jax.numpy as jnp

    from ip_mcmc_tpu import diagnostics, driver
    from ip_mcmc_tpu.adapt import warmup
    from ip_mcmc_tpu.kernels import nuts

    n_chains = positions.shape[0]
    key_warm, key_run = jax.random.split(jax.random.key(11))

    t0 = time.perf_counter()
    positions = warmup.map_localize(logpi, positions, num_steps=300)
    state = driver.init_chains(nuts.init, positions, logpi)
    state, eps, inv_mass = warmup.warmup_nuts(
        logpi, state, key_warm, num_steps=300, max_depth=max_depth
    )
    jax.block_until_ready(state.position)
    warm_s = time.perf_counter() - t0
    log(f"nuts warmup {warm_s:.1f}s  eps={float(eps):.4f}")

    kernel = nuts.build_kernel(
        logpi, step_size=eps, max_depth=max_depth, inv_mass=inv_mass
    )

    @jax.jit
    def sample(state):
        def body(st, i):
            keys = driver.chain_keys(key_run, i, n_chains)
            st, info = jax.vmap(kernel)(keys, st)
            # exact per-transition gradient accounting: per-chain leaf count
            return st, (
                st.position,
                jnp.sum(info.num_steps),
                jnp.max(info.num_steps),
                jnp.mean(info.accept_prob),
            )

        return jax.lax.scan(body, state, jnp.arange(n_samples))

    sample(state)[1][0].block_until_ready()  # compile
    t0 = time.perf_counter()
    _, (samples, grads_per_step, max_leafs, acc) = sample(state)
    jax.block_until_ready(samples)
    run_s = time.perf_counter() - t0

    summ = diagnostics.summarize(samples)
    total_grads = int(np.asarray(grads_per_step).sum())
    # vmap lockstep: each scan step costs ~max-over-chains leaves per chain
    lockstep_grads = int(np.asarray(max_leafs).sum()) * n_chains
    min_ess = float(summ["min_ess"])
    return {
        "sampler": f"nuts (max_depth={max_depth}, dual-averaged eps)",
        "n_chains": n_chains,
        "n_samples": n_samples,
        "warmup_s": warm_s,
        "run_s": run_s,
        "accept_prob": float(np.asarray(acc).mean()),
        "min_ess": min_ess,
        "ess_per_s": min_ess / run_s,
        "grad_evals": total_grads,
        "grad_evals_per_step_per_chain": total_grads / (n_samples * n_chains),
        "ess_per_1k_grads": 1000.0 * min_ess / total_grads,
        "lockstep_grad_evals": lockstep_grads,
        "lockstep_waste": 1.0 - total_grads / lockstep_grads,
        "ess_per_1k_lockstep_grads": 1000.0 * min_ess / lockstep_grads,
        "max_rhat": float(summ["max_rhat"]),
    }


def run_chees(logpi, positions, n_samples):
    import jax
    import jax.numpy as jnp

    from ip_mcmc_tpu import diagnostics
    from ip_mcmc_tpu.adapt import warmup
    from ip_mcmc_tpu.kernels import chees_hmc

    n_chains = positions.shape[0]
    key_warm, key_run = jax.random.split(jax.random.key(12))

    t0 = time.perf_counter()
    positions = warmup.map_localize(logpi, positions, num_steps=300)
    state, eps, traj, inv_mass = chees_hmc.warmup_chees(
        logpi, positions, key_warm, num_steps=300,
        initial_step_size=0.05, initial_trajectory=0.5,
    )
    jax.block_until_ready(state.positions)
    warm_s = time.perf_counter() - t0
    log(f"chees warmup {warm_s:.1f}s  eps={float(eps):.4f} tau={float(traj):.3f}")

    def sample():
        return chees_hmc.sample_chees(
            logpi, state, key_run, eps, traj, inv_mass,
            n_samples=n_samples, burn_in=0, thin=1,
        )

    jax.block_until_ready(sample()[1])  # compile
    t0 = time.perf_counter()
    _, samples, infos = sample()
    jax.block_until_ready(samples)
    run_s = time.perf_counter() - t0

    # exact replay of the leapfrog counts: batch_step integrates
    # n_leap = max(ceil(u_i*tau/eps), 1) shared across chains, +1 extra
    # value_and_grad on the proposal; halton(i) is deterministic.
    e, t = float(eps), float(traj)
    n_leaps = [
        max(math.ceil(float(chees_hmc.halton(jnp.int32(i))) * t / e), 1)
        for i in range(n_samples)
    ]
    total_grads = sum(n + 1 for n in n_leaps) * n_chains

    summ = diagnostics.summarize(samples)
    min_ess = float(summ["min_ess"])
    return {
        "sampler": "chees-hmc (adapted eps + trajectory, halton jitter)",
        "n_chains": n_chains,
        "n_samples": n_samples,
        "warmup_s": warm_s,
        "run_s": run_s,
        "accept_prob": float(np.asarray(infos.accept_prob).mean()),
        "min_ess": min_ess,
        "ess_per_s": min_ess / run_s,
        "grad_evals": total_grads,
        "grad_evals_per_step_per_chain": total_grads / (n_samples * n_chains),
        "ess_per_1k_grads": 1000.0 * min_ess / total_grads,
        # the ChEES step count is a traced SCALAR shared by every chain:
        # zero lockstep waste by construction
        "lockstep_grad_evals": total_grads,
        "lockstep_waste": 0.0,
        "ess_per_1k_lockstep_grads": 1000.0 * min_ess / total_grads,
        "max_rhat": float(summ["max_rhat"]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--n-chains", type=int, default=256)
    args = ap.parse_args(argv)

    import jax

    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_s=1.0)

    from ip_mcmc_tpu import configs

    problem = configs.build("ode_nuts")
    logpi = problem.log_density_fn
    n_samples = 200 if args.quick else 1000
    # EQUAL chain counts so the device-time comparison is apples-to-apples
    positions = problem.init_positions(jax.random.key(5), args.n_chains)

    rows = [
        run_nuts(logpi, positions, n_samples),
        run_chees(logpi, positions, n_samples),
    ]
    for r in rows:
        print(json.dumps(r))
    out = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                        "nuts_vs_chees.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    log(f"wrote {out}")
    nuts_r, chees_r = rows
    log(
        f"ESS/1k grads: chees {chees_r['ess_per_1k_grads']:.3f} vs nuts "
        f"{nuts_r['ess_per_1k_grads']:.3f} "
        f"({chees_r['ess_per_1k_grads']/nuts_r['ess_per_1k_grads']:.2f}x); "
        f"ESS/s: chees {chees_r['ess_per_s']:.1f} vs nuts "
        f"{nuts_r['ess_per_s']:.1f} "
        f"({chees_r['ess_per_s']/nuts_r['ess_per_s']:.2f}x); "
        f"nuts lockstep waste {nuts_r['lockstep_waste']:.1%}"
    )


if __name__ == "__main__":
    main()
