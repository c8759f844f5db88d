"""Smoke test of the sampler on NVIDIA GPUs, through the entry points a user
calls, at the full width of the Darcy configurations (64 KL modes, 16² grid,
4096 chains).

    python chip_smoke.py          # one GPU
    python chip_smoke.py --four   # the four-GPU paths only

One GPU, in one process, phase by phase:

1. device     JAX's first device must be a GPU; prints its kind and
              ``nvidia-smi``'s name and power limit.
2. parity     Darcy exact, surrogate and adjoint potentials on the GPU
              against the float64 NumPy oracle at 4096 prior draws, the
              composed ('chains', 'model') misfit on a 1×1 mesh against the
              single-device one, the DEFAULT-vs-HIGHEST matmul-precision
              difference in Φ, and every
              fused entry point on the GPU against the same call on the
              host CPU (share of chains whose acceptance differs).
3. main path  ``runner.run_problem`` on ``darcy_da_fused`` and
              ``darcy_pcn_4096``; each metrics JSON on its own line.
4. triton     the Pallas-Triton attempt at the DA-pCN step
              (``benchmarks/triton_da_attempt.py``) and its outcome.

``--four`` runs, on four GPUs, only the sharded paths and what each is
compared with: chain-sharded scan sampling, the chain-sharded fused DA-pCN
engine, distributed systematic resampling, and the composed 2×2
('chains', 'model') pCN and misfit.

Any failed check raises, so the exit code is non-zero. The last line of
standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

N_DRAWS = 4096
NOISE = 0.002

# Tolerances against the float64 oracle (dense Cholesky solves). The same
# code in float32 on the host CPU, over these 4096 draws, reaches a max
# relative Φ error of 2.2e-6 (exact: CG-12, truncated-DST preconditioner),
# 3.6e-2 (surrogate: CG-3 on the 8×8 grid — solver truncation, by design)
# and a directional-derivative error of 1.9e-6 of |∇Φ| (adjoint). The
# bounds leave room for float32 rounding in another summation order, and
# no more: a TF32 product in the KL reconstruction or the observation
# operator moves Φ by ~1e-3 relative at σ = 0.002 and fails the exact and
# the CPU-vs-GPU bounds. The composed misfit (Jacobi-PCG, 150 iterations)
# reaches 4.6e-6 of the single-device one on the CPU; it is held to the
# CPU-vs-GPU bound.
PHI_RTOL_EXACT = 2e-5
PHI_RTOL_SURROGATE = 4.5e-2
GRAD_RTOL = 2e-5
PHI_RTOL_VS_CPU = 1e-4


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    """``name, power.limit`` of each card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def device_phase(n_required=1):
    """Refuse anything but a GPU; returns the device record."""
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a GPU; JAX's first device is {d0} "
            f"(platform {d0.platform!r})"
        )
    if len(devs) < n_required:
        raise RuntimeError(f"need {n_required} GPUs, JAX sees {len(devs)}")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": n_required}


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def parity_phase(n_draws=N_DRAWS, seed=0):
    """Darcy potentials and adjoint on the default device vs the float64
    oracle, and the DEFAULT-vs-HIGHEST precision difference. Returns the
    measured errors; raises if a tolerance is exceeded."""
    from benchmarks.oracle_darcy import OracleDarcyPCN
    from ip_mcmc_tpu import configs
    from ip_mcmc_tpu.models import darcy
    from ip_mcmc_tpu.parallel import composed

    problem = configs.build("darcy_da_fused")
    y = np.asarray(problem.data, np.float64)
    oracle = OracleDarcyPCN()
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((n_draws, oracle.K))
    Ut = jnp.asarray(U.T, jnp.float32)
    cpu = jax.devices("cpu")[0]
    out = {"n_draws": n_draws}

    phi_o = np.array([oracle.potential(u, y, NOISE) for u in U])
    phi_exact = jax.jit(problem.batched_potential_fn)
    phi_dev = np.asarray(phi_exact(Ut))
    with jax.default_device(cpu):
        phi_cpu = np.asarray(jax.jit(problem.batched_potential_fn)(
            jax.device_put(Ut, cpu)))
    with jax.default_matmul_precision("default"):
        phi_default = np.asarray(jax.jit(problem.batched_potential_fn)(Ut))
    out["exact_phi_max_rel_vs_oracle"] = _max_rel(phi_dev, phi_o)
    out["exact_phi_max_rel_vs_cpu_f32"] = _max_rel(phi_dev, phi_cpu)
    out["phi_range"] = [float(phi_o.min()), float(phi_o.max())]
    out["precision_default_vs_highest_max_abs_dphi"] = float(
        np.max(np.abs(phi_default - phi_dev)))
    out["precision_default_vs_highest_max_rel_dphi"] = _max_rel(
        phi_default, phi_dev)

    # the composed ('chains', 'model') misfit of the darcy_composed_* configs
    # on a 1×1 mesh of the default device, against the single-device misfit
    ckp = configs.build("darcy_composed_pcn").kernel_params
    mesh = composed.make_composed_mesh(1, 1, jax.devices()[:1])
    phi_comp = jax.jit(lambda u: composed.composed_misfit_and_grad(
        ckp["aux"], problem.data, ckp["noise_scale"], mesh, u,
        cg_iters=ckp["cg_iters"])[0])(Ut.T)
    out["composed_phi_max_rel_vs_single_device"] = _max_rel(phi_comp, phi_dev)

    # surrogate: the deployed coarse-grid CG-3 misfit, calibrated with the
    # oracle's (y_surr, scale) so both sides evaluate the same Φ*
    surr_o = oracle.make_coarse_surrogate(y, NOISE)
    _, aux8 = darcy.make_darcy_forward(
        n_grid=8, n_modes_per_dim=8, alpha=2.0, field_scale=10.0,
        obs_indices=surr_o.coarse.obs,
    )
    surr_b = darcy.make_batched_misfit(
        aux8, surr_o.y_surr, surr_o.scale, cg_iters=3, precond="dst_trunc",
        precond_modes=64,
    )
    surr_dev = np.asarray(jax.jit(surr_b)(Ut))
    surr_oracle = np.array([surr_o(u) for u in U])
    out["surrogate_phi_max_rel_vs_oracle"] = _max_rel(surr_dev, surr_oracle)

    # adjoint: directional derivative of the differentiable exact misfit
    # against a float64 central difference of the oracle along one random
    # unit direction per draw
    _, aux16 = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    phi_ad = darcy.make_batched_misfit(
        aux16, y, NOISE, cg_iters=12, precond="dst_trunc", precond_modes=128,
        differentiable=True,
    )
    grad = jax.jit(lambda x: jax.vjp(phi_ad, x)[1](jnp.ones(x.shape[1]))[0])
    g = np.asarray(grad(Ut)).T  # (n_draws, K)
    V = rng.standard_normal(U.shape)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    eps = 1e-5
    fd = np.array([
        (oracle.potential(u + eps * v, y, NOISE)
         - oracle.potential(u - eps * v, y, NOISE)) / (2 * eps)
        for u, v in zip(U, V)
    ])
    gv = np.sum(g * V, axis=1)
    gnorm = np.linalg.norm(g, axis=1)
    out["adjoint_dir_deriv_max_err_over_grad_norm"] = float(
        np.max(np.abs(gv - fd) / np.maximum(gnorm, 1e-30)))

    checks = [
        ("exact_phi_max_rel_vs_oracle", PHI_RTOL_EXACT),
        ("exact_phi_max_rel_vs_cpu_f32", PHI_RTOL_VS_CPU),
        ("composed_phi_max_rel_vs_single_device", PHI_RTOL_VS_CPU),
        ("surrogate_phi_max_rel_vs_oracle", PHI_RTOL_SURROGATE),
        ("adjoint_dir_deriv_max_err_over_grad_norm", GRAD_RTOL),
    ]
    for key, tol in checks:
        if not out[key] <= tol:
            raise AssertionError(
                f"parity: {key} = {out[key]:.3e} > {tol:.1e}; {json.dumps(out)}")
    return out


def _fused_cases(problem):
    """(name, fn, args, kwargs) for one call of each shipped fused entry
    point on the darcy_da_fused posterior at full width (64 modes, 16²)."""
    from ip_mcmc_tpu import ops
    from ip_mcmc_tpu.models import darcy

    y = jnp.asarray(problem.data, jnp.float32)
    _, aux = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0)
    phi = problem.batched_potential_fn
    surr = problem.batched_surrogate_fn
    mid = darcy.make_batched_misfit(aux, y, NOISE, cg_iters=4,
                                    precond="dst_trunc", precond_modes=128)
    phi_ad = darcy.make_batched_misfit(aux, y, NOISE, cg_iters=12,
                                       precond="dst_trunc", precond_modes=128,
                                       differentiable=True)
    warm, aux_w = darcy.make_batched_misfit_warm(
        aux, y, NOISE, cg_iters=4, precond="dst_trunc", precond_modes=64)
    pag, aux_m = darcy.make_batched_misfit_mala_warm(
        aux, y, NOISE, cg_iters=4, precond="dst")
    post = lambda U: phi(U) + 0.5 * jnp.sum(U * U, axis=0)
    post_ad = lambda U: phi_ad(U) + 0.5 * jnp.sum(U * U, axis=0)
    K = problem.dim
    pm, ps = np.zeros(K, np.float32), np.ones(K, np.float32)
    chol = np.eye(K, dtype=np.float32)
    return [
        ("rwm", ops.fused_rwm_chain, (post, 0.003), {}),
        ("pcn", ops.fused_pcn_chain, (phi, pm, ps, 0.05), {}),
        ("pcn_warm", ops.fused_pcn_chain_warm, (warm, pm, ps, 0.05),
         {"aux_dim": aux_w}),
        ("pcn_dense", ops.fused_pcn_chain_dense, (phi, pm, chol, 0.05), {}),
        ("pcn_adapt", ops.fused_pcn_chain_adapt, (phi, pm, ps, 0.05), {}),
        ("da", lambda p, pos, *a, **k: ops.fused_da_pcn_chain(
            p, surr, pos, *a, **k), (phi, pm, ps, 0.35),
         {"subchain_len": 8}),
        ("da3", lambda p, pos, *a, **k: ops.fused_da3_pcn_chain(
            p, mid, surr, pos, *a, **k), (phi, pm, ps, 0.35),
         {"k_inner": 4, "k_mid": 2}),
        ("mala", ops.fused_mala_chain, (post_ad, 0.002), {}),
        ("mala_warm", ops.fused_mala_chain_warm, (pag, pm, ps, 0.002),
         {"aux_dim": aux_m}),
        ("ess", ops.fused_ess_chain, (phi, pm, ps), {"max_shrink": 6}),
        ("fes", ops.fused_fes_chain, (phi, pm, ps, 8), {}),
    ]


def fused_device_vs_cpu_phase(n_chains=512, n_steps=4, block_chains=128):
    """Each fused entry point on the default device and on the host CPU in
    this process, from the same start, seed and stream: the share of
    chains whose acceptance rate differs, and the largest position
    difference. Raises on non-finite output or if more than half the
    chains disagree (a broken engine, not rounding)."""
    from ip_mcmc_tpu import configs

    problem = configs.build("darcy_da_fused")
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(1)
    pos = (np.asarray(problem.truth, np.float32)[None, :]
           + 0.05 * rng.standard_normal((n_chains, problem.dim))
           ).astype(np.float32)
    out = {}
    for name, fn, args, kw in _fused_cases(problem):
        call = lambda p: fn(args[0], p, *args[1:], seed=11, n_steps=n_steps,
                            block_chains=block_chains, **kw)
        dev = [np.asarray(o) for o in call(jnp.asarray(pos))]
        with jax.default_device(cpu):
            ref = [np.asarray(o) for o in call(jax.device_put(pos, cpu))]
        if not all(np.isfinite(o).all() for o in dev):
            raise AssertionError(f"fused {name}: non-finite output on device")
        differ = float(np.mean(dev[1] != ref[1]))
        out[name] = {
            "accept_rate": float(dev[1].mean()),
            "share_chains_accept_differs": differ,
            "max_abs_position_diff": float(np.max(np.abs(dev[0] - ref[0]))),
        }
        if differ > 0.5:
            raise AssertionError(f"fused {name}: {differ:.0%} of chains "
                                 "accept differently on device and CPU")
    return out


def main_path_phase(smi):
    """darcy_da_fused and darcy_pcn_4096 through runner.run_problem at full
    width; prints each metrics JSON and checks convergence and agreement."""
    from ip_mcmc_tpu import configs, runner

    runs = {}
    for name in ("darcy_da_fused", "darcy_pcn_4096"):
        t0 = time.perf_counter()
        m = runner.run_problem(configs.build(name), key=jax.random.key(0))
        m["phase_wall_s"] = time.perf_counter() - t0
        m["card"] = smi
        log(json.dumps(m))
        mean = np.asarray(m["posterior_mean"])
        if not (np.isfinite(mean).all() and np.isfinite(m["min_ess"])):
            raise AssertionError(f"{name}: non-finite output")
        if not m["max_rhat"] < 1.1:
            raise AssertionError(f"{name}: max_rhat {m['max_rhat']:.3f}")
        if not 0.0 < m["accept_rate"] < 1.0:
            raise AssertionError(f"{name}: accept_rate {m['accept_rate']}")
        runs[name] = m
    a, b = runs["darcy_da_fused"], runs["darcy_pcn_4096"]
    diff = np.abs(np.asarray(a["posterior_mean"])
                  - np.asarray(b["posterior_mean"]))
    mcse = np.hypot(a["posterior_mcse"], b["posterior_mcse"])
    worst = float(np.max(diff / mcse))
    log(f"posterior means agree: max |Δmean| / combined MCSE = {worst:.2f}")
    if not worst < 4.0:
        raise AssertionError(
            f"posterior means differ by {worst:.2f} combined MC errors")
    return {"max_mean_diff_over_mcse": worst}


def triton_phase():
    """The bounded Pallas-Triton attempt at the DA-pCN step."""
    from benchmarks import triton_da_attempt

    return [triton_da_attempt.attempt(b) for b in (32, 64)]


def four_phase(n_chains=4096, block_chains=512, n_particles=16384):
    """The four-GPU paths, each against its one-GPU run, at the Darcy
    configurations' width (``n_chains``) unless told otherwise."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ip_mcmc_tpu import configs, driver, ops, parallel, smc
    from ip_mcmc_tpu.kernels import pcn
    from ip_mcmc_tpu.models import darcy
    from ip_mcmc_tpu.parallel import composed, resample
    from ip_mcmc_tpu.parallel.fused_shard import SEED_STRIDE

    out = {}
    devs = jax.devices()[:4]

    # chain-sharded scan+vmap pCN on darcy_pcn_4096 vs one GPU
    problem = configs.build("darcy_pcn_4096")
    kernel = pcn.build_kernel(problem.potential_fn, problem.prior, beta=0.08)
    pos = problem.init_positions(jax.random.key(1), n_chains)
    state = driver.init_chains(pcn.init, pos, problem.potential_fn)
    kw = dict(n_samples=20, burn_in=10)
    _, s1, i1 = driver.sample_chains(kernel, state, jax.random.key(2), **kw)
    mesh = parallel.make_chain_mesh(n_devices=4)
    _, s4, i4 = parallel.sample_chains_sharded(
        kernel, state, jax.random.key(2), mesh, **kw)
    s1, s4 = np.asarray(s1), np.asarray(s4)
    out["sharded_pcn"] = {
        "bitwise": bool(np.array_equal(s1, s4)),
        "max_abs_diff": float(np.max(np.abs(s1 - s4))),
        "share_chains_differ": float(np.mean(np.any(s1 != s4, axis=(0, 2)))),
    }
    if out["sharded_pcn"]["share_chains_differ"] > 0.01:
        raise AssertionError(f"sharded pCN: {out['sharded_pcn']}")

    # chain-sharded fused DA-pCN: shard d == one-GPU run at seed + d*stride
    da = configs.build("darcy_da_fused")
    kp = da.kernel_params
    pos = jnp.asarray(da.init_positions(jax.random.key(3), n_chains))
    run_kw = dict(prior_mean=np.asarray(da.prior.mean),
                  prior_scale=np.asarray(da.prior.scale), beta=kp["beta"],
                  n_steps=4, subchain_len=kp["subchain_len"],
                  block_chains=block_chains)
    fn = lambda p, x, **k: ops.fused_da_pcn_chain(
        p, da.batched_surrogate_fn, x, **k)
    f4, a4, _ = parallel.sharded_fused_chain(
        fn, mesh, da.batched_potential_fn, pos, seed=5, **run_kw)
    f4, a4 = np.asarray(f4), np.asarray(a4)
    per = n_chains // 4
    shard_equal = []
    for d in range(4):
        sl = slice(d * per, (d + 1) * per)
        f1, a1, _ = fn(da.batched_potential_fn, pos[sl],
                       seed=5 + d * SEED_STRIDE, **run_kw)
        shard_equal.append(float(np.mean(np.asarray(a1) == a4[sl])))
    out["sharded_fused_da"] = {"share_accept_equal_per_shard": shard_equal}
    if min(shard_equal) < 0.99:
        raise AssertionError(f"sharded fused DA: {out['sharded_fused_da']}")

    # distributed systematic resampling vs the serial oracle, bitwise
    chain_shard = NamedSharding(mesh, P(parallel.CHAIN_AXIS))
    key = jax.random.key(7)
    particles = jax.random.normal(jax.random.fold_in(key, 0),
                                  (n_particles, 64))
    log_w = -0.5 * jnp.sum(particles ** 2, axis=1)
    res = resample.distributed_systematic_resample(
        jax.random.fold_in(key, 1), jax.device_put(log_w, chain_shard),
        jax.device_put(particles, chain_shard), mesh)
    anc = smc.systematic_resample(jax.random.fold_in(key, 1), log_w)
    bitwise = bool(np.array_equal(np.asarray(res),
                                  np.asarray(particles)[np.asarray(anc)]))
    out["distributed_resample_bitwise"] = bitwise
    if not bitwise:
        raise AssertionError("distributed resampling != serial oracle")

    # composed 2x2 ('chains', 'model') pCN vs one GPU
    fwd, aux = darcy.make_darcy_forward(n_grid=16, n_modes_per_dim=8,
                                        alpha=2.0, field_scale=10.0)
    y = fwd(jax.random.normal(jax.random.key(300), (64,)))
    u0 = jax.random.normal(jax.random.key(5), (64, 64))
    ckw = dict(beta=0.2, u0=u0, base_key=jax.random.key(9), n_samples=8,
               burn_in=4, cg_iters=60)
    s_ref, a_ref = composed.sample_composed_pcn(
        aux, y, 0.05, mesh=composed.make_composed_mesh(1, 1, devs), **ckw)
    s_22, a_22 = composed.sample_composed_pcn(
        aux, y, 0.05, mesh=composed.make_composed_mesh(2, 2, devs), **ckw)
    err = float(np.max(np.abs(np.asarray(s_22) - np.asarray(s_ref))))
    out["composed_2x2"] = {"max_abs_diff": err, "accept": float(a_22),
                           "accept_one_gpu": float(a_ref)}
    if not (err <= 1e-4 and abs(float(a_22) - float(a_ref)) <= 1e-6):
        raise AssertionError(f"composed 2x2: {out['composed_2x2']}")

    # composed 2x2 misfit of the darcy_composed_* configs (σ = 0.002) at
    # prior draws, against the single-device misfit on one GPU
    ckp = configs.build("darcy_composed_pcn").kernel_params
    U = jax.random.normal(jax.random.key(11), (n_chains, 64))
    phi_1 = jax.jit(da.batched_potential_fn)(U.T)
    phi_22, _ = jax.jit(lambda u: composed.composed_misfit_and_grad(
        ckp["aux"], da.data, ckp["noise_scale"],
        composed.make_composed_mesh(2, 2, devs), u,
        cg_iters=ckp["cg_iters"]))(U)
    rel = _max_rel(phi_22, phi_1)
    out["composed_2x2_phi_max_rel_vs_single_device"] = rel
    if not rel <= PHI_RTOL_VS_CPU:
        raise AssertionError(f"composed 2x2 misfit: max rel {rel:.3e}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="GPU smoke test")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths")
    args = ap.parse_args(argv)

    n_cards = 4 if args.four else 1
    t0 = time.perf_counter()
    device = device_phase(n_cards)
    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    smi = nvidia_smi()
    log(f"device: {device['kind']} x{len(jax.devices())} (using {n_cards})")
    for line in smi:
        print(line, flush=True)
    times = {"device": time.perf_counter() - t0}

    def phase(name, fn, *a):
        t = time.perf_counter()
        res = fn(*a)
        times[name] = time.perf_counter() - t
        log(f"phase {name} ({times[name]:.1f} s): {json.dumps(res)}")

    if args.four:
        phase("four", four_phase)
    else:
        phase("parity", parity_phase)
        phase("fused_device_vs_cpu", fused_device_vs_cpu_phase)
        phase("main_path", main_path_phase, smi)
        phase("triton", triton_phase)
    log(f"phase times (s): {json.dumps(times)}")
    log(f"card: {'; '.join(smi)}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
