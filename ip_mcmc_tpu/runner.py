"""Problem runner: config → (warmup) → sampling → on-device diagnostics.

The reproducible entry for every named BASELINE config (used by the CLI,
the benchmark harness, and tests). Returns a JSON-able metrics dict:
wall-clock split (compile vs run), chain-steps/s, multi-chain ESS (same
estimator as the NumPy oracle), ESS/sec, split-R̂, acceptance rate.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np

from ip_mcmc_tpu import diagnostics, driver, smc
from ip_mcmc_tpu.adapt import (
    warmup,
    warmup_hmc,
    warmup_mala,
    warmup_nuts,
    warmup_pcn,
    warmup_rwm,
)
from ip_mcmc_tpu.kernels import (
    chees_hmc,
    da_pcn,
    elliptical,
    hmc,
    mala,
    nuts,
    pcn,
    rwm,
)


def _setup_kernel_state(problem, positions, key_warm):
    """Kernel/state construction core: (positions, key_warm) →
    (kernel, state, warm_steps). Pure in its array arguments, so it can be
    traced INTO the one-dispatch pipeline program (_run_one_dispatch) or run
    eagerly by _build_kernel_and_state. Warmup replaces burn-in when
    kernel_params['adapt'] is set (adaptation doubles as burn-in);
    ``warm_steps`` counts the chain steps warmup/map_init executed so
    throughput accounting stays honest when everything is one program."""
    kp = dict(problem.kernel_params)
    adapt = kp.pop("adapt", False)
    map_init = kp.pop("map_init", 0)
    kp.pop("fused", None)  # handled by run_problem; ignored on other paths
    kp.pop("block_chains", None)
    kp.pop("vi_init", None)  # VI warm start: consumed by run_problem
    kp.pop("pod_enrich", None)  # online enrichment: consumed by run_problem
    warm_steps = 0
    if map_init and problem.kernel in ("mala", "hmc", "nuts"):
        # map_init runs Adam iterations, not chain steps — it is NOT added
        # to warm_steps (ADVICE round 4: optimizer iterations inflated
        # steps_per_s); _run_one_dispatch reports it as map_init_iters
        positions = warmup.map_localize(
            problem.log_density_fn, positions, num_steps=map_init
        )

    if problem.kernel == "rwm":
        logpi = problem.log_density_fn
        state = driver.init_chains(rwm.init, positions, logpi)
        if adapt:
            warm_steps += problem.burn_in or 300
            state, step_size, chol = warmup_rwm(
                logpi, state, key_warm, num_steps=problem.burn_in or 300,
                initial_step_size=kp.get("step_size", 0.5),
            )
            kernel = rwm.build_kernel(logpi, step_size=step_size, scale=chol)
        else:
            kernel = rwm.build_kernel(logpi, **kp)
    elif problem.kernel == "pcn":
        phi, prior = problem.potential_fn, problem.prior
        state = driver.init_chains(pcn.init, positions, phi)
        if adapt:
            warm_steps += problem.burn_in or 300
            state, beta = warmup_pcn(
                phi, prior, state, key_warm, num_steps=problem.burn_in or 300,
                initial_beta=kp.get("beta", 0.2),
            )
            kernel = pcn.build_kernel(phi, prior, beta=beta)
        else:
            kernel = pcn.build_kernel(phi, prior, **kp)
    elif problem.kernel == "da_pcn":
        phi, prior = problem.potential_fn, problem.prior
        surr = problem.surrogate_potential_fn
        if surr is None:
            raise ValueError(
                f"config {problem.name}: kernel 'da_pcn' needs surrogate_potential_fn"
            )
        if "k_mid" in kp or "k_inner" in kp:
            # 3-level delayed acceptance exists only as the fused
            # step builder (ops.fused_da3_pcn_chain); without it the
            # k_inner/k_mid params would reach da_pcn.build_kernel as
            # unknown kwargs (ADVICE round 3) — fail with the real reason.
            raise ValueError(
                f"config {problem.name}: 3-level delayed acceptance "
                "(k_inner/k_mid) is fused-only — set kernel_params"
                "['fused']=True and provide batched potential/mid/surrogate "
                "functions (see burgers_da3_pcn)"
            )
        state = driver.init_chains(
            lambda pos: da_pcn.init(pos, phi, surr), positions
        )
        kernel = da_pcn.build_kernel(phi, surr, prior, **kp)
    elif problem.kernel == "elliptical":
        phi, prior = problem.potential_fn, problem.prior
        state = driver.init_chains(elliptical.init, positions, phi)
        kernel = elliptical.build_kernel(phi, prior, **kp)
    elif problem.kernel == "mala":
        logpi = problem.log_density_fn
        state = driver.init_chains(mala.init, positions, logpi)
        if adapt:
            warm_steps += problem.burn_in or 300
            state, eps, precond = warmup_mala(
                logpi, state, key_warm, num_steps=problem.burn_in or 300,
                initial_step_size=kp.get("step_size", 0.05),
            )
            kernel = mala.build_kernel(logpi, step_size=eps, precond=precond)
        else:
            kernel = mala.build_kernel(logpi, **kp)
    elif problem.kernel == "hmc":
        logpi = problem.log_density_fn
        state = driver.init_chains(hmc.init, positions, logpi)
        nint = kp.get("num_integration_steps", 8)
        if adapt:
            warm_steps += problem.burn_in or 300
            state, eps, inv_mass = warmup_hmc(
                logpi, state, key_warm, num_steps=problem.burn_in or 300,
                num_integration_steps=nint,
                initial_step_size=kp.get("step_size", 0.1),
            )
            kernel = hmc.build_kernel(
                logpi, step_size=eps, num_integration_steps=nint, inv_mass=inv_mass
            )
        else:
            kernel = hmc.build_kernel(logpi, **kp)
    elif problem.kernel == "nuts":
        logpi = problem.log_density_fn
        state = driver.init_chains(nuts.init, positions, logpi)
        md = kp.get("max_depth", 8)
        if adapt:
            warm_steps += problem.burn_in or 200
            state, eps, inv_mass = warmup_nuts(
                logpi, state, key_warm, num_steps=problem.burn_in or 200,
                max_depth=md, initial_step_size=kp.get("step_size", 0.1),
            )
            kernel = nuts.build_kernel(
                logpi, step_size=eps, max_depth=md, inv_mass=inv_mass
            )
        else:
            kernel = nuts.build_kernel(logpi, **kp)
    else:
        raise ValueError(f"unknown kernel {problem.kernel}")

    return kernel, state, warm_steps


def _build_kernel_and_state(problem, key, n_chains):
    """Eager wrapper over _setup_kernel_state: draws initial positions and
    times warmup. Returns (kernel, state, warmup_time_s)."""
    key_init, key_warm = jax.random.split(key)
    positions = problem.init_positions(key_init, n_chains)
    t0 = time.perf_counter()
    kernel, state, _ = _setup_kernel_state(problem, positions, key_warm)
    jax.block_until_ready(jax.tree_util.tree_leaves(state)[0])
    return kernel, state, time.perf_counter() - t0


def _summarize_timed(samples):
    """diagnostics.summarize with its wall time measured. The ESS/R̂
    program is a real compile+run cost — round-2 VERDICT weak #1 measured
    ~80s of eager-dispatch compile hidden OUTSIDE every timed phase — so it
    is now (a) a single jitted, persistently-cacheable program
    (diagnostics.summarize) and (b) reported as ``diag_s`` in metrics."""
    t0 = time.perf_counter()
    summ = diagnostics.summarize(jnp.asarray(samples))
    jax.block_until_ready(summ["min_ess"])
    return summ, time.perf_counter() - t0


def _mcse(summ):
    """Per-parameter Monte-Carlo standard error of the posterior mean:
    posterior std / sqrt(ESS)."""
    std, ess = np.asarray(summ["std"]), np.asarray(summ["ess"])
    return (std / np.sqrt(np.maximum(ess, 1.0))).tolist()


# metric keys that name wall-time phases (used for attribution in
# _finalize; note rate keys like steps_per_s also end in "_s")
_PHASE_KEYS = (
    "warmup_s", "trace_s", "compile_s", "first_dispatch_s", "run_s",
    "diag_s", "fit_s", "vi_fit_s", "pod_enrich_s",
)


def _run_one_dispatch(problem, key, n_chains, n_samples, mesh=None,
                      profile_dir=None):
    """Single-program path for the scan kernels (rwm/pcn/mala/hmc/nuts/
    elliptical/da_pcn): warmup + burn-in + sampling + ESS/R̂ diagnostics
    traced into ONE jitted program, dispatched via the AOT API so every
    wall-second has a name:

      trace_s            local Python tracing + StableHLO lowering
      compile_s          ``lowered.compile()`` — persistent-cache load on
                         hit, XLA compile on miss
      first_dispatch_s   first-call wall MINUS the steady-state re-run —
                         executable load and first-launch cost
      run_s              steady-state whole-program execution (second call,
                         same keys — bitwise-identical work)

    ``steps_per_s`` counts every CHAIN step the program executes (warmup +
    burn-in + thinned sampling — map_init's Adam iterations are optimizer
    steps, reported separately as ``map_init_iters``), since they all happen
    inside ``run_s``; ``sampling_steps_per_s`` (sampling steps only) is the
    cross-path-comparable rate, and the warm/burn/sampling composition is
    reported so neither number can mislead (ADVICE round 4). ``diag_s`` no
    longer exists as a phase — diagnostics run inside the program
    (SURVEY.md §5.5 "diagnostics on-device")."""
    kp = problem.kernel_params
    adapted = kp.get("adapt", False)
    burn = 0 if adapted else problem.burn_in
    thin = problem.thin

    key_build, key_run = jax.random.split(key)
    warm_steps_box = {"n": 0}  # static int, recorded during tracing
    eager_warm_s = None

    if mesh is None:
        # ONE program: warmup + burn + sample + diagnostics. Warmup's
        # pooled-statistics reductions stay inside the trace, so no
        # hyper-parameter constants ever cross a program boundary.
        def pipeline(positions, key_warm, key_run):
            kernel, state, warm_steps = _setup_kernel_state(
                problem, positions, key_warm
            )
            warm_steps_box["n"] = warm_steps
            final_state, samples, info_means = driver.sample_chains(
                kernel, state, key_run,
                n_samples=n_samples, burn_in=burn, thin=thin,
            )
            summ = diagnostics.summarize(samples)
            return summ, info_means

        key_init, key_warm = jax.random.split(key_build)
        positions = problem.init_positions(key_init, n_chains)
        args = (positions, key_warm, key_run)
        program_count = 1
    else:
        # Mesh runs keep warmup EAGER and REPLICATED (two dispatches).
        # Folding warmup into the sharded program would route its pooled
        # statistics through cross-process psums whose association order
        # differs from the single-process run; MH accept thresholds then
        # amplify the ulp-level differences into divergent chains — the
        # multiprocess product tests assert the sharded run matches the
        # single-process run, which per-chain-deterministic sampling
        # guarantees only when warmup (the one cross-chain-coupled phase)
        # is computed identically (replicated) everywhere.
        from ip_mcmc_tpu import parallel

        kernel, state, eager_warm_s = _build_kernel_and_state(
            problem, key_build, n_chains
        )
        state = parallel.shard_chains(state, mesh)

        def pipeline(state, key_run):
            final_state, samples, info_means = driver.sample_chains(
                kernel, state, key_run,
                n_samples=n_samples, burn_in=burn, thin=thin,
            )
            summ = diagnostics.summarize(samples)
            return summ, info_means

        args = (state, key_run)
        program_count = 2

    t0 = time.perf_counter()
    lowered = jax.jit(pipeline).lower(*args)
    trace_s = time.perf_counter() - t0
    warm_steps = warm_steps_box["n"]

    t0 = time.perf_counter()
    compiled = lowered.compile()
    compile_s = time.perf_counter() - t0

    # each timed call ends in a 4-byte device->host read of its result,
    # which waits for the whole program
    t0 = time.perf_counter()
    out = compiled(*args)
    float(out[0]["min_ess"])
    first_call_s = time.perf_counter() - t0

    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    t0 = time.perf_counter()
    summ, info_means = compiled(*args)
    float(summ["min_ess"])
    run_s = time.perf_counter() - t0
    if profile_dir:
        jax.profiler.stop_trace()

    total_steps = (warm_steps + burn + n_samples * thin) * n_chains
    flat_mean = np.asarray(summ["mean"])
    metrics = {
        "config": problem.name,
        "kernel": problem.kernel,
        "n_chains": int(n_chains),
        "n_samples": int(n_samples),
        "dim": int(problem.dim),
        "program_count": program_count,
        "trace_s": trace_s,
        "compile_s": compile_s,
        "first_dispatch_s": max(first_call_s - run_s, 0.0),
        "run_s": run_s,
        # step composition made explicit so rates stay comparable across
        # runner paths (ADVICE round 4: warm/burn steps silently inflated
        # steps_per_s vs the mesh path; map_init Adam iterations are not
        # chain steps and are reported separately)
        "warm_steps": int(warm_steps),
        "burn_steps": int(burn),
        "sampling_steps": int(n_samples * thin),
        "sampling_steps_per_s": n_samples * thin * n_chains / run_s,
        "min_ess": float(summ["min_ess"]),
        "ess_per_s": float(summ["min_ess"]) / run_s,
        "max_rhat": float(summ["max_rhat"]),
        "posterior_mean": flat_mean.tolist(),
        "posterior_mcse": _mcse(summ),
    }
    if kp.get("map_init"):
        metrics["map_init_iters"] = int(kp["map_init"])
    if problem.kernel == "da_pcn":
        # a DA "step" is an OUTER step (k surrogate proposals + 1 exact
        # correction): name the unit so no key changes meaning across
        # configs (round-4 VERDICT weak #4)
        k_total = int(kp.get("subchain_len", 4))
        metrics["outer_steps_per_s"] = total_steps / run_s
        metrics["inner_steps_per_s"] = total_steps * k_total / run_s
    else:
        metrics["steps_per_s"] = total_steps / run_s
    if eager_warm_s is not None:
        metrics["warmup_s"] = eager_warm_s
    if hasattr(info_means, "accepted"):
        metrics["accept_rate"] = float(np.asarray(info_means.accepted).mean())
    if hasattr(info_means, "accept_prob") and problem.kernel == "nuts":
        metrics["accept_rate"] = float(
            np.asarray(info_means.accept_prob).mean()
        )
        metrics["mean_tree_depth"] = float(np.asarray(info_means.depth).mean())
    if problem.truth is not None and problem.name in (
        "lingauss_pcn", "lingauss_elliptical"
    ):
        metrics["mean_error_vs_exact"] = float(
            np.abs(flat_mean - problem.truth).max()
        )
    trace = getattr(
        info_means, "accepted", getattr(info_means, "accept_prob", None)
    )
    return metrics, trace


def _finalize(metrics, metrics_log, t_start, accept_trace=None):
    """Uniform metrics post-processing for every runner path: honest
    end-to-end wall time (VERDICT round-1 weak #1: the per-phase timers
    under-reported compile cost), an explicit non-convergence warning when
    R̂ > 1.1 (weak #7), and the run_complete metrics-log event (ADVICE:
    previously dropped on the chees/fes paths)."""
    metrics["total_wall_s"] = time.perf_counter() - t_start
    # attribute the wall: anything not covered by a named phase timer is
    # surfaced explicitly instead of silently hidden (round-2 VERDICT
    # weak #1 — "observability that misleads is worse than none")
    metrics["unattributed_s"] = metrics["total_wall_s"] - sum(
        metrics.get(k, 0.0) for k in _PHASE_KEYS
    )
    if "min_ess" in metrics:
        # the rate a user actually experiences for THIS invocation,
        # compile/dispatch walls included (round-3 VERDICT weak #6:
        # ess_per_s alone, a steady-state rate, invites misquotation on
        # runs whose wall is dominated by first-dispatch cost)
        metrics["ess_per_total_wall_s"] = (
            metrics["min_ess"] / metrics["total_wall_s"]
        )
    rhat = metrics.get("max_rhat")
    if rhat is not None:
        metrics["converged"] = bool(rhat < 1.1)
        if not metrics["converged"]:
            metrics["warning"] = (
                f"max_rhat {rhat:.2f} > 1.1: chains not converged — treat "
                "posterior_mean as unreliable; increase n_samples/burn_in"
            )
    if metrics_log is not None:
        from ip_mcmc_tpu.utils.logging import MetricsLogger

        logger = MetricsLogger(path=metrics_log)
        logger.log({"event": "run_complete", **metrics})
        if accept_trace is not None:
            # per-retained-step acceptance trace (chain-mean, on-device
            # reduced) — the CountedAccepter record stream
            acc = np.asarray(accept_trace)
            for i in range(0, len(acc), max(1, len(acc) // 50)):
                logger.log(
                    {"event": "accept_trace", "step": int(i),
                     "accept": float(acc[i])}
                )
        logger.close()
    return metrics


def run_problem(
    problem,
    key=None,
    n_chains=None,
    n_samples=None,
    profile_dir=None,
    mesh=None,
    metrics_log=None,
):
    """Execute a Problem end-to-end; returns a metrics dict.

    ``mesh``: optional chain mesh — shards the chain/particle axis across
    devices (XLA partitions the compiled program; SMC runs under
    ``set_mesh`` so its collectives ride the mesh too)."""
    t_start = time.perf_counter()
    key = jax.random.key(0) if key is None else key
    n_chains = n_chains or problem.n_chains
    n_samples = n_samples or problem.n_samples

    if problem.kernel == "vi":
        metrics = _run_vi(problem, key)
        return _finalize(metrics, metrics_log, t_start)

    if problem.kernel == "pt":
        metrics = _run_pt(problem, key, n_chains, n_samples)
        return _finalize(metrics, metrics_log, t_start)

    if problem.kernel in ("pcn_composed", "mala_composed", "ess_composed"):
        metrics = _run_composed(problem, key, n_chains, n_samples)
        return _finalize(metrics, metrics_log, t_start)

    vi_extra = {}
    if problem.kernel_params.get("vi_init") or (
        problem.kernel == "da_pcn" and problem.kernel_params.get("pod_enrich")
    ):
        # these warm-start paths install init_positions_fn / surrogate /
        # burn_in on the Problem — operate on a shallow copy so a second
        # run_problem() on the caller's instance starts from the configured
        # state, not the already-warm-started one (ADVICE round 4)
        problem = dataclasses.replace(problem)
    if problem.kernel_params.get("vi_init"):
        vi_extra = _vi_warm_start(problem, jax.random.fold_in(key, 71))
    if problem.kernel == "da_pcn" and problem.kernel_params.get("pod_enrich"):
        if problem.kernel_params.get("fused"):
            # the fused branch consumes batched_surrogate_fn, which
            # enrichment does not rebuild — running anyway would silently
            # cut burn-in and never apply the enriched surrogate (ADVICE
            # round 4, medium)
            raise ValueError(
                f"config {problem.name}: kernel_params['pod_enrich'] is not "
                "supported with fused=True — enrichment rebuilds the unfused "
                "surrogate_potential_fn only (use the scan da_pcn path, or "
                "drop pod_enrich)"
            )
        vi_extra.update(
            _pod_enrich_burnin(problem, jax.random.fold_in(key, 72), n_chains)
        )

    if problem.kernel == "chees":
        metrics = _run_chees(problem, key, n_chains, n_samples)
        metrics.update(vi_extra)
        return _finalize(metrics, metrics_log, t_start)

    if problem.kernel == "fes":
        if (
            problem.kernel_params.get("fused")
            and problem.batched_potential_fn is not None
        ):
            metrics = _run_fused_mcmc(problem, key, n_chains, n_samples, mesh=mesh)
        else:
            metrics = _run_fes(problem, key, n_chains, n_samples)
        metrics.update(vi_extra)
        return _finalize(metrics, metrics_log, t_start)

    if problem.kernel == "smc":
        if mesh is not None:
            with jax.sharding.set_mesh(mesh):
                metrics = _run_smc(problem, key, n_chains)
        else:
            metrics = _run_smc(problem, key, n_chains)
        return _finalize(metrics, metrics_log, t_start)

    if (
        problem.kernel in ("pcn", "mala", "rwm", "elliptical", "da_pcn")
        and problem.kernel_params.get("fused")
        and problem.batched_potential_fn is not None
    ):
        metrics = _run_fused_mcmc(problem, key, n_chains, n_samples, mesh=mesh)
        metrics.update(vi_extra)
        return _finalize(metrics, metrics_log, t_start)

    metrics, trace = _run_one_dispatch(
        problem, key, n_chains, n_samples, mesh=mesh, profile_dir=profile_dir
    )
    metrics.update(vi_extra)
    return _finalize(metrics, metrics_log, t_start, accept_trace=trace)


def _resolve_n_low_modes(kp, problem):
    """FES stretch dimension: explicit int, or "auto" → the spectral-energy
    criterion (kernels.ensemble.choose_n_low_modes) over the KL spectrum the
    config supplies as kernel_params["kl_eigenvalues"] (whitened samplers
    hide the spectrum in the forward map, so the config must pass it)."""
    m = kp.get("n_low_modes")
    if m == "auto":
        from ip_mcmc_tpu.kernels import ensemble

        lam = kp.get("kl_eigenvalues")
        if lam is None:
            raise ValueError(
                'n_low_modes="auto" needs kernel_params["kl_eigenvalues"] '
                "(the field's KL spectrum; the whitened prior scale is "
                "isotropic and carries no mode preference)"
            )
        return ensemble.choose_n_low_modes(
            lam, energy_frac=kp.get("energy_frac", 0.9),
            max_modes=problem.dim,
        )
    if m is None:
        return min(8, problem.dim)
    return int(m)


def _run_fused_mcmc(problem, key, n_chains, n_samples, mesh=None):
    """The fused chain engine (kernel_params={'fused': True}) for
    pCN / MALA / RWM / ESS / FES / DA: burn-in launch + recorded sampling
    launch, diagnostics on the recorded series. This is the configuration behind the headline
    bench numbers. pCN consumes the data misfit alone (prior-reversible);
    MALA/RWM target the full posterior, so the whitened-prior potential is
    folded into the batched potential here. ``mesh``: chain-shards the
    launches over devices via parallel.sharded_fused_chain (one fused
    program per device, decorrelated seeds, no collectives)."""
    from ip_mcmc_tpu import ops

    kp = dict(problem.kernel_params)
    block = min(int(kp.get("block_chains", 512)), n_chains)
    phi_b = problem.batched_potential_fn
    pm = np.asarray(problem.prior.mean)
    ps = np.asarray(problem.prior.scale)

    if problem.kernel == "fes":
        run_kw = dict(prior_mean=pm, prior_scale=ps,
                      n_low_modes=_resolve_n_low_modes(kp, problem),
                      pcn_beta=kp.get("pcn_beta", 0.2),
                      stretch_a=kp.get("stretch_a", 2.0))
        chain, chain_rec = ops.fused_fes_chain, ops.fused_fes_chain_recorded
        phi_full = phi_b
    elif problem.kernel == "elliptical":
        run_kw = dict(prior_mean=pm, prior_scale=ps,
                      max_shrink=kp.get("max_shrink", 8))
        chain, chain_rec = ops.fused_ess_chain, ops.fused_ess_chain_recorded
        phi_full = phi_b
    elif problem.kernel == "da_pcn":
        # fused delayed acceptance: k surrogate pCN steps (coarse-grid
        # misfit) + one exact correction per outer step — both potentials
        # in ONE program (ops.fused_da_pcn_chain). pCN is
        # prior-reversible, so both sides consume data misfits alone.
        surr_b = problem.batched_surrogate_fn
        if surr_b is None:
            raise ValueError(
                f"config {problem.name}: fused 'da_pcn' needs "
                "batched_surrogate_fn"
            )
        if kp.get("k_mid"):
            # THREE-level variant (ops.fused_da3_pcn_chain): inner pCN on
            # the coarse surrogate, middle corrections vs batched_mid_fn,
            # one fine correction per outer step
            mid_b = problem.batched_mid_fn
            if mid_b is None:
                raise ValueError(
                    f"config {problem.name}: fused 3-level 'da_pcn' needs "
                    "batched_mid_fn"
                )
            run_kw = dict(prior_mean=pm, prior_scale=ps,
                          beta=kp.get("beta", 0.2),
                          k_inner=kp.get("k_inner", 8),
                          k_mid=kp["k_mid"])
            chain = lambda p, pos, **kw: ops.fused_da3_pcn_chain(
                p, mid_b, surr_b, pos, **kw)
            chain_rec = lambda p, pos, **kw: ops.fused_da3_pcn_chain_recorded(
                p, mid_b, surr_b, pos, **kw)
        else:
            run_kw = dict(prior_mean=pm, prior_scale=ps,
                          beta=kp.get("beta", 0.2),
                          subchain_len=kp.get("subchain_len", 4))
            chain = lambda p, pos, **kw: ops.fused_da_pcn_chain(
                p, surr_b, pos, **kw)
            chain_rec = lambda p, pos, **kw: ops.fused_da_pcn_chain_recorded(
                p, surr_b, pos, **kw)
        phi_full = phi_b
    elif problem.kernel == "pcn":
        beta = kp.get("beta", 0.2)
        run_kw = dict(prior_mean=pm, prior_scale=ps, beta=beta)
        if kp.get("warm") and problem.batched_warm_potential is not None:
            phi_full, aux_dim = problem.batched_warm_potential
            run_kw["aux_dim"] = aux_dim
            chain = ops.fused_pcn_chain_warm
            chain_rec = ops.fused_pcn_chain_warm_recorded
        else:
            chain, chain_rec = ops.fused_pcn_chain, ops.fused_pcn_chain_recorded
            phi_full = phi_b
    elif (
        problem.kernel == "mala"
        and kp.get("warm")
        and problem.batched_warm_potential is not None
    ):
        # warm MALA: forward+adjoint solutions in the kernel state; the
        # warm potential is a value-and-grad pag(U, aux) and the prior is
        # folded in by the step builder itself
        phi_full, aux_dim = problem.batched_warm_potential
        run_kw = dict(prior_mean=pm, prior_scale=ps,
                      step_size=kp.get("step_size", 0.05), aux_dim=aux_dim)
        chain = ops.fused_mala_chain_warm
        chain_rec = ops.fused_mala_chain_warm_recorded
    else:
        pm_j, ps_j = jnp.asarray(pm), jnp.asarray(ps)

        def phi_full(U):  # data misfit + prior potential (full −log π)
            z = (U - pm_j[:, None]) / ps_j[:, None]
            return phi_b(U) + 0.5 * jnp.sum(z * z, axis=0)

        run_kw = dict(step_size=kp.get("step_size", 0.05))
        if problem.kernel == "mala":
            chain, chain_rec = ops.fused_mala_chain, ops.fused_mala_chain_recorded
        else:
            chain, chain_rec = ops.fused_rwm_chain, ops.fused_rwm_chain_recorded

    if mesh is not None:
        from ip_mcmc_tpu.parallel import sharded_fused_chain

        def launch(fn, pos, seed, **kw):
            return sharded_fused_chain(
                fn, mesh, phi_full, pos, seed=seed, block_chains=block,
                **run_kw, **kw,
            )
    else:
        def launch(fn, pos, seed, **kw):
            return fn(phi_full, pos, seed=seed, block_chains=block,
                      **run_kw, **kw)

    positions = problem.init_positions(key, n_chains)
    t0 = time.perf_counter()
    # FES returns a third output (per-chain stretch-move acceptance via the
    # kernel's extra_out channel — the quantity stretch_a is tuned with)
    burn_out = launch(chain, positions, 1, n_steps=problem.burn_in)
    positions = burn_out[0]
    stretch_acc = burn_out[2] if len(burn_out) > 2 else None
    np.asarray(burn_out[1])  # transfer barrier
    burn_s = time.perf_counter() - t0

    # The recorded program is a DIFFERENT compiled program from the burn
    # one (static n_steps/thin), so its compile would otherwise land in
    # run_s and poison every rate derived from it. Mirror the one-dispatch
    # path's protocol: first call = compile + run, second identical call
    # (same seed — bitwise-identical work) = steady-state run_s.
    t0 = time.perf_counter()
    out1 = launch(
        chain_rec, positions, 2, n_steps=n_samples * problem.thin,
        thin=problem.thin,
    )
    np.asarray(out1[1])  # transfer barrier
    first_rec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    final, acc, samples = launch(
        chain_rec, positions, 2, n_steps=n_samples * problem.thin,
        thin=problem.thin,
    )
    np.asarray(acc)  # transfer barrier
    run_s = time.perf_counter() - t0

    summ, diag_s = _summarize_timed(samples)
    # the kernel's extra_out channel: FES reports the stretch-move rate,
    # 2-level DA-pCN the surrogate-subchain (inner) rate, 3-level DA the
    # middle-correction rate (its inner rate equals the 2-level kernel's
    # at the same beta — same coarse chain)
    extra_key = (
        ("mid_accept_rate" if problem.kernel_params.get("k_mid")
         else "inner_accept_rate") if problem.kernel == "da_pcn"
        else "stretch_accept_rate"
    )
    extra = (
        {extra_key: float(np.asarray(stretch_acc).mean())}
        if stretch_acc is not None
        else {}
    )
    if problem.kernel == "da_pcn":
        # outer/inner units named explicitly (round-4 VERDICT weak #4): an
        # outer DA step hides k (or k_inner*k_mid) surrogate proposals, so
        # a generic steps_per_s would silently change meaning vs pcn
        k_total = (
            int(kp.get("k_inner", 8)) * int(kp["k_mid"])
            if kp.get("k_mid") else int(kp.get("subchain_len", 4))
        )
        outer_rate = n_chains * n_samples * problem.thin / run_s
        rate_keys = {
            "outer_steps_per_s": outer_rate,
            "inner_steps_per_s": outer_rate * k_total,
        }
    else:
        rate_keys = {
            "steps_per_s": n_chains * n_samples * problem.thin / run_s,
        }
    return {
        **extra,
        "config": problem.name,
        "kernel": f"{problem.kernel}(fused)",
        "n_chains": int(n_chains),
        "n_samples": int(n_samples),
        "dim": int(problem.dim),
        "warmup_s": burn_s,
        "compile_s": max(first_rec_s - run_s, 0.0),
        "run_s": run_s,
        **rate_keys,
        "diag_s": diag_s,
        "min_ess": float(summ["min_ess"]),
        "ess_per_s": float(summ["min_ess"]) / run_s,
        "max_rhat": float(summ["max_rhat"]),
        "accept_rate": float(np.asarray(acc).mean()),
        "posterior_mean": np.asarray(summ["mean"]).tolist(),
        "posterior_mcse": _mcse(summ),
    }


def _pod_enrich_burnin(problem, key, n_chains):
    """Online POD-surrogate enrichment during burn-in (ROADMAP P2's last
    lever; round-3 VERDICT item 6). Runs the DA-pCN chain in short
    segments; between segments, hands the CURRENT chain positions to
    ``problem.surrogate_enrich_fn`` (darcy.make_pod_surrogate_online),
    which full-solves the worst positions by the reduced-residual
    indicator and rebuilds the POD basis — enrichment targeted at
    posterior-typical states instead of prior draws. The surrogate is then
    FROZEN (installed as problem.surrogate_potential_fn) and the remaining
    burn-in + all recorded sampling run the standard time-homogeneous DA
    kernel — the DA correction keeps the posterior exact for any frozen
    surrogate, so enrichment moves only the subchain efficiency, never the
    target. Mutates ``problem`` (surrogate, resume positions, remaining
    burn_in) and returns the indicator history for the metrics dict."""
    from ip_mcmc_tpu.kernels import da_pcn

    if problem.surrogate_enrich_fn is None:
        raise ValueError(
            f"config {problem.name}: kernel_params['pod_enrich'] needs "
            "surrogate_enrich_fn (see darcy.make_pod_surrogate_online)"
        )
    spec = problem.kernel_params["pod_enrich"]
    spec = spec if isinstance(spec, dict) else {}
    epochs = int(spec.get("epochs", 3))
    seg = int(spec.get("segment_steps", 40))
    kp = {
        k: v for k, v in problem.kernel_params.items()
        if k in ("beta", "subchain_len")
    }
    phi, prior = problem.potential_fn, problem.prior
    surr = problem.surrogate_potential_fn
    t0 = time.perf_counter()
    positions = problem.init_positions(jax.random.fold_in(key, 0), n_chains)
    history = []
    for e in range(epochs):
        kernel = da_pcn.build_kernel(phi, surr, prior, **kp)
        state = driver.init_chains(
            lambda p: da_pcn.init(p, phi, surr), positions
        )
        state, _, _ = driver.sample_chains(
            kernel, state, jax.random.fold_in(key, e + 1),
            n_samples=1, burn_in=seg - 1, thin=1,
        )
        positions = state.position
        surr, stats = problem.surrogate_enrich_fn(np.asarray(positions))
        history.append(stats)

    problem.surrogate_potential_fn = surr
    pos_final = np.asarray(positions)
    problem.init_positions_fn = lambda k, n: jnp.asarray(pos_final[:n])
    problem.burn_in = max(problem.burn_in - epochs * seg, 0)
    return {
        "pod_enrich_epochs": epochs,
        "pod_enrich_segment_steps": seg,
        "pod_enrich_s": time.perf_counter() - t0,
        "pod_enrich_indicator_max": [h["indicator_max"] for h in history],
        "pod_enrich_indicator_mean": [h["indicator_mean"] for h in history],
    }


def _run_chees(problem, key, n_chains, n_samples):
    """ChEES-HMC path: batch-level kernel with its own warmup + scan driver
    (trajectory length is shared across chains, so the kernel updates the
    whole (n, d) block — see kernels/chees_hmc.py)."""
    kp = dict(problem.kernel_params)
    logpi = problem.log_density_fn
    key_init, key_warm, key_run = jax.random.split(key, 3)
    positions = problem.init_positions(key_init, n_chains)
    map_init = kp.pop("map_init", 0)
    if map_init:
        from ip_mcmc_tpu.adapt import warmup as _warmup

        positions = _warmup.map_localize(logpi, positions, num_steps=map_init)

    t0 = time.perf_counter()
    state, eps, traj, inv_mass = chees_hmc.warmup_chees(
        logpi, positions, key_warm,
        num_steps=problem.burn_in or 400,
        initial_step_size=kp.get("step_size", 0.1),
        initial_trajectory=kp.get("trajectory_length", 1.0),
    )
    jax.block_until_ready(state.positions)
    warm_s = time.perf_counter() - t0

    def _sample():
        return chees_hmc.sample_chees(
            logpi, state, key_run, eps, traj, inv_mass,
            n_samples=n_samples, burn_in=0, thin=problem.thin,
        )

    t0 = time.perf_counter()
    out = _sample()
    jax.block_until_ready(out[1])
    compile_and_run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    final_state, samples, infos = _sample()
    jax.block_until_ready(samples)
    run_s = time.perf_counter() - t0

    summ, diag_s = _summarize_timed(samples)
    metrics = {
        "config": problem.name,
        "kernel": "chees",
        "n_chains": int(n_chains),
        "n_samples": int(n_samples),
        "dim": int(problem.dim),
        "warmup_s": warm_s,
        "compile_s": max(compile_and_run_s - run_s, 0.0),
        "run_s": run_s,
        "steps_per_s": n_samples * problem.thin * n_chains / run_s,
        "diag_s": diag_s,
        "min_ess": float(summ["min_ess"]),
        "ess_per_s": float(summ["min_ess"]) / run_s,
        "max_rhat": float(summ["max_rhat"]),
        "accept_rate": float(np.asarray(infos.accept_prob).mean()),
        "step_size": float(eps),
        "trajectory_length": float(traj),
        "posterior_mean": np.asarray(summ["mean"]).tolist(),
    }
    return metrics


def _run_fes(problem, key, n_chains, n_samples):
    """Functional ensemble sampler path (batch-level: the walker ensemble
    is the chain axis; see kernels/ensemble.py)."""
    from ip_mcmc_tpu.kernels import ensemble

    kp = dict(problem.kernel_params)
    key_init, key_run = jax.random.split(key)
    positions = problem.init_positions(key_init, n_chains)

    def _sample():
        return ensemble.sample_fes(
            problem.potential_fn, problem.prior, positions, key_run,
            _resolve_n_low_modes(kp, problem),
            stretch_a=kp.get("stretch_a", 2.0),
            pcn_beta=kp.get("pcn_beta", 0.2),
            n_samples=n_samples, burn_in=problem.burn_in, thin=problem.thin,
        )

    t0 = time.perf_counter()
    out = _sample()
    jax.block_until_ready(out[1])
    compile_and_run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    final_state, samples, infos = _sample()
    jax.block_until_ready(samples)
    run_s = time.perf_counter() - t0

    summ, diag_s = _summarize_timed(samples)
    return {
        "config": problem.name,
        "kernel": "fes",
        "n_chains": int(n_chains),
        "n_samples": int(n_samples),
        "dim": int(problem.dim),
        "compile_s": max(compile_and_run_s - run_s, 0.0),
        "run_s": run_s,
        "steps_per_s": (problem.burn_in + n_samples * problem.thin)
        * n_chains / run_s,
        "diag_s": diag_s,
        "min_ess": float(summ["min_ess"]),
        "ess_per_s": float(summ["min_ess"]) / run_s,
        "max_rhat": float(summ["max_rhat"]),
        "accept_rate": float(np.asarray(infos.stretch_accept).mean()),
        "pcn_accept_rate": float(np.asarray(infos.pcn_accept).mean()),
        "posterior_mean": np.asarray(summ["mean"]).tolist(),
    }


def _run_vi(problem, key):
    """ADVI path (kernel='vi'): maximize the ELBO, report the fitted
    variational moments plus errors against the exact posterior where the
    config carries one (lingauss_advi: conjugate closed form — the full-rank
    family is exact there, so moment errors measure optimizer convergence,
    not family bias). VERDICT round-1 item 3: VI reachable from the CLI."""
    from ip_mcmc_tpu import vi

    kp = dict(problem.kernel_params)
    exact_cov = kp.pop("exact_cov", None)
    t0 = time.perf_counter()
    params, elbo_trace = vi.fit(
        problem.log_density_fn,
        problem.dim,
        key,
        num_steps=kp.get("num_steps", 2000),
        n_samples=kp.get("n_mc_samples", 64),
        learning_rate=kp.get("learning_rate", 5e-2),
        full_rank=kp.get("full_rank", False),
    )
    jax.block_until_ready(params.mu)
    fit_s = time.perf_counter() - t0
    mean, cov = vi.posterior_moments(params)
    mean = np.asarray(mean)
    elbo = np.asarray(elbo_trace)
    metrics = {
        "config": problem.name,
        "kernel": "vi" + ("(full_rank)" if kp.get("full_rank") else "(mean_field)"),
        "dim": int(problem.dim),
        "num_steps": int(kp.get("num_steps", 2000)),
        "fit_s": fit_s,
        "elbo_steps_per_s": kp.get("num_steps", 2000) / fit_s,
        "final_elbo": float(elbo[-100:].mean()),  # MC-noise-averaged tail
        "posterior_mean": mean.tolist(),
    }
    if problem.truth is not None:
        metrics["mean_error_vs_exact"] = float(
            np.abs(mean - np.asarray(problem.truth)).max()
        )
    if exact_cov is not None:
        cov_err = np.abs(np.asarray(cov) - np.asarray(exact_cov)).max()
        metrics["cov_error_vs_exact"] = float(cov_err)
    return metrics


def _vi_warm_start(problem, key):
    """kernel_params['vi_init']: fit a short ADVI pass and install its
    variational posterior as the chain initializer (vi.warm_start), so MCMC
    burn-in starts inside the posterior bulk instead of at prior draws.
    Returns metrics quantifying what the warm start bought: the mean data
    misfit of VI-initialized vs prior-initialized chains."""
    from ip_mcmc_tpu import vi

    cfg = problem.kernel_params["vi_init"]
    cfg = cfg if isinstance(cfg, dict) else {}
    key_fit, key_cmp = jax.random.split(key)
    t0 = time.perf_counter()
    params, elbo_trace = vi.fit(
        problem.log_density_fn,
        problem.dim,
        key_fit,
        num_steps=cfg.get("num_steps", 800),
        n_samples=cfg.get("n_mc_samples", 32),
        learning_rate=cfg.get("learning_rate", 5e-2),
        full_rank=cfg.get("full_rank", False),
    )
    jax.block_until_ready(params.mu)
    fit_s = time.perf_counter() - t0
    problem.init_positions_fn = lambda k, n: vi.warm_start(params, k, n)

    # what the warm start buys: initial-state potential, VI vs prior draws
    n_cmp = min(256, problem.n_chains or 256)
    phi_v = jax.vmap(problem.potential_fn)
    vi_pos = vi.warm_start(params, key_cmp, n_cmp)
    prior_pos = problem.prior.sample(key_cmp, (n_cmp,))
    return {
        "vi_fit_s": fit_s,
        "vi_final_elbo": float(np.asarray(elbo_trace)[-50:].mean()),
        "init_potential_vi": float(np.asarray(phi_v(vi_pos)).mean()),
        "init_potential_prior": float(np.asarray(phi_v(prior_pos)).mean()),
    }


def _run_composed(problem, key, n_chains, n_samples):
    """Composed ('chains', 'model') mesh path (kernel='pcn_composed' or
    'mala_composed'): chain-parallel sampling where EACH chain's Darcy
    forward solve is row-sharded over the 'model' axis (parallel/composed.py
    — SURVEY.md §2.3 reserved axis made concrete); the MALA variant adds the
    distributed ADJOINT solve for its gradient. Mesh shape auto-derived from
    the device count (override via kernel_params['mesh_shape'])."""
    from ip_mcmc_tpu.parallel import composed

    kp = dict(problem.kernel_params)
    aux = kp.pop("aux")
    noise_scale = kp.pop("noise_scale")
    cg_iters = kp.get("cg_iters", 150)
    mesh_shape = kp.get("mesh_shape")
    n_grid = int(aux["n_grid"])
    if mesh_shape is None:
        n_dev = len(jax.devices())
        m = next(
            (c for c in (4, 2) if n_dev % c == 0 and n_grid % c == 0), 1
        )
        mesh_shape = (n_dev // m, m)
    mesh = composed.make_composed_mesh(*mesh_shape)
    key_init, key_run = jax.random.split(key)
    u0 = problem.init_positions(key_init, n_chains)

    if problem.kernel == "ess_composed":
        def _sample():
            return composed.sample_composed_elliptical(
                aux, problem.data, noise_scale, mesh=mesh, u0=u0,
                base_key=key_run, n_samples=n_samples,
                burn_in=problem.burn_in, thin=problem.thin,
                cg_iters=cg_iters,
                max_shrink=kp.get("max_shrink", 20),
            )
    elif problem.kernel == "mala_composed":
        def _sample():
            return composed.sample_composed_mala(
                aux, problem.data, noise_scale,
                step_size=kp.get("step_size", 0.05), mesh=mesh, u0=u0,
                base_key=key_run, n_samples=n_samples,
                burn_in=problem.burn_in, thin=problem.thin,
                cg_iters=cg_iters,
            )
    else:
        beta = kp.get("beta", 0.2)

        def _sample():
            return composed.sample_composed_pcn(
                aux, problem.data, noise_scale, beta=beta, mesh=mesh, u0=u0,
                base_key=key_run, n_samples=n_samples,
                burn_in=problem.burn_in, thin=problem.thin,
                cg_iters=cg_iters,
            )

    t0 = time.perf_counter()
    out = _sample()
    jax.block_until_ready(out[0])
    compile_and_run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    samples, acc = _sample()
    jax.block_until_ready(samples)
    run_s = time.perf_counter() - t0

    summ, diag_s = _summarize_timed(samples)
    total_steps = problem.burn_in + n_samples * problem.thin
    return {
        "config": problem.name,
        "kernel": f"{problem.kernel.split('_')[0]}(composed chains x model)",
        "mesh_shape": list(mesh_shape),
        "n_chains": int(n_chains),
        "n_samples": int(n_samples),
        "dim": int(problem.dim),
        "compile_s": max(compile_and_run_s - run_s, 0.0),
        "run_s": run_s,
        "steps_per_s": n_chains * total_steps / run_s,
        "diag_s": diag_s,
        "min_ess": float(summ["min_ess"]),
        "ess_per_s": float(summ["min_ess"]) / run_s,
        "max_rhat": float(summ["max_rhat"]),
        # elliptical is rejection-free: the second output is the mean
        # forward-evaluation count per step, not an acceptance probability
        ("mean_evals_per_step" if problem.kernel == "ess_composed"
         else "accept_rate"): float(acc),
        "posterior_mean": np.asarray(summ["mean"]).tolist(),
    }


def _pt_pair_metrics(infos, n_temps, adapt_pair_rates):
    """Per-pair swap-acceptance metrics for the PT surface (VERDICT round-2
    weak #4). ``infos`` holds driver-reduced per-retained-step chain means
    of pair_swap_prob (zeroed when inactive) and pair_active."""
    prob = np.asarray(infos.pair_swap_prob)[:, : n_temps - 1]
    act = np.asarray(infos.pair_active)[:, : n_temps - 1]
    rates = prob.sum(axis=0) / np.maximum(act.sum(axis=0), 1e-9)
    out = {
        "swap_rate_per_pair": rates.tolist(),
        "swap_spread": float(rates.max() - rates.min()),
    }
    if adapt_pair_rates is not None:
        out["adapt_pair_rates"] = np.asarray(adapt_pair_rates).tolist()
    return out


def _run_pt(problem, key, n_chains, n_samples):
    """Parallel-tempering path (kernel='pt'): equi-acceptance ladder
    adaptation (doubles as burn-in), then the frozen-ladder PT kernel —
    tempered pCN or MALA mutations + parity-alternating swaps — scanned by
    the standard driver with the COLD (β=1) replica recorded. Mode balance
    (sign split of the first coordinate) is reported: it is the quantity PT
    exists to fix on multimodal targets."""
    from ip_mcmc_tpu.kernels import tempering

    kp = dict(problem.kernel_params)
    n_temps = kp.get("n_temps", 8)
    beta_min = kp.get("beta_min", 0.05)
    pcn_step = kp.get("pcn_step", 0.25)
    mutation = kp.get("mutation", "pcn")
    phi, prior = problem.potential_fn, problem.prior
    key_init, key_adapt, key_run = jax.random.split(key, 3)
    positions = problem.init_positions(key_init, n_chains)

    t0 = time.perf_counter()
    adapt_pair_rates = None
    if kp.get("adapt_ladder", True):
        # ladder adaptation runs the SAME mutation the production run uses
        # (ROADMAP P2): the equi-acceptance equilibrium depends on the
        # replica-Φ distribution the mutation actually produces
        states, betas, adapt_pair_rates = tempering.adapt_ladder(
            phi, prior, positions, key_adapt,
            n_temps=n_temps,
            num_steps=problem.burn_in or 300,
            # swap_center only CENTERS the stochastic-approximation update;
            # the equilibrium is equal per-attempt rates (see adapt_ladder
            # docstring). "target_swap" accepted as a deprecated alias.
            swap_center=kp.get("swap_center", kp.get("target_swap", 0.4)),
            pcn_step=pcn_step,
            beta_min=beta_min,
            mutation=mutation,
            step_size=kp.get("step_size", 0.05),
        )
        burn = 0
    elif mutation == "mala":
        betas = tempering.geometric_ladder(n_temps, beta_min)
        states = driver.init_chains(
            lambda p: tempering.init_mala(p, phi, n_temps), positions
        )
        burn = problem.burn_in
    else:
        betas = tempering.geometric_ladder(n_temps, beta_min)
        states = driver.init_chains(
            lambda p: tempering.init(p, phi, n_temps), positions
        )
        burn = problem.burn_in

    if mutation == "mala":
        kernel = tempering.build_mala_kernel(
            phi, prior, betas, step_size=kp.get("step_size", 0.05)
        )
    else:
        kernel = tempering.build_kernel(phi, prior, betas, pcn_step=pcn_step)
    jax.block_until_ready(states.positions)
    warm_s = time.perf_counter() - t0

    cold = lambda s: s.positions[:, 0, :]

    def _sample():
        return driver.sample_chains(
            kernel, states, key_run,
            n_samples=n_samples, burn_in=burn, thin=problem.thin,
            record_fn=cold,
        )

    t0 = time.perf_counter()
    out = _sample()
    jax.block_until_ready(out[1])
    compile_and_run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    final_state, samples, infos = _sample()
    jax.block_until_ready(samples)
    run_s = time.perf_counter() - t0

    summ, diag_s = _summarize_timed(samples)
    s = np.asarray(samples)
    metrics = {
        "config": problem.name,
        "kernel": f"pt({mutation})",
        "n_chains": int(n_chains),
        "n_temps": int(n_temps),
        "n_samples": int(n_samples),
        "dim": int(problem.dim),
        "warmup_s": warm_s,
        "compile_s": max(compile_and_run_s - run_s, 0.0),
        "run_s": run_s,
        # one PT step = n_temps replica mutations + a swap round
        "steps_per_s": (burn + n_samples * problem.thin) * n_chains / run_s,
        "replica_steps_per_s": (burn + n_samples * problem.thin)
        * n_chains * n_temps / run_s,
        "diag_s": diag_s,
        "min_ess": float(summ["min_ess"]),
        "ess_per_s": float(summ["min_ess"]) / run_s,
        "max_rhat": float(summ["max_rhat"]),
        "accept_rate": float(np.asarray(infos.accept_rate).mean()),
        # per-attempt swap acceptance, overall and per adjacent pair, from
        # the FROZEN-ladder production run (pair_swap_prob is zeroed on
        # inactive steps; dividing by pair_active restores per-attempt).
        # swap_spread = max−min across pairs: the equalization quality the
        # ladder adaptation actually controls (round-2 VERDICT weak #4 —
        # the old lone "swap_rate" invited reading it as the target).
        "swap_rate_per_attempt": float(np.asarray(infos.swap_rate).mean()),
        **_pt_pair_metrics(infos, n_temps, adapt_pair_rates),
        "betas": np.asarray(betas).tolist(),
        "mode_balance": float((s[..., 0] > 0).mean()),
        "posterior_mean": np.asarray(summ["mean"]).tolist(),
    }
    return metrics


def _run_smc(problem, key, n_particles):
    kp = dict(problem.kernel_params)
    batched = kp.pop("batched", False)
    if batched:
        # warm/DST batched mutation path (smc.run_batched): the config-4
        # fast machinery driving config 5 (VERDICT round-1 item 4)
        extra = {}
        if kp.pop("warm", False) and problem.batched_warm_potential is not None:
            phi2, aux_dim = problem.batched_warm_potential
            extra = dict(warm_potential_fn=phi2, aux_dim=aux_dim)
        kernel_name = "smc(batched" + ("+warm)" if extra else ")")

        def _go():
            return smc.run_batched(
                problem.batched_potential_fn,
                np.asarray(problem.prior.mean),
                np.asarray(problem.prior.scale),
                key,
                n_particles=n_particles,
                **extra,
                **kp,
            )

        particle_axis = 1
    else:
        kernel_name = "smc"

        def _go():
            return smc.run(
                problem.potential_fn, problem.prior, key,
                n_particles=n_particles, **kp,
            )

        particle_axis = 0

    t0 = time.perf_counter()
    state, info = _go()
    jax.block_until_ready(state.particles)
    compile_and_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, info = _go()
    jax.block_until_ready(state.particles)
    run_s = time.perf_counter() - t0
    n_stages = int(info.n_stages)
    mean = np.asarray(state.particles).mean(axis=particle_axis)
    return {
        "config": problem.name,
        "kernel": kernel_name,
        "n_particles": int(n_particles),
        "dim": int(problem.dim),
        "compile_s": max(compile_and_run - run_s, 0.0),
        "run_s": run_s,
        "n_stages": n_stages,
        "log_evidence": float(state.log_z),
        "log_evidence_ti": smc.thermodynamic_log_z(info),
        "final_beta": float(state.beta),
        "mean_mutation_accept": float(
            np.nanmean(np.asarray(info.accept_rates)[:n_stages])
        ),
        "posterior_mean": mean.tolist(),
        "particles_per_s": n_particles * n_stages / run_s,
    }
