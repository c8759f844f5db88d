"""Named benchmark configurations (SURVEY.md §5.6, BASELINE.json `configs`).

Each BASELINE config is a registered builder returning a ``Problem`` — data
synthesized with fixed seeds, so every named benchmark is reproducible via
``python -m ip_mcmc_tpu.run --config <name>``:

1. gauss2d_rwm     — RWM on a 2D Gaussian posterior (analytic likelihood)
2. lingauss_pcn    — pCN on a linear-Gaussian IP with KL-truncated GP prior
3. ode_mala / ode_nuts — MALA / NUTS on an ODE (Lotka–Volterra) forward model
4. darcy_pcn_4096  — pCN on Darcy-flow coefficient inversion, 64-dim KL,
                     4096 parallel chains
5. darcy_smc       — adaptive tempered SMC on the Darcy inverse problem
+  burgers_pcn     — the reference's headline problem class: conservation-law
                     initial-data inversion (derivative-free pCN)

Beyond-BASELINE configs: lingauss_elliptical, lingauss_fes (ensemble
sampler), ode_hmc, ode_chees, darcy_pcn_warm / darcy_mala_fused /
darcy_ess_fused (fused-engine variants), darcy_da_pcn / darcy_da_pod
(delayed acceptance: loose-CG / POD reduced-order surrogates), darcy64_pcn
(large grid, DST-PCG), burgers_multitime_pcn, lingauss_advi / darcy_advi
(ADVI backend; full-rank exact on the conjugate problem),
darcy_advi_warmstart (VI→MCMC warm start), multimodal_pt /
multimodal_pt_mala (parallel tempering). ``--list`` shows all.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ip_mcmc_tpu import distributions as dist
from ip_mcmc_tpu import potentials
from ip_mcmc_tpu.models import burgers, darcy, kl, linear, ode


@dataclasses.dataclass
class Problem:
    name: str
    dim: int
    prior: Any
    potential_fn: Callable  # Φ(u), single particle
    kernel: str  # rwm | pcn | mala | hmc | nuts | smc | vi | pt | ...
    kernel_params: dict
    n_chains: int
    n_samples: int
    burn_in: int
    thin: int = 1
    data: Optional[np.ndarray] = None
    truth: Optional[np.ndarray] = None
    notes: str = ""
    batched_potential_fn: Optional[Callable] = None  # (d, block)->(block,)
    # for the fused chain engine (runner uses it when kernel_params["fused"])
    surrogate_potential_fn: Optional[Callable] = None  # cheap Φ* for da_pcn
    batched_surrogate_fn: Optional[Callable] = None  # fused-da_pcn Φ*
    batched_mid_fn: Optional[Callable] = None  # middle level for 3-level DA
    # warm-started fused path: (phi2(U, x0) -> (phi, x), aux_dim)
    batched_warm_potential: Optional[tuple] = None
    # optional initial-position override (VI warm-start installs one):
    # (key, n) -> (n, dim)
    init_positions_fn: Optional[Callable] = None
    # online POD enrichment hook (darcy.make_pod_surrogate_online):
    # enrich(positions) -> (new surrogate_fn, indicator stats); consumed by
    # runner._pod_enrich_burnin when kernel_params["pod_enrich"] is set
    surrogate_enrich_fn: Optional[Callable] = None

    @property
    def log_density_fn(self):
        return potentials.posterior_log_density(self.potential_fn, self.prior)

    def init_positions(self, key, n=None):
        n = n or self.n_chains
        if self.init_positions_fn is not None:
            return self.init_positions_fn(key, n)
        return self.prior.sample(key, (n,))


REGISTRY: dict = {}


def register(fn):
    REGISTRY[fn.__name__] = fn
    return fn


def _to_host(x):
    return np.asarray(x) if isinstance(x, jax.Array) else x


def build(name: str, **overrides) -> Problem:
    """Build a named Problem — ON THE HOST.

    Config construction is data synthesis: dozens of tiny eager jnp ops
    (Cholesky factors, prior draws, forward solves for synthetic data).
    Dispatching those one-by-one to an accelerator buys nothing: each is a
    separate launch and a separate small compile. So the builder runs
    pinned to the CPU backend, and array leaves are converted to NumPy
    afterwards so nothing stays committed to a CPU device (a committed-CPU
    jit argument would silently pull the whole computation onto the CPU —
    "computation follows data"). Closure-captured constants are traced
    into the device programs as constants either way.
    """
    if name not in REGISTRY:
        raise KeyError(f"unknown config '{name}'; have {sorted(REGISTRY)}")
    try:
        cpu = jax.local_devices(backend="cpu")[0]
    except RuntimeError:  # CPU backend unavailable (platform-restricted)
        cpu = None
    if cpu is None:
        p = REGISTRY[name]()
    else:
        with jax.default_device(cpu):
            p = REGISTRY[name]()
    for f in dataclasses.fields(p):
        setattr(
            p, f.name,
            jax.tree_util.tree_map(_to_host, getattr(p, f.name)),
        )
    for k, v in overrides.items():
        if v is not None:
            setattr(p, k, v)
    return p


@register
def gauss2d_rwm() -> Problem:
    """BASELINE config 1: RWM, 2D Gaussian posterior, analytic likelihood."""
    mean = jnp.array([1.0, -0.5])
    cov = jnp.array([[2.0, 0.8], [0.8, 1.0]])
    target = dist.Gaussian.from_covariance(mean, cov)
    prior = dist.DiagGaussian(mean=jnp.zeros(2), scale=10.0 * jnp.ones(2))
    phi = potentials.analytic_potential(target.log_prob)
    prec = jnp.asarray(np.linalg.inv(np.asarray(cov)), jnp.float32)

    def phi_batched(U):  # (2, block) -> (block,): ½ (U−m)ᵀ Σ⁻¹ (U−m)
        d = U - mean[:, None]
        return 0.5 * jnp.sum(d * (prec @ d), axis=0)

    return Problem(
        name="gauss2d_rwm",
        dim=2,
        prior=prior,
        potential_fn=phi,
        kernel="rwm",
        kernel_params={"step_size": 1.0, "adapt": True},
        n_chains=1024,
        n_samples=1000,
        burn_in=500,
        truth=np.asarray(mean),
        notes="analytic target; truth = exact posterior mean (≈, flat prior)",
    )


@register
def lingauss_pcn() -> Problem:
    """BASELINE config 2: pCN, linear-Gaussian IP, KL-truncated GP prior."""
    d, m = 32, 16
    lam = kl.laplacian_eigenvalues(d, alpha=1.0, scale=4.0)
    prior = dist.gaussian_kl_prior(lam)
    rng = np.random.default_rng(42)
    A = jnp.asarray(rng.standard_normal((m, d)) / np.sqrt(d), jnp.float32)
    u_true = prior.sample(jax.random.key(100))
    noise = dist.DiagGaussian(mean=jnp.zeros(m), scale=0.05 * jnp.ones(m))
    y = A @ u_true + noise.sample(jax.random.key(101))
    phi = potentials.misfit_potential(linear.make_forward(A), y, noise)
    exact_mean, exact_cov = linear.conjugate_posterior(
        np.asarray(A), np.zeros(d), np.asarray(lam), 0.05**2 * np.ones(m), np.asarray(y)
    )
    return Problem(
        name="lingauss_pcn",
        dim=d,
        prior=prior,
        potential_fn=phi,
        kernel="pcn",
        kernel_params={"beta": 0.2, "adapt": True},
        n_chains=2048,
        n_samples=1000,
        burn_in=500,
        data=np.asarray(y),
        truth=exact_mean,
        notes="closed-form posterior available (conjugate)",
    )


@register
def lingauss_elliptical() -> Problem:
    """Elliptical slice sampling (tuning-free) on the config-2 problem."""
    p = lingauss_pcn()
    p.name = "lingauss_elliptical"
    p.kernel = "elliptical"
    p.kernel_params = {}
    return p


@register
def lingauss_fes() -> Problem:
    """Functional ensemble sampler on the config-2 problem: affine-invariant
    stretch moves on the 6 leading KL modes + pCN complement (Coullon–Webber
    2020) — self-tunes to posterior correlations with no covariance
    adaptation."""
    p = lingauss_pcn()
    p.name = "lingauss_fes"
    p.kernel = "fes"
    p.kernel_params = {"n_low_modes": 6, "pcn_beta": 0.25}
    return p


def _lv_problem(kernel: str, kernel_params: dict, n_chains: int) -> Problem:
    y0 = jnp.array([1.0, 0.5])
    dt, n_steps = 0.05, 200  # t ∈ [0, 10]
    obs_idx = np.arange(10, 201, 10)  # every 0.5 time units — identifiable
    fwd = ode.make_lotka_volterra_forward(y0, dt, n_steps, obs_idx)
    theta_true = jnp.log(jnp.array([0.8, 1.2, 0.9, 1.1]))
    noise = dist.DiagGaussian(
        mean=jnp.zeros(len(obs_idx) * 2), scale=0.1 * jnp.ones(len(obs_idx) * 2)
    )
    y = fwd(theta_true) + noise.sample(jax.random.key(200))
    prior = dist.DiagGaussian(mean=jnp.zeros(4), scale=0.3 * jnp.ones(4))
    phi = potentials.misfit_potential(fwd, y, noise)
    return Problem(
        name=f"ode_{kernel}",
        dim=4,
        prior=prior,
        potential_fn=phi,
        kernel=kernel,
        kernel_params=kernel_params,
        n_chains=n_chains,
        n_samples=1000,
        burn_in=500,
        data=np.asarray(y),
        truth=np.asarray(theta_true),
        notes="Lotka-Volterra log-rate inference; smooth, AD through RK4 scan",
    )


@register
def ode_mala() -> Problem:
    """BASELINE config 3a: MALA on the ODE forward model."""
    return _lv_problem(
        "mala", {"step_size": 0.05, "adapt": True, "map_init": 300}, 1024
    )


@register
def ode_hmc() -> Problem:
    """Fixed-trajectory HMC variant of config 3."""
    p = _lv_problem(
        "hmc",
        {"step_size": 0.05, "num_integration_steps": 8, "adapt": True,
         "map_init": 300},
        512,
    )
    return p


@register
def ode_chees() -> Problem:
    """ChEES-HMC on the ODE forward model: cross-chain trajectory-length
    adaptation — the ensemble alternative to NUTS (vmaps without masked
    tree building)."""
    p = _lv_problem(
        "chees",
        {"step_size": 0.05, "trajectory_length": 0.5, "map_init": 300},
        512,
    )
    p.burn_in = 300
    return p


@register
def ode_nuts() -> Problem:
    """BASELINE config 3b: NUTS on the ODE forward model."""
    p = _lv_problem(
        "nuts",
        {"step_size": 0.05, "max_depth": 8, "adapt": True, "map_init": 300},
        256,
    )
    p.n_samples = 500
    p.burn_in = 200
    return p


def _darcy_problem() -> tuple:
    fwd, aux = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    K = 64
    prior = dist.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))  # whitened
    u_true = prior.sample(jax.random.key(300))
    m = 16
    noise = dist.DiagGaussian(mean=jnp.zeros(m), scale=0.002 * jnp.ones(m))
    y = fwd(u_true) + noise.sample(jax.random.key(301))
    phi = potentials.misfit_potential(fwd, y, noise)
    phi_batched = darcy.make_batched_misfit(aux, y, 0.002)
    return phi, prior, y, u_true, phi_batched


@register
def darcy_pcn_4096() -> Problem:
    """BASELINE config 4: Darcy coefficient inversion, 64-dim KL, 4096 chains.

    pCN on this sharp posterior (σ = 0.002) has an autocorrelation time of
    ~200 steps, so the run is 2000 adaptive warmup steps and 500 samples
    at thin=8. On the CPU, 500 warmup + 500 sampling steps left max R̂ at
    1.33 (256 chains) and 2000 + 4000 steps reach 1.04 (128 chains); the
    GPU numbers at 4096 chains are in PERF.md. The timed program runs
    warmup and sampling together, so ``run_s`` and ``ess_per_s`` cover all
    6000 steps (1000 under the earlier 500 + 500 budget)."""
    phi, prior, y, u_true, phi_batched = _darcy_problem()
    return Problem(
        name="darcy_pcn_4096",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="pcn",
        kernel_params={"beta": 0.08, "adapt": True},
        n_chains=4096,
        n_samples=500,
        burn_in=2000,
        thin=8,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="elliptic PDE inversion; whitened KL coordinates",
        batched_potential_fn=phi_batched,
    )


@register
def darcy_composed_pcn() -> Problem:
    """Composed ('chains', 'model') mesh: Darcy pCN with chain sharding AND
    each chain's forward solve row-sharded over the 'model' axis — the two
    parallelism axes in one program (SURVEY.md §2.3; parallel/composed.py).
    Mesh shape is auto-derived from the device count; on one chip this is a
    (1, 1) mesh (the composed program ≡ the single-device run — tested)."""
    phi, prior, y, u_true, _ = _darcy_problem()
    _, aux = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    return Problem(
        name="darcy_composed_pcn",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="pcn_composed",
        kernel_params={"beta": 0.08, "cg_iters": 150, "aux": aux,
                       "noise_scale": 0.002},
        n_chains=512,
        n_samples=300,
        burn_in=300,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="grid-sharded forward solves UNDER chain sharding",
    )


@register
def darcy_composed_mala() -> Problem:
    """Composed ('chains', 'model') mesh with GRADIENT-based sampling
    (ROADMAP P2: the composed mesh beyond pCN): MALA whose ∇Φ comes from the
    distributed adjoint solve — forward CG, adjoint CG, and face-derivative
    assembly all row-sharded over 'model', vmapped over each group's chain
    block (parallel/composed.py sample_composed_mala; gradient tested
    against implicit AD in tests/test_composed.py)."""
    phi, prior, y, u_true, _ = _darcy_problem()
    _, aux = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    return Problem(
        name="darcy_composed_mala",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="mala_composed",
        kernel_params={"step_size": 0.05, "cg_iters": 150, "aux": aux,
                       "noise_scale": 0.002},
        n_chains=512,
        n_samples=300,
        burn_in=300,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="distributed adjoint gradients under chain sharding",
    )


@register
def darcy_composed_ess() -> Problem:
    """Composed ('chains', 'model') mesh with TUNING-FREE sampling: elliptical
    slice sampling (kernels/elliptical.py's transition, SPMD-reshaped) whose
    fixed-trip shrinkage loop keeps the vmapped ppermute/psum collective
    schedule uniform across each 'model' group (parallel/composed.py
    sample_composed_elliptical; equality with a plain single-device
    reimplementation tested in tests/test_composed.py)."""
    phi, prior, y, u_true, _ = _darcy_problem()
    _, aux = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    return Problem(
        name="darcy_composed_ess",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="ess_composed",
        kernel_params={"cg_iters": 150, "aux": aux, "noise_scale": 0.002,
                       "max_shrink": 20},
        n_chains=512,
        n_samples=300,
        burn_in=300,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="rejection-free slice sampling on grid-sharded solves",
    )


@register
def darcy_pcn_warm() -> Problem:
    """Warm-started fused pCN on Darcy: the CG solution rides the kernel
    state, proposal solves start from it. Preconditioner: truncated-DST
    (64 lowest sine modes as tall-skinny matmuls + Jacobi
    remainder) at 4 warm iterations — 4.8x fewer preconditioner MACs than
    the dense Kronecker DST, acceptance parity to 4 decimals, posterior
    moments within 1/8 of MC error of the dense kernel
    (benchmarks/darcy16_parity.py). Speed on the GPU: not measured."""
    phi, prior, y, u_true, phi_batched = _darcy_problem()
    _, aux = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    warm = darcy.make_batched_misfit_warm(aux, y, 0.002, cg_iters=4,
                                          precond="dst_trunc",
                                          precond_modes=64)
    return Problem(
        name="darcy_pcn_warm",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="pcn",
        kernel_params={"fused": True, "warm": True, "beta": 0.08,
                       "block_chains": 256},
        n_chains=4096,
        n_samples=500,
        burn_in=500,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="warm dst_trunc-4 K=64; 1.57x over round-2 dense DST-6",
        batched_potential_fn=phi_batched,
        batched_warm_potential=warm,
    )


@register
def darcy_ess_fused() -> Problem:
    """Fused elliptical slice sampling on Darcy: tuning-free (no β), the
    masked shrink loop runs the CG misfit up to max_shrink times per step."""
    phi, prior, y, u_true, phi_batched = _darcy_problem()
    return Problem(
        name="darcy_ess_fused",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="elliptical",
        kernel_params={"fused": True, "max_shrink": 6, "block_chains": 256},
        n_chains=4096,
        n_samples=400,
        burn_in=200,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="rejection-free, 3x per-step ESS of pCN at this geometry",
        batched_potential_fn=phi_batched,
    )


@register
def darcy_fes_fused() -> Problem:
    """Fused functional ensemble sampler on Darcy: affine stretch moves on
    the leading KL modes (lane-roll partners within each block-ensemble)
    + pCN complement — self-tunes to posterior correlations. The stretch
    dimension is chosen by the spectral-energy criterion ("auto": smallest
    M capturing 90% of the field's KL eigenvalue mass — 6 modes for this
    α=2 Laplacian spectrum; kernels.ensemble.choose_n_low_modes)."""
    phi, prior, y, u_true, phi_batched = _darcy_problem()
    # the field spectrum behind the whitened parameterization (same geometry
    # as _darcy_problem's make_darcy_forward call)
    _, ij = kl.sine_basis_2d(8, 16)
    lam = kl.laplacian_eigenvalues_2d(ij, alpha=2.0, scale=10.0)
    return Problem(
        name="darcy_fes_fused",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="fes",
        kernel_params={"fused": True, "n_low_modes": "auto",
                       "kl_eigenvalues": lam, "energy_frac": 0.9,
                       "pcn_beta": 0.08, "block_chains": 256},
        n_chains=4096,
        n_samples=400,
        burn_in=300,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="block = one walker ensemble; 3 misfit evals/step",
        batched_potential_fn=phi_batched,
    )


@register
def darcy_mala_fused() -> Problem:
    """Fused MALA on Darcy: gradient-based proposals with the ADJOINT CG
    solve (darcy.make_batched_misfit differentiable=True → custom_vjp;
    ops.fused_mala_chain differentiates it with jax.vjp)."""
    phi, prior, y, u_true, _ = _darcy_problem()
    _, aux = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    phi_batched = darcy.make_batched_misfit(aux, y, 0.002, differentiable=True)
    return Problem(
        name="darcy_mala_fused",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="mala",
        kernel_params={"fused": True, "step_size": 0.012, "block_chains": 256},
        n_chains=4096,
        n_samples=400,
        burn_in=300,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="adjoint-method gradients inside the fused kernel",
        batched_potential_fn=phi_batched,
    )


@register
def darcy_mala_warm() -> Problem:
    """Warm fused MALA on Darcy: forward AND adjoint CG solutions carried
    in the kernel state, DST-preconditioned (6+6 iterations — 2.3x over the
    cold adjoint)."""
    phi, prior, y, u_true, phi_batched = _darcy_problem()
    _, aux = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    warm = darcy.make_batched_misfit_mala_warm(aux, y, 0.002, cg_iters=6,
                                               precond="dst")
    return Problem(
        name="darcy_mala_warm",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="mala",
        kernel_params={"fused": True, "warm": True, "step_size": 0.012,
                       "block_chains": 256},
        n_chains=4096,
        n_samples=400,
        burn_in=300,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="explicit adjoint, warm forward+adjoint solves",
        batched_potential_fn=phi_batched,
        batched_warm_potential=warm,
    )


@register
def darcy_da_pcn() -> Problem:
    """Delayed-acceptance pCN on Darcy: subchain against a LOOSE-CG surrogate
    (8 Jacobi-PCG iterations vs the exact 48), one exact correction per
    ``subchain_len`` proposals — the classic two-level trick for expensive
    PDE forward models."""
    phi, prior, y, u_true, phi_batched = _darcy_problem()
    fwd_loose, aux_loose = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0, cg_iters=8
    )
    noise = dist.DiagGaussian(mean=jnp.zeros(16), scale=0.002 * jnp.ones(16))
    phi_surrogate = potentials.misfit_potential(fwd_loose, y, noise)
    return Problem(
        name="darcy_da_pcn",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="da_pcn",
        kernel_params={"beta": 0.08, "subchain_len": 4},
        n_chains=4096,
        n_samples=250,
        burn_in=150,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="two-level: loose-CG surrogate subchain + exact correction",
        batched_potential_fn=phi_batched,
        surrogate_potential_fn=phi_surrogate,
    )


@register
def darcy32_pcn_warm() -> Problem:
    """Fused warm pCN at 32×32 cells. Truncated-DST two-level
    preconditioning (128 lowest sine modes as tall-skinny matmuls +
    Jacobi — the dense Kronecker factors are O(n⁴) and stop paying past
    n = 16): warm-6 dst_trunc
    reaches 7e-5 relative residual where the former warm-32 Jacobi sat at
    ~3e-4 (round-1 VERDICT item 6). Round-3 gated swap
    (benchmarks/darcy3264_precond.py): 4 warm iterations with acceptance
    equal to 3 decimals, warm-path phi error exactly 0, moments within MC
    error. Speed on the GPU: not measured."""
    fwd, aux = darcy.make_darcy_forward(
        n_grid=32, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    K = 64
    prior = dist.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = prior.sample(jax.random.key(310))
    noise = dist.DiagGaussian(mean=jnp.zeros(16), scale=0.002 * jnp.ones(16))
    y = fwd(u_true) + noise.sample(jax.random.key(311))
    phi = potentials.misfit_potential(fwd, y, noise)
    warm = darcy.make_batched_misfit_warm(aux, y, 0.002, cg_iters=4,
                                          precond="dst_trunc",
                                          precond_modes=128)
    return Problem(
        name="darcy32_pcn_warm",
        dim=K,
        prior=prior,
        potential_fn=phi,
        kernel="pcn",
        kernel_params={"fused": True, "warm": True, "beta": 0.08,
                       "block_chains": 128},
        n_chains=4096,
        n_samples=400,
        burn_in=300,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="32x32 grid entirely in the fused kernel",
        batched_potential_fn=darcy.make_batched_misfit(aux, y, 0.002, cg_iters=96),
        batched_warm_potential=warm,
    )


@register
def darcy64_pcn() -> Problem:
    """Large-grid Darcy (64² cells, 144-dim KL): DST fast-Poisson
    preconditioned CG — iteration count stays ~16 where Jacobi needs
    hundreds. The big-grid capability demonstration."""
    fwd, aux = darcy.make_darcy_forward(
        n_grid=64, n_modes_per_dim=12, alpha=2.0, field_scale=10.0,
        cg_iters=24, precond="dst",
    )
    K = 144
    prior = dist.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = prior.sample(jax.random.key(500))
    m = 16
    noise = dist.DiagGaussian(mean=jnp.zeros(m), scale=0.002 * jnp.ones(m))
    y = fwd(u_true) + noise.sample(jax.random.key(501))
    phi = potentials.misfit_potential(fwd, y, noise)
    return Problem(
        name="darcy64_pcn",
        dim=K,
        prior=prior,
        potential_fn=phi,
        kernel="pcn",
        kernel_params={"beta": 0.06, "adapt": True},
        n_chains=512,
        n_samples=300,
        burn_in=300,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="64x64 grid, DST-PCG forward solve",
    )


@register
def darcy64_pcn_warm() -> Problem:
    """FUSED warm pCN at 64×64 cells, 144-dim KL: the 4096-cell PCG solve
    runs inside the fused engine with the truncated-DST two-level
    preconditioner (256 lowest sine modes; the dense Kronecker factors
    would be 32 MB each here). The big-grid capability, fused (round-1
    VERDICT item 6: 'a fused darcy64'). Round-3 gated swap
    (benchmarks/darcy3264_precond.py): 4 warm iterations, acceptance equal
    to 3 decimals, warm-path phi error exactly 0, moments within MC error.
    Speed on the GPU: not measured."""
    fwd, aux = darcy.make_darcy_forward(
        n_grid=64, n_modes_per_dim=12, alpha=2.0, field_scale=10.0,
        cg_iters=24, precond="dst",
    )
    K = 144
    prior = dist.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = prior.sample(jax.random.key(500))
    m = 16
    noise = dist.DiagGaussian(mean=jnp.zeros(m), scale=0.002 * jnp.ones(m))
    y = fwd(u_true) + noise.sample(jax.random.key(501))
    phi = potentials.misfit_potential(fwd, y, noise)
    warm = darcy.make_batched_misfit_warm(aux, y, 0.002, cg_iters=4,
                                          precond="dst_trunc",
                                          precond_modes=256)
    return Problem(
        name="darcy64_pcn_warm",
        dim=K,
        prior=prior,
        potential_fn=phi,
        kernel="pcn",
        kernel_params={"fused": True, "warm": True, "beta": 0.06,
                       "block_chains": 128},
        n_chains=2048,
        n_samples=300,
        burn_in=300,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="64x64 grid entirely in the fused kernel (dst_trunc)",
        batched_potential_fn=darcy.make_batched_misfit(
            aux, y, 0.002, cg_iters=30, precond="dst_trunc",
            precond_modes=256,
        ),
        batched_warm_potential=warm,
    )


def _darcy_coarse_surrogate(prior, y, n_coarse=8, cg_iters=8,
                            precond="jacobi", precond_modes=64,
                            solver="cg", omega=1.0,
                            return_unfused=False):
    """Calibrated coarse-GRID batched Darcy misfit for fused delayed
    acceptance (the burgers_da_pcn recipe transplanted): same whitened KL
    coefficient space (sine modes are grid-independent), field sampled on
    the n_coarse grid, observations at the nearest coarse cells, bias-
    corrected by the mean fine-coarse discrepancy over 64 prior draws and
    noise-inflated by its std. The calibration forward runs the SAME
    ``cg_iters`` as the deployed surrogate, so the discrepancy statistics
    describe the solver that actually runs in the subchain (ADVICE round 4:
    a 60-iter calibration under-estimated the deployed 8-iter solver's
    error). Returns a (K, block) -> (block,) misfit; with
    ``return_unfused=True`` also the single-particle Φ* built from the same
    calibrated (y_surr, scale) pair."""
    n_fine = 16
    fwd_f, aux_f = darcy.make_darcy_forward(
        n_grid=n_fine, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    obs_f = np.asarray(aux_f["obs_indices"])
    i_f, j_f = obs_f // n_fine, obs_f % n_fine

    def to_coarse(i):
        return np.clip(
            np.round((i + 0.5) * n_coarse / n_fine - 0.5).astype(int),
            0, n_coarse - 1,
        )

    obs_c = to_coarse(i_f) * n_coarse + to_coarse(j_f)
    # calibration forward mirrors the deployed solver: same cg_iters, and
    # "dst" when the batched surrogate runs the spectral (dst_trunc)
    # preconditioner (the single-particle path's dense fast-Poisson apply
    # is the same preconditioner at n_coarse=8, where 64 modes = ALL modes)
    fwd_c, aux_c = darcy.make_darcy_forward(
        n_grid=n_coarse, n_modes_per_dim=8, alpha=2.0, field_scale=10.0,
        obs_indices=obs_c, cg_iters=cg_iters,
        precond=("dst" if precond != "jacobi" else "jacobi"),
        solver=solver, omega=omega,
    )
    U_cal = prior.sample(jax.random.key(402), (64,))
    d = np.asarray(jax.vmap(fwd_f)(U_cal) - jax.vmap(fwd_c)(U_cal))
    y_surr = np.asarray(y) - d.mean(axis=0)
    scale = np.sqrt(0.002**2 + d.std(axis=0) ** 2).astype(np.float32)
    batched = darcy.make_batched_misfit(aux_c, y_surr, scale, cg_iters=cg_iters,
                                        precond=precond,
                                        precond_modes=precond_modes,
                                        solver=solver, omega=omega)
    if not return_unfused:
        return batched
    phi_surr = potentials.misfit_potential(
        fwd_c,
        jnp.asarray(y_surr),
        dist.DiagGaussian(mean=jnp.zeros(len(y_surr)),
                          scale=jnp.asarray(scale)),
    )
    return batched, phi_surr


@register
def darcy_da_fused() -> Problem:
    """Fused 2-level delayed-acceptance pCN on the HEADLINE Darcy problem:
    48-step subchain on a calibrated 8×8-grid surrogate, one exact
    correction per outer step — one program for all chains
    (ops.fused_da_pcn_chain), k=48, β=0.35, solver pair below. Samples the
    EXACT posterior (the DA correction is exact for any surrogate). The
    mechanism is the Burgers DA finding transplanted: cheap surrogate steps
    decorrelate recorded samples (per-outer-step ESS 0.18 vs the warm
    kernel's 0.0008/step) faster than the outer acceptance decays (0.64 at
    the optimum). ESS/s on the GPU: see PERF.md."""
    phi, prior, y, u_true, _ = _darcy_problem()
    # Solver pair: the surrogate is dst_trunc-64 @ 3 CG iters (at n=8, 64
    # modes = ALL modes: the spectral apply is a direct fast-Poisson solve
    # of the constant-coefficient problem); the exact potential is
    # dst_trunc-128 @ 12 CG iters (relative Φ error 2.2e-6 against dense
    # float64 solves over 4096 prior draws, chip_smoke.py). Posterior
    # parity with the Jacobi pair: |dmean| 0.009 / |dstd| 0.005. A 2-iter
    # surrogate is too loose (outer accept 0.65->0.55, ESS/outer
    # 0.173->0.135 — the solver error became the surrogate error).
    fwd16, aux16 = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    phi_batched = darcy.make_batched_misfit(
        aux16, y, 0.002, cg_iters=12, precond="dst_trunc", precond_modes=128
    )
    surr_b, phi_surr = _darcy_coarse_surrogate(
        prior, y, cg_iters=3, precond="dst_trunc", return_unfused=True
    )
    return Problem(
        name="darcy_da_fused",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="da_pcn",
        kernel_params={"beta": 0.35, "subchain_len": 48, "fused": True},
        n_chains=4096,
        n_samples=400,
        burn_in=40,  # outer steps (each = 48 inner surrogate steps)
        # thin=4 raises per-recorded-sample ESS 0.18 -> 0.66, cutting the
        # sample volume a user stores/transfers ~3.8x per effective sample.
        thin=4,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="8x8 calibrated surrogate subchain + exact correction; "
        "exact posterior",
        batched_potential_fn=phi_batched,
        # same calibrated (y_surr, inflated-scale) pair as the fused
        # surrogate, so the scan da_pcn path runs the surrogate the
        # subchain acceptance was tuned for (ADVICE round 4)
        surrogate_potential_fn=phi_surr,
        batched_surrogate_fn=surr_b,
    )


@register
def darcy64_da_fused() -> Problem:
    """Fused 2-level delayed-acceptance pCN on the LARGE-GRID (64², 144-dim
    KL) Darcy problem: 48-step subchain on a calibrated 32²-grid
    surrogate, one exact correction per outer step, one program for all
    chains, at (48, β0.4) with the iteration pair surrogate dst_trunc-128
    @ 3 iters / exact dst_trunc-256 @ 16 (benchmarks/da_ksweep_r5.py):
    exact posterior, outer accept 0.82. The 16²-grid surrogate measured
    too crude for this problem, and 2 surrogate iterations is the
    solver-error boundary (outer accept collapses to 0.70). ESS/s on the
    GPU: not measured."""
    fwd, aux = darcy.make_darcy_forward(
        n_grid=64, n_modes_per_dim=12, alpha=2.0, field_scale=10.0,
        cg_iters=24, precond="dst",
    )
    K = 144
    prior = dist.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = prior.sample(jax.random.key(500))
    m = 16
    noise = dist.DiagGaussian(mean=jnp.zeros(m), scale=0.002 * jnp.ones(m))
    y = fwd(u_true) + noise.sample(jax.random.key(501))  # darcy64 data
    phi = potentials.misfit_potential(fwd, y, noise)
    # iteration pair: exact dst_trunc-256 @ 16 iters and surrogate
    # dst_trunc-128 @ 3 iters at unchanged acceptance (outer 0.830, inner
    # 0.184) and posterior parity |dmean| 0.011 / |dstd| 0.011 against the
    # 24/12 pair; at s=2 the outer accept drops 0.83 -> 0.70 (solver error
    # becomes surrogate error, as in the 16x16 kernel's dst-2 negative).
    phi_exact_b = darcy.make_batched_misfit(
        aux, y, 0.002, cg_iters=16, precond="dst_trunc", precond_modes=256
    )

    # calibrated 32²-grid surrogate (same 144-mode whitened KL space)
    n_coarse = 32
    obs_f = np.asarray(aux["obs_indices"])
    i_f, j_f = obs_f // 64, obs_f % 64

    def _to_coarse(i):
        return np.clip(
            np.round((i + 0.5) * n_coarse / 64 - 0.5).astype(int),
            0, n_coarse - 1,
        )

    obs_c = _to_coarse(i_f) * n_coarse + _to_coarse(j_f)
    # calibration forward at the DEPLOYED surrogate's iteration count
    # (cg_iters=3, matching surr_b below) so the discrepancy statistics
    # describe the solver that actually runs in the subchain (ADVICE
    # round 4; the single-particle path has no dst_trunc, but dst-3 vs
    # dst_trunc-3 solver error is small against the 32²-vs-64² grid
    # discrepancy that dominates d_cal)
    fwd_c, aux_c = darcy.make_darcy_forward(
        n_grid=n_coarse, n_modes_per_dim=12, alpha=2.0, field_scale=10.0,
        obs_indices=obs_c, cg_iters=3, precond="dst",
    )
    U_cal = prior.sample(jax.random.key(402), (32,))
    d_cal = np.asarray(jax.vmap(fwd)(U_cal) - np.asarray(jax.vmap(fwd_c)(U_cal)))
    y_surr = np.asarray(y) - d_cal.mean(axis=0)
    scale_surr = np.sqrt(0.002**2 + d_cal.std(axis=0) ** 2).astype(np.float32)
    surr_b = darcy.make_batched_misfit(
        aux_c, y_surr, scale_surr, cg_iters=3, precond="dst_trunc",
        precond_modes=128,
    )
    phi_surr = potentials.misfit_potential(
        fwd_c,
        jnp.asarray(y_surr),
        dist.DiagGaussian(mean=jnp.zeros(m), scale=jnp.asarray(scale_surr)),
    )
    return Problem(
        name="darcy64_da_fused",
        dim=K,
        prior=prior,
        potential_fn=phi,
        kernel="da_pcn",
        # k=48 (benchmarks/da_ksweep_r5.py) at outer acceptance 0.82; the
        # optimum was set on the earlier hardware, on the GPU: not measured.
        kernel_params={"beta": 0.4, "subchain_len": 48, "fused": True,
                       "block_chains": 128},
        n_chains=1024,
        n_samples=300,
        burn_in=30,  # outer steps (each = 48 inner surrogate steps)
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="32c calibrated dst-3 surrogate subchain + exact dst_trunc-16 "
        "correction; exact posterior at ~33x the warm 64c kernel",
        batched_potential_fn=phi_exact_b,
        surrogate_potential_fn=phi_surr,
        batched_surrogate_fn=surr_b,
    )


@register
def darcy_da_pod() -> Problem:
    """Delayed-acceptance pCN with a POD reduced-order surrogate (rank-20
    Galerkin projection from 64 offline prior solves — the data-driven
    model-reduction recipe): the subchain runs on the tiny reduced system,
    one full solve per ``subchain_len`` proposals corrects exactly."""
    phi, prior, y, u_true, phi_batched = _darcy_problem()
    _, aux = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    phi_pod = darcy.make_pod_surrogate(
        aux, y, 0.002, jax.random.key(777), n_snapshots=64, rank=20
    )
    return Problem(
        name="darcy_da_pod",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="da_pcn",
        kernel_params={"beta": 0.08, "subchain_len": 4},
        n_chains=4096,
        n_samples=250,
        burn_in=150,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="reduced-order subchain + exact correction",
        batched_potential_fn=phi_batched,
        surrogate_potential_fn=phi_pod,
    )


@register
def darcy_da_pod_online() -> Problem:
    """`darcy_da_pod` with ONLINE POD enrichment (round-4; ROADMAP P2's
    last lever): starts from a deliberately small prior-draw snapshot set
    (24 solves, auto rank), then, between burn-in segments, full-solves
    the chain positions with the worst reduced-residual indicator and
    rebuilds the basis — enrichment at posterior-typical states. The
    surrogate is frozen before any recorded sample (runner.
    _pod_enrich_burnin), so the DA-corrected posterior is exact by
    construction; the metrics record the decreasing indicator history.

    Head-to-head (benchmarks/pod_online_vs_static.py): on THIS problem
    static-POD inner acceptance is already 0.89, so the enriched basis
    buys +0.009 acceptance for many extra full solves (speed on the GPU:
    not measured). The mechanism works (indicator 0.097 → 0.065);
    use this config when the surrogate actually limits acceptance
    (sharper posteriors / larger grids), not by default."""
    phi, prior, y, u_true, phi_batched = _darcy_problem()
    _, aux = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    phi_pod, enrich = darcy.make_pod_surrogate_online(
        aux, y, 0.002, jax.random.key(777), n_snapshots=24, rank="auto",
        enrich_batch=8,
    )
    return Problem(
        name="darcy_da_pod_online",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="da_pcn",
        kernel_params={"beta": 0.08, "subchain_len": 4,
                       "pod_enrich": {"epochs": 3, "segment_steps": 40}},
        n_chains=4096,
        n_samples=250,
        burn_in=150,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="online-enriched reduced-order subchain + exact correction",
        batched_potential_fn=phi_batched,
        surrogate_potential_fn=phi_pod,
        surrogate_enrich_fn=enrich,
    )


@register
def darcy_smc() -> Problem:
    """BASELINE config 5: adaptive tempered SMC on the Darcy inverse problem."""
    phi, prior, y, u_true, _ = _darcy_problem()
    return Problem(
        name="darcy_smc",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="smc",
        kernel_params={
            "ess_target": 0.5,
            "mutation_steps": 5,
            "pcn_step": 0.15,
            "max_stages": 60,
        },
        n_chains=4096,  # particles
        n_samples=0,
        burn_in=0,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="particles shard across hosts; collective resampling",
    )


@register
def darcy_smc_warm() -> Problem:
    """Config 5 on the fast path: adaptive tempered SMC whose mutation runs
    the warm-DST batched Darcy misfit (smc.run_batched) — each particle
    carries its converged solve across mutation steps AND resampling, so a
    mutation evaluation costs 6 DST-PCG iterations instead of the cold 48
    per-particle solves of ``darcy_smc`` (VERDICT round-1 item 4)."""
    phi, prior, y, u_true, phi_batched = _darcy_problem()
    _, aux = darcy.make_darcy_forward(
        n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0
    )
    warm = darcy.make_batched_misfit_warm(aux, y, 0.002, cg_iters=6,
                                          precond="dst")
    return Problem(
        name="darcy_smc_warm",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="smc",
        kernel_params={
            "batched": True,
            "warm": True,
            "ess_target": 0.5,
            "mutation_steps": 5,
            "pcn_step": 0.15,
            "max_stages": 60,
        },
        n_chains=4096,  # particles
        n_samples=0,
        burn_in=0,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="same posterior/algorithm as darcy_smc; warm batched mutation",
        batched_potential_fn=phi_batched,
        batched_warm_potential=warm,
    )


@register
def burgers_pcn() -> Problem:
    """Reference headline problem class: Burgers initial-data inversion."""
    fwd, aux = burgers.make_burgers_forward(
        n_cells=128, n_modes=16, alpha=1.5, field_scale=1.0, t_final=0.2,
        mean_profile=np.sin(2 * np.pi * (np.arange(128) + 0.5) / 128),
    )
    K = 16
    prior = dist.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = prior.sample(jax.random.key(400))
    m = 16
    noise = dist.DiagGaussian(mean=jnp.zeros(m), scale=0.02 * jnp.ones(m))
    y = fwd(u_true) + noise.sample(jax.random.key(401))
    phi = potentials.misfit_potential(fwd, y, noise)
    phi_batched = burgers.make_batched_misfit(aux, y, 0.02)
    return Problem(
        name="burgers_pcn",
        dim=K,
        prior=prior,
        potential_fn=phi,
        kernel="pcn",
        kernel_params={"beta": 0.15, "adapt": True},
        n_chains=2048,
        n_samples=500,
        burn_in=500,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="shock-forming forward map: derivative-free kernels only",
        batched_potential_fn=phi_batched,
    )


@register
def burgers_da_pcn() -> Problem:
    """Burgers inversion via fused delayed acceptance: coarse-grid FV
    surrogate subchain + exact correction (round-2 VERDICT missing #5 —
    the reference's headline problem class gets the warm-path treatment).

    Surrogate = the measured optimum of the round-3 sweep
    (benchmarks/burgers_da.py, honest-ESS grid over resolution × subchain
    length): 64 cells at CFL≈0.9 — half the cells AND ~3x coarser time
    steps than the fine 128-cell/CFL~0.3 model (cost ratio 1/11.9), with
    subchain_len=16 (benchmarks/burgers_da.py; its speed-up over the cold
    fused kernel on the GPU: not measured). Space-only
    coarsening to 32 cells (the round-2 first cut) measured WORSE (its
    O(h) shock error is up to 8x the observation noise at shock-adjacent
    points); time-coarsening preserves the shock position, which is a
    grid-resolution property. Posterior is identical to ``burgers_pcn`` by
    construction (the exact correction makes any surrogate valid; only
    efficiency depends on its quality)."""
    n_fine, n_coarse, K, m = 128, 64, 16, 16
    mean_fine = np.sin(2 * np.pi * (np.arange(n_fine) + 0.5) / n_fine)
    fwd, aux = burgers.make_burgers_forward(
        n_cells=n_fine, n_modes=K, alpha=1.5, field_scale=1.0, t_final=0.2,
        mean_profile=mean_fine,
    )
    prior = dist.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = prior.sample(jax.random.key(400))
    noise = dist.DiagGaussian(mean=jnp.zeros(m), scale=0.02 * jnp.ones(m))
    y = fwd(u_true) + noise.sample(jax.random.key(401))  # same data as burgers_pcn
    phi = potentials.misfit_potential(fwd, y, noise)
    phi_batched = burgers.make_batched_misfit(aux, y, 0.02)

    # coarse surrogate: same physical observation points x=(i+0.5)/n_fine,
    # same mean profile sampled at the coarse centers, same KL mode count
    obs_fine = np.asarray(aux["obs_indices"])
    obs_coarse = np.clip(
        np.round((obs_fine + 0.5) * n_coarse / n_fine - 0.5).astype(int),
        0, n_coarse - 1,
    )
    mean_coarse = np.sin(2 * np.pi * (np.arange(n_coarse) + 0.5) / n_coarse)
    # cfl_amax=1.0 → effective CFL ≈ 0.9 at the prior's |u| ≤ ~1.8: the
    # time-coarsening half of the surrogate (fine model uses the default
    # conservative bound → CFL ~0.3)
    fwd_c, aux_c = burgers.make_burgers_forward(
        n_cells=n_coarse, n_modes=K, alpha=1.5, field_scale=1.0,
        t_final=0.2, mean_profile=mean_coarse, obs_indices=obs_coarse,
        cfl_amax=1.0,
    )

    # two-level calibration (standard multilevel-DA practice): the raw
    # coarse model's discretization error (O(h) near the shock, up to 8x
    # the 0.02 noise at shock-adjacent points) misranks proposals and
    # measured a 0.06 exact-correction acceptance. Estimate the fine-coarse
    # discrepancy d(u) = G_f(u) − G_c(u) over a few prior draws (host-side,
    # build time), then (a) bias-correct the surrogate data by mean(d) and
    # (b) inflate its per-observation noise by std(d) — shock-adjacent
    # points get downweighted in Φ*, and the exact correction keeps the
    # posterior exact regardless.
    U_cal = prior.sample(jax.random.key(402), (64,))
    d_cal = np.asarray(jax.vmap(fwd)(U_cal) - jax.vmap(fwd_c)(U_cal))
    y_surr = np.asarray(y) - d_cal.mean(axis=0)
    scale_surr = np.sqrt(0.02**2 + d_cal.std(axis=0) ** 2).astype(np.float32)
    noise_surr = dist.DiagGaussian(
        mean=jnp.zeros(m), scale=jnp.asarray(scale_surr)
    )
    phi_surr = potentials.misfit_potential(fwd_c, jnp.asarray(y_surr), noise_surr)
    phi_surr_batched = burgers.make_batched_misfit(aux_c, y_surr, scale_surr)

    return Problem(
        name="burgers_da_pcn",
        dim=K,
        prior=prior,
        potential_fn=phi,
        kernel="da_pcn",
        kernel_params={"beta": 0.15, "subchain_len": 16, "fused": True},
        n_chains=2048,
        n_samples=500,
        burn_in=100,  # outer DA steps (each = 16 inner pCN steps)
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="coarse-FV surrogate subchain + exact correction; posterior "
        "identical to burgers_pcn",
        batched_potential_fn=phi_batched,
        surrogate_potential_fn=phi_surr,
        batched_surrogate_fn=phi_surr_batched,
    )


def _burgers_calibrated_surrogate(fwd, aux, prior, y, n_coarse, cfl_amax):
    """Two-level-calibrated coarse Burgers misfit (see burgers_da_pcn for
    the calibration rationale): bias-correct by the mean fine-coarse
    discrepancy over prior draws, inflate per-observation noise by its std.
    Returns (batched misfit (d, block)->(block,), single-particle misfit)."""
    K = 16
    n_fine = int(aux["n_cells"])
    obs_fine = np.asarray(aux["obs_indices"])
    obs_c = np.clip(
        np.round((obs_fine + 0.5) * n_coarse / n_fine - 0.5).astype(int),
        0, n_coarse - 1,
    )
    mean_c = np.sin(2 * np.pi * (np.arange(n_coarse) + 0.5) / n_coarse)
    fwd_c, aux_c = burgers.make_burgers_forward(
        n_cells=n_coarse, n_modes=K, alpha=1.5, field_scale=1.0,
        t_final=0.2, mean_profile=mean_c, obs_indices=obs_c,
        cfl_amax=cfl_amax,
    )
    U_cal = prior.sample(jax.random.key(402), (64,))
    d_cal = np.asarray(jax.vmap(fwd)(U_cal) - jax.vmap(fwd_c)(U_cal))
    y_surr = np.asarray(y) - d_cal.mean(axis=0)
    scale = np.sqrt(0.02**2 + d_cal.std(axis=0) ** 2).astype(np.float32)
    noise_s = dist.DiagGaussian(mean=jnp.zeros(len(y_surr)),
                                scale=jnp.asarray(scale))
    phi_s = potentials.misfit_potential(fwd_c, jnp.asarray(y_surr), noise_s)
    return burgers.make_batched_misfit(aux_c, y_surr, scale), phi_s


@register
def burgers_da3_pcn() -> Problem:
    """THREE-level fused delayed-acceptance pCN on the Burgers inversion
    (round-3 P2): inner pCN subchain on the 64-cell CFL-0.9 surrogate,
    middle corrections against the 128-cell CFL-0.9 surrogate (discrepancy
    below the observation noise — its 2-level exact-correction acceptance
    measured 0.82), one exact fine correction per outer step. Built
    because 2-level DA plateaus at ~2.3x honest ESS: its fine-correction
    acceptance decays with subchain length (0.274@k=16 → 0.167@k=48),
    while the accurate middle level restores it.
    Ships the earlier sweep's optimum (k_inner=8, k_mid=24, beta=0.25;
    benchmarks/burgers_da3_sweep.py; its ESS/s gain on the GPU: not
    measured): 128c-middle dominant (96c middles collapse the
    fine-correction acceptance to ~0.33), outer acceptance 0.78 at the
    optimum, per-sample ESS 0.14, and beta=0.25 better than 0.15/0.2 at
    large k2.
    Posterior identical to ``burgers_pcn`` (exact corrections at both
    levels — Christen–Fox composition; tests/test_fused_da.py::TestDA3)."""
    n_fine, K, m = 128, 16, 16
    mean_fine = np.sin(2 * np.pi * (np.arange(n_fine) + 0.5) / n_fine)
    fwd, aux = burgers.make_burgers_forward(
        n_cells=n_fine, n_modes=K, alpha=1.5, field_scale=1.0, t_final=0.2,
        mean_profile=mean_fine,
    )
    prior = dist.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = prior.sample(jax.random.key(400))
    noise = dist.DiagGaussian(mean=jnp.zeros(m), scale=0.02 * jnp.ones(m))
    y = fwd(u_true) + noise.sample(jax.random.key(401))  # same data/posterior
    phi = potentials.misfit_potential(fwd, y, noise)
    phi_batched = burgers.make_batched_misfit(aux, y, 0.02)
    surr_c, phi_surr = _burgers_calibrated_surrogate(fwd, aux, prior, y,
                                                     64, 1.0)
    surr_m, _ = _burgers_calibrated_surrogate(fwd, aux, prior, y, 128, 1.0)
    return Problem(
        name="burgers_da3_pcn",
        dim=K,
        prior=prior,
        potential_fn=phi,
        kernel="da_pcn",
        kernel_params={"beta": 0.25, "k_inner": 8, "k_mid": 24,
                       "fused": True},
        n_chains=2048,
        n_samples=400,
        burn_in=100,  # outer steps (each = k_inner*k_mid inner pCN steps)
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="3-level DA: 64c inner subchain, 128c middle, exact fine "
        "correction; posterior identical to burgers_pcn",
        batched_potential_fn=phi_batched,
        surrogate_potential_fn=phi_surr,
        batched_surrogate_fn=surr_c,
        batched_mid_fn=surr_m,
    )


@register
def lingauss_advi() -> Problem:
    """Full-rank ADVI on the config-2 linear-Gaussian IP. The posterior is
    Gaussian and conjugate, so the full-rank family is EXACT at the optimum:
    the runner reports fitted mean/covariance error against the closed-form
    posterior (the strongest possible VI oracle — VERDICT round-1 item 3)."""
    p = lingauss_pcn()
    p.name = "lingauss_advi"
    p.kernel = "vi"
    p.kernel_params = {"full_rank": True, "num_steps": 3000,
                       "n_mc_samples": 64, "learning_rate": 3e-2}
    # exact posterior covariance for the error report (mean is in .truth)
    lam = kl.laplacian_eigenvalues(32, alpha=1.0, scale=4.0)
    rng = np.random.default_rng(42)
    A = rng.standard_normal((16, 32)) / np.sqrt(32)
    _, exact_cov = linear.conjugate_posterior(
        A, np.zeros(32), np.asarray(lam), 0.05**2 * np.ones(16),
        np.asarray(p.data),
    )
    p.notes = "full-rank family exact for this conjugate posterior"
    p.kernel_params["exact_cov"] = exact_cov
    return p


@register
def darcy_advi() -> Problem:
    """Mean-field ADVI on the Darcy inverse problem — the fast approximate
    pass whose fitted family feeds ``darcy_advi_warmstart``."""
    phi, prior, y, u_true, _ = _darcy_problem()
    return Problem(
        name="darcy_advi",
        dim=64,
        prior=prior,
        potential_fn=phi,
        kernel="vi",
        kernel_params={"full_rank": False, "num_steps": 1500,
                       "n_mc_samples": 32, "learning_rate": 5e-2},
        n_chains=0,
        n_samples=0,
        burn_in=0,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="mean-field ADVI; ELBO maximized through the PDE solve",
    )


@register
def darcy_advi_warmstart() -> Problem:
    """VI→MCMC warm start (VERDICT round-1 item 3): a short mean-field ADVI
    fit initializes the pCN chains at the variational posterior instead of
    the prior, cutting burn-in — the runner reports the VI fit time and the
    initial-state misfit gap vs prior draws."""
    p = darcy_pcn_4096()
    p.name = "darcy_advi_warmstart"
    p.burn_in = 100  # vs 500 from prior draws — the point of the warm start
    p.kernel_params = {
        "beta": 0.08,
        "adapt": True,
        "vi_init": {"full_rank": False, "num_steps": 800,
                    "n_mc_samples": 32, "learning_rate": 5e-2},
    }
    p.notes = "chains start at the ADVI variational posterior"
    return p


def _bimodal_problem() -> tuple:
    """2-D bimodal Gaussian mixture under a wide Gaussian reference measure:
    modes at ±(sep, sep) with scale sig — the multimodality stress case that
    single-temperature pCN/RWM provably cannot mix across."""
    sep, sig = 2.5, 0.3
    prior = dist.DiagGaussian(mean=jnp.zeros(2), scale=3.0 * jnp.ones(2))
    mode = jnp.array([sep, sep])

    def log_mix(u):
        a = -0.5 * jnp.sum((u - mode) ** 2) / sig**2
        b = -0.5 * jnp.sum((u + mode) ** 2) / sig**2
        return jnp.logaddexp(a, b)

    phi = lambda u: -log_mix(u) - prior.potential(u)
    return prior, phi, sep, sig


@register
def multimodal_pt() -> Problem:
    """Parallel tempering (replica exchange) on a bimodal target: 8-rung
    tempered-pCN ladder with equi-acceptance adaptation
    (kernels/tempering.py), cold chain recorded. The registry/CLI path for
    the PT kernel (VERDICT round-1 item 3); mode-balance is the headline
    metric — plain pCN at this separation stays in its starting mode."""
    prior, phi, sep, sig = _bimodal_problem()
    return Problem(
        name="multimodal_pt",
        dim=2,
        prior=prior,
        potential_fn=phi,
        kernel="pt",
        kernel_params={"n_temps": 8, "pcn_step": 0.4, "beta_min": 0.05,
                       "adapt_ladder": True, "swap_center": 0.4},
        n_chains=256,
        n_samples=800,
        burn_in=300,
        truth=np.zeros(2),  # symmetric mixture: exact mean is 0
        notes="cold-chain mode balance ≈ 0.5/0.5; swaps transport hot-chain jumps",
    )


@register
def multimodal_pt_mala() -> Problem:
    """PT with MALA mutations on the bimodal target (gradient proposals per
    replica, ladder swaps identical) — ROADMAP P2's 'ladder adaptation +
    MALA mutations compose'."""
    p = multimodal_pt()
    p.name = "multimodal_pt_mala"
    p.kernel_params = {"n_temps": 8, "step_size": 0.25, "beta_min": 0.05,
                       "mutation": "mala", "adapt_ladder": True,
                       "swap_center": 0.4, "pcn_step": 0.4}
    return p


@register
def burgers_multitime_pcn() -> Problem:
    """Burgers inversion observing the evolution at THREE times (reference
    parity: EvolutionPotential observes times and points) — 48 observations,
    sharper posterior than the final-time-only variant."""
    times = [0.07, 0.14, 0.2]
    fwd, aux = burgers.make_burgers_forward(
        n_cells=128, n_modes=16, alpha=1.5, field_scale=1.0, t_final=0.2,
        obs_times=times,
        mean_profile=np.sin(2 * np.pi * (np.arange(128) + 0.5) / 128),
    )
    K = 16
    prior = dist.DiagGaussian(mean=jnp.zeros(K), scale=jnp.ones(K))
    u_true = prior.sample(jax.random.key(400))
    m = 48
    noise = dist.DiagGaussian(mean=jnp.zeros(m), scale=0.02 * jnp.ones(m))
    y = fwd(u_true) + noise.sample(jax.random.key(402))
    phi = potentials.misfit_potential(fwd, y, noise)
    phi_batched = burgers.make_batched_misfit(aux, y, 0.02)
    return Problem(
        name="burgers_multitime_pcn",
        dim=K,
        prior=prior,
        potential_fn=phi,
        kernel="pcn",
        kernel_params={"beta": 0.15, "adapt": True},
        n_chains=2048,
        n_samples=500,
        burn_in=500,
        data=np.asarray(y),
        truth=np.asarray(u_true),
        notes="evolution observed at t=0.07/0.14/0.2 (48 observations)",
        batched_potential_fn=phi_batched,
    )
