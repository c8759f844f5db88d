"""Darcy-flow forward model: −∇·(a(x)∇p) = f on the unit square, p|∂Ω = 0.

BASELINE.json config 4: "pCN on elliptic-PDE (Darcy-flow) coefficient
inversion, 64-dim KL expansion, 4096 parallel chains". The unknown is the
log-permeability log a(x), a Gaussian random field truncated to a KL
coefficient vector u ∈ R^K (K = 64 = 8×8 tensor sine modes by default).

Accelerator design:
- field reconstruction log a = u·√λ @ basis — one (K)×(K, n²) matmul;
- cell-centered finite volumes, harmonic-mean face transmissibilities,
  5-point stencil assembled as a DENSE (n², n²) SPD matrix with statically
  precomputed scatter indices — dense because the batched Cholesky
  factorization of thousands of chains' matrices is exactly what the matrix units
  eats (a sparse solver would serialize on-chip);
- solve via ``jnp.linalg.cholesky`` + triangular solves — differentiable
  (MALA/NUTS on Darcy work through implicit AD of the solve), and the whole
  forward vmaps over the chain axis;
- observations: static gather of pressure at observation cells.

Reference analog: the PDE evolution operators consumed by
``EvolutionPotential`` (SURVEY.md §2.1 [M]); the elliptic problem is the
smooth-PDE member of BASELINE's config set.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ip_mcmc_tpu.models import kl
from ip_mcmc_tpu.precision import mm


def _stencil_indices(n: int):
    """Static scatter indices for the 5-point FV stencil on an n×n grid."""
    idx = np.arange(n * n).reshape(n, n)
    # horizontal faces: between (i, j) and (i, j+1)
    h_left = idx[:, :-1].ravel()
    h_right = idx[:, 1:].ravel()
    # vertical faces: between (i, j) and (i+1, j)
    v_top = idx[:-1, :].ravel()
    v_bot = idx[1:, :].ravel()
    # boundary cells per edge (for Dirichlet ghost transmissibility)
    b_cells = np.concatenate([idx[0, :], idx[-1, :], idx[:, 0], idx[:, -1]])
    return h_left, h_right, v_top, v_bot, b_cells


def assemble_operator(a, indices, n: int):
    """Dense SPD operator A(a) for conductivity field a (n, n)."""
    h_left, h_right, v_top, v_bot, b_cells = indices
    h2 = float(n * n)  # 1/h²
    af = a.reshape(-1)
    N = n * n
    t_h = 2.0 * af[h_left] * af[h_right] / (af[h_left] + af[h_right]) * h2
    t_v = 2.0 * af[v_top] * af[v_bot] / (af[v_top] + af[v_bot]) * h2
    t_b = 2.0 * af[b_cells] * h2  # Dirichlet: half-cell distance to boundary

    A = jnp.zeros((N, N), dtype=a.dtype)
    A = A.at[h_left, h_right].add(-t_h)
    A = A.at[h_right, h_left].add(-t_h)
    A = A.at[v_top, v_bot].add(-t_v)
    A = A.at[v_bot, v_top].add(-t_v)
    diag = (
        jnp.zeros(N, dtype=a.dtype)
        .at[h_left].add(t_h)
        .at[h_right].add(t_h)
        .at[v_top].add(t_v)
        .at[v_bot].add(t_v)
        .at[b_cells].add(t_b)
    )
    return A + jnp.diag(diag)


def _face_transmissibilities(a, n: int):
    """Harmonic-mean face transmissibilities × 1/h² for an (n, n) field."""
    h2 = float(n * n)
    t_h = 2.0 * a[:, :-1] * a[:, 1:] / (a[:, :-1] + a[:, 1:]) * h2  # (n, n-1)
    t_v = 2.0 * a[:-1, :] * a[1:, :] / (a[:-1, :] + a[1:, :]) * h2  # (n-1, n)
    return t_h, t_v


def apply_operator(a, p, n: int):
    """Matrix-free A(a) @ p on (n, n) grids — pure stencil arithmetic,
    identical to ``assemble_operator``'s matrix (tested), no scatters."""
    h2 = float(n * n)
    t_h, t_v = _face_transmissibilities(a, n)
    flux_h = t_h * (p[:, :-1] - p[:, 1:])  # (n, n-1)
    flux_v = t_v * (p[:-1, :] - p[1:, :])  # (n-1, n)
    out = jnp.zeros_like(p)
    out = out.at[:, :-1].add(flux_h).at[:, 1:].add(-flux_h)
    out = out.at[:-1, :].add(flux_v).at[1:, :].add(-flux_v)
    # Dirichlet boundary faces (half-cell distance)
    tb = 2.0 * h2
    out = out.at[0, :].add(tb * a[0, :] * p[0, :])
    out = out.at[-1, :].add(tb * a[-1, :] * p[-1, :])
    out = out.at[:, 0].add(tb * a[:, 0] * p[:, 0])
    out = out.at[:, -1].add(tb * a[:, -1] * p[:, -1])
    return out


def _operator_diagonal(a, n: int):
    """diag(A) for Jacobi preconditioning — same stencil bookkeeping."""
    h2 = float(n * n)
    t_h, t_v = _face_transmissibilities(a, n)
    d = jnp.zeros_like(a)
    d = d.at[:, :-1].add(t_h).at[:, 1:].add(t_h)
    d = d.at[:-1, :].add(t_v).at[1:, :].add(t_v)
    tb = 2.0 * h2
    d = d.at[0, :].add(tb * a[0, :])
    d = d.at[-1, :].add(tb * a[-1, :])
    d = d.at[:, 0].add(tb * a[:, 0])
    d = d.at[:, -1].add(tb * a[:, -1])
    return d


def dst_basis(n: int):
    """Orthonormal eigenbasis of the 1-D constant-coefficient operator of
    this discretization: φ_k(j) = sin(πk(j+½)/n), k = 1..n — the HALF-CELL
    Dirichlet rows (t_b = 2a/h²) are exactly the ghost reflection
    p_{-1} = −p_0, whose eigenvectors are these shifted sines with
    eigenvalues a·h⁻²·(2 − 2cos(πk/n)). Returns (S (n, n) orthonormal rows,
    eig1d (n,) eigenvalues in units of a·n²)."""
    j = np.arange(n) + 0.5
    k = np.arange(1, n + 1)[:, None]
    S = np.sin(np.pi * k * j[None, :] / n)
    S *= np.sqrt(2.0 / n)
    S[-1] *= np.sqrt(0.5)  # k = n row has half the norm
    eig = 2.0 - 2.0 * np.cos(np.pi * k[:, 0] / n)
    return jnp.asarray(S, jnp.float32), jnp.asarray(eig, jnp.float32)


def make_dst_preconditioner(a, n: int):
    """Fast-Poisson preconditioner M = A(ā), ā = geometric mean of the
    coefficient field: M⁻¹r = Sᵀ[(S r Sᵀ) / λ]S — two (n, n) matmuls
    per application, and the eigenvalue table λ_ij = ā n²(e_i + e_j). The
    scalable choice for large grids where Jacobi-PCG iteration counts grow
    with n (ROADMAP P1)."""
    S, e = dst_basis(n)
    a_bar = jnp.exp(jnp.mean(jnp.log(a)))
    lam = a_bar * float(n * n) * (e[:, None] + e[None, :])

    def inv_m(r):  # (n, n) -> (n, n)
        return S.T @ ((S @ r @ S.T) / lam) @ S

    return inv_m


def solve_cg(a, f, n: int, n_iters: int = 48, precond: str = "jacobi",
             solver: str = "cg", omega: float = 1.0):
    """Preconditioned CG solve of A(a) p = f, matrix-free, fixed iteration
    count (static shapes), wrapped in ``lax.custom_linear_solve`` so
    gradients use the IMPLICIT adjoint solve (same CG, symmetric) rather
    than differentiating through the iterations (SURVEY.md §7.3 item 3).

    ``precond``: "jacobi" (diagonal — cheapest per iteration) or "dst"
    (fast-Poisson via the sine eigenbasis — iteration count nearly
    grid-independent; the right choice at 64²+).

    ``solver``: "cg" or "richardson" (fixed-ω preconditioned Richardson —
    no dot products; for the spectrally-preconditioned surrogate regime,
    and for calibrating surrogates whose deployed batched solver is
    Richardson — see ``_richardson_flat`` for the measured rationale).
    """
    f2 = f.reshape(n, n)
    if precond == "dst":
        inv_m = make_dst_preconditioner(a, n)
    elif precond == "jacobi":
        inv_diag = 1.0 / _operator_diagonal(a, n)
        inv_m = lambda r: inv_diag * r
    else:
        raise ValueError(f"precond must be 'jacobi' or 'dst', got {precond!r}")
    if solver not in ("cg", "richardson"):
        raise ValueError(
            f"solver must be 'cg' or 'richardson', got {solver!r}"
        )

    def matvec(p):
        return apply_operator(a, p, n)

    def richardson(mv, b):
        om = jnp.float32(omega)
        x = om * inv_m(b)

        def body(_, x):
            return x + om * inv_m(b - mv(x))

        return jax.lax.fori_loop(0, n_iters - 1, body, x)

    def cg(mv, b):
        x = jnp.zeros_like(b)
        r = b
        z = inv_m(r)
        p = z
        rz = jnp.sum(r * z)

        def body(_, carry):
            x, r, p, rz = carry
            Ap = mv(p)
            denom = jnp.sum(p * Ap)
            # guards: once converged (r = 0) the recurrences hit 0/0 —
            # freeze instead of emitting NaN (iteration count is static)
            alpha = jnp.where(denom > 0.0, rz / jnp.where(denom > 0.0, denom, 1.0), 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            z = inv_m(r)
            rz_new = jnp.sum(r * z)
            beta = jnp.where(rz > 0.0, rz_new / jnp.where(rz > 0.0, rz, 1.0), 0.0)
            p = z + beta * p
            return x, r, p, rz_new

        x, _, _, _ = jax.lax.fori_loop(0, n_iters, body, (x, r, p, rz))
        return x

    p = jax.lax.custom_linear_solve(
        matvec, f2, solve=(richardson if solver == "richardson" else cg),
        symmetric=True,
    )
    return p.reshape(-1)


def default_observation_indices(n: int, n_obs_per_dim: int = 4):
    """Evenly spaced interior observation cells (flattened indices)."""
    pos = np.linspace(0, n - 1, n_obs_per_dim + 2)[1:-1].round().astype(int)
    ii, jj = np.meshgrid(pos, pos, indexing="ij")
    return (ii * n + jj).ravel()


def make_darcy_forward(
    n_grid: int = 16,
    n_modes_per_dim: int = 8,
    alpha: float = 2.0,
    field_scale: float = 10.0,
    obs_indices=None,
    source=None,
    log_a_mean: float = 0.0,
    method: str = "cg",
    cg_iters: int = 48,
    precond: str = "jacobi",
    solver: str = "cg",
    omega: float = 1.0,
    mesh=None,
):
    """Build forward(u): KL coefficients (K,) → pressure at observation cells.

    ``u`` is in WHITENED coordinates (u ~ N(0, I) under the prior); the
    spectrum √λ is folded into the reconstruction so samplers always see an
    isotropic Gaussian prior — the pCN-friendly parameterization.

    Returns (forward, aux) with aux = dict(basis, sqrt_eigenvalues,
    obs_indices, n_grid) for reuse (e.g. plotting, truth synthesis).
    """
    basis_np, ij = kl.sine_basis_2d(n_modes_per_dim, n_grid)
    lam = kl.laplacian_eigenvalues_2d(ij, alpha=alpha, scale=field_scale)
    scaled_basis = jnp.asarray(np.sqrt(lam)[:, None] * basis_np, dtype=jnp.float32)
    indices = _stencil_indices(n_grid)
    if obs_indices is None:
        obs_indices = default_observation_indices(n_grid)
    obs_indices = jnp.asarray(np.asarray(obs_indices))
    if source is None:
        f = jnp.ones(n_grid * n_grid, dtype=jnp.float32)
    else:
        f = jnp.asarray(source, dtype=jnp.float32).reshape(-1)

    if method not in ("cg", "dense", "sharded"):
        raise ValueError(
            f"method must be 'cg', 'dense' or 'sharded', got {method!r}"
        )
    if method == "sharded":
        # grid row-sharded over the 'model' mesh axis (SURVEY.md §5.7):
        # ppermute halo exchange + psum CG reductions; for single solves
        # that outgrow one chip. Derivative-free kernels only in v1.
        from ip_mcmc_tpu.parallel import grid_shard

        if mesh is None:
            mesh = grid_shard.make_model_mesh()
        if n_grid % mesh.devices.size:
            raise ValueError(
                f"n_grid {n_grid} must divide over the {mesh.devices.size}-"
                "device 'model' axis (row-block decomposition)"
            )

    def forward(u):
        log_a = log_a_mean + mm(u, scaled_basis)  # (n²,)
        a = jnp.exp(log_a).reshape(n_grid, n_grid)
        if method == "cg":
            # matrix-free stencil CG: no dense assembly, no scatters —
            # compiles ~100x faster and scales to large grids
            p = solve_cg(a, f, n_grid, n_iters=cg_iters, precond=precond,
                         solver=solver, omega=omega)
        elif method == "sharded":
            from ip_mcmc_tpu.parallel import grid_shard

            p = grid_shard.sharded_solve_cg(a, f, n_grid, mesh, n_iters=cg_iters)
        else:
            A = assemble_operator(a, indices, n_grid)
            L = jnp.linalg.cholesky(A)
            p = jax.scipy.linalg.cho_solve((L, True), f)
        return p[obs_indices]

    aux = {
        "scaled_basis": scaled_basis,
        "eigenvalues": jnp.asarray(lam),
        "obs_indices": obs_indices,
        "n_grid": n_grid,
        "stencil_indices": indices,
        "source": f,
    }
    return forward, aux


def _shift_up(x, k):
    """x[p+k] in flat flat index (zeros shifted in at the tail)."""
    return jnp.concatenate([x[k:], jnp.zeros((k,) + x.shape[1:], x.dtype)], axis=0)


def _shift_down(x, k):
    """x[p-k] in flat flat index (zeros shifted in at the head)."""
    return jnp.concatenate([jnp.zeros((k,) + x.shape[1:], x.dtype), x[:-k]], axis=0)


def _flat_masks(n):
    """Constant (n², 1) masks for the FLAT stencil: the 5-point stencil is
    expressed on the flattened (n², block) grid, with no scatter/gather and
    no 2D↔3D reshape, as flat-index shifts (±1 horizontal, ±n
    vertical) and these masks kill row wrap-around / boundary terms."""
    idx = np.arange(n * n)
    i, j = idx // n, idx % n
    def col(c):
        return jnp.asarray(c.astype(np.float32).reshape(-1, 1))
    return {
        "right": col(j < n - 1),   # face to the right exists
        "down": col(i < n - 1),    # face below exists
        "edge": col((i == 0).astype(float) + (i == n - 1) + (j == 0) + (j == n - 1)),
    }


def _flat_transmissibilities(a, n, masks):
    """Face transmissibilities on the flat layout. a: (n², block)."""
    h2 = float(n * n)
    a_r = _shift_up(a, 1)      # right neighbor
    a_d = _shift_up(a, n)      # below neighbor
    t_h = 2.0 * a * a_r / (a + a_r + 1e-38) * h2 * masks["right"]
    t_v = 2.0 * a * a_d / (a + a_d + 1e-38) * h2 * masks["down"]
    return t_h, t_v


def _apply_operator_flat(a, p, n, masks, t_h, t_v):
    """A(a) @ p on the flat (n², block) layout — shifts + elementwise only."""
    h2 = float(n * n)
    flux_h = t_h * (p - _shift_up(p, 1))   # face owned by left cell
    flux_v = t_v * (p - _shift_up(p, n))   # face owned by upper cell
    out = flux_h - _shift_down(flux_h, 1) + flux_v - _shift_down(flux_v, n)
    out = out + 2.0 * h2 * a * p * masks["edge"]
    return out


def _operator_diagonal_flat(a, n, masks, t_h, t_v):
    h2 = float(n * n)
    d = t_h + _shift_down(t_h, 1) + t_v + _shift_down(t_v, n)
    return d + 2.0 * h2 * a * masks["edge"]


def _cg_flat(a, b, n, masks, t_h, t_v, inv_diag, n_iters, x0=None, inv_m=None,
             apply_fn=None):
    """Batched PCG on the flat (n², block) layout — shifts + elementwise +
    per-chain reductions . ``inv_m`` overrides the Jacobi
    preconditioner (e.g. the flat DST fast-Poisson apply); ``apply_fn``
    overrides the operator apply (e.g. the bf16 mixed-precision variant —
    CG vectors and reductions stay f32 either way)."""
    if inv_m is None:
        inv_m = lambda r: inv_diag * r
    if apply_fn is None:
        apply_fn = lambda p: _apply_operator_flat(a, p, n, masks, t_h, t_v)

    def dots(u, v):
        return jnp.sum(u * v, axis=0)  # (block,)

    x = jnp.zeros_like(b) if x0 is None else x0
    r = b if x0 is None else b - apply_fn(x)
    z = inv_m(r)
    p = z
    rz = dots(r, z)

    def body(_, carry):
        x, r, p, rz = carry
        Ap = apply_fn(p)
        pAp = dots(p, Ap)
        alpha = jnp.where(pAp > 0.0, rz / jnp.where(pAp > 0.0, pAp, 1.0), 0.0)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * Ap
        z = inv_m(r)
        rz_new = dots(r, z)
        beta = jnp.where(rz > 0.0, rz_new / jnp.where(rz > 0.0, rz, 1.0), 0.0)
        p = z + beta[None, :] * p
        return x, r, p, rz_new

    x, _, _, _ = jax.lax.fori_loop(0, n_iters, body, (x, r, p, rz))
    return x


def _richardson_flat(a, b, n, masks, t_h, t_v, inv_diag, n_iters,
                     omega=1.0, inv_m=None, apply_fn=None):
    """Fixed-coefficient preconditioned Richardson on the flat (n², block)
    layout: x ← x + ω·M⁻¹(b − A x), starting from x₁ = ω·M⁻¹b. Unlike CG
    there are NO per-iteration dot products — the ablation split
    (benchmarks/da_vpu_split.py) measured the fused DA surrogate's CG body
    at ~39% of the whole outer step, and each CG iteration spends part of
    that on two (n², block)→(block,) reductions plus the α/β
    scalar algebra and broadcasts, none of which Richardson has. Per
    iteration this is ONE stencil apply + ONE preconditioner apply + an
    axpy; n_iters iterations do n_iters−1 stencil applies (the first
    "apply" against x₀ = 0 is free). Division-free, so inherently NaN-safe
    where CG needs pAp/rz guards.

    Meant for use with the SPECTRAL preconditioners (dst/dst_trunc), where
    M⁻¹A clusters near 1 and fixed ω ≈ 0.8–0.9 is near-optimal; under
    plain Jacobi the un-adapted iteration converges far slower than CG.

    MEASURED VERDICT for the fused DA surrogate (its motivating use,
    benchmarks/darcy_da_richardson.py): NEGATIVE — do not substitute for
    CG there. The predicted rate win materializes exactly (+30% outer
    steps/s at 3 iterations) but ESS/outer-step collapses ~6× at
    unchanged outer acceptance: without CG's per-chain adaptivity the
    fixed iteration's solver error is ~3× larger at the median per state
    (3.1 vs 1.05 nats on prior draws) and state-dependent, which roughens
    the surrogate landscape the subchain samples — the posterior stays
    exact (DA corrects; parity held at |Δmean| ≤ 0.011) but outer mixing
    dies. Kept as an option because the iteration is correct, tested, and
    the right tool where a division-free fixed-cost solve matters more
    than last-iteration accuracy."""
    if inv_m is None:
        inv_m = lambda r: inv_diag * r
    if apply_fn is None:
        apply_fn = lambda p: _apply_operator_flat(a, p, n, masks, t_h, t_v)
    om = jnp.float32(omega)
    x = om * inv_m(b)

    def body(_, x):
        r = b - apply_fn(x)
        return x + om * inv_m(r)

    return jax.lax.fori_loop(0, n_iters - 1, body, x)


def _flat_dst_preconditioner(n, a, precond_dtype=jnp.bfloat16):
    """Fast-Poisson preconditioner on the FLAT (n², block) layout: the 2-D
    sine transform factorizes as vec(S R Sᵀ) = (S⊗I)(I⊗S) vec(R), and both
    Kronecker factors are small (n², n²) matrices — so each application is
    four matmuls + an eigenvalue divide, instead of more stencil
    iterations. The matmuls run in ``precond_dtype`` (bf16 by default: a
    preconditioner only steers CG, so its rounding never biases the
    solution — measured iterations-to-tolerance identical to f32).
    ``a``: (n², block) conductivities (geometric mean taken per chain)."""
    # numpy-only construction (this runs under trace: jnp constants here
    # would be tracers that can't round-trip through np.kron)
    j = np.arange(n) + 0.5
    k = np.arange(1, n + 1)[:, None]
    Snp = np.sin(np.pi * k * j[None, :] / n) * np.sqrt(2.0 / n)
    Snp[-1] *= np.sqrt(0.5)
    e = 2.0 - 2.0 * np.cos(np.pi * k[:, 0] / n)
    IS = jnp.asarray(np.kron(np.eye(n), Snp), precond_dtype)
    SI = jnp.asarray(np.kron(Snp, np.eye(n)), precond_dtype)
    lam_flat = jnp.asarray(
        float(n * n) * (e[:, None] + e[None, :]).reshape(-1, 1), jnp.float32
    )
    a_bar = jnp.exp(jnp.mean(jnp.log(a), axis=0))  # (block,)
    denom = lam_flat * a_bar[None, :]

    def mm_lp(A, x):  # bf16 inputs, f32 accumulation
        return jnp.matmul(
            A, x.astype(precond_dtype), preferred_element_type=jnp.float32
        )

    def mm_t(A, x):
        """Aᵀ @ x WITHOUT materializing Aᵀ (dot_general with the lhs
        contraction on dim 0 — a transposed-lhs dot). Materialized
        transposes double the factors' memory footprint."""
        return jax.lax.dot_general(
            A, x.astype(precond_dtype), (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )

    def inv_m(r):
        rt = mm_lp(SI, mm_lp(IS, r)) / denom
        return mm_t(IS, mm_t(SI, rt))

    return inv_m


def _flat_truncated_dst_preconditioner(n, a, inv_diag, k_modes,
                                        precond_dtype=jnp.bfloat16):
    """Two-level spectral preconditioner on the FLAT (n², block) layout:

        M⁻¹ = D⁻¹ + Vᵀ Λ_K⁻¹ V

    with V the ``k_modes`` LOWEST-eigenvalue 2-D sine modes of the
    constant-coefficient Poisson operator (rows of S⊗S sorted by
    λ_{k1,k2} = n²(e_{k1}+e_{k2})) and D⁻¹ the Jacobi diagonal of the TRUE
    variable-coefficient operator. Why this beats the dense Kronecker
    factorization at n ≥ 32: the dense apply costs O(n⁴) MACs/chain with
    (n², n²) factors that outgrow on-chip memory (32 MB each at n = 64, bf16), while
    this is two TALL-SKINNY matmuls — O(K·n²) with GEMM-friendly shapes
    (contraction n² ≥ 1024, block on the last axis) and (n², K) factors (1 MB at
    n = 64, K = 256). Per-mode quality is IDENTICAL to the full DST (both
    correct with 1/(ā λ) on the sine modes — the same constant-coefficient
    approximation); truncation only leaves the HIGH modes to D⁻¹-CG, which
    handles them well (κ of the remaining spectrum ~ λ_max/λ_K). At
    K = n² and D⁻¹ = 0 this IS the full fast-Poisson apply — tested against
    ``_flat_dst_preconditioner``. The additive D⁻¹ keeps M SPD (sum of SPD
    terms), so plain PCG stays valid.

    ``a``: (n², block) conductivities; ``inv_diag``: (n², block) Jacobi
    inverse diagonal (pass 0 to drop the two-level term)."""
    j = np.arange(n) + 0.5
    k = np.arange(1, n + 1)[:, None]
    Snp = np.sin(np.pi * k * j[None, :] / n) * np.sqrt(2.0 / n)
    Snp[-1] *= np.sqrt(0.5)
    e = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, n + 1) / n)
    lam2d = float(n * n) * (e[:, None] + e[None, :])  # mode (k1, k2)
    order = np.argsort(lam2d.reshape(-1), kind="stable")[:k_modes]
    k1, k2 = order // n, order % n
    # V[m, i*n + j] = S[k1_m, i] · S[k2_m, j] — row-major flat cells
    Vnp = (Snp[k1][:, :, None] * Snp[k2][:, None, :]).reshape(k_modes, n * n)
    V = jnp.asarray(Vnp, precond_dtype)                 # (K, n²)
    Vt = jnp.asarray(Vnp.T.copy(), precond_dtype)       # (n², K) — eager
    lam_k = jnp.asarray(lam2d.reshape(-1)[order].reshape(-1, 1), jnp.float32)
    a_bar = jnp.exp(jnp.mean(jnp.log(a), axis=0))       # (block,)
    denom = lam_k * a_bar[None, :]

    def mm_lp(A, x):  # bf16 inputs, f32 accumulation
        return jnp.matmul(
            A, x.astype(precond_dtype), preferred_element_type=jnp.float32
        )

    def inv_m(r):
        rt = mm_lp(V, r) / denom          # (K, block) spectral correction
        return inv_diag * r + mm_lp(Vt, rt)

    return inv_m


def make_batched_misfit(aux, data, noise_scale, cg_iters: int = 48,
                        log_a_mean: float = 0.0, differentiable: bool = False,
                        precond: str = "jacobi", precond_modes: int = 128,
                        solver: str = "cg", omega: float = 1.0):
    """Batched misfit Φ for FEATURES-FIRST (K, block) coefficient batches —
    the form consumed by ``ops.fused_pcn_chain``: KL reconstruction
    (matmul), the ENTIRE Jacobi-PCG Darcy solve, observation and misfit all
    run inside the fused engine, chains on the last axis, the solution
    grid flat (n², block) (the stencil uses flat-index shifts + masks).

    ``differentiable=True`` attaches a ``custom_vjp`` implementing the
    ADJOINT METHOD (one extra CG solve of A λ = ∂Φ/∂x, plus the closed-form
    derivative of the harmonic-mean transmissibilities w.r.t. the cell
    conductivities) — reverse-mode through the CG iterations would need
    cg_iters×(n², block) residuals in memory; the adjoint needs none. This
    is what lets ``ops.fused_mala_chain`` run gradient-based MCMC on Darcy
    inside one fused program.
    """
    data = jnp.asarray(data, jnp.float32)
    noise_scale = jnp.asarray(noise_scale, jnp.float32)
    if noise_scale.ndim == 1:
        # per-observation scales (e.g. discrepancy-inflated calibrated
        # surrogates): column-shape so they broadcast over (m, block)
        noise_scale = noise_scale[:, None]
    basis = aux["scaled_basis"]  # (K, n²)
    # pre-transpose the constants EAGERLY: a `.T` inside the traced potential
    # becomes an in-kernel transpose op executed every evaluation (measured
    # ~1.4x on the precond factors); a pre-transposed constant is free
    basis_t = jnp.asarray(np.asarray(basis).T)
    obs = np.asarray(aux["obs_indices"])
    f = jnp.asarray(aux["source"]).reshape(-1, 1)
    n = int(aux["n_grid"])
    masks = _flat_masks(n)
    # observation as a one-hot matmul (no gather in the fused step)
    obs_mat = np.zeros((len(obs), n * n), np.float32)
    obs_mat[np.arange(len(obs)), obs] = 1.0
    obs_mat_t = jnp.asarray(obs_mat.T.copy())
    obs_mat = jnp.asarray(obs_mat)
    if precond not in ("jacobi", "dst_trunc"):
        raise ValueError(
            f"precond must be 'jacobi' or 'dst_trunc', got {precond!r}"
        )
    if solver not in ("cg", "richardson"):
        raise ValueError(
            f"solver must be 'cg' or 'richardson', got {solver!r}"
        )
    if solver == "richardson" and differentiable:
        # the adjoint solve reuses the forward solver; Richardson's fixed
        # iteration is tuned for the spectrally-preconditioned SURROGATE
        # misfits, which are never differentiated — keep the adjoint path
        # on CG until a measured need exists
        raise ValueError("solver='richardson' supports differentiable=False "
                         "only (surrogate misfits)")

    def _inv_m(a, inv_diag):
        if precond == "dst_trunc":
            return _flat_truncated_dst_preconditioner(
                n, a, inv_diag, precond_modes
            )
        return None

    def _forward(U):
        """U (K, block) → (phi (block,), a, x, res) — shared fwd pass."""
        block = U.shape[1]
        log_a = log_a_mean + mm(basis_t, U)  # (n², block)
        a = jnp.exp(log_a)
        t_h, t_v = _flat_transmissibilities(a, n, masks)
        b = jnp.broadcast_to(f, (n * n, block))
        inv_diag = 1.0 / _operator_diagonal_flat(a, n, masks, t_h, t_v)
        if solver == "richardson":
            x = _richardson_flat(a, b, n, masks, t_h, t_v, inv_diag,
                                 cg_iters, omega=omega,
                                 inv_m=_inv_m(a, inv_diag))
        else:
            x = _cg_flat(a, b, n, masks, t_h, t_v, inv_diag, cg_iters,
                         inv_m=_inv_m(a, inv_diag))
        pred = mm(obs_mat, x)  # (m, block)
        res = (data[:, None] - pred) / noise_scale
        return 0.5 * jnp.sum(res * res, axis=0), a, x, res

    if not differentiable:
        def phi(U):  # (K, block) -> (block,)
            return _forward(U)[0]

        return phi

    @jax.custom_vjp
    def phi(U):
        return _forward(U)[0]

    def phi_fwd(U):
        val, a, x, res = _forward(U)
        return val, (a, x, res)

    def phi_bwd(saved, t):  # t: (block,) cotangent of Φ
        a, x, res = saved
        h2 = float(n * n)
        t_h, t_v = _flat_transmissibilities(a, n, masks)
        inv_diag = 1.0 / _operator_diagonal_flat(a, n, masks, t_h, t_v)
        # ∂Φ/∂x = −Oᵀ(res/σ); adjoint solve A λ = ∂Φ/∂x (A symmetric)
        dphi_dx = -mm(obs_mat_t, res / noise_scale)
        lam = _cg_flat(a, dphi_dx, n, masks, t_h, t_v, inv_diag, cg_iters,
                       inv_m=_inv_m(a, inv_diag))
        # ∂Φ/∂a = −∇_a[λᵀ A(a) x]  (λ, x fixed):
        # face term t_f(a_i, a_j)(x_i−x_j)(λ_i−λ_j), harmonic-mean derivative
        # ∂t/∂a_i = 2h²(a_j/(a_i+a_j))², ∂t/∂a_j = 2h²(a_i/(a_i+a_j))²
        a_r, a_d = _shift_up(a, 1), _shift_up(a, n)
        den_h = 1.0 / (a + a_r + 1e-38)
        den_v = 1.0 / (a + a_d + 1e-38)
        s_h = (x - _shift_up(x, 1)) * (lam - _shift_up(lam, 1)) * masks["right"]
        s_v = (x - _shift_up(x, n)) * (lam - _shift_up(lam, n)) * masks["down"]
        g_a = (
            2.0 * h2 * jnp.square(a_r * den_h) * s_h
            + _shift_down(2.0 * h2 * jnp.square(a * den_h) * s_h, 1)
            + 2.0 * h2 * jnp.square(a_d * den_v) * s_v
            + _shift_down(2.0 * h2 * jnp.square(a * den_v) * s_v, n)
            + 2.0 * h2 * x * lam * masks["edge"]
        )
        g_loga = a * (-g_a)  # chain: a = exp(log a); sign from δΦ = −λᵀ δA x
        g_U = mm(basis, g_loga * t[None, :])  # (K, block)
        return (g_U,)

    phi.defvjp(phi_fwd, phi_bwd)
    return phi


def make_batched_misfit_warm(aux, data, noise_scale, cg_iters: int = 16,
                             log_a_mean: float = 0.0, precond: str = "jacobi",
                             precond_modes: int = 128,
                             mixed_precision: str = "none"):
    """WARM-STARTED batched misfit for the fused pCN path: ``phi2(U, x0) ->
    (phi, x)`` where ``x0`` is the CG start (the chain's previous accepted
    solution) and ``x`` the converged pressure, carried in the kernel state
    (ROADMAP P1). pCN proposals are local, so starting CG at the current
    solution cuts the iteration count ~2-3× at equal residual (measured:
    warm-16 ≲ cold-32). The potential then depends weakly on the chain
    history through ``x0`` (solver error ~1e-4 relative ≪ observation
    noise); exactness-critical runs should keep the cold path or pair the
    warm one with delayed acceptance.

    ``precond="dst"``: fast-Poisson preconditioning via flat Kronecker-factor
    matmuls (bf16) — warm-4 DST beats warm-16 Jacobi in residual, so the
    stencil iteration count drops ~4× (the headline-bench configuration).
    The dense factors are O(n⁴)-cost and outgrow on-chip memory past n = 16.

    ``precond="dst_trunc"``: the two-level truncated spectral preconditioner
    (``_flat_truncated_dst_preconditioner``) — ``precond_modes`` lowest sine
    modes as tall-skinny matmuls + the Jacobi diagonal. The fused-kernel
    DST option that SCALES: O(K·n²) per apply, (n², K) factors; use for
    n ≥ 32 (round-1 VERDICT item 6).

    ``mixed_precision`` (round-4 VERDICT item 5 — one measured lever on the
    elementwise-bound post-swap kernel): "none" (f32 everywhere, the shipping
    default), "recon" (KL field reconstruction matmul with bf16 inputs /
    f32 accumulation — matmul at 2× rate, exp stays f32), or "recon+op"
    (additionally the CG operator apply — transmissibilities and stencil
    fluxes — in bf16, with CG vectors, reductions and axpy updates kept
    f32). Gated like every kernel swap: accept/warm-Φ/moment parity in
    ``benchmarks/darcy16_bf16.py``; ships only on ≥10%% steps/s at parity.

    Returns (phi2, aux_dim) with aux_dim = n² (the carried solution rows).
    """
    data = jnp.asarray(data, jnp.float32)
    noise_scale = jnp.asarray(noise_scale, jnp.float32)
    if noise_scale.ndim == 1:
        # per-observation scales (e.g. discrepancy-inflated calibrated
        # surrogates): column-shape so they broadcast over (m, block)
        noise_scale = noise_scale[:, None]
    basis = aux["scaled_basis"]
    basis_t = jnp.asarray(np.asarray(basis).T)  # eager: no in-kernel transpose
    obs = np.asarray(aux["obs_indices"])
    f = jnp.asarray(aux["source"]).reshape(-1, 1)
    n = int(aux["n_grid"])
    masks = _flat_masks(n)
    obs_mat = np.zeros((len(obs), n * n), np.float32)
    obs_mat[np.arange(len(obs)), obs] = 1.0
    obs_mat = jnp.asarray(obs_mat)

    if precond not in ("jacobi", "dst", "dst_trunc"):
        raise ValueError(
            f"precond must be 'jacobi', 'dst' or 'dst_trunc', got {precond!r}"
        )
    if mixed_precision not in ("none", "recon", "recon+op"):
        raise ValueError(
            "mixed_precision must be 'none', 'recon' or 'recon+op', got "
            f"{mixed_precision!r}"
        )
    bf16 = jnp.bfloat16
    basis_t16 = basis_t.astype(bf16) if mixed_precision != "none" else None

    def phi2(U, x0):  # (K, block), (n², block) -> ((block,), (n², block))
        block = U.shape[1]
        if mixed_precision != "none":
            log_a = log_a_mean + jax.lax.dot(
                basis_t16, U.astype(bf16),
                preferred_element_type=jnp.float32,
            )
        else:
            log_a = log_a_mean + mm(basis_t, U)
        a = jnp.exp(log_a)
        t_h, t_v = _flat_transmissibilities(a, n, masks)
        apply_fn = None
        if mixed_precision == "recon+op":
            h2 = float(n * n)
            a16 = a.astype(bf16)
            th16, tv16 = t_h.astype(bf16), t_v.astype(bf16)
            edge16 = (2.0 * h2 * masks["edge"]).astype(bf16) * a16

            def apply_fn(p):
                p16 = p.astype(bf16)
                flux_h = th16 * (p16 - _shift_up(p16, 1))
                flux_v = tv16 * (p16 - _shift_up(p16, n))
                out = (flux_h - _shift_down(flux_h, 1)
                       + flux_v - _shift_down(flux_v, n)
                       + edge16 * p16)
                return out.astype(jnp.float32)

        b = jnp.broadcast_to(f, (n * n, block))
        if precond == "dst":
            # NB: no Jacobi diagonal here — it would be dead work
            inv_m = _flat_dst_preconditioner(n, a)
            inv_diag = None
        elif precond == "dst_trunc":
            inv_diag = 1.0 / _operator_diagonal_flat(a, n, masks, t_h, t_v)
            inv_m = _flat_truncated_dst_preconditioner(
                n, a, inv_diag, precond_modes
            )
        else:
            inv_m = None
            inv_diag = 1.0 / _operator_diagonal_flat(a, n, masks, t_h, t_v)
        x = _cg_flat(a, b, n, masks, t_h, t_v, inv_diag, cg_iters, x0=x0,
                     inv_m=inv_m, apply_fn=apply_fn)
        pred = mm(obs_mat, x)
        res = (data[:, None] - pred) / noise_scale
        return 0.5 * jnp.sum(res * res, axis=0), x

    return phi2, n * n


def make_batched_misfit_mala_warm(aux, data, noise_scale, cg_iters: int = 8,
                                  log_a_mean: float = 0.0,
                                  precond: str = "dst",
                                  precond_modes: int = 128):
    """Warm-started value-AND-GRADIENT batched misfit for fused MALA:
    ``pag(U, aux0) -> (phi, grad, aux_out)`` where aux0 stacks the previous
    accepted state's forward solution x AND adjoint solution λ
    ((2n², block)); both solves warm-start from them, cutting the two CG
    loops to ``cg_iters`` each (vs 48 cold). The gradient is the explicit
    adjoint method (same math as make_batched_misfit(differentiable=True)'s
    custom_vjp, written out so the solutions can be carried).

    Returns (pag, aux_dim = 2n²).
    """
    data = jnp.asarray(data, jnp.float32)
    noise_scale = jnp.asarray(noise_scale, jnp.float32)
    if noise_scale.ndim == 1:
        # per-observation scales (e.g. discrepancy-inflated calibrated
        # surrogates): column-shape so they broadcast over (m, block)
        noise_scale = noise_scale[:, None]
    basis = aux["scaled_basis"]
    basis_t = jnp.asarray(np.asarray(basis).T)
    obs = np.asarray(aux["obs_indices"])
    f = jnp.asarray(aux["source"]).reshape(-1, 1)
    n = int(aux["n_grid"])
    masks = _flat_masks(n)
    obs_mat = np.zeros((len(obs), n * n), np.float32)
    obs_mat[np.arange(len(obs)), obs] = 1.0
    obs_mat_t = jnp.asarray(obs_mat.T.copy())
    obs_mat = jnp.asarray(obs_mat)
    if precond not in ("jacobi", "dst", "dst_trunc"):
        raise ValueError(
            f"precond must be 'jacobi', 'dst' or 'dst_trunc', got {precond!r}"
        )
    N = n * n

    def pag(U, aux0):  # (K, block), (2n², block)
        block = U.shape[1]
        log_a = log_a_mean + mm(basis_t, U)
        a = jnp.exp(log_a)
        t_h, t_v = _flat_transmissibilities(a, n, masks)
        if precond == "dst":
            inv_m = _flat_dst_preconditioner(n, a)
            inv_diag = None
        elif precond == "dst_trunc":
            # the n ≥ 32 option: tall-skinny spectral two-level apply (the
            # same inv_m serves BOTH the forward and adjoint solves below)
            inv_diag = 1.0 / _operator_diagonal_flat(a, n, masks, t_h, t_v)
            inv_m = _flat_truncated_dst_preconditioner(
                n, a, inv_diag, precond_modes
            )
        else:
            inv_m = None
            inv_diag = 1.0 / _operator_diagonal_flat(a, n, masks, t_h, t_v)
        b = jnp.broadcast_to(f, (N, block))
        x = _cg_flat(a, b, n, masks, t_h, t_v, inv_diag, cg_iters,
                     x0=aux0[:N], inv_m=inv_m)
        pred = mm(obs_mat, x)
        res = (data[:, None] - pred) / noise_scale
        phi = 0.5 * jnp.sum(res * res, axis=0)

        # adjoint solve, warm-started from the carried λ
        dphi_dx = -mm(obs_mat_t, res / noise_scale)
        lam = _cg_flat(a, dphi_dx, n, masks, t_h, t_v, inv_diag, cg_iters,
                       x0=aux0[N:], inv_m=inv_m)
        # ∂Φ/∂a = −∇_a[λᵀ A(a) x] (see make_batched_misfit's phi_bwd)
        h2 = float(n * n)
        a_r, a_d = _shift_up(a, 1), _shift_up(a, n)
        den_h = 1.0 / (a + a_r + 1e-38)
        den_v = 1.0 / (a + a_d + 1e-38)
        s_h = (x - _shift_up(x, 1)) * (lam - _shift_up(lam, 1)) * masks["right"]
        s_v = (x - _shift_up(x, n)) * (lam - _shift_up(lam, n)) * masks["down"]
        g_a = (
            2.0 * h2 * jnp.square(a_r * den_h) * s_h
            + _shift_down(2.0 * h2 * jnp.square(a * den_h) * s_h, 1)
            + 2.0 * h2 * jnp.square(a_d * den_v) * s_v
            + _shift_down(2.0 * h2 * jnp.square(a * den_v) * s_v, n)
            + 2.0 * h2 * x * lam * masks["edge"]
        )
        grad = mm(basis, a * (-g_a))  # (K, block)
        return phi, grad, jnp.concatenate([x, lam], axis=0)

    return pag, 2 * N


def choose_pod_rank(singular_values, energy_tol: float = 1e-6,
                    min_rank: int = 2, max_rank=None):
    """Energy criterion for the POD rank (ROADMAP P2): the smallest r whose
    DISCARDED squared-singular-value mass is below ``energy_tol`` of the
    total — i.e. the snapshot set is reproduced to relative L2 energy error
    √energy_tol by the rank-r basis. Static Python int (offline)."""
    s2 = np.square(np.asarray(singular_values, np.float64))
    if s2.size == 0 or s2.sum() <= 0:
        raise ValueError("singular values must be a nonempty positive set")
    tail = 1.0 - np.cumsum(s2) / s2.sum()
    r = int(np.searchsorted(-tail, -energy_tol) + 1)
    r = max(r, int(min_rank))
    if max_rank is not None:
        r = min(r, int(max_rank))
    return min(r, int(s2.size))


def make_pod_surrogate(aux, data, noise_scale, key, n_snapshots: int = 64,
                       rank=20, log_a_mean: float = 0.0,
                       prior_scale=None, energy_tol: float = 1e-6,
                       greedy_rounds: int = 0, n_candidates: int = 128,
                       greedy_batch: int = 8, return_info: bool = False):
    """Data-driven reduced-order misfit (PAPERS.md: Cui–Marzouk–Willcox
    1403.4290 — model reduction for Bayesian inversion): OFFLINE, solve the
    full Darcy problem at ``n_snapshots`` prior draws and take the rank-r
    POD (SVD) basis V of the pressure snapshots; ONLINE, Galerkin-project
    each chain's operator onto V — solve the tiny dense SPD system
    (Vᵀ A(a) V) c = Vᵀ f (one batched r×r Cholesky) instead of the n²
    grid solve.

    Cost per evaluation: r stencil applies + one (r, n²)·(n², r) matmul
    contraction + an r×r solve — vs cg_iters stencil applies for the full
    model. Any surrogate error is REMOVED by delayed acceptance
    (``kernels.da_pcn``): use this as the ``surrogate_fn``.

    ``rank="auto"`` sizes the basis with ``choose_pod_rank(energy_tol)``
    from the snapshot spectrum. ``greedy_rounds > 0`` enriches the snapshot
    set by the WEAK-GREEDY reduced-basis recipe: each round draws
    ``n_candidates`` fresh prior points, scores them with the CHEAP reduced
    RESIDUAL indicator ‖A(a) V c − f‖ / ‖f‖ (r stencil applies each — no
    full solve), and runs full solves only for the ``greedy_batch`` worst,
    appending them as snapshots. That targets offline work at the prior
    regions the current basis covers worst, instead of spending every full
    solve on i.i.d. draws.

    Returns phi_r(u): (K,) → scalar, vmappable — or ``(phi_r, info)`` when
    ``return_info`` (info: chosen rank, singular values, per-round max/mean
    residual indicators — the error history that justifies the rank).
    """
    data = jnp.asarray(data, jnp.float32)
    noise_scale = jnp.asarray(noise_scale, jnp.float32)
    basis = aux["scaled_basis"]  # (K, n²)
    n = int(aux["n_grid"])
    f = jnp.asarray(aux["source"]).reshape(-1)
    obs_indices = aux["obs_indices"]
    K = basis.shape[0]

    # ---- offline: snapshots at prior draws, POD via SVD ----
    if prior_scale is None:
        prior_scale = jnp.ones((K,), jnp.float32)
    prior_scale = jnp.asarray(prior_scale)
    key, key0 = jax.random.split(jax.random.key(key) if isinstance(key, int)
                                 else key)
    draws = prior_scale * jax.random.normal(key0, (n_snapshots, K))

    def full_solve(u):
        a = jnp.exp(log_a_mean + u @ basis).reshape(n, n)
        return solve_cg(a, f, n, n_iters=120, precond="dst")

    full_solve_v = jax.jit(jax.vmap(full_solve))
    snapshots = full_solve_v(draws)  # (S, n²)

    def _pod(snaps):
        _, s, vt = jnp.linalg.svd(snaps, full_matrices=False)
        r = (choose_pod_rank(s, energy_tol, max_rank=snaps.shape[0])
             if rank == "auto" else int(rank))
        return vt[:r].T, s, r  # V: (n², r) orthonormal columns

    def _reduced_residual(V, u):
        """‖A(a) V c − f‖/‖f‖ for the reduced solution c — the classic RB
        a-posteriori indicator, no full solve needed."""
        a = jnp.exp(log_a_mean + u @ basis).reshape(n, n)
        AV = jax.vmap(
            lambda col: apply_operator(a, col.reshape(n, n), n).reshape(-1),
            in_axes=1, out_axes=1,
        )(V)
        Ar = V.T @ AV
        L = jnp.linalg.cholesky(Ar)
        c = jax.scipy.linalg.cho_solve((L, True), V.T @ f)
        return jnp.linalg.norm(AV @ c - f) / jnp.linalg.norm(f)

    residual_history = []
    for _ in range(int(greedy_rounds)):
        V, s, r = _pod(snapshots)
        key, key_c = jax.random.split(key)
        cands = prior_scale * jax.random.normal(key_c, (n_candidates, K))
        res = jax.jit(jax.vmap(lambda u: _reduced_residual(V, u)))(cands)
        res_np = np.asarray(res)
        residual_history.append(
            {"max": float(res_np.max()), "mean": float(res_np.mean())}
        )
        worst = np.argsort(res_np)[-int(greedy_batch):]
        snapshots = jnp.concatenate(
            [snapshots, full_solve_v(cands[worst])], axis=0
        )

    V, s, r = _pod(snapshots)
    Vt_f = V.T @ f  # (r,)
    obs_V = V[obs_indices]  # (m, r)

    def phi_r(u):
        a = jnp.exp(log_a_mean + u @ basis).reshape(n, n)
        AV = jax.vmap(
            lambda col: apply_operator(a, col.reshape(n, n), n).reshape(-1),
            in_axes=1, out_axes=1,
        )(V)  # (n², r): r stencil applies
        Ar = V.T @ AV  # (r, r) — Galerkin projection, SPD
        L = jnp.linalg.cholesky(Ar)
        c = jax.scipy.linalg.cho_solve((L, True), Vt_f)
        pred = obs_V @ c
        res = (data - pred) / noise_scale
        return 0.5 * jnp.sum(res * res)

    if return_info:
        info = {
            "rank": int(r),
            "n_snapshots": int(snapshots.shape[0]),
            "singular_values": np.asarray(s),
            "residual_history": residual_history,
        }
        return phi_r, info
    return phi_r


def make_pod_surrogate_online(aux, data, noise_scale, key,
                              n_snapshots: int = 24, rank="auto",
                              log_a_mean: float = 0.0, prior_scale=None,
                              energy_tol: float = 1e-6,
                              enrich_batch: int = 8):
    """ONLINE-enrichable POD surrogate (ROADMAP P2's last unbuilt lever;
    round-3 VERDICT item 6): like :func:`make_pod_surrogate`, but returns
    ``(phi_r, enrich)`` where ``enrich(positions) -> (phi_r', stats)``
    rebuilds the basis with full solves at the ``enrich_batch`` WORST
    chain positions by the reduced-residual indicator ‖A(a)Vc − f‖/‖f‖.

    The point over offline weak-greedy enrichment: chain positions are
    POSTERIOR-typical, so enrichment targets exactly the region the chain
    actually visits — prior-draw snapshots overcover the prior's bulk and
    undercover the (data-shrunk) posterior. The runner calls ``enrich``
    between burn-in segments and FREEZES the surrogate before any recorded
    sample (the repo's freeze-after-warmup discipline), so the recorded
    chain is a plain time-homogeneous DA kernel — and the DA correction
    makes the posterior exact for ANY frozen surrogate regardless of how
    it was built; enrichment only moves the surrogate's efficiency
    (subchain acceptance), never the target. ``stats`` reports the
    indicator max/mean over the scored positions BEFORE enrichment — the
    decreasing sequence that justifies the mechanism (test_da_pcn).
    """
    data_j = jnp.asarray(data, jnp.float32)
    noise_scale_j = jnp.asarray(noise_scale, jnp.float32)
    basis = aux["scaled_basis"]
    n = int(aux["n_grid"])
    f = jnp.asarray(aux["source"]).reshape(-1)
    obs_indices = aux["obs_indices"]
    K = basis.shape[0]
    if prior_scale is None:
        prior_scale = jnp.ones((K,), jnp.float32)
    prior_scale = jnp.asarray(prior_scale)
    key = jax.random.key(key) if isinstance(key, int) else key
    draws = prior_scale * jax.random.normal(key, (n_snapshots, K))

    def full_solve(u):
        a = jnp.exp(log_a_mean + u @ basis).reshape(n, n)
        return solve_cg(a, f, n, n_iters=120, precond="dst")

    full_solve_v = jax.jit(jax.vmap(full_solve))
    # snapshots live as host numpy: the config builder runs CPU-pinned while
    # enrichment runs on the session's default backend — mixing committed
    # arrays from both in one concatenate would be a cross-device error
    state = {"snapshots": np.asarray(full_solve_v(draws))}

    def _build():
        _, s, vt = jnp.linalg.svd(jnp.asarray(state["snapshots"]),
                                  full_matrices=False)
        r = (choose_pod_rank(s, energy_tol,
                             max_rank=state["snapshots"].shape[0])
             if rank == "auto" else int(rank))
        V = vt[:r].T
        Vt_f = V.T @ f
        obs_V = V[np.asarray(obs_indices)]

        def phi_r(u):
            a = jnp.exp(log_a_mean + u @ basis).reshape(n, n)
            AV = jax.vmap(
                lambda col: apply_operator(a, col.reshape(n, n), n).reshape(-1),
                in_axes=1, out_axes=1,
            )(V)
            Ar = V.T @ AV
            L = jnp.linalg.cholesky(Ar)
            c = jax.scipy.linalg.cho_solve((L, True), Vt_f)
            pred = obs_V @ c
            res = (data_j - pred) / noise_scale_j
            return 0.5 * jnp.sum(res * res)

        def indicator(u):
            a = jnp.exp(log_a_mean + u @ basis).reshape(n, n)
            AV = jax.vmap(
                lambda col: apply_operator(a, col.reshape(n, n), n).reshape(-1),
                in_axes=1, out_axes=1,
            )(V)
            Ar = V.T @ AV
            L = jnp.linalg.cholesky(Ar)
            c = jax.scipy.linalg.cho_solve((L, True), Vt_f)
            return jnp.linalg.norm(AV @ c - f) / jnp.linalg.norm(f)

        return phi_r, jax.jit(jax.vmap(indicator))

    phi_r, indicator_v = _build()

    def enrich(positions):
        """positions: (n_chains, K) current chain states. Scores them with
        the residual indicator, full-solves the worst ``enrich_batch``,
        appends snapshots, rebuilds. Returns (new_phi_r, stats)."""
        nonlocal phi_r, indicator_v
        res = np.asarray(indicator_v(jnp.asarray(positions)))
        stats = {"indicator_max": float(res.max()),
                 "indicator_mean": float(res.mean()),
                 "n_snapshots": int(state["snapshots"].shape[0])}
        worst = np.argsort(res)[-int(enrich_batch):]
        new_snaps = np.asarray(full_solve_v(jnp.asarray(positions)[worst]))
        state["snapshots"] = np.concatenate(
            [state["snapshots"], new_snaps], axis=0
        )
        phi_r, indicator_v = _build()
        return phi_r, stats

    return phi_r, enrich


def solve_pressure(u, aux, log_a_mean: float = 0.0):
    """Full pressure field for a coefficient vector (diagnostics/plots)."""
    n = aux["n_grid"]
    log_a = log_a_mean + u @ aux["scaled_basis"]
    a = jnp.exp(log_a).reshape(n, n)
    A = assemble_operator(a, aux["stencil_indices"], n)
    L = jnp.linalg.cholesky(A)
    return jax.scipy.linalg.cho_solve((L, True), aux["source"]).reshape(n, n)
