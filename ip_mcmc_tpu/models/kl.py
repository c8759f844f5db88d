"""Karhunen–Loève expansion utilities for Gaussian random-field priors.

The reference represents unknown fields by truncated KL expansions of a
Gaussian prior (SURVEY.md §1.1 [H]): u(x) = Σ_k c_k √λ_k φ_k(x), with the
coefficients c ~ N(0, I) in whitened coordinates (equivalently c_k ~ N(0, λ_k)
with φ_k orthonormal). Samplers operate on the coefficient vector; the field
reconstruction is ONE matmul coeffs @ basis — exactly what the matrix units want, and
it batches over thousands of chains for free.

We use the Fourier sine/cosine eigenbasis on [0,1] (the KL basis of the
periodic / Dirichlet Laplacian-inverse-power covariance C = (−Δ)^{−α},
Stuart 2010 §2.4), with eigenvalues λ_k ∝ (πk)^{−2α}.
"""

from __future__ import annotations

import numpy as np


def sine_basis(n_modes: int, grid: np.ndarray) -> np.ndarray:
    """Orthonormal Dirichlet eigenfunctions φ_k(x)=√2 sin(kπx), k=1..n.

    Returns (n_modes, n_grid) — apply with ``coeffs @ basis``.
    """
    k = np.arange(1, n_modes + 1)[:, None]
    return np.sqrt(2.0) * np.sin(np.pi * k * grid[None, :])


def fourier_basis(n_modes: int, grid: np.ndarray) -> np.ndarray:
    """Orthonormal periodic basis: 1, √2 cos(2πx), √2 sin(2πx), ... ."""
    rows = [np.ones_like(grid)]
    j = 1
    while len(rows) < n_modes:
        rows.append(np.sqrt(2.0) * np.cos(2.0 * np.pi * j * grid))
        if len(rows) < n_modes:
            rows.append(np.sqrt(2.0) * np.sin(2.0 * np.pi * j * grid))
        j += 1
    return np.stack(rows[:n_modes])


def laplacian_eigenvalues(n_modes: int, alpha: float = 2.0, scale: float = 1.0):
    """λ_k = scale · (πk)^{−2α}: KL spectrum of C = scale·(−Δ)^{−α}."""
    k = np.arange(1, n_modes + 1)
    return scale * (np.pi * k) ** (-2.0 * alpha)


def sine_basis_2d(n_modes_per_dim: int, n_grid: int):
    """2-D tensor sine basis on the unit square, flattened.

    Returns (basis, eigen_index): basis is (K, n_grid*n_grid) with
    K = n_modes_per_dim², rows φ_{ij}(x,y) = 2 sin(iπx) sin(jπy) evaluated at
    cell centers; eigen_index is the (K, 2) array of (i, j) mode numbers for
    spectrum construction.
    """
    centers = (np.arange(n_grid) + 0.5) / n_grid
    b1 = np.sqrt(2.0) * np.sin(
        np.pi * np.arange(1, n_modes_per_dim + 1)[:, None] * centers[None, :]
    )  # (m, n)
    basis = np.einsum("ix,jy->ijxy", b1, b1).reshape(
        n_modes_per_dim * n_modes_per_dim, n_grid * n_grid
    )
    ij = np.stack(
        np.meshgrid(
            np.arange(1, n_modes_per_dim + 1),
            np.arange(1, n_modes_per_dim + 1),
            indexing="ij",
        ),
        axis=-1,
    ).reshape(-1, 2)
    return basis, ij


def laplacian_eigenvalues_2d(eigen_index: np.ndarray, alpha: float = 2.0, scale: float = 1.0):
    """λ_{ij} = scale · (π²(i²+j²))^{−α} for the 2-D tensor modes."""
    k2 = np.pi**2 * (eigen_index[:, 0] ** 2 + eigen_index[:, 1] ** 2)
    return scale * k2 ** (-alpha)


def matern_eigenvalues(
    n_modes: int,
    nu: float = 1.5,
    lengthscale: float = 0.2,
    variance: float = 1.0,
):
    """Matérn(ν, ℓ) KL spectrum for the 1-D sine basis on [0, 1].

    SPDE characterization (Whittle–Matérn, Lindgren–Rue–Lindström 2011): a
    Matérn field solves (κ² − Δ)^{(ν + d/2)/2} u = W with κ = √(2ν)/ℓ, so in
    the Laplacian eigenbasis (sine modes, eigenfrequency πk) the covariance
    eigenvalues are λ_k ∝ (κ² + (πk)²)^{−(ν + d/2)}, normalized here so that
    Σλ_k · E[φ_k²] integrates to ``variance`` on average over the domain
    (E[φ_k²] = 1 for the orthonormal basis ⇒ Σλ_k = variance · dim-factor).
    """
    k = np.arange(1, n_modes + 1)
    kappa2 = 2.0 * nu / (lengthscale * lengthscale)
    raw = (kappa2 + (np.pi * k) ** 2) ** (-(nu + 0.5))
    return variance * raw / raw.sum()


def matern_eigenvalues_2d(
    eigen_index: np.ndarray,
    nu: float = 1.5,
    lengthscale: float = 0.2,
    variance: float = 1.0,
):
    """Matérn(ν, ℓ) KL spectrum for the 2-D tensor sine modes (d = 2):
    λ_{ij} ∝ (κ² + π²(i²+j²))^{−(ν + 1)}, normalized to total ``variance``."""
    kappa2 = 2.0 * nu / (lengthscale * lengthscale)
    k2 = np.pi**2 * (eigen_index[:, 0] ** 2 + eigen_index[:, 1] ** 2)
    raw = (kappa2 + k2) ** (-(nu + 1.0))
    return variance * raw / raw.sum()


def matern_covariance(x: np.ndarray, y: np.ndarray = None, nu: float = 1.5,
                      lengthscale: float = 0.2, variance: float = 1.0):
    """Dense Matérn covariance matrix k(x, y) for ν ∈ {1/2, 3/2, 5/2, ∞}.

    ``x``/``y``: (n,) or (n, d) point arrays. The closed-form Matérn family —
    the reference's function-space priors are this class of GP covariance
    (Stuart 2010 §2); ν=∞ gives the squared-exponential limit.
    """
    x = np.atleast_2d(np.asarray(x, float).T).T
    y = x if y is None else np.atleast_2d(np.asarray(y, float).T).T
    r = np.sqrt(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1))
    s = r / lengthscale
    if nu == 0.5:
        c = np.exp(-s)
    elif nu == 1.5:
        a = np.sqrt(3.0) * s
        c = (1.0 + a) * np.exp(-a)
    elif nu == 2.5:
        a = np.sqrt(5.0) * s
        c = (1.0 + a + a * a / 3.0) * np.exp(-a)
    elif nu == np.inf:
        c = np.exp(-0.5 * s * s)
    else:
        raise ValueError(f"closed-form Matérn needs nu in {{0.5, 1.5, 2.5, inf}}, got {nu}")
    return variance * c


def kl_from_covariance(cov: np.ndarray, n_modes: int):
    """Numerical KL decomposition of an arbitrary dense covariance matrix.

    Returns (basis (n_modes, n_points), eigenvalues (n_modes,)) — the leading
    eigenpairs, eigenvalues descending, basis rows orthonormal. Use when the
    prior covariance has no analytic eigenbasis (non-stationary kernels,
    irregular grids): ``field = (coeffs * sqrt(eigenvalues)) @ basis``.
    """
    cov = np.asarray(cov, float)
    w, v = np.linalg.eigh(cov)  # ascending
    order = np.argsort(w)[::-1][:n_modes]
    lam = np.clip(w[order], 0.0, None)
    return v[:, order].T.copy(), lam
