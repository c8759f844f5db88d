"""Burgers' equation forward model: u_t + (u²/2)_x = 0, finite-volume Godunov.

The reference's headline experiment class: inversion of uncertain initial
data for a hyperbolic conservation law with a Godunov-type FV solver
(SURVEY.md §1.1/§3.4 [M]). Shock formation makes this forward map
NON-differentiable — use the derivative-free kernels (RWM/pCN) on it, exactly
as the reference does (SURVEY.md §7.3 item 3).

Accelerator design: the time loop is ``lax.scan`` with a STATIC step count
(dt fixed by a CFL bound on the prior's amplitude range — no data-dependent
shapes), the flux sweep is pure elementwise work on the (n_cells,) state
(and vmaps over chains into (chains, n_cells) — wide batches), periodic BC
via ``jnp.roll``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ip_mcmc_tpu.models import kl
from ip_mcmc_tpu.precision import mm


def godunov_flux2(u_left, u_right):
    """TWICE the exact Godunov flux for f(u) = u²/2:
    2F = max( max(u_l, 0)², min(u_r, 0)² ).

    The ½ is algebraically hoisted out of the per-face max (0.5·max(a,b) ≡
    max(0.5a, 0.5b), exactly in fp) and folded into the time-step constant
    by callers — two fewer multiplies per cell per CFL step in the hot
    FV loop (~18% of the stencil's op count)."""
    fl = jnp.square(jnp.maximum(u_left, 0.0))
    fr = jnp.square(jnp.minimum(u_right, 0.0))
    return jnp.maximum(fl, fr)


def godunov_flux(u_left, u_right):
    """Exact Godunov flux for the convex flux f(u) = u²/2:
    F = max( f(max(u_l, 0)), f(min(u_r, 0)) )."""
    return 0.5 * godunov_flux2(u_left, u_right)


def step_burgers(state, dt_over_h):
    """One periodic FV step: u_i -= dt/h (F_{i+1/2} − F_{i−1/2}).
    Cell axis is the LAST axis — works on (n,) or batched (chains, n)."""
    u_right = jnp.roll(state, -1, axis=-1)
    flux2_right = godunov_flux2(state, u_right)  # 2·F_{i+1/2}
    flux2_left = jnp.roll(flux2_right, 1, axis=-1)  # 2·F_{i−1/2}
    return state - (0.5 * dt_over_h) * (flux2_right - flux2_left)


def integrate(u0, dt, n_steps, record_every=0):
    """Integrate n_steps with cell width h = 1/n_cells.

    record_every=0: return final state only. Otherwise also return the
    recorded trajectory every ``record_every`` steps (static count).
    """
    n_cells = u0.shape[-1]
    dt_over_h = dt * n_cells

    if record_every == 0:
        def body(state, _):
            return step_burgers(state, dt_over_h), None

        final, _ = jax.lax.scan(body, u0, None, length=n_steps)
        return final

    def body(state, i):
        new = step_burgers(state, dt_over_h)
        return new, new

    final, traj = jax.lax.scan(body, u0, jnp.arange(n_steps))
    return final, traj[record_every - 1 :: record_every]


def make_burgers_forward(
    n_cells: int = 128,
    n_modes: int = 16,
    alpha: float = 1.5,
    field_scale: float = 2.0,
    t_final: float = 0.3,
    cfl_amax: float = 3.0,
    obs_indices=None,
    mean_profile=None,
    obs_times=None,
):
    """Build forward(u): KL coefficients (whitened) → solution at
    observation cells, at ``t_final`` or at each of ``obs_times``.

    Initial data: u0(x) = mean_profile(x) + Σ u_k √λ_k φ_k(x) (periodic
    Fourier basis). ``cfl_amax`` bounds |u| for the static CFL time step:
    dt = CFL·h/amax with CFL=0.5 — keep the prior scale consistent with it.

    ``obs_times``: optional increasing physical times (≤ t_final); the
    forward returns the CONCATENATION of the observed cells at each time
    (reference parity: ``EvolutionPotential`` observes the evolution at
    times AND points, SURVEY.md §2.1). Times snap to the static CFL grid;
    the time loop runs as one ``lax.scan`` per inter-observation segment —
    static shapes throughout.
    """
    centers = (np.arange(n_cells) + 0.5) / n_cells
    basis_np = kl.fourier_basis(n_modes, centers)
    k_eff = np.maximum(1, (np.arange(n_modes) + 1) // 2)  # mode frequency
    lam = field_scale * (2.0 * np.pi * k_eff) ** (-2.0 * alpha)
    scaled_basis = jnp.asarray(np.sqrt(lam)[:, None] * basis_np, dtype=jnp.float32)
    if mean_profile is None:
        mean = jnp.zeros(n_cells, dtype=jnp.float32)
    else:
        mean = jnp.asarray(mean_profile, dtype=jnp.float32)
    h = 1.0 / n_cells
    dt = 0.5 * h / cfl_amax
    n_steps = int(np.ceil(t_final / dt))
    dt = t_final / n_steps  # hit t_final exactly, still CFL-safe
    if obs_indices is None:
        obs_indices = np.linspace(0, n_cells - 1, 16).round().astype(int)
    obs_indices = jnp.asarray(np.asarray(obs_indices))

    if obs_times is None:
        segment_steps = [n_steps]
    else:
        ts = np.asarray(obs_times, float)
        if not (np.all(np.diff(ts) > 0) and ts[0] > 0 and ts[-1] <= t_final + 1e-9):
            raise ValueError(
                f"obs_times must be increasing in (0, t_final={t_final}], got {ts}"
            )
        step_idx = np.clip(np.round(ts / dt).astype(int), 1, n_steps)
        if len(np.unique(step_idx)) != len(step_idx):
            raise ValueError(f"obs_times collapse onto the same CFL steps: {step_idx}")
        segment_steps = np.diff(np.concatenate([[0], step_idx])).tolist()

    def forward(u):
        state = mean + mm(u, scaled_basis)
        outs = []
        for seg in segment_steps:  # static unroll: ≤ len(obs_times) scans
            state = integrate(state, dt, int(seg))
            outs.append(state[obs_indices])
        return jnp.concatenate(outs)

    aux = {
        "scaled_basis": scaled_basis,
        "eigenvalues": jnp.asarray(lam),
        "obs_indices": obs_indices,
        "n_cells": n_cells,
        "dt": dt,
        "n_steps": n_steps,
        "mean": mean,
        "segment_steps": segment_steps,
    }
    return forward, aux


def make_batched_misfit(aux, data, noise_scale):
    """Batched misfit Φ for a FEATURES-FIRST (K, block) coefficient batch —
    the form consumed by ops.fused_pcn_chain: the ENTIRE FV time loop runs
    inside the fused engine with chains on the last axis (fields laid out
    (cells, block); the stencil rolls along the cell axis).
    """
    data = jnp.asarray(data, jnp.float32)
    # scalar or per-observation (m,) noise scale — a vector downweights
    # observations where a surrogate's discretization error is large
    # (two-level delayed acceptance; see configs.burgers_da_pcn)
    noise_scale = jnp.asarray(noise_scale, jnp.float32)
    if noise_scale.ndim == 1:
        noise_scale = noise_scale[:, None]  # broadcast over the chain block
    basis = aux["scaled_basis"]
    basis_t = jnp.asarray(np.asarray(basis).T)  # eager: no in-kernel transpose
    mean = aux["mean"]
    obs = np.asarray(aux["obs_indices"])
    dt = aux["dt"]
    segments = [int(s) for s in aux.get("segment_steps", [aux["n_steps"]])]
    n_cells = aux["n_cells"]
    dt_over_h = dt * n_cells
    # observation as a one-hot matmul (no gather in the fused step)
    obs_mat = np.zeros((len(obs), n_cells), np.float32)
    obs_mat[np.arange(len(obs)), obs] = 1.0
    obs_mat = jnp.asarray(obs_mat)

    def phi(U):  # (K, block) -> (block,)
        state = mean[:, None] + mm(basis_t, U)  # (cells, block)

        half_dt_over_h = 0.5 * dt_over_h  # ½ hoisted out of godunov_flux2

        def body(_, state):
            u_down = jnp.roll(state, -1, axis=0)
            flux2_down = godunov_flux2(state, u_down)
            flux2_up = jnp.roll(flux2_down, 1, axis=0)
            return state - half_dt_over_h * (flux2_down - flux2_up)

        preds = []
        for seg in segments:  # static unroll over observation times
            state = jax.lax.fori_loop(0, seg, body, state)
            preds.append(mm(obs_mat, state))  # (m, block)
        pred = jnp.concatenate(preds, axis=0)
        r = (data[:, None] - pred) / noise_scale
        return 0.5 * jnp.sum(r * r, axis=0)

    return phi
