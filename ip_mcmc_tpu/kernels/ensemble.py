"""Functional ensemble sampler (FES): affine-invariant ensemble moves on
the leading KL modes + pCN on the complement.

Beyond-reference capability from the retrieved literature (PAPERS.md:
Coullon & Webber 2020, "Ensemble sampler for infinite-dimensional inverse
problems", arXiv:2010.15181): the affine-invariant stretch move (Goodman &
Weare 2010, emcee) self-tunes to anisotropic/correlated posteriors with NO
proposal covariance to adapt — but degenerates with dimension, so FES
restricts it to the first ``n_low_modes`` whitened KL coordinates and
updates the complement with dimension-robust pCN.

Accelerator mapping: the walker ensemble IS the chain axis. The parallel stretch
move uses the red-black (two half-ensemble) scheme — half A proposes with
partners gathered from half B and vice versa, so the whole update is two
batched potential evaluations plus one gather (which lowers to a collective
when the walker axis is sharded). Everything is batch-level jnp — one
compiled program, no per-walker Python.

Whitened coordinates assumed (prior N(mean, scale²) diagonal — the KL
parameterization every config here uses).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ip_mcmc_tpu.utils.struct import pytree_dataclass


def choose_n_low_modes(eigenvalues, energy_frac=0.9, min_modes=2,
                       max_modes=None):
    """Spectral-energy criterion for the stretch-move dimension (ROADMAP P2):
    the smallest M whose leading-M KL eigenvalue mass reaches ``energy_frac``
    of the total spectrum. The affine move pays per dimension — its expected
    acceptance degrades as the stretch block grows (Coullon–Webber 2020 §3,
    PAPERS.md) — so it should span exactly the modes that carry the field's
    energy; the dimension-robust pCN complement absorbs the tail.

    ``eigenvalues``: the KL spectrum of the underlying field (e.g. Darcy's
    ``aux["eigenvalues"]``), NOT the whitened sampler-side prior scale (which
    is isotropic by construction and carries no mode preference). Returns a
    static Python int — call before ``build_kernel`` (M is a compile-time
    constant in both the scan and fused kernels)."""
    lam = np.sort(np.asarray(eigenvalues, dtype=np.float64))[::-1]
    if lam.size == 0 or not np.all(np.isfinite(lam)) or np.any(lam < 0):
        raise ValueError("eigenvalues must be a finite nonnegative spectrum")
    total = lam.sum()
    if total <= 0:
        raise ValueError("eigenvalue spectrum sums to zero")
    frac = np.cumsum(lam) / total
    m = int(np.searchsorted(frac, energy_frac) + 1)
    m = max(m, int(min_modes))
    if max_modes is not None:
        m = min(m, int(max_modes))
    return min(m, int(lam.size))


@pytree_dataclass
class FESState:
    positions: jnp.ndarray  # (L, d) walkers
    potentials: jnp.ndarray  # (L,) cached Φ


@pytree_dataclass
class FESInfo:
    stretch_accept: jnp.ndarray  # mean acceptance of the affine move
    pcn_accept: jnp.ndarray  # mean acceptance of the complement move


def init(positions, potential_fn):
    positions = jnp.asarray(positions)
    return FESState(
        positions=positions, potentials=jax.vmap(potential_fn)(positions)
    )


def _sample_stretch(key, n, a):
    """z ~ g(z) ∝ 1/√z on [1/a, a] (Goodman–Weare): z = ((a−1)u + 1)²/a."""
    u = jax.random.uniform(key, (n,))
    return jnp.square((a - 1.0) * u + 1.0) / a


def build_kernel(potential_fn, prior, n_low_modes, stretch_a=2.0,
                 pcn_beta=0.2):
    """One FES transition on the WHOLE ensemble (batch-level kernel):
    red-black affine stretch on coords [:n_low_modes] + pCN on the rest.
    Requires an even number of walkers; ≥ 2·n_low_modes walkers recommended
    (the affine move spans the ensemble's low-mode hull)."""
    if not 0 < n_low_modes:
        raise ValueError(f"n_low_modes must be positive, got {n_low_modes}")
    M = n_low_modes

    def whiten(u):
        return (u - prior.mean) / prior.scale

    def unwhiten(w):
        return prior.mean + prior.scale * w

    def half_stretch(key, movers, movers_phi, anchors):
        """Stretch-move half an ensemble using partners from the other half.
        movers: (h, d) positions (unwhitened); anchors: (h_other, d)."""
        h = movers.shape[0]
        key_pick, key_z, key_acc = jax.random.split(key, 3)
        pick = jax.random.randint(key_pick, (h,), 0, anchors.shape[0])
        partners = anchors[pick]
        z = _sample_stretch(key_z, h, stretch_a)
        w_m, w_p = whiten(movers), whiten(partners)
        v_low = w_p[:, :M] + z[:, None] * (w_m[:, :M] - w_p[:, :M])
        v = unwhiten(jnp.concatenate([v_low, w_m[:, M:]], axis=1))
        phi_v = jax.vmap(potential_fn)(v)
        # prior terms on the unchanged complement cancel; on the low block:
        d_prior = 0.5 * (
            jnp.sum(jnp.square(v_low), axis=1)
            - jnp.sum(jnp.square(w_m[:, :M]), axis=1)
        )
        log_ratio = (M - 1) * jnp.log(z) - (phi_v - movers_phi) - d_prior
        log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
        log_u = jnp.log(jax.random.uniform(key_acc, (h,)))
        acc = log_u < log_ratio
        return (
            jnp.where(acc[:, None], v, movers),
            jnp.where(acc, phi_v, movers_phi),
            acc,
        )

    contraction = jnp.sqrt(1.0 - pcn_beta * pcn_beta)

    def kernel(key, state):
        L = state.positions.shape[0]
        h = L // 2
        key_a, key_b, key_pcn_xi, key_pcn_u = jax.random.split(key, 4)

        # --- red-black affine stretch on the low modes ---
        pos_a, phi_a = state.positions[:h], state.potentials[:h]
        pos_b, phi_b = state.positions[h:], state.potentials[h:]
        pos_a, phi_a, acc_a = half_stretch(key_a, pos_a, phi_a, pos_b)
        pos_b, phi_b, acc_b = half_stretch(key_b, pos_b, phi_b, pos_a)
        positions = jnp.concatenate([pos_a, pos_b], axis=0)
        potentials = jnp.concatenate([phi_a, phi_b], axis=0)
        stretch_acc = jnp.concatenate([acc_a, acc_b]).astype(jnp.float32)

        # --- pCN on the complement (prior-reversible: only Φ in the ratio)
        w = (positions - prior.mean) / prior.scale
        xi = jax.random.normal(key_pcn_xi, w.shape, w.dtype)
        w_prop = jnp.concatenate(
            [
                w[:, :M],
                contraction * w[:, M:] + pcn_beta * xi[:, M:],
            ],
            axis=1,
        )
        v = prior.mean + prior.scale * w_prop
        phi_v = jax.vmap(potential_fn)(v)
        log_ratio = potentials - phi_v
        log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
        log_u = jnp.log(jax.random.uniform(key_pcn_u, (L,)))
        acc = log_u < log_ratio
        positions = jnp.where(acc[:, None], v, positions)
        potentials = jnp.where(acc, phi_v, potentials)

        new_state = FESState(positions=positions, potentials=potentials)
        info = FESInfo(
            stretch_accept=jnp.mean(stretch_acc),
            pcn_accept=jnp.mean(acc.astype(jnp.float32)),
        )
        return new_state, info

    return kernel


@partial(
    jax.jit,
    static_argnames=("potential_fn", "n_low_modes", "n_samples", "burn_in",
                     "thin"),
)
def sample_fes(
    potential_fn,
    prior,
    positions,
    base_key,
    n_low_modes,
    *,
    stretch_a=2.0,
    pcn_beta=0.2,
    n_samples,
    burn_in=0,
    thin=1,
):
    """Batch-level scan driver for FES (the walker axis is the batch).
    Returns (state, samples (n_samples, L, d), info_means)."""
    kernel = build_kernel(potential_fn, prior, n_low_modes,
                          stretch_a=stretch_a, pcn_beta=pcn_beta)
    state = init(positions, potential_fn)

    def one(st, i):
        return kernel(jax.random.fold_in(base_key, i), st)

    def burn_body(st, i):
        st, _ = one(st, i)
        return st, None

    state, _ = jax.lax.scan(burn_body, state, jnp.arange(burn_in))

    def outer(st, sample_idx):
        def inner(st, i):
            return one(st, i)

        steps = burn_in + sample_idx * thin + jnp.arange(thin)
        st, infos = jax.lax.scan(inner, st, steps)
        info_mean = jax.tree_util.tree_map(lambda x: x[-1], infos)
        return st, (st.positions, info_mean)

    state, (samples, info_means) = jax.lax.scan(
        outer, state, jnp.arange(n_samples)
    )
    return state, samples, info_means
