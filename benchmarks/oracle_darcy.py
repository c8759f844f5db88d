"""NumPy oracle for the Darcy pCN benchmark: the reference-equivalent
single-process single-chain loop (SURVEY.md §6 — the reference publishes no
numbers, so the build creates the baseline by running its own
reference-equivalent implementation with identical algorithm + ESS
estimator).

Same math as ip_mcmc_tpu.models.darcy + kernels.pcn, in the reference's
idiom: Python per-step loop, NumPy dense linalg, one chain.
"""

from __future__ import annotations

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import scipy.linalg

from ip_mcmc_tpu.models import darcy, kl


class OracleDarcyPCN:
    def __init__(self, n_grid=16, n_modes_per_dim=8, alpha=2.0, field_scale=10.0):
        basis, ij = kl.sine_basis_2d(n_modes_per_dim, n_grid)
        lam = kl.laplacian_eigenvalues_2d(ij, alpha=alpha, scale=field_scale)
        self.scaled_basis = np.sqrt(lam)[:, None] * basis
        self.n = n_grid
        self.indices = darcy._stencil_indices(n_grid)
        self.obs = np.asarray(darcy.default_observation_indices(n_grid))
        self.f = np.ones(n_grid * n_grid)
        self.K = self.scaled_basis.shape[0]

    def assemble(self, a):
        h_left, h_right, v_top, v_bot, b_cells = self.indices
        n = self.n
        h2 = float(n * n)
        af = a.reshape(-1)
        N = n * n
        t_h = 2.0 * af[h_left] * af[h_right] / (af[h_left] + af[h_right]) * h2
        t_v = 2.0 * af[v_top] * af[v_bot] / (af[v_top] + af[v_bot]) * h2
        t_b = 2.0 * af[b_cells] * h2
        A = np.zeros((N, N))
        A[h_left, h_right] -= t_h
        A[h_right, h_left] -= t_h
        A[v_top, v_bot] -= t_v
        A[v_bot, v_top] -= t_v
        diag = np.zeros(N)
        np.add.at(diag, h_left, t_h)
        np.add.at(diag, h_right, t_h)
        np.add.at(diag, v_top, t_v)
        np.add.at(diag, v_bot, t_v)
        np.add.at(diag, b_cells, t_b)
        A[np.arange(N), np.arange(N)] += diag
        return A

    def forward(self, u):
        log_a = u @ self.scaled_basis
        a = np.exp(log_a)
        A = self.assemble(a)
        c, low = scipy.linalg.cho_factor(A, lower=True, check_finite=False)
        p = scipy.linalg.cho_solve((c, low), self.f, check_finite=False)
        return p[self.obs]

    def potential(self, u, y, noise_std):
        r = (y - self.forward(u)) / noise_std
        return 0.5 * r @ r

    def run_pcn(self, y, noise_std, beta, n_steps, rng, u0=None):
        """Reference-idiom pCN chain; returns (samples, accept_rate)."""
        u = rng.standard_normal(self.K) if u0 is None else np.array(u0)
        phi = self.potential(u, y, noise_std)
        contraction = np.sqrt(1.0 - beta**2)
        samples = np.empty((n_steps, self.K))
        accepts = 0
        for i in range(n_steps):
            xi = rng.standard_normal(self.K)
            v = contraction * u + beta * xi
            phi_v = self.potential(v, y, noise_std)
            if np.log(rng.uniform()) < phi - phi_v:
                u, phi = v, phi_v
                accepts += 1
            samples[i] = u
        return samples, accepts / n_steps

    def make_coarse_surrogate(self, y, noise_std, n_coarse=8, n_cal=64,
                              seed=402):
        """Calibrated coarse-grid surrogate potential Φ*, mirroring
        configs._darcy_coarse_surrogate on the NumPy side: same whitened KL
        space, forward on the n_coarse grid with observations at the
        nearest coarse cells, bias-corrected by the mean fine-coarse
        discrepancy over ``n_cal`` prior draws and noise-inflated by its
        std. (The coarse solve is dense Cholesky — the reference idiom —
        so the oracle's surrogate is at least as good as the fused
        engine's CG-3 one; DA is exact for any surrogate either way.)"""
        coarse = OracleDarcyPCN(n_grid=n_coarse)
        i_f, j_f = self.obs // self.n, self.obs % self.n

        def to_coarse(i):
            return np.clip(
                np.round((i + 0.5) * n_coarse / self.n - 0.5).astype(int),
                0, n_coarse - 1,
            )

        coarse.obs = to_coarse(i_f) * n_coarse + to_coarse(j_f)
        rng = np.random.default_rng(seed)
        U = rng.standard_normal((n_cal, self.K))
        d = np.stack([self.forward(u) - coarse.forward(u) for u in U])
        y_surr = np.asarray(y) - d.mean(axis=0)
        scale = np.sqrt(noise_std**2 + d.std(axis=0) ** 2)

        def phi_surr(u):
            r = (y_surr - coarse.forward(u)) / scale
            return 0.5 * r @ r

        # the calibration, for evaluating the same Φ* with another solver
        phi_surr.y_surr, phi_surr.scale, phi_surr.coarse = y_surr, scale, coarse
        return phi_surr

    def run_da_pcn(self, y, noise_std, beta, subchain_len, n_outer, rng,
                   u0=None, phi_surr=None):
        """Reference-idiom DELAYED-ACCEPTANCE pCN chain: ``subchain_len``
        pCN steps against the calibrated coarse surrogate, then one exact
        correction per outer step (Christen–Fox 2005 surrogate-transition
        form — identical algorithm to ops.fused_da_pcn_chain, so the
        device-vs-oracle ratio on this row is pure hardware+implementation,
        no algorithm factor). Returns (outer-step samples, outer_accept,
        inner_accept)."""
        if phi_surr is None:
            phi_surr = self.make_coarse_surrogate(y, noise_std)
        u = rng.standard_normal(self.K) if u0 is None else np.array(u0)
        phi = self.potential(u, y, noise_std)
        surr = phi_surr(u)
        contraction = np.sqrt(1.0 - beta**2)
        samples = np.empty((n_outer, self.K))
        outer_accepts = 0
        inner_accepts = 0
        for i in range(n_outer):
            v, sv = u, surr
            for _ in range(subchain_len):
                xi = rng.standard_normal(self.K)
                w = contraction * v + beta * xi
                sw = phi_surr(w)
                if np.log(rng.uniform()) < sv - sw:
                    v, sv = w, sw
                    inner_accepts += 1
            phi_v = self.potential(v, y, noise_std)
            # pi*-to-pi correction: (Phi(u)-Phi(v)) - (Phi*(u)-Phi*(v))
            if np.log(rng.uniform()) < (phi - phi_v) - (surr - sv):
                u, phi, surr = v, phi_v, sv
                outer_accepts += 1
            samples[i] = u
        return (
            samples,
            outer_accepts / n_outer,
            inner_accepts / (n_outer * subchain_len),
        )
