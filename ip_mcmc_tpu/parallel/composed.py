"""Composed ('chains', 'model') mesh: data-parallel chains OVER grid-sharded
forward solves (SURVEY.md §2.3 'model' axis + §5.7; round-1 VERDICT item 9).

The two parallelism axes the framework defines finally meet in one program:

- ``'chains'`` shards the chain batch (DP — each device group owns a chain
  block, zero cross-talk between blocks during sampling),
- ``'model'`` row-shards EACH chain's elliptic Darcy solve across its group
  (halo exchange via ``ppermute``, CG dot products via ``psum`` — the
  stencil analog of ring attention), by ``vmap``-ing the per-shard CG body
  of ``grid_shard.solve_cg_local`` over the local chain block: JAX batches
  the collectives, so one program step runs ``chains_local`` simultaneous
  distributed solves.

Keys are derived from (step, GLOBAL chain index) only, so the math is
mesh-shape invariant: a (1, 1) mesh is literally the single-device run, and
(C, M) reshapes move work without changing any chain's trajectory (up to
f32 psum reduction order in the solver — tested at tight tolerances in
tests/test_composed.py).

Every device in a 'model' group computes identical chain states (same psum
results feed the same accept decisions), so sample outputs are replicated
over 'model' by construction; ``check_vma=False`` because JAX cannot prove
that through the manual collectives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ip_mcmc_tpu import precision
from ip_mcmc_tpu.parallel import grid_shard
from ip_mcmc_tpu.parallel.mesh import CHAIN_AXIS

MODEL_AXIS = grid_shard.MODEL_AXIS


def make_composed_mesh(n_chain_groups: int, n_model_devices: int,
                       devices=None):
    """Mesh of shape (n_chain_groups, n_model_devices) with axes
    ('chains', 'model')."""
    if devices is None:
        devices = jax.devices()
    need = n_chain_groups * n_model_devices
    if len(devices) < need:
        raise ValueError(
            f"need {need} devices for a ({n_chain_groups}, {n_model_devices})"
            f" mesh, have {len(devices)}"
        )
    arr = np.array(devices[:need]).reshape(n_chain_groups, n_model_devices)
    return Mesh(arr, (CHAIN_AXIS, MODEL_AXIS))


def sample_composed_pcn(
    aux,
    data,
    noise_scale,
    *,
    beta,
    mesh,
    u0,
    base_key,
    n_samples,
    burn_in=0,
    thin=1,
    cg_iters=150,
    log_a_mean=0.0,
):
    """pCN on the Darcy posterior over a ('chains', 'model') mesh.

    aux: the dict from ``darcy.make_darcy_forward`` (scaled_basis,
    obs_indices, source, n_grid). u0: (n_chains, K) whitened initial
    positions (prior = N(0, I) — the same whitened parameterization as the
    darcy configs). Returns (samples (n_samples, n_chains, K), accept_rate).
    """
    n = int(aux["n_grid"])
    K = u0.shape[1]
    n_chain_groups, n_model = mesh.devices.shape
    if u0.shape[0] % n_chain_groups:
        raise ValueError("n_chains must divide the 'chains' axis")
    if n % n_model:
        raise ValueError("n_grid must divide the 'model' axis")

    basis3 = jnp.asarray(aux["scaled_basis"], jnp.float32).reshape(K, n, n)
    f2 = jnp.asarray(aux["source"], jnp.float32).reshape(n, n)
    obs_idx = np.asarray(aux["obs_indices"])
    m = len(obs_idx)
    obs_mat = np.zeros((m, n * n), np.float32)
    obs_mat[np.arange(m), obs_idx] = 1.0
    obs3 = jnp.asarray(obs_mat).reshape(m, n, n)
    y = jnp.asarray(data, jnp.float32)
    scale = jnp.float32(noise_scale)
    beta = jnp.float32(beta)
    total_steps = burn_in + n_samples * thin

    def body(u_loc, basis_loc, f_loc, obs_loc):
        c_loc = u_loc.shape[0]
        cidx = jax.lax.axis_index(CHAIN_AXIS)
        gidx = cidx * c_loc + jnp.arange(c_loc)  # global chain ids

        def misfit(ub):  # (c_loc, K) -> (c_loc,)
            log_a = precision.einsum("ck,krn->crn", ub, basis_loc) + log_a_mean
            a = jnp.exp(log_a)
            # c_loc simultaneous distributed solves: vmap batches the
            # ppermute halo exchange and psum reductions over 'model'
            sol = jax.vmap(
                lambda al: grid_shard.solve_cg_local(al, f_loc, n, cg_iters)
            )(a)
            pred = jax.lax.psum(
                precision.einsum("mrn,crn->cm", obs_loc, sol), MODEL_AXIS
            )
            r = (y[None, :] - pred) / scale
            return 0.5 * jnp.sum(r * r, axis=1)

        def step(carry, t):
            u, phi = carry
            # keys from (step, global chain id) ONLY — identical across the
            # 'model' group and invariant to the mesh shape
            keys = jax.vmap(
                lambda g: jax.random.fold_in(jax.random.fold_in(base_key, t), g)
            )(gidx)
            xi = jax.vmap(
                lambda k: jax.random.normal(jax.random.fold_in(k, 0), (K,))
            )(keys)
            log_u = jnp.log(
                jax.vmap(
                    lambda k: jax.random.uniform(jax.random.fold_in(k, 1))
                )(keys)
            )
            v = jnp.sqrt(1.0 - beta * beta) * u + beta * xi
            phi_v = misfit(v)
            acc = log_u < (phi - phi_v)  # pCN: min(1, exp(Φ(u) − Φ(v)))
            u = jnp.where(acc[:, None], v, u)
            phi = jnp.where(acc, phi_v, phi)
            return (u, phi), (u, acc)

        phi0 = misfit(u_loc)
        _, (us, accs) = jax.lax.scan(
            step, (u_loc, phi0), jnp.arange(total_steps)
        )
        samples = us[burn_in + thin - 1 :: thin][:n_samples]
        acc_rate = jax.lax.pmean(
            jnp.mean(accs.astype(jnp.float32)), CHAIN_AXIS
        )
        return samples, acc_rate

    samples, acc = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(CHAIN_AXIS, None),
            P(None, MODEL_AXIS, None),
            P(MODEL_AXIS, None),
            P(None, MODEL_AXIS, None),
        ),
        out_specs=(P(None, CHAIN_AXIS, None), P()),
        check_vma=False,
    )(u0, basis3, f2, obs3)
    return samples, acc


def _grad_wrt_a_local(a_local, x_local, lam_local, n, axis_name=MODEL_AXIS):
    """Local row block of ∇_a[λᵀ A(a) x] — the harmonic-mean face derivative
    (mirrors models.darcy's flat-layout phi_bwd, re-derived for the
    row-sharded layout): horizontal faces are shard-local, vertical faces
    use one-row halos of a, x, λ; halo-zero rows mark the global boundary
    (no face → masked)."""
    h2 = float(n * n)
    nd = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    a_above, a_below = grid_shard._halo_exchange_rows(a_local, axis_name)
    x_above, x_below = grid_shard._halo_exchange_rows(x_local, axis_name)
    l_above, l_below = grid_shard._halo_exchange_rows(lam_local, axis_name)

    g = jnp.zeros_like(a_local)
    # horizontal faces (within rows — local): ∂t/∂a_i = 2h²(a_j/(a_i+a_j))²
    den_h = a_local[:, :-1] + a_local[:, 1:]
    s_h = (x_local[:, :-1] - x_local[:, 1:]) * (
        lam_local[:, :-1] - lam_local[:, 1:]
    )
    g = g.at[:, :-1].add(2.0 * h2 * jnp.square(a_local[:, 1:] / den_h) * s_h)
    g = g.at[:, 1:].add(2.0 * h2 * jnp.square(a_local[:, :-1] / den_h) * s_h)

    # vertical faces on the halo-extended block
    a_ext = jnp.concatenate([a_above[None], a_local, a_below[None]], axis=0)
    x_ext = jnp.concatenate([x_above[None], x_local, x_below[None]], axis=0)
    l_ext = jnp.concatenate([l_above[None], lam_local, l_below[None]], axis=0)
    den_v = a_ext[:-1] + a_ext[1:]
    face = (a_ext[:-1] > 0.0) & (a_ext[1:] > 0.0)  # halo zeros = no face
    den_v = jnp.where(face, den_v, 1.0)
    s_v = jnp.where(
        face,
        (x_ext[:-1] - x_ext[1:]) * (l_ext[:-1] - l_ext[1:]),
        0.0,
    )
    up = 2.0 * h2 * jnp.square(a_ext[1:] / den_v) * s_v  # → upper cell
    lo = 2.0 * h2 * jnp.square(a_ext[:-1] / den_v) * s_v  # → lower cell
    # local row r = ext row r+1: face below has index r+1, face above r
    g = g + up[1:] + lo[:-1]

    # global Dirichlet boundary terms: ∂(t_b p)/∂a = 2h² x λ per side
    tb = 2.0 * h2
    zero = jnp.zeros((n,), a_local.dtype)
    g = g.at[0].add(
        jnp.where(idx == 0, tb * x_local[0] * lam_local[0], zero)
    )
    g = g.at[-1].add(
        jnp.where(idx == nd - 1, tb * x_local[-1] * lam_local[-1], zero)
    )
    g = g.at[:, 0].add(tb * x_local[:, 0] * lam_local[:, 0])
    g = g.at[:, -1].add(tb * x_local[:, -1] * lam_local[:, -1])
    return g


def _local_value_and_grad(ub, basis_loc, f_loc, obs_loc, y, scale, n,
                          cg_iters, log_a_mean):
    """Per-shard (Φ, ∇_uΦ) for a (c_loc, K) chain block: distributed forward
    solve + distributed ADJOINT solve (same operator, symmetric) + the face
    derivative — the adjoint method of models.darcy's custom_vjp, running on
    the row-sharded grid. Collectives (ppermute halos, psum dots) are
    vmapped over the local chain block."""
    log_a = precision.einsum("ck,krn->crn", ub, basis_loc) + log_a_mean
    a = jnp.exp(log_a)
    sol = jax.vmap(
        lambda al: grid_shard.solve_cg_local(al, f_loc, n, cg_iters)
    )(a)
    pred = jax.lax.psum(precision.einsum("mrn,crn->cm", obs_loc, sol), MODEL_AXIS)
    r = (y[None, :] - pred) / scale
    phi = 0.5 * jnp.sum(r * r, axis=1)
    # adjoint rhs: ∂Φ/∂x = −Oᵀ(r/σ); Oᵀ maps obs → grid rows, shard-local
    rhs = -precision.einsum("mrn,cm->crn", obs_loc, r / scale)
    lam = jax.vmap(
        lambda al, rl: grid_shard.solve_cg_local(al, rl, n, cg_iters)
    )(a, rhs)
    g_a = jax.vmap(
        lambda al, xl, ll: _grad_wrt_a_local(al, xl, ll, n)
    )(a, sol, lam)
    g_loga = a * (-g_a)  # chain rule a = exp(log a); sign: δΦ = −λᵀ δA x
    g_u = jax.lax.psum(
        precision.einsum("krn,crn->ck", basis_loc, g_loga), MODEL_AXIS
    )
    return phi, g_u


def composed_misfit_and_grad(aux, data, noise_scale, mesh, u,
                             cg_iters=150, log_a_mean=0.0):
    """(Φ(u), ∇Φ(u)) for a (n_chains, K) batch on a ('chains','model') mesh
    — the distributed adjoint gradient, exposed for direct testing against
    ``jax.grad`` of the single-device misfit."""
    n = int(aux["n_grid"])
    K = u.shape[1]
    basis3 = jnp.asarray(aux["scaled_basis"], jnp.float32).reshape(K, n, n)
    f2 = jnp.asarray(aux["source"], jnp.float32).reshape(n, n)
    obs_idx = np.asarray(aux["obs_indices"])
    m = len(obs_idx)
    obs_mat = np.zeros((m, n * n), np.float32)
    obs_mat[np.arange(m), obs_idx] = 1.0
    obs3 = jnp.asarray(obs_mat).reshape(m, n, n)
    y = jnp.asarray(data, jnp.float32)
    scale = jnp.float32(noise_scale)

    phi, g = jax.shard_map(
        lambda ul, bl, fl, ol: _local_value_and_grad(
            ul, bl, fl, ol, y, scale, n, cg_iters, log_a_mean
        ),
        mesh=mesh,
        in_specs=(
            P(CHAIN_AXIS, None),
            P(None, MODEL_AXIS, None),
            P(MODEL_AXIS, None),
            P(None, MODEL_AXIS, None),
        ),
        out_specs=(P(CHAIN_AXIS), P(CHAIN_AXIS, None)),
        check_vma=False,
    )(u, basis3, f2, obs3)
    return phi, g


def sample_composed_elliptical(
    aux,
    data,
    noise_scale,
    *,
    mesh,
    u0,
    base_key,
    n_samples,
    burn_in=0,
    thin=1,
    cg_iters=150,
    log_a_mean=0.0,
    max_shrink=20,
):
    """Elliptical slice sampling on the Darcy posterior over a
    ('chains', 'model') mesh (ROADMAP P2: composed mesh beyond pCN/MALA) —
    the tuning-free kernel of ``kernels/elliptical.py`` re-shaped for the
    SPMD program: the per-chain shrinkage loop becomes a masked
    ``while_loop`` over the local chain BLOCK (exit when every chain has
    accepted, capped at ``max_shrink``), so every device in a 'model' group
    executes the identical collective schedule (vmapped ppermute/psum
    distributed solves) — chain data is replicated across the group, so the
    done-masks agree device-to-device by construction. The exit test is made
    GLOBALLY uniform (a scalar psum of the remaining-chain count over
    'chains' rides the loop carry), so every device in the mesh runs the
    same trip count — per-group early exit would be algorithmically fine (no
    collective crosses 'chains' in the body) but can deadlock runtimes whose
    collective rendezvous is channel-global. Masked updates make the samples
    independent of the trip count either way.

    θ → 0 is the guaranteed-accept fallback (u' = u beats the slice level
    by definition), so a chain that exhausts ``max_shrink`` keeps its
    position — same capped-iteration semantics as the single-device kernel.

    Keys derive from (step, global chain id) only → mesh-shape invariant
    like ``sample_composed_pcn``. Whitened prior N(0, I) (mean 0), matching
    the darcy configs. Returns (samples (n_samples, n_chains, K),
    mean forward evaluations per step)."""
    n = int(aux["n_grid"])
    K = u0.shape[1]
    n_chain_groups, n_model = mesh.devices.shape
    if u0.shape[0] % n_chain_groups:
        raise ValueError("n_chains must divide the 'chains' axis")
    if n % n_model:
        raise ValueError("n_grid must divide the 'model' axis")

    basis3 = jnp.asarray(aux["scaled_basis"], jnp.float32).reshape(K, n, n)
    f2 = jnp.asarray(aux["source"], jnp.float32).reshape(n, n)
    obs_idx = np.asarray(aux["obs_indices"])
    m = len(obs_idx)
    obs_mat = np.zeros((m, n * n), np.float32)
    obs_mat[np.arange(m), obs_idx] = 1.0
    obs3 = jnp.asarray(obs_mat).reshape(m, n, n)
    y = jnp.asarray(data, jnp.float32)
    scale = jnp.float32(noise_scale)
    two_pi = jnp.float32(2.0 * np.pi)
    total_steps = burn_in + n_samples * thin

    def body(u_loc, basis_loc, f_loc, obs_loc):
        c_loc = u_loc.shape[0]
        cidx = jax.lax.axis_index(CHAIN_AXIS)
        gidx = cidx * c_loc + jnp.arange(c_loc)

        def misfit(ub):  # (c_loc, K) -> (c_loc,)
            log_a = precision.einsum("ck,krn->crn", ub, basis_loc) + log_a_mean
            a = jnp.exp(log_a)
            sol = jax.vmap(
                lambda al: grid_shard.solve_cg_local(al, f_loc, n, cg_iters)
            )(a)
            pred = jax.lax.psum(
                precision.einsum("mrn,crn->cm", obs_loc, sol), MODEL_AXIS
            )
            r = (y[None, :] - pred) / scale
            return 0.5 * jnp.sum(r * r, axis=1)

        def step(carry, t):
            u, phi = carry
            keys = jax.vmap(
                lambda g: jax.random.fold_in(jax.random.fold_in(base_key, t), g)
            )(gidx)
            nu = jax.vmap(
                lambda k: jax.random.normal(jax.random.fold_in(k, 0), (K,))
            )(keys)
            log_w = jnp.log(
                jax.vmap(
                    lambda k: jax.random.uniform(jax.random.fold_in(k, 1))
                )(keys)
            )
            theta0 = jax.vmap(
                lambda k: jax.random.uniform(
                    jax.random.fold_in(k, 2), minval=0.0, maxval=two_pi
                )
            )(keys)
            log_y = -phi + log_w  # slice level

            def shrink_cond(st):
                i, remaining = st[0], st[1]
                return (i < max_shrink) & (remaining > 0)

            def shrink(st):
                i, _, u_new, phi_new, theta, lo, hi, done, n_ev = st
                v = (
                    u * jnp.cos(theta)[:, None]
                    + nu * jnp.sin(theta)[:, None]
                )
                phi_v = misfit(v)  # uniform collective schedule: all chains
                acc = (-phi_v > log_y) & ~done
                u_new = jnp.where(acc[:, None], v, u_new)
                phi_new = jnp.where(acc, phi_v, phi_new)
                n_ev = n_ev + jnp.where(done, 0.0, 1.0)
                done = done | acc
                # shrink bracket toward 0 for still-running chains
                lo = jnp.where(done | (theta >= 0.0), lo, theta)
                hi = jnp.where(done | (theta < 0.0), hi, theta)
                us01 = jax.vmap(
                    lambda k: jax.random.uniform(jax.random.fold_in(k, 3 + i))
                )(keys)
                theta = jnp.where(done, theta, lo + us01 * (hi - lo))
                remaining = jax.lax.psum(
                    jnp.sum((~done).astype(jnp.int32)), CHAIN_AXIS
                )
                return (i + 1, remaining, u_new, phi_new, theta, lo, hi,
                        done, n_ev)

            done0 = jnp.zeros((c_loc,), bool)
            n_ev0 = jnp.zeros((c_loc,), jnp.float32)
            _, _, u_new, phi_new, *_rest, n_ev = jax.lax.while_loop(
                shrink_cond,
                shrink,
                (0, jnp.int32(c_loc), u, phi, theta0, theta0 - two_pi,
                 theta0, done0, n_ev0),
            )
            # exhausted chains keep u (θ→0 guaranteed-accept fallback)
            return (u_new, phi_new), (u_new, n_ev)

        phi0 = misfit(u_loc)
        _, (us, n_evs) = jax.lax.scan(
            step, (u_loc, phi0), jnp.arange(total_steps)
        )
        samples = us[burn_in + thin - 1 :: thin][:n_samples]
        mean_evals = jax.lax.pmean(jnp.mean(n_evs), CHAIN_AXIS)
        return samples, mean_evals

    samples, mean_evals = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(CHAIN_AXIS, None),
            P(None, MODEL_AXIS, None),
            P(MODEL_AXIS, None),
            P(None, MODEL_AXIS, None),
        ),
        out_specs=(P(None, CHAIN_AXIS, None), P()),
        check_vma=False,
    )(u0, basis3, f2, obs3)
    return samples, mean_evals


def sample_composed_mala(
    aux,
    data,
    noise_scale,
    *,
    step_size,
    mesh,
    u0,
    base_key,
    n_samples,
    burn_in=0,
    thin=1,
    cg_iters=150,
    log_a_mean=0.0,
):
    """MALA on the Darcy posterior over a ('chains', 'model') mesh (ROADMAP
    P2: the composed mesh beyond pCN): gradient proposals whose ∇Φ comes
    from the distributed ADJOINT solve — forward CG, adjoint CG, and the
    face-derivative assembly all run on the row-sharded grid, vmapped over
    each device group's chain block. Whitened prior N(0, I) folded into the
    drift and acceptance. Key derivation matches sample_composed_pcn
    ((step, global chain id) only → mesh-shape invariant).

    Returns (samples (n_samples, n_chains, K), accept_rate)."""
    n = int(aux["n_grid"])
    K = u0.shape[1]
    n_chain_groups, n_model = mesh.devices.shape
    if u0.shape[0] % n_chain_groups:
        raise ValueError("n_chains must divide the 'chains' axis")
    if n % n_model:
        raise ValueError("n_grid must divide the 'model' axis")

    basis3 = jnp.asarray(aux["scaled_basis"], jnp.float32).reshape(K, n, n)
    f2 = jnp.asarray(aux["source"], jnp.float32).reshape(n, n)
    obs_idx = np.asarray(aux["obs_indices"])
    m = len(obs_idx)
    obs_mat = np.zeros((m, n * n), np.float32)
    obs_mat[np.arange(m), obs_idx] = 1.0
    obs3 = jnp.asarray(obs_mat).reshape(m, n, n)
    y = jnp.asarray(data, jnp.float32)
    scale = jnp.float32(noise_scale)
    eps = jnp.float32(step_size)
    total_steps = burn_in + n_samples * thin

    def body(u_loc, basis_loc, f_loc, obs_loc):
        c_loc = u_loc.shape[0]
        cidx = jax.lax.axis_index(CHAIN_AXIS)
        gidx = cidx * c_loc + jnp.arange(c_loc)

        def vg(ub):
            return _local_value_and_grad(
                ub, basis_loc, f_loc, obs_loc, y, scale, n, cg_iters,
                log_a_mean,
            )

        def drift(ub, g_phi):  # ∇ log π = −∇Φ − u (whitened prior)
            return -g_phi - ub

        def step(carry, t):
            u, phi, g = carry
            keys = jax.vmap(
                lambda gi: jax.random.fold_in(
                    jax.random.fold_in(base_key, t), gi
                )
            )(gidx)
            xi = jax.vmap(
                lambda k: jax.random.normal(jax.random.fold_in(k, 0), (K,))
            )(keys)
            log_u = jnp.log(
                jax.vmap(
                    lambda k: jax.random.uniform(jax.random.fold_in(k, 1))
                )(keys)
            )
            mean_fwd = u + 0.5 * eps * eps * drift(u, g)
            v = mean_fwd + eps * xi
            phi_v, g_v = vg(v)
            mean_rev = v + 0.5 * eps * eps * drift(v, g_v)
            inv2e2 = 1.0 / (2.0 * eps * eps)
            log_q_rev = -jnp.sum(jnp.square(u - mean_rev), axis=1) * inv2e2
            log_q_fwd = -0.5 * jnp.sum(xi * xi, axis=1)
            logpi_u = -phi - 0.5 * jnp.sum(u * u, axis=1)
            logpi_v = -phi_v - 0.5 * jnp.sum(v * v, axis=1)
            log_ratio = logpi_v - logpi_u + log_q_rev - log_q_fwd
            log_ratio = jnp.where(jnp.isnan(log_ratio), -jnp.inf, log_ratio)
            acc = log_u < log_ratio
            u = jnp.where(acc[:, None], v, u)
            phi = jnp.where(acc, phi_v, phi)
            g = jnp.where(acc[:, None], g_v, g)
            return (u, phi, g), (u, acc)

        phi0, g0 = vg(u_loc)
        _, (us, accs) = jax.lax.scan(
            step, (u_loc, phi0, g0), jnp.arange(total_steps)
        )
        samples = us[burn_in + thin - 1 :: thin][:n_samples]
        acc_rate = jax.lax.pmean(
            jnp.mean(accs.astype(jnp.float32)), CHAIN_AXIS
        )
        return samples, acc_rate

    samples, acc = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(CHAIN_AXIS, None),
            P(None, MODEL_AXIS, None),
            P(MODEL_AXIS, None),
            P(None, MODEL_AXIS, None),
        ),
        out_specs=(P(None, CHAIN_AXIS, None), P()),
        check_vma=False,
    )(u0, basis3, f2, obs3)
    return samples, acc
