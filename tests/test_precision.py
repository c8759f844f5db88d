"""Matmul precision policy (ip_mcmc_tpu/precision.py): every float32 product
on the exact potentials' and proposals' paths is traced at HIGHEST, so a GPU
cannot run it as TF32; a matmul-precision setting in JAX's config wins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ip_mcmc_tpu import configs, distributions, observations, ops, precision
from ip_mcmc_tpu.models import darcy, linear
from ip_mcmc_tpu.parallel import composed

HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _f32_dots(jaxpr):
    """Every dot_general with float32 operands in a (closed) jaxpr,
    including those in nested jaxprs (loops, shard_map, custom rules)."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and all(
            v.aval.dtype == jnp.float32 for v in eqn.invars
        ):
            found.append(eqn)
        for p in eqn.params.values():
            for sub in p if isinstance(p, (tuple, list)) else (p,):
                if hasattr(sub, "eqns") or hasattr(getattr(sub, "jaxpr", None),
                                                   "eqns"):
                    found += _f32_dots(sub)
    return found


def _darcy_aux():
    return darcy.make_darcy_forward(n_grid=8, n_modes_per_dim=4, alpha=2.0,
                                    field_scale=10.0)[1]


def _cases():
    aux = _darcy_aux()
    y = jnp.zeros(len(aux["obs_indices"]))
    U = jnp.ones((16, 4)) * 0.1
    diff = darcy.make_batched_misfit(aux, y, 0.002, cg_iters=4,
                                     differentiable=True)
    mesh = composed.make_composed_mesh(1, 1, jax.devices()[:1])
    A = np.ones((3, 16), np.float32)
    chol = np.eye(16, dtype=np.float32)
    return {
        "darcy_misfit": (darcy.make_batched_misfit(aux, y, 0.002, cg_iters=4),
                         (U,)),
        "darcy_adjoint": (lambda u: jax.vjp(diff, u)[1](jnp.ones(4))[0],
                          (U,)),
        "composed_misfit_and_grad": (
            lambda u: composed.composed_misfit_and_grad(
                aux, y, 0.002, mesh, u, cg_iters=4),
            (U.T,)),
        "composed_pcn": (
            lambda u: composed.sample_composed_pcn(
                aux, y, 0.002, beta=0.1, mesh=mesh, u0=u,
                base_key=jax.random.key(0), n_samples=1, cg_iters=4),
            (U.T,)),
        "linear_forward": (linear.make_forward(A), (jnp.ones(16),)),
        "linear_observation": (observations.linear_observation(A),
                               (jnp.ones((5, 16)),)),
        "gaussian_scale_apply": (
            distributions.Gaussian(mean=jnp.zeros(16),
                                   chol=jnp.asarray(chol)).scale_apply,
            (jnp.ones((5, 16)),)),
        "fused_pcn_dense": (
            lambda p: ops.fused_pcn_chain_dense(
                lambda x: jnp.sum(x * x, axis=0), p, np.zeros(16), chol, 0.1,
                0, n_steps=2, block_chains=4),
            (U.T,)),
        "burgers_misfit": (configs.build("burgers_pcn").batched_potential_fn,
                           None),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_f32_products_run_at_highest(name):
    fn, args = _cases()[name]
    if args is None:  # a configured potential: (dim, block) input
        args = (jnp.full((configs.build("burgers_pcn").dim, 4), 0.1),)
    dots = _f32_dots(jax.make_jaxpr(fn)(*args))
    assert dots, f"{name}: no float32 product traced"
    low = [e.params["precision"] for e in dots
           if e.params["precision"] != HIGHEST]
    assert not low, f"{name}: float32 products below HIGHEST: {low}"


@pytest.mark.parametrize("op", ["mm", "einsum"])
def test_configured_matmul_precision_wins(op):
    a, b = jnp.ones((2, 3)), jnp.ones((3, 4))
    call = {"mm": lambda: precision.mm(a, b),
            "einsum": lambda: precision.einsum("ij,jk->ik", a, b)}[op]
    (eqn,) = jax.make_jaxpr(call)().eqns
    assert eqn.params["precision"] == HIGHEST
    with jax.default_matmul_precision("default"):
        (eqn,) = jax.make_jaxpr(call)().eqns
    assert eqn.params["precision"] == (jax.lax.Precision.DEFAULT,) * 2
    np.testing.assert_array_equal(call(), a @ b)
