"""Float32 matrix products at full precision: the one place the matmul
precision policy lives.

On a GPU, XLA may run a float32 product at DEFAULT precision on the tensor
cores as TF32, which keeps about three decimal digits. The KL field
reconstruction and the observation operator feed the misfit Φ, whose
Darcy noise σ = 0.002 turns a 1e-3 relative error into a visible shift of
Φ, so the Metropolis–Hastings ratio would target another posterior; a
rounded prior factor would break pCN's prior reversibility the same way.
These products therefore go through ``mm`` / ``einsum`` here, at HIGHEST
precision.

Any matmul-precision setting in JAX's config takes precedence: the
``jax.default_matmul_precision(...)`` context (how ``chip_smoke.py``
measures the DEFAULT-vs-HIGHEST difference), the
``jax_default_matmul_precision`` flag and the
``JAX_DEFAULT_MATMUL_PRECISION`` environment variable. Leave them unset
for exact potentials. On the CPU both precisions give the same float32
result.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _precision():
    if jax.config.jax_default_matmul_precision is not None:
        return None  # the configured precision applies
    return jax.lax.Precision.HIGHEST


def mm(a, b, **kw):
    """``jnp.matmul(a, b)`` at HIGHEST precision unless JAX's config sets a
    matmul precision."""
    return jnp.matmul(a, b, precision=_precision(), **kw)


def einsum(subscripts, *operands, **kw):
    """``jnp.einsum`` at HIGHEST precision unless JAX's config sets a
    matmul precision."""
    return jnp.einsum(subscripts, *operands, precision=_precision(), **kw)
