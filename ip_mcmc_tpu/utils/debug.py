"""Debug / sanitizer mode (SURVEY.md §5.2): the accelerator analog of race
detectors & sanitizers for a pure-functional engine.

- ``debug_mode()``: context manager enabling ``jax_debug_nans`` (fail fast at
  the op producing the first NaN) and disabling jit (pinpoints the Python
  line).
- ``checked_potential``: wraps a potential with ``checkify`` NaN/Inf checks
  so a bad forward model reports *where* it went non-finite instead of the
  kernel silently rejecting forever.
- Determinism (same key ⇒ same result across mesh shapes) is the collective-
  misuse detector; asserted continuously in tests/test_sharding.py.
"""

from __future__ import annotations

import contextlib

import jax
from jax.experimental import checkify


@contextlib.contextmanager
def debug_mode(disable_jit=False):
    old_nans = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        if disable_jit:
            with jax.disable_jit():
                yield
        else:
            yield
    finally:
        jax.config.update("jax_debug_nans", old_nans)


def checked_potential(potential_fn):
    """Return (checked_fn, run), both safe under jit:

    - ``run(u) -> (err, phi)``: the ``checkify``-transformed potential —
      functional error handling (``err.throw()`` when convenient).
    - ``checked_fn(u) -> phi``: eager convenience wrapper that calls ``run``
      and throws immediately on a non-finite Φ.

    (Round-1 advisor fix: the first element used to be the RAW function
    holding a bare ``checkify.check`` — it errored if jitted outside a
    checkify transform, contradicting the docstring contract.)"""

    def inner(u):
        phi = potential_fn(u)
        checkify.check(
            jax.numpy.isfinite(phi), "potential returned non-finite value {phi}",
            phi=phi,
        )
        return phi

    run = checkify.checkify(inner)

    def checked_fn(u):
        err, phi = run(u)
        err.throw()
        return phi

    return checked_fn, run
