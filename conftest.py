"""Root conftest: run the test suite on a deterministic 8-device CPU mesh.

Tests run on ``--xla_force_host_platform_device_count=8`` virtual CPU
devices, so the multi-device sharding paths (``jax.sharding.Mesh`` over a
``'chains'`` axis, ``shard_map`` + collectives) are exercised on every run
without accelerators, per SURVEY.md §4.2 item 4. The platform is the CPU
unless ``JAX_PLATFORMS`` says otherwise: the GPU-only tests (marker
``gpu``) run on a card with ``JAX_PLATFORMS=cuda,cpu python -m pytest
tests -m gpu``.

This file also puts the repo root on ``sys.path`` (pytest rootdir insertion),
so ``import ip_mcmc_tpu`` works without installation.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
