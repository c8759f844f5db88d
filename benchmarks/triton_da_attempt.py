"""The fused DA-pCN step as a Pallas kernel through Triton: does it compile,
and is it faster than the plain XLA engine?

One grid block per ``block_chains`` chains holds the block's (64, block)
state on chip for all ``n_steps`` outer steps, runs the unchanged
``_make_da_pcn_step_builder`` step with the real ``darcy_da_fused``
potentials (48-step surrogate subchain + one exact correction) and the
same counter-hash RNG as ``ops.fused_da_pcn_chain``. Pallas forbids
captured constants, so each potential is traced to a jaxpr first and its
constants become kernel operands.

    python benchmarks/triton_da_attempt.py            # on the GPU
    python benchmarks/triton_da_attempt.py --lower-only

``--lower-only`` stops after lowering for CUDA, which also works on a
machine without a GPU. Prints one JSON line per block size. A refusal is
a result here (``"outcome": "refused"`` with the compiler's message), not
an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from ip_mcmc_tpu import configs
from ip_mcmc_tpu.ops import fused_da_pcn_chain
from ip_mcmc_tpu.ops import fused_mcmc as fm


def _hoisted(fn, d, block):
    """(closed jaxpr, constants) of a features-first potential."""
    closed = jax.make_jaxpr(fn)(jax.ShapeDtypeStruct((d, block), jnp.float32))
    return closed.jaxpr, [jnp.asarray(c) for c in closed.consts]


def build_triton_da(problem, block_chains, n_steps):
    """pallas_call(backend="triton") running ``n_steps`` DA-pCN outer steps;
    returns ``run(positions (n, d), seed) -> (final (n, d), accept (n,))``."""
    kp = problem.kernel_params
    d = problem.dim
    builder = fm._make_da_pcn_step_builder(kp["subchain_len"])
    jx_e, c_e = _hoisted(problem.batched_potential_fn, d, block_chains)
    jx_s, c_s = _hoisted(problem.batched_surrogate_fn, d, block_chains)
    consts = c_e + c_s
    shapes = [c.shape for c in consts]
    beta = float(kp["beta"])
    mean = np.asarray(problem.prior.mean, np.float32)
    scale = np.asarray(problem.prior.scale, np.float32)

    def kernel(seed_ref, mean_ref, scale_ref, pos_ref, *refs):
        const_refs, (out_ref, acc_ref) = refs[: len(consts)], refs[len(consts):]
        vals = [r[...] for r in const_refs]
        ve, vs = vals[: len(c_e)], vals[len(c_e):]
        pot_e = lambda x: jax.core.eval_jaxpr(jx_e, ve, x)[0]
        pot_s = lambda x: jax.core.eval_jaxpr(jx_s, vs, x)[0]
        init, step = builder(
            (pot_e, pot_s), jnp.float32(beta), mean_ref[...], scale_ref[...]
        )
        block_seed = (seed_ref[0] + pl.program_id(0) * 7919).astype(jnp.uint32)

        def body(i, state):
            carry, acc = state
            rand_u = lambda shape, tag: fm._uniform01(
                fm._mix_key(block_seed, i, tag), shape)
            rand_n = lambda shape, tag: fm._normal(
                fm._mix_key(block_seed, i, tag),
                fm._mix_key(block_seed, i, tag + 1), shape)
            carry, accepted = step(carry, rand_n, rand_u)
            return carry, acc + accepted.astype(jnp.float32)

        carry, acc = jax.lax.fori_loop(
            0, n_steps, body,
            (init(pos_ref[...]), jnp.zeros((1, block_chains), jnp.float32)),
        )
        out_ref[...] = carry[0]
        acc_ref[...] = acc / n_steps

    def full(shape):
        return pl.BlockSpec(shape, lambda i, _n=len(shape): (0,) * _n)

    def run(positions, seed):
        n = positions.shape[0]
        chain_block = pl.BlockSpec((d, block_chains), lambda i: (0, i))
        final, acc = pl.pallas_call(
            kernel,
            grid=(n // block_chains,),
            in_specs=[full((1,)), full((d,)), full((d,)), chain_block,
                      *[full(s) for s in shapes]],
            out_specs=(chain_block,
                       pl.BlockSpec((1, block_chains), lambda i: (0, i))),
            out_shape=(jax.ShapeDtypeStruct((d, n), jnp.float32),
                       jax.ShapeDtypeStruct((1, n), jnp.float32)),
            backend="triton",
            name="da_pcn_triton",
        )(jnp.asarray([seed], jnp.int32), mean, scale, positions.T, *consts)
        return final.T, acc[0]

    return run


def attempt(block_chains, n_chains=4096, n_steps=40, lower_only=False):
    """One bounded attempt at one block size; returns a JSON-able dict."""
    problem = configs.build("darcy_da_fused")
    pos = jnp.asarray(problem.init_positions(jax.random.key(0), n_chains))
    out = {"block_chains": block_chains, "n_chains": n_chains,
           "n_outer_steps": n_steps}
    run = jax.jit(build_triton_da(problem, block_chains, n_steps),
                  static_argnums=1)
    t0 = time.perf_counter()
    try:
        lowered = run.trace(pos, 3).lower(lowering_platforms=("cuda",))
        if lower_only:
            return {**out, "outcome": "lowered",
                    "lower_s": time.perf_counter() - t0}
        compiled = lowered.compile()
    except Exception as e:  # the refusal is the finding
        msg = f"{type(e).__name__}: {e}"
        return {**out, "outcome": "refused", "error": msg[:600]}
    out["compile_s"] = time.perf_counter() - t0
    jax.block_until_ready(compiled(pos))
    t0 = time.perf_counter()
    final, acc = compiled(pos)
    jax.block_until_ready(final)
    out["triton_s"] = time.perf_counter() - t0

    kp = problem.kernel_params
    plain = jax.jit(lambda p: fused_da_pcn_chain(
        problem.batched_potential_fn, problem.batched_surrogate_fn, p,
        np.asarray(problem.prior.mean), np.asarray(problem.prior.scale),
        kp["beta"], 3, n_steps=n_steps, subchain_len=kp["subchain_len"],
        block_chains=block_chains))
    ref_final, ref_acc, _ = jax.block_until_ready(plain(pos))
    t0 = time.perf_counter()
    jax.block_until_ready(plain(pos))
    out["plain_s"] = time.perf_counter() - t0
    out["triton_outer_steps_per_s"] = n_chains * n_steps / out["triton_s"]
    out["plain_outer_steps_per_s"] = n_chains * n_steps / out["plain_s"]
    out["accept_share_equal"] = float(
        np.mean(np.asarray(acc) == np.asarray(ref_acc)))
    out["max_abs_diff"] = float(
        np.max(np.abs(np.asarray(final) - np.asarray(ref_final))))
    out["outcome"] = "compiled"
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, nargs="+", default=[32, 64])
    ap.add_argument("--n-chains", type=int, default=4096)
    ap.add_argument("--n-steps", type=int, default=40)
    ap.add_argument("--lower-only", action="store_true")
    args = ap.parse_args(argv)
    for b in args.blocks:
        print(json.dumps(attempt(b, args.n_chains, args.n_steps,
                                 args.lower_only)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
