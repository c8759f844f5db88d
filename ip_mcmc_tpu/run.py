"""CLI entry: ``python -m ip_mcmc_tpu.run --config darcy_pcn_4096``.

Reference has no CLI (experiments are hard-coded scripts, SURVEY.md §5.6);
this makes each BASELINE config a one-command reproducible run with JSON
metrics on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import jax


def main(argv=None):
    t_main = time.perf_counter()
    ap = argparse.ArgumentParser(description="ip_mcmc_tpu benchmark runner")
    # NOTE: --config is validated against configs.REGISTRY after parsing —
    # importing the package here would initialize the XLA backend, which
    # must not happen before jax.distributed.initialize in multi-host mode.
    ap.add_argument("--config")
    ap.add_argument("--n-chains", type=int, default=None)
    ap.add_argument("--n-samples", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--devices", type=int, default=None,
        help="shard chains over the first N devices (default: no sharding; "
        "in multi-process mode the default is ALL global devices)",
    )
    # Multi-host launch (SURVEY.md §2.4): one process per host. Flags fall
    # back to the environment
    # (IPX_COORDINATOR / IPX_NUM_PROCESSES / IPX_PROCESS_ID) so schedulers
    # that template env vars need no per-process argv. Example, 2 hosts:
    #   host0$ python -m ip_mcmc_tpu.run --config darcy_pcn_4096 \
    #            --coordinator host0:8476 --num-processes 2 --process-id 0
    #   host1$ ... --process-id 1
    # Process 0 prints the merged metrics JSON; others print nothing.
    ap.add_argument(
        "--coordinator", default=os.environ.get("IPX_COORDINATOR"),
        metavar="HOST:PORT",
        help="jax.distributed coordinator address (process 0's host)",
    )
    ap.add_argument(
        "--num-processes", type=int,
        default=int(os.environ["IPX_NUM_PROCESSES"])
        if "IPX_NUM_PROCESSES" in os.environ else None,
    )
    ap.add_argument(
        "--process-id", type=int,
        default=int(os.environ["IPX_PROCESS_ID"])
        if "IPX_PROCESS_ID" in os.environ else None,
    )
    ap.add_argument("--profile-dir", default=None, help="jax.profiler trace dir")
    ap.add_argument(
        "--metrics-log", default=None,
        help="write JSON-lines metric records (run summary + accept trace)",
    )
    ap.add_argument(
        "--tensorboard", default=None, metavar="LOGDIR",
        help="export the run's metric records as a TensorBoard event file "
        "under LOGDIR (scalar dashboard; utils/tensorboard.py — no "
        "tensorboard package needed to write)",
    )
    ap.add_argument(
        "--fused", action="store_true",
        help="use the fused chain engine (pCN configs with a batched "
        "potential: darcy_pcn_4096, burgers_pcn)",
    )
    ap.add_argument(
        "--list", action="store_true", help="list configs and exit"
    )
    args = ap.parse_args(argv)

    multiproc = args.coordinator is not None or (args.num_processes or 0) > 1
    if multiproc and not args.list:
        # must happen before ANY JAX call that initializes the backend —
        # including importing modules that build jnp constants at import
        # time — so this precedes the configs/runner import below
        from ip_mcmc_tpu.parallel.mesh import distributed_init

        distributed_init(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    # Persistent compilation cache: a second invocation of a config reuses
    # its compiled programs. Imported only now: importing the package
    # touches the backend, which must follow jax.distributed.initialize.
    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from ip_mcmc_tpu import configs, runner

    if args.list:
        for name in sorted(configs.REGISTRY):
            doc = (configs.REGISTRY[name].__doc__ or "").strip().splitlines()[0]
            print(f"{name:22s} {doc}")
        return 0
    if args.config is None:
        ap.error("--config is required (or use --list)")
    if args.config not in configs.REGISTRY:
        ap.error(
            f"unknown config {args.config!r} (choose from "
            f"{', '.join(sorted(configs.REGISTRY))})"
        )

    problem = configs.build(args.config)
    if args.fused:
        problem.kernel_params = {**problem.kernel_params, "fused": True}
    mesh = None
    if args.devices or multiproc:
        from ip_mcmc_tpu import parallel

        mesh = parallel.make_chain_mesh(n_devices=args.devices)
    if multiproc and jax.process_index() != 0:
        # single-writer outputs: only process 0 logs/exports (the records
        # are replicated across processes anyway)
        args.metrics_log = args.tensorboard = None
    metrics_log = args.metrics_log
    if args.tensorboard and metrics_log is None:
        # TB export reads the JSONL records; synthesize a log next to it
        os.makedirs(args.tensorboard, exist_ok=True)
        metrics_log = os.path.join(args.tensorboard, "metrics.jsonl")
    # MetricsLogger appends: remember where this run's records start so the
    # TB export below doesn't re-export stale records from earlier runs
    # against the same log file (ADVICE round 2).
    log_offset = (
        os.path.getsize(metrics_log)
        if metrics_log and os.path.exists(metrics_log)
        else 0
    )
    setup_s = time.perf_counter() - t_main
    metrics = runner.run_problem(
        problem,
        key=jax.random.key(args.seed),
        n_chains=args.n_chains,
        n_samples=args.n_samples,
        profile_dir=args.profile_dir,
        mesh=mesh,
        metrics_log=metrics_log,
    )
    # CLI-level wall attribution: setup_s = arg parsing + config build +
    # backend init before run_problem; cli_total_s = everything inside
    # main(). Python import time before main() is the only remainder.
    metrics["setup_s"] = setup_s
    metrics["cli_total_s"] = time.perf_counter() - t_main
    if multiproc:
        metrics["process_count"] = jax.process_count()
        metrics["process_id"] = jax.process_index()
        metrics["global_devices"] = len(jax.devices())
        if jax.process_index() != 0:
            # one JSON on stdout for the whole job: process 0's. Metrics
            # are identical across processes (reductions over the sharded
            # chain axis are globally replicated by GSPMD).
            return 0
    if args.tensorboard:
        from ip_mcmc_tpu.utils.tensorboard import export_jsonl

        metrics["tensorboard_events"] = export_jsonl(
            metrics_log, args.tensorboard, start_offset=log_offset
        )
    json.dump(metrics, sys.stdout)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
