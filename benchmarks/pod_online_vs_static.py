"""POD online enrichment vs static POD, head-to-head on the chip (round-5,
VERDICT round-4 item 7).

Round 4 shipped online enrichment with an INDICATOR claim (the reduced-
residual error indicator decreases over enrichment epochs — tested) but no
VALUE claim: nothing measured whether enrichment buys inner acceptance or
ESS/s against the static-POD config on real hardware. This script runs
`darcy_da_pod` (static rank-20 basis from 64 offline prior solves) and
`darcy_da_pod_online` (starts from 24 prior solves, 3 enrichment epochs at
posterior-typical states during burn-in) through the runner on the ambient
backend and commits the comparison.

Both sample the SAME exact posterior (DA corrects any surrogate); the
differences are efficiency only: inner/outer acceptance, ESS/s, and the
enrichment cost itself (pod_enrich_s, amortized or not).

Writes benchmarks/pod_online_vs_static.json.
"""

from __future__ import annotations

import json
import sys
import time


def log(*a):
    print(*a, file=sys.stderr, flush=True)


KEEP = (
    "config", "n_chains", "n_samples", "accept_rate", "min_ess", "ess_per_s",
    "outer_steps_per_s", "inner_steps_per_s", "max_rhat", "run_s",
    "trace_s", "compile_s", "first_dispatch_s", "total_wall_s",
    "pod_enrich_s", "pod_enrich_epochs", "pod_enrich_indicator_mean",
    "ess_per_total_wall_s",
)


def main():
    import jax

    from ip_mcmc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_time_s=1.0)

    import numpy as np

    from ip_mcmc_tpu import configs, runner

    log(f"device: {jax.devices()[0]}")
    rows = {}
    for name in ("darcy_da_pod", "darcy_da_pod_online"):
        p = configs.build(name)
        t0 = time.time()
        m = runner.run_problem(p, key=jax.random.key(5))
        row = {k: m[k] for k in KEEP if k in m}
        row["posterior_mean_norm"] = float(
            np.linalg.norm(np.asarray(m["posterior_mean"]))
        )
        rows[name] = row
        log(json.dumps(row))

    s, o = rows["darcy_da_pod"], rows["darcy_da_pod_online"]
    verdict = {
        "ess_per_s_ratio_online_vs_static": round(
            o["ess_per_s"] / s["ess_per_s"], 3),
        "ess_per_total_wall_ratio": round(
            o["ess_per_total_wall_s"] / s["ess_per_total_wall_s"], 3),
        "accept_static": s["accept_rate"],
        "accept_online": o["accept_rate"],
        "enrich_cost_s": o.get("pod_enrich_s"),
        "posterior_mean_gap": round(abs(
            o["posterior_mean_norm"] - s["posterior_mean_norm"]), 4),
    }
    log(json.dumps(verdict))
    out = {"rows": rows, "verdict": verdict}
    with open("benchmarks/pod_online_vs_static.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
