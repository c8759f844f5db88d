"""chip_smoke.py: its device phase refuses anything but a GPU (runs here),
and its phases pass on a card (marker ``gpu``: skipped without one)."""

import json
import subprocess
import sys
import os

import jax
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_phase_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.device_phase()


def test_script_fails_without_printing_a_result_on_cpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_device_phase_on_gpu(gpu):
    dev = chip_smoke.device_phase()
    assert dev == {"platform": "gpu", "kind": gpu.device_kind, "count": 1}
    assert chip_smoke.nvidia_smi()


@pytest.mark.gpu
def test_parity_phase_on_gpu(gpu):
    out = chip_smoke.parity_phase(n_draws=256)
    assert out["exact_phi_max_rel_vs_oracle"] <= chip_smoke.PHI_RTOL_EXACT


@pytest.mark.gpu
def test_fused_entry_points_on_gpu_match_cpu(gpu):
    out = chip_smoke.fused_device_vs_cpu_phase(n_chains=256, n_steps=2)
    assert set(out) == {"rwm", "pcn", "pcn_warm", "pcn_dense", "pcn_adapt",
                        "da", "da3", "mala", "mala_warm", "ess", "fes"}
    assert all(np.isfinite(v["accept_rate"]) for v in out.values())
    json.dumps(out)
