"""chip_smoke.py: refuses to report without a GPU or without the
package, and its phases run end to end on the CPU at a tiny size (the
kernel in the Pallas interpreter)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as CS

REPO = Path(__file__).resolve().parents[1]
TINY = CS.Sizes(stack_n=4, stack_h=160, stack_w=192, band_rows=2,
                preview=96, compose_h=256, compose_w=256, compose_stars=45,
                drizzle_n=3, drizzle_side=48, runs=1)


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_on_a_cpu_device():
    r = _run(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_fails_alone_without_the_package(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", script)
    r = _run(tmp_path, script)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.setenv("ASTROBURST_CONFIG_DIR", str(tmp_path / "config"))
    return str(tmp_path)


def test_stack_api_and_headline_phases_tiny(workdir):
    rng = np.random.default_rng(0)
    res, (frames, shifts) = CS.phase_stack_api(TINY, rng, workdir)
    assert res["offsets_exact"] and res["band_pixels_off"] <= 1
    head = CS.phase_headline(TINY, frames, shifts, interpret=True)
    assert head["kernel_vs_xla_max_abs_diff"] < 1e-2
    assert not head["kernel_on_main_path"]     # no Triton on the CPU
    assert set(head["shift_clip"]) == {"xla_ms", "kernel_ms"}


def test_preview_phase_tiny(workdir):
    res = CS.phase_preview(TINY, np.random.default_rng(1), workdir)
    assert res["png_shape"][0] > 0


def test_compose_phase_tiny(workdir):
    res = CS.phase_compose(TINY, np.random.default_rng(2), workdir)
    assert min(res["aligned_ncc"]) > 0.9
    assert res["export_bytes"] > 0


def test_drizzle_phase_tiny(workdir):
    res = CS.phase_drizzle(TINY, np.random.default_rng(3), workdir)
    assert res["output_dims"] == [96, 96]
    assert res["corner_max_abs_diff"] < 2e-3
