"""wl/wlp engines at K=16 shards: the conftest mesh is 8 devices, so a
subprocess brings up a 16-device CPU backend and asserts push parity for
both sharded engines. K=32 runs via the same worker when PPRX_TEST_K32=1
(slow; exercised manually)."""

import os
import subprocess
import sys

import pytest


def _run_k(k: int):
    worker = os.path.join(os.path.dirname(__file__), "_k16_worker.py")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={k}"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    out = subprocess.run(
        [sys.executable, worker, str(k)],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "ALL-OK" in out.stdout, out.stdout + out.stderr
    return out.stdout


def test_wl_engines_k16():
    _run_k(16)


@pytest.mark.skipif(
    os.environ.get("PPRX_TEST_K32", "0") != "1",
    reason="slow; set PPRX_TEST_K32=1",
)
def test_wl_engines_k32():
    _run_k(32)
