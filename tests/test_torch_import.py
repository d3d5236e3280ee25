"""The PyTorch port never imports jax. Checked in a fresh interpreter:
tests/conftest.py imports jax into every test process."""

import os
import pkgutil
import subprocess
import sys

import improved_body_parts_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    pkg = improved_body_parts_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]


def test_port_imports_no_jax():
    mods = _port_modules()
    for m in ("ops.kernels", "ops.warp", "apps.demo_image", "apps.evaluate"):
        assert "improved_body_parts_tpu_torch." + m in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
