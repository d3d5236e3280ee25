"""The PyTorch port never imports jax, nor anything of the JAX package
``improved_body_parts_tpu``. Checked statically (every import statement of
the port and of ``chip_smoke.py``, lazy ones inside functions included) and
in a fresh interpreter: tests/conftest.py imports jax into every test
process."""

import ast
import glob
import os
import pkgutil
import subprocess
import sys

import pytest

import improved_body_parts_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PACKAGE = "improved_body_parts_tpu"


def _port_modules():
    pkg = improved_body_parts_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]


def _port_sources():
    pkg_dir = os.path.join(REPO, "improved_body_parts_tpu_torch")
    return sorted(glob.glob(os.path.join(pkg_dir, "**", "*.py"), recursive=True)
                  + [os.path.join(REPO, "chip_smoke.py")])


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
                for alias in node.names:      # `from x import y` may import x.y
                    yield node.lineno, f"{node.module}.{alias.name}"


def _is_jax_package(name: str) -> bool:
    return name == JAX_PACKAGE or name.startswith(JAX_PACKAGE + ".")


def test_ast_scan_catches_a_lazy_import():
    src = ("def f():\n    from improved_body_parts_tpu.ops import group\n"
           "import improved_body_parts_tpu_torch.configs\n")
    bad = [n for _, n in _imported_names(ast.parse(src)) if _is_jax_package(n)]
    assert bad == ["improved_body_parts_tpu.ops", "improved_body_parts_tpu.ops.group"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_imports_nothing_of_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [(line, n) for line, n in _imported_names(tree)
           if _is_jax_package(n) or n == "jax" or n.startswith("jax.")]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_port_imports_no_jax():
    mods = _port_modules()
    for m in ("ops.kernels", "ops.warp", "ops.group_cpp", "apps.demo_image",
              "apps.evaluate", "infer.serving", "data.synthetic",
              "utils.oks_eval", "configs"):
        assert "improved_body_parts_tpu_torch." + m in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "importlib.import_module('chip_smoke')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
            "assert not bad, bad\n"
            f"bad = sorted(m for m in sys.modules if m == {JAX_PACKAGE!r} "
            f"or m.startswith({JAX_PACKAGE + '.'!r}))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
