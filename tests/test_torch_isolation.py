"""The port stands alone: importing any module of ``srganfd_tpu_torch``
pulls in no JAX and nothing of the JAX package, and no source of the
port (nor ``chip_smoke.py`` and ``f32_step_study.py``, which run it on the
card) names either."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "srganfd_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + [
    ROOT / "chip_smoke.py", ROOT / "f32_step_study.py"]

FORBIDDEN_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax|srganfd_tpu(?!_torch))\b", re.M
)
FORBIDDEN_NAME = re.compile(r"\bsrganfd_tpu\.|\bimport\s+jax\b")

_PROBE = r"""
import importlib, pkgutil, re, sys
import srganfd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(srganfd_tpu_torch.__path__, "srganfd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if re.match(r"^(jax|jaxlib|flax|optax|orbax)(\.|$)", m) or re.match(r"^srganfd_tpu(\.|$)", m))
print(len(names), bad)
"""


def test_importing_every_module_loads_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    count, bad = proc.stdout.strip().split(" ", 1)
    assert int(count) >= 15, proc.stdout  # every module was walked
    assert bad == "[]", f"the port imported {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax(path):
    text = path.read_text()
    assert not FORBIDDEN_IMPORT.search(text), FORBIDDEN_IMPORT.search(text).group(0)
    assert not FORBIDDEN_NAME.search(text), FORBIDDEN_NAME.search(text).group(0)
