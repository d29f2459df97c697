"""The port stands alone: importing every module of ``repro_torch`` (host
offload among them) and ``chip_smoke.py`` (a fresh interpreter) pulls in
neither JAX nor any module of the JAX package ``repro``."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
sys.path[:0] = [{root!r}, {src!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), "repro_torch.tiering.host_offload" in names, bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules, offload, bad = proc.stdout.strip().split(" ", 2)
    assert int(n_modules) >= 20 and offload == "True"
    assert bad == "[]", f"port imported {bad}"
