"""The port stands alone: importing every module of ``repro_torch`` (host
offload and the launch layer among them) and ``chip_smoke.py`` (a fresh
interpreter) pulls in neither JAX nor any module of the JAX package
``repro``, and brings up no process group."""
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
import torch.distributed as dist
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
launch = all(f"repro_torch.{{m}}" in names for m in (
    "roofline", "launch.mesh", "launch.sharding", "launch.specs",
    "launch.dryrun", "utils.act_sharding"))
print(len(names), "repro_torch.tiering.host_offload" in names and launch,
      dist.is_initialized(), bad)
"""


def test_port_and_chip_smoke_import_no_jax():
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n_modules, named, group, bad = proc.stdout.strip().split(" ", 3)
    assert int(n_modules) >= 100 and named == "True"
    assert group == "False", "importing the port brought up a process group"
    assert bad == "[]", f"port imported {bad}"
